#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card
    python3 chip_smoke.py zoo    # phases 1-3's zoo part, 9 and 10 alone
    python3 chip_smoke.py train  # phases 1-3's training part and 11 alone
    python3 chip_smoke.py softcap  # phases 1-3's soft-cap part and 12 alone
    python3 chip_smoke.py mesh   # phases 1-3's mesh part, 13 and 14 (b)

Phases, each printing its own lines; any failure raises, and the script
then exits non-zero without the final result line:

1. card: name and power limit, as nvidia-smi prints them;
2. build: the CUDA kernels from src/repro_torch/kernels/csrc (set-up),
   with one line per kernel from ptxas (registers, spills);
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the serving shapes and edge cases, with the stated
   tolerances (flash on both sides of the tensor-core threshold, and
   both flash kernels forced at shapes around it; BvSB and decode
   attention called twice, bitwise equal, and decode with NaN in every
   slot past the length, in f32, bf16 and f32 q over a bf16 cache; the
   RG-LRU scan bit for bit, in f32 and bf16,
   on its ring and its per-element path; flash and decode at the zoo's
   shapes, head dim 160 among them; flash non-causal over T != S keys
   at seamless's cross-attention, at edges with each kernel forced and
   on a strided q, each repeated bitwise, and refusing causal over T !=
   S; decode over seamless's cross K/V and self ring; BvSB at every zoo
   model's padded head); kernel, plain, library and bound
   times at the paths' shapes (the zoo's models too) and at B = 64
   (CUDA events,
   after warm-up), the scan also in bf16 and at B = 1, flash's bound at
   the tensor-core rate beside its FP32 CUDA-core bound (every bound from
   ``repro_torch.roofline.analysis``, every time from
   ``repro_torch.kernels.timing.time_ms``), the threshold sweep of the
   two flash kernels (the planners' constants are swept in phase 14).
   The training part: flash under
   autograd (FlashAttentionFn) at each training path's attention and at
   deepseek's and seamless's forms, f32 and bf16: the forward's row
   log-sum-exp against the plain one, dq / dk / dv against
   ``flash_attention_bwd_plain`` on the same inputs (max |err| over max
   |ref|: 1e-4 f32, 2e-2 bf16), a second backward bitwise equal; the
   scan's backward (RGLRUScanFn) bit for bit against its plain reverse
   loop, f32 and bf16, with and without h0; BvSB and decode attention
   under grad raising; the backward kernels' times beside their bounds
   (flash: 2.5 times the forward's products at the tensor-core and the
   FP32 rates; the scan: 5 B S D 4 bytes), plain versions and SDPA's
   backward through autograd; the scan's backward on its cp.async ring
   and its per-element path, each forced, bit for bit the plain loop, its
   rows beside the per-element path's time. The soft-cap part: flash forward and
   backward (each form forced) and decode (three dtype pairs) with
   gemma's cap against their plain versions with the cap, each repeated
   bitwise, and capped rows at gemma-7b's shapes beside the uncapped
   ones, the library flex attention with a tanh score_mod where the
   card's install compiles it;
4. cascade path: the live cascade — 16 device clients on tier-low, a
   server engine hosting tier-server-fast and tier-server-heavy with
   model switching, the MultiTASC++ scheduler — through ``run_cascade``,
   with the kernels' launch counters read around it. The run must keep
   some samples on the devices and forward the rest, move the thresholds
   until S(C) switches the server model, and serve batches on both
   server models. Then one 64-sample tier-server-heavy batch on the card
   against the same weights on the CPU (plain versions);
5. RecurrentGemma path: RecurrentGemma-9B at full width and depth (38
   layers, random weights drawn on the card) through the zoo's serving
   entry points — ``make_prefill_step`` on 4 prompts of 3,000 tokens,
   then 32 ``make_serve_step`` decode steps feeding back each top-1 —
   with the launch counters read around it and held to 12 flash, 26
   RG-LRU scan, 384 decode-attention and 33 BvSB launches; the ring
   caches must hold positions 952..2999 at slot pos % 2048. Then the
   card against the CPU at full width and one super-block of depth;
6. simulator path: calibration from light-model logits on the card (the
   BvSB kernel) against the CPU, then the paper's simulator through
   ``jaxsim.run_sweep`` on the card at the paper's scale: (a) the
   heterogeneous fleet of 100 devices x 5,000 samples, 3 schedulers x 3
   seeds; (b) the same fleet under churn and MMPP arrivals with model
   switching over three servers, one lane per scheduler. The first three
   lanes of each also run on the CPU in worker processes started at the
   phase's start, and must equal the card's lanes (counts, per-device
   fields, thresholds, the traces' server index and forwarded counts;
   the float sums over devices within 1e-5 relative). Then (a)'s fleet
   at 600 samples for B in {1, 9, 64, 256}, and a profiled rerun for the
   device's busy time. The launch counters around the path must read one
   BvSB launch (the calibration) and nothing else;
7. transport, replay and segmented frontier: (a) phase 4's fleet
   through the async transport ``run_transport`` at 1 and 2 in-flight
   slots, each ``CascadeResult`` field and the launch counts equal to
   ``run_cascade``'s at the same slots (at 1 slot phase 4's own run), the
   walls printed, and the idle share of a profiled 2-slot rerun of 16 of
   the 128 samples a device; (b)
   ``serving_vs_sim`` on steady / churn / churn_drift x the three
   schedulers (10 devices x 80 samples), the simulator half on the card:
   every delta within ``SERVING_TOL``, the card's simulator outputs equal
   to the CPU's under phase 6's rules; (c) 5,000 devices (three tiers,
   per-device jittered latencies, MultiTASC++ with switching over three
   servers, 3 seeds) through ``jaxsim.run_sweep`` on the card with the
   automatic segmented frontier (G = 128) and with the flat one: equal
   bit for bit but in ``n_events``, the first lane equal to the CPU's
   (a worker process started at the phase's start) under phase 6's
   rules; trips, us a trip and the kernels of one graph replay of each.
   The launch counters around (b) and (c) must read zero;
8. sharded sweeps: four ranks spawned on the card (``torch.multiprocessing``,
   a ``gloo`` world group rendezvoused through a file under build/; NCCL
   refuses two ranks on one GPU), each building ``make_sweep_mesh((4,))``:
   (a) phase 6's width-sweep run of (a)'s 9 lanes at ``SIM_WIDTH_S``
   samples through ``run_sweep_sharded`` (B = 9 padded to 12), every
   field on every rank equal to that ``run_sweep`` bit for bit and 9
   points counted as sharded; (b) phase 7c's first lane,
   its fleet cut to ``SHARD_N`` devices, through ``run_device_sharded``,
   held on every rank to the same lane through the local segmented engine
   under tests/test_scale.py's rules (dynamics and ``n_events`` exact,
   the float sums over ranks within 1e-6 / 1e-5 relative). Walls against
   the local runs', trips or events, us an event, and for (b) the
   collectives an event and their share of the wall. A rank's failure
   raises here;
9. the decoder zoo: granite-moe-1b-a400m at full width and depth,
   deepseek-moe-16b (the dense layer 0 and 3 MoE layers), stablelm-12b
   (hd 160) and qwen2-vl-7b (M-RoPE, 1,024 vision embeddings in front of
   1,024 tokens) at full width and 4 layers, random weights drawn on the
   card, each through ``make_prefill_step`` on 4 prompts of 2,048
   positions and 16 (granite) or 8 ``make_serve_step`` decode steps
   feeding back each top-1, the launch counters read around them and held
   to one flash launch an attention layer, layers x steps decode launches
   and 1 + steps BvSB launches; for MoE the assignments dropped at the
   capacity per layer, from a second prefill bitwise equal to the first;
   a profiled rerun; then the card against the CPU at full width and 2
   layers (deepseek: the dense layer and one MoE layer) on 2 prompts of
   64 positions and 4 steps: BvSB within 1e-5, top-1, and for MoE the
   routing ids where the router's k-th and (k+1)-th probabilities are
   more than 1e-6 apart, the MoE output within 1e-4 on the tokens routed
   alike, two card calls bitwise equal;
10. the rest of the zoo, at full width and depth with random weights
   drawn on the card: xlstm-350m (12 mLSTM + 12 sLSTM layers) through
   ``make_prefill_step`` on 4 prompts of 2,048 tokens and 16
   ``make_serve_step`` decode steps, launches held to 17 BvSB and
   nothing else; seamless-m4t-medium (12 encoder + 12 decoder layers)
   over 4 x 1,024 seeded audio frame embeddings with prompts of 512
   tokens into self rings of 520 slots and 8 decode steps, launches held
   to 36 flash (12 encoder, 12 decoder self, 12 cross over T != S),
   192 decode (self and cross) and 9 BvSB; prefill wall, ms a step, peak
   memory, a profiled rerun (xLSTM's of a 128-token prefill) and
   xLSTM's one-layer cell walls; then the card against the CPU at full
   width: xLSTM's first mLSTM and sLSTM layer on 2 x 256 tokens,
   seamless at 2 + 2 layers over 2 x 48 frames and prompts of 32
   tokens, 4 steps each: BvSB within 1e-5, top-1, a second card prefill
   bitwise equal, xLSTM's states after the prefill within 1e-4
   relative;
11. training, with the launch counters read around each path: (a) the
   cascade pair of examples/serve_cascade.py, tier-server-fast trained
   60 steps through ``trainer.train`` on the classification stream
   (batch 64, the label at the last position), then tier-low distilled
   from it 60 steps (``make_distill_step``): the loss and kd fall; (b)
   granite-moe-1b-a400m at full width and depth (1.33 B parameters)
   through ``launch.distributed.make_train_step`` with remat, 4 steps of
   4 x 2,048 SyntheticLM tokens: finite losses, the first CE within 0.25
   of what random weights give (ln V + var(logit) / 2), 48 flash forward
   (with the recompute) and 24 backward launches a step; (c)
   recurrentgemma-9b at full width over one super-block (rglru, rglru,
   lattn; 1.64 B), 3 steps of 2 x 3,000 tokens (the 2,048 window masks):
   4 scan forward, 2 scan backward, 2 flash forward and 1 backward a
   step; each at most 70 GB peak, step ms, tokens/s and a profiled
   step's idle share; then each of (b) at 2 layers and (c) at its
   super-block on 1 x 256 tokens against the CPU on the same weights:
   the loss within 1e-5 relative, each parameter's gradient within 1e-4
   of its max |g|, the grad norm within 1e-4 relative, and on the card
   remat on and off bitwise equal;
12. soft-capped attention: gemma-7b at full width with Gemma 2's
   attention soft cap of 50 (``logit_soft_cap``), served at 4 layers
   (``make_prefill_step`` on 4 prompts of 2,048 positions, 8
   ``make_serve_step`` steps feeding back each top-1; launches held to one
   flash launch a layer at the prefill, layers x steps decode and 1 +
   steps BvSB; a profiled rerun; 2 layers card vs CPU on 2 x 64 and 4
   steps: BvSB within 1e-5, top-1), then trained at 2 layers through
   ``make_train_step`` with remat, 3 steps of 2 x 2,048 SyntheticLM
   tokens (two flash forward and one backward launch a layer a step),
   then 2 layers on 1 x 256 tokens card vs CPU under phase 11's rules;
13. the step factories over a (data, model) mesh, four ``gloo`` ranks
   spawned on the card as in phase 8 (``make_model_mesh``), every layer
   cut over the model ranks (``launch.shardings``: heads, MLP features,
   RG-LRU channels, experts, vocabulary rows; the rings on their slots):
   (a) granite-moe-1b-a400m at full width and depth on a (1, 4) mesh, 4
   heads, 8 experts and a quarter of the vocabulary a rank:
   ``make_prefill_step`` on 4 x 2,048 tokens into rings of 2,064 slots
   (516 a rank), 8 ``make_serve_step`` steps feeding back top-1 (one
   decode partial and one merge launch an attention layer a step, one
   BvSB partial and one merge launch a call, counted on every rank), 3
   ``make_train_step`` steps of 2 x 2,048 with remat, held to the one-card
   steps on the same weights and tokens (BvSB 1e-5, top-1 equal, the
   losses 1e-5 relative), every rank's conf and top-1 bitwise equal; the
   gradients at 2 layers on 1 x 256 tokens, the rank's experts against
   their slice of the one-card gradient, 1e-4 of a leaf's max |g|; (b)
   the same weights on a (2, 2) mesh: each data rank's rows against a
   one-card run on those rows alone (their own capacity), and the
   gradients at 2 layers against the mean of the two rows' one-card
   gradients; walls, tokens/s, each rank's peak (together at most 72
   GB; the earlier layout, the dense layers whole on every rank, took
   8.153 GB a rank on an H100 80GB HBM3 at 700 W) and the all_reduces' count and share of a clocked step (gloo: a
   host copy each way, not a fabric); (e) RecurrentGemma-9B at full
   width and 12 of its 38 layers on a (1, 4) mesh: flash on 4 of 16
   heads, the scan on
   1,024 channels a rank, the 2,048-slot local rings 512 slots a rank
   through the decode partial and merge entries; a prefill of 4 x 3,000
   tokens (the rings wrap) and 8 serve steps, held to the one-card run of
   the same weights and tokens (BvSB 1e-5, top-1 equal wherever the top-2
   logit gap exceeds 1e-4), every rank bitwise equal; (c)
   seamless-m4t-medium trained at full width and depth (3 steps of 2 x
   512 tokens over 1,024 audio frames, remat; flash's three forms each
   held to twice its layers a step), (d) xlstm-350m (2 steps of 2 x 128,
   no kernel: its cells are plain PyTorch), (f) each at 2 layers against
   the CPU under phase 11's rules. Phase 3 holds the BvSB partial entry
   to its plain version (shards of granite's head with padded columns,
   whole chunks at -inf, bf16, bitwise repeats) and the merge over four
   shards to ``bvsb_plain``, the decode partial entry on each rank's
   shard of RecurrentGemma's and granite's rings (full, partly filled,
   shards empty; three dtype pairs, capped and not) to its plain version
   and the merge of the gathered partials to the whole ring's plain
   decode, bitwise repeats, and times all four beside their bounds. Each
   clocked step's all_reduces must be as many as the collectives
   ``MeshContext`` books (``models.common.counting_collectives``: the
   logical gathers, reduces and reduce-scatters), and each rank's stored
   bytes are kept exact;
14. tuning and the dry-run: (a) ``kernels.autotune.sweep`` of every
   planner constant (BvSB's BLOCKS_PER_SM and MIN_CHUNK, decode's
   BLOCKS_PER_SM and SHARD_MIN_KEYS, the scan's IN_FLIGHT, STAGES and
   BWD_STEPS) over the paths' shapes, each candidate held to its plain
   version (float32: BVSB_ATOL / DECODE_ATOL, top-1 exact; the scan
   bitwise), any disagreement a failure, and printed against its bound
   (a winner must beat the value in force by more than its timings'
   spread); the winners persisted to a file under build/ and
   reloaded, then another BvSB plan: ``ops.cache_token`` changes, the
   serving executable cache takes a new entry and the cascade's server
   BvSB under it equals the default plans' (1e-5, top-1), the defaults
   put back; flash's ``tensor_core_rule`` held to the library's choice;
   (b) ``launch.dryrun`` of phase 13's granite cells ((a)'s serve step,
   (b)'s train step stored FSDP and resident) on a fake process group of
   four ranks in a process of its own: the bytes a rank stores equal
   phase 13's measured bytes exactly, the collectives its clocked
   steps', kind by kind; the peak estimate printed beside the measured
   peak; (c) the timer floors (``timing.time_ms``'s event span and
   ``time_blocked``'s block at MIN_RES_MULT times their clocks'
   resolution: the events' documented 0.5 us, perf_counter's measured);
15. the kernels line: one JSON object describing every ported kernel;
16. the result line: {"ok": true, "device": {...}}.

``zoo`` runs phases 1 and 2, phase 3's BvSB, flash and decode checks
and its zoo timing rows, the MoE dispatch's scan of its one-hot in two
forms in turns (JAX's ``cumsum`` down the (N k, E) one-hot against
``moe.dispatch`` along the transposed one-hot's contiguous dim, at
granite's and deepseek's prefill: the same rows, device ms), then phases
9 and 10, and prints no result line. ``train`` runs phases 1 and 2,
phase 3's training part, then phase 11, and prints no result line.
``softcap`` runs phases 1 and 2, phase 3's soft-cap part, then phase 12,
and prints no result line. ``mesh`` runs phases 1 and 2, phase 3's
partial-entry checks and rows (BvSB and decode attention), then phase
13 and phase 14 (b), and prints no result line. ``train`` also sweeps
the scan's BWD_STEPS as phase 14 does.

``throughput`` of the cascade is a virtual-clock figure from the paper's
latency profiles, not a measurement of the card.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import datetime
import functools
import io
import json
import multiprocessing
import pathlib
import pickle
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.cascade_tiers import (BATCH_LADDER,  # noqa: E402
                                               DEVICE_PROFILES,
                                               SERVER_PROFILES,
                                               ServerProfile)
from repro_torch.configs import scenarios  # noqa: E402
from repro_torch.configs.scenarios import (ArrivalSpec,  # noqa: E402
                                           ChurnSpec, ScenarioSpec)
from repro_torch.core import calibration  # noqa: E402
from repro_torch.core.switching import DEFAULT_C_UPPER  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bvsb as _bvsb  # noqa: E402
from repro_torch.kernels import decode_attention as _decode  # noqa: E402
from repro_torch.kernels import flash_attention as _flash  # noqa: E402
from repro_torch.kernels import rglru_scan as _rglru  # noqa: E402
from repro_torch.kernels.bvsb import (bvsb_merge_plain,  # noqa: E402
                                      bvsb_partials_plain, bvsb_plain)
from repro_torch.kernels.decode_attention import \
    decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_lse_plain, flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.kernels import autotune, timing  # noqa: E402
from repro_torch.kernels.timing import time_ms  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    bvsb_bound_ms, bvsb_merge_bound_ms, bvsb_partials_bound_ms, rates_for,
    decode_bound_ms, decode_merge_bound_ms, decode_partials_bound_ms,
    flash_bounds_ms, flash_bwd_bounds_ms, rglru_bound_ms, rglru_bwd_bound_ms)
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    rglru_scan_bwd_plain, rglru_scan_plain)
from repro_torch.launch.distributed import (PAD_LOGIT,  # noqa: E402
                                            head_bvsb, make_loss_fn,
                                            make_prefill_step,
                                            make_serve_step,
                                            make_train_step)
from repro_torch.launch.mesh import make_sweep_mesh  # noqa: E402
from repro_torch.models import attention, common, moe, xlstm  # noqa: E402
from repro_torch.models.common import counting_collectives  # noqa: E402
from repro_torch.models.model import build_model, init_params  # noqa: E402
from repro_torch.serving.cascade import run_cascade  # noqa: E402
from repro_torch.serving.client import DeviceClient  # noqa: E402
from repro_torch.serving.engine import ServedModel, ServerEngine  # noqa: E402
from repro_torch.serving.executables import classify_fn  # noqa: E402
from repro_torch.serving.replay import (SERVING_TOL,  # noqa: E402
                                        serving_vs_sim)
from repro_torch.serving.transport import run_transport  # noqa: E402
from repro_torch.sim import jaxsim, synthetic  # noqa: E402
from repro_torch.sim.events import make_scheduler  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.data import (DataConfig,  # noqa: E402
                                       SyntheticLM, classification_stream)
from repro_torch.training.distill import (DistillConfig,  # noqa: E402
                                          make_distill_step)
from repro_torch.training.trainer import (TrainConfig,  # noqa: E402
                                          grads_of, init_model, to_device,
                                          train, trainable)

N_DEVICES, SAMPLES, SEQ, VOCAB = 16, 128, 16, 2048
PROFILE_SAMPLES = 16      # a device, in the profiled cascade reruns
SLO, WINDOW, THRESHOLD = 0.15, 0.25, 0.5
# tier-low's random weights are drawn at this scale (the tiers' default
# is 0.02, which leaves every BvSB near 1e-3) so that its confidences
# spread over (0, 1) as a trained light model's do: some samples stay on
# the device, and the thresholds the scheduler moves steer the rest
LOW_INIT_SCALE = 0.5
BVSB_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
FLASH_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DECODE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CLASSIFY_CONF_ATOL, TOP2_GAP = 1e-5, 1e-4

# the RecurrentGemma path: B prompts of S tokens, then STEPS decode steps
RG_ARCH, RG_B, RG_S, RG_STEPS = "recurrentgemma-9b", 4, 3000, 32
# and its card-vs-CPU check: one super-block, B prompts of S, STEPS steps
RG_CHECK_LAYERS, RG_CHECK_B, RG_CHECK_S, RG_CHECK_STEPS = 3, 2, 300, 4
RING_ATOL = 1e-4    # ring keys against a recomputation at another batch

# the zoo path: (arch, layers on the card (None: all), decode steps); each
# serves ZOO_B prompts of ZOO_S positions (Qwen2-VL: ZOO_VISION vision
# embeddings, then the text), then its decode steps
ZOO_MODELS = (("granite-moe-1b-a400m", None, 16), ("deepseek-moe-16b", 4, 8),
              ("stablelm-12b", 4, 8), ("qwen2-vl-7b", 4, 8))
ZOO_B, ZOO_S, ZOO_VISION = 4, 2048, 1024
# and its card-vs-CPU check: 2 layers (DeepSeek: the dense prefix and one
# MoE layer), B prompts of S positions (Qwen2-VL: S vision embeddings and
# S text tokens), STEPS decode steps
ZOO_CHECK_LAYERS, ZOO_CHECK_B, ZOO_CHECK_S, ZOO_CHECK_STEPS = 2, 2, 64, 4
ROUTE_GAP = 1e-6    # router probabilities closer than this may swap experts
MOE_ATOL = 1e-4

# phase 10, the rest of the zoo at full width and depth: xlstm-350m on B
# prompts of S tokens, then STEPS decode steps; its profiled rerun is a
# prefill of PROFILE_S tokens (the sLSTM's loop makes ~30 launches a
# position a layer, and the profiler's processing costs ~0.15 ms a
# launch)
XLSTM_ARCH, XLSTM_B, XLSTM_S, XLSTM_STEPS = "xlstm-350m", 4, 2048, 16
XLSTM_PROFILE_S = 128
# seamless-m4t-medium: B x FRAMES seeded audio frame embeddings and B
# prompts of S tokens, self rings of CACHE slots, STEPS decode steps
SEAM_ARCH, SEAM_B, SEAM_FRAMES, SEAM_S, SEAM_CACHE, SEAM_STEPS = (
    "seamless-m4t-medium", 4, 1024, 512, 520, 8)
# and their card-vs-CPU checks at full width: xLSTM's first two layers
# (one mLSTM, one sLSTM) on B prompts of S tokens (two mLSTM chunks);
# seamless 2 + 2 layers over B x FRAMES frames, prompts of S tokens (T !=
# S in the cross-attention); STEPS decode steps each
XLSTM_CHECK_LAYERS, XLSTM_CHECK_B, XLSTM_CHECK_S = 2, 2, 256
SEAM_CHECK_LAYERS, SEAM_CHECK_B, SEAM_CHECK_FRAMES, SEAM_CHECK_S = (
    2, 2, 48, 32)
ZOO10_CHECK_STEPS = 4
STATE_RTOL = 1e-4   # xLSTM states, card vs CPU: |card - cpu| / max(|cpu|, 1)

# phase 11, training. (a) the cascade pair of examples/serve_cascade.py:
# tier-server-fast trained, then tier-low distilled from it, PAIR_STEPS
# steps each on batches of PAIR_BS from classification_stream(PAIR_N, SEQ,
# PAIR_VOCAB, PAIR_CLASSES, 0), the label at the last position
PAIR_STEPS, PAIR_BS, PAIR_N, PAIR_VOCAB, PAIR_CLASSES = 60, 64, 2048, 256, 8
# (b) granite-moe-1b-a400m at full width and depth through
# launch.distributed.make_train_step (remat), B x S SyntheticLM tokens
GRANITE_ARCH, GRANITE_B, GRANITE_S, GRANITE_STEPS = (
    "granite-moe-1b-a400m", 4, 2048, 4)
# (c) RecurrentGemma-9B at full width over one super-block (its full depth
# with AdamW would need ~137 GB)
RGT_LAYERS, RGT_B, RGT_S, RGT_STEPS = 3, 2, 3000, 3
TRAIN_PEAK_GB = 70       # a training path's peak device memory, at most
# the first step's CE of random weights: ln V + var(logit) / 2, a logit
# being a unit-RMS hidden state (the final norm) against a head row of
# d weights drawn from N(0, 1) cut at +-2 (variance TRUNC_VAR) times the
# init scale; held within FIRST_CE_ATOL
TRUNC_VAR = 0.7737413
FIRST_CE_ATOL = 0.25
# the card against the CPU at full width, cut depth, B x S tokens
TRAIN_CHECK_LAYERS = {GRANITE_ARCH: 2, RG_ARCH: 3}
TRAIN_CHECK_B, TRAIN_CHECK_S = 1, 256
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4    # a leaf's max |card - cpu| over its max |cpu|
TRAIN_GNORM_RTOL = 1e-4
# the backward kernels against their plain versions: max |err| over max
# |ref| (f32 sums in another order; bf16 outputs rounded once each), and
# the forward's row log-sum-exp
FLASH_BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-4

# phase 12, soft-capped attention: gemma-7b's widths (16 heads of 256, G =
# 1) with Gemma 2's attn_logit_softcapping, served at CAP_LAYERS layers
# (ZOO_B prompts of ZOO_S positions, CAP_STEPS decode steps) and trained
# at CAP_TRAIN_LAYERS (CAP_TRAIN_STEPS steps of CAP_TRAIN_B x
# CAP_TRAIN_S SyntheticLM tokens, remat); the card against the CPU at
# CAP_CHECK_LAYERS layers (serving: ZOO_CHECK_B x ZOO_CHECK_S and
# ZOO_CHECK_STEPS steps; training: TRAIN_CHECK_B x TRAIN_CHECK_S tokens)
CAP_ARCH, CAP = "gemma-7b", 50.0
CAP_LAYERS, CAP_STEPS = 4, 8
CAP_TRAIN_LAYERS, CAP_TRAIN_B, CAP_TRAIN_S, CAP_TRAIN_STEPS = 2, 2, 2048, 3
CAP_CHECK_LAYERS = 2
# phase 3's capped cases draw q and k at CAP_QK times a unit normal, so
# that the scores reach the cap's curved part
CAP_QK = 3.0


# every kernel's launch count at zero: what a path's expected counts start
# from
NO_LAUNCHES = dict.fromkeys(ops.launch_counts(), 0)


# phase 13, the step factories over a (data, model) mesh: MESH_RANKS gloo
# ranks on the one card (NCCL refuses two ranks on one GPU), each a
# process of its own. (a) granite-moe-1b-a400m at full width and depth on
# a MESH_SHAPE mesh (8 experts a rank, the head's rows cut in 4): a
# prefill of MESH_B x MESH_S tokens into rings of MESH_S + MESH_STEPS
# slots, MESH_STEPS serve steps feeding back top-1, MESH_TRAIN_STEPS train
# steps (remat) of MESH_TRAIN_B x MESH_S SyntheticLM tokens; the
# gradients at MESH_GRAD_LAYERS layers on TRAIN_CHECK_B x TRAIN_CHECK_S
# tokens. (b) the same model on a (2, 2) mesh, the prefill and
# MESH22_STEPS serve steps, the gradients at MESH_GRAD_LAYERS layers on 2 x
# TRAIN_CHECK_S tokens (a row a data rank); then trained at full width and
# depth, MESH_TRAIN_STEPS steps (remat, MESH_TRAIN_B x MESH_S) stored FSDP
# (each matrix's other dim over the two data ranks) and one step of the
# same first batch on the resident weights: each rank's stored bytes
# (parameters and AdamW's moments), its peak, the all_reduces of a step.
# (c) seamless-m4t-medium trained at full width and depth, SEAMT_STEPS
# steps of SEAMT_B x SEAMT_FRAMES audio frames and SEAMT_S-token prompts;
# (d) xlstm-350m at full width and depth on an XLM_SHAPE mesh, one mLSTM
# and one sLSTM head a rank: a prefill of XLM_B x XLM_S tokens, XLM_STEPS
# serve steps, XLSTMT_STEPS train steps of XLSTMT_B x XLSTMT_S tokens, held
# to the one-card run; (f) seamless and xLSTM at 2 layers (seamless 2 + 2)
# against the CPU. Every layer is cut over the model ranks. (a)'s rings hold MESH_RING
# slots, which its four model ranks divide, so its decode runs the partial
# and merge entries; (b)'s hold MESH22_RING, which its two do not, so each
# rank holds the whole ring and decodes its own heads through the
# whole-ring entry. (e) RecurrentGemma-9B on an RGM_SHAPE mesh at
# RGM_LAYERS layers (None: full depth): a prefill of RGM_B x RGM_S tokens,
# RGM_STEPS serve steps, its 2,048-slot local rings cut in four. Its depth
# is cut from 38 to 12 layers (8 RG-LRU, 4 local attention): at full depth
# the prefill's all_reduces through the host took 31.0 s of a script that
# outgrew its time limit
MESH_RANKS, MESH_SHAPE, MESH_SEED = 4, (1, 4), 3
MESH_B, MESH_S, MESH_STEPS = 4, 2048, 8
MESH_RING = MESH_S + 16
RGM_SHAPE, RGM_B, RGM_S, RGM_STEPS, RGM_LAYERS = (1, 4), 4, 3000, 8, 12
RGM_PEAK_GB = 76         # (e)'s ranks' peaks together, at most
MESH_TRAIN_B, MESH_TRAIN_STEPS = 2, 3
MESH_GRAD_LAYERS, MESH22_STEPS = 2, 4
MESH22_RING = MESH_S + MESH22_STEPS + 1
MESH_PEAK_GB = 72        # the ranks' peaks together, at most
SEAMT_B, SEAMT_FRAMES, SEAMT_S, SEAMT_STEPS = 2, 1024, 512, 3
XLSTMT_B, XLSTMT_S, XLSTMT_STEPS = 2, 128, 2
XLM_SHAPE, XLM_B, XLM_S, XLM_STEPS = (1, 4), 4, 512, 8


PTXAS_KERNELS = ("flash_tc", "flash_fma", "decode_partial", "decode_merge",
                 "bvsb_chunk", "bvsb_merge", "rglru_ring", "rglru_elem",
                 "flash_bwd_prep", "flash_bwd_fma_dkdv", "flash_bwd_fma_dq",
                 "flash_bwd_tc_dkdv", "flash_bwd_tc_dq", "flash_bwd_sum",
                 "rglru_bwd_ring", "rglru_bwd")


def print_ptxas(log: str):
    """One line per kernel from nvcc's -Xptxas -v report: registers, spill
    stores and loads, static shared memory."""
    for fn, body in re.findall(r"Compiling entry function '(\w+)' for "
                               r"'sm_90a'(.*?)(?=Compiling entry|\Z)", log,
                               re.S):
        name = re.search(rf"((?:{'|'.join(PTXAS_KERNELS)})_kernel)"
                         r"(?:I(\w+?)EEv)?", fn)
        if not name:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        print(f"ptxas {name.group(1)} <{name.group(2) or ''}>: "
              f"{regs.group(1) if regs else '?'} registers, spill stores/loads "
              f"{spill.group(1) if spill else '?'}/"
              f"{spill.group(2) if spill else '?'} bytes, static smem "
              f"{smem.group(1) if smem else 0} bytes")


def max_err(a, b) -> float:
    a, b = a.float(), b.float().to(a.device)
    both_nan = torch.isnan(a) & torch.isnan(b)
    if (torch.isnan(a) != torch.isnan(b)).any():
        return float("inf")
    return float((a - b).abs()[~both_nan].max()) if (~both_nan).any() else 0.0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def bvsb_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for b, v in ((1, 2048), (64, 2048), (20, 1000), (3, 130)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, v, generator=gen, device=dev) * 4
            cases.append((f"randn({b},{v})", x.to(dt)))
    # what the classify path hands the kernel at every ladder bucket: the
    # last position of (B, S, V) logits, a view with row stride S * V
    for b in BATCH_LADDER:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, SEQ, VOCAB, generator=gen, device=dev) * 4
            cases.append((f"randn({b},{SEQ},{VOCAB})[:,-1,:]",
                          x.to(dt)[:, -1, :]))
    # what the RecurrentGemma path hands the kernel: contiguous rows over
    # its vocab of 256,000, at the path's B = 4 and at 64, several chunks a
    # row; and the same rows starting 4 (2) bytes off 16-byte alignment
    for b in (RG_B, 64):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, 256_000, generator=gen, device=dev) * 4
            cases.append((f"randn({b},256000)", x.to(dt)))
            x = torch.randn(b, 256_001, generator=gen, device=dev) * 4
            cases.append((f"randn({b},256001)[:,1:]", x.to(dt)[:, 1:]))
        # edges across chunks: tied maxima in the first and the last chunk,
        # the second chunk all -inf, +inf in the last chunk
        _, per = _bvsb.chunks(b, 256_000, _build.sm_count(dev))
        x = torch.randn(b, 256_000, generator=gen, device=dev) * 4
        x[0, [7, 255_993]] = 30.0
        x[1, per:2 * per] = float("-inf")
        x[2, 255_990] = float("inf")
        cases.append((f"ties/-inf chunk/+inf last chunk({b},256000)", x))
    # what the zoo path hands the kernel: head_bvsb's (B, padded vocab) f32
    # logits, the columns past the vocab set to PAD_LOGIT
    for arch in [a for a, _, _ in ZOO_MODELS] + [XLSTM_ARCH, SEAM_ARCH]:
        v = get_config(arch).vocab_size
        pv = common.padded_vocab(v)
        x = torch.randn(ZOO_B, pv, generator=gen, device=dev) * 4
        x[:, v:] = PAD_LOGIT
        pad = f", PAD_LOGIT past {v}" if pv > v else ""
        cases.append((f"{arch} randn({ZOO_B},{pv}){pad}", x))
    x = torch.full((5, 2048), -1.0, device=dev)
    x[0, [7, 1999]] = 3.0            # tied maxima in different warps
    x[1, [0, 1]] = 2.5               # tied maxima in neighbouring threads
    x[2] = -1e38
    x[2, 5] = 1e4
    x[3, :10] = float("-inf")
    x[3, 11] = 2.0
    x[4, 1000:] = torch.finfo(torch.float32).min
    cases.append(("ties/-inf/-1e38/padding(5,2048)", x))
    inf = torch.zeros(2, 64, device=dev)
    inf[0, 3] = float("inf")
    inf[1, [5, 9]] = float("inf")
    cases.append(("+inf(2,64)", inf))
    return cases


def bits(t):
    """A float tensor's bit patterns (NaN equal to itself)."""
    return t.contiguous().view(torch.int32)


def check_bvsb(dev):
    for name, x in bvsb_cases(dev):
        conf, top1 = ops.bvsb(x)
        torch.cuda.synchronize()
        pconf, ptop1 = bvsb_plain(x)
        err, atol = max_err(conf, pconf), BVSB_ATOL[x.dtype]
        finite = ~torch.isnan(pconf)
        top1_ok = torch.equal(top1[finite], ptop1[finite])
        nan_ok = torch.equal(torch.isnan(conf), torch.isnan(pconf))
        conf2, top2 = ops.bvsb(x)
        same = torch.equal(bits(conf), bits(conf2)) and torch.equal(top1, top2)
        print(f"bvsb {name} {str(x.dtype)[6:]}: max|err| {err:.3g} "
              f"(atol {atol:g}), top-1 {'equal' if top1_ok else 'DIFFERS'}, "
              f"NaN rows {int((~finite).sum())}, second call "
              f"{'bitwise equal' if same else 'DIFFERS'}")
        if not (err <= atol and top1_ok and nan_ok and same):
            raise AssertionError(f"bvsb kernel disagrees with its plain "
                                 f"version on {name} {x.dtype}")
        if name.startswith("+inf") and not torch.isnan(conf).all():
            raise AssertionError("bvsb: +inf logits must give NaN")
        if name.startswith("ties/-inf chunk") and not (
                float(conf[0]) == 0.0 and int(top1[0]) == 7
                and bool(torch.isnan(conf[2]))):
            raise AssertionError(f"bvsb {name}: a tie across chunks must give "
                                 "margin 0 at the first index, +inf NaN")


def partials_cases(dev):
    """(name, logits, first column) as the mesh paths hand the partial entry
    its shard: granite's head (PV 49,280) cut in 4 at phase 13's B = 4
    and at 64, each shard at its offset, the last holding padded columns;
    a row cut into several chunks with whole chunks at -inf; bf16; a short
    row; seamless's head (256,256) cut in 2."""
    gen = torch.Generator(device=dev).manual_seed(13)
    cfg = get_config(GRANITE_ARCH)
    pv = common.padded_vocab(cfg.vocab_size)
    cases = []
    for b in (MESH_B, 64):
        full = torch.randn(b, pv, generator=gen, device=dev) * 4
        full[:, cfg.vocab_size:] = PAD_LOGIT
        m = MESH_SHAPE[1]
        for j in range(m):
            lo, hi = j * pv // m, (j + 1) * pv // m
            cases.append((f"granite shard {j} ({b},{hi - lo})",
                          full[:, lo:hi].contiguous(), lo))
    x = torch.randn(4, 65536, generator=gen, device=dev) * 4
    x[1, :32768] = float("-inf")
    x[2, [9, 60000]] = 30.0
    cases.append(("(4,65536) -inf chunks, ties", x, 1000))
    cases.append(("(4,65536) bf16", x.to(torch.bfloat16), 0))
    cases.append(("(3,130)", torch.randn(3, 130, generator=gen,
                                         device=dev) * 4, 7))
    v = common.padded_vocab(get_config(SEAM_ARCH).vocab_size)
    x = torch.randn(MESH_B, v, generator=gen, device=dev) * 4
    cases.append((f"seamless shard 1 ({MESH_B},{v // 2})",
                  x[:, v // 2:].contiguous(), v // 2))
    return cases


def check_bvsb_partials(dev):
    """The partial entry against its plain version (m1, m2, index exact, z
    to 1e-5 relative), twice bitwise; then the merge entry over each
    granite row's four shards against ``bvsb_plain`` of the whole row
    (BVSB_ATOL, top-1 equal), twice bitwise, and a maximum tied across two
    shards giving margin 0 at the first index."""
    shards = {}
    for name, x, offset in partials_cases(dev):
        t = ops.bvsb_partials(x, offset)
        torch.cuda.synchronize()
        ref = bvsb_partials_plain(x, offset)
        exact = torch.equal(t[:, [0, 1, 3]], ref[:, [0, 1, 3]])
        z_err = float(((t[:, 2] - ref[:, 2]).abs()
                       / ref[:, 2].abs().clamp(min=1e-30)).max())
        same = torch.equal(bits(t), bits(ops.bvsb_partials(x, offset)))
        print(f"bvsb partials {name} {str(x.dtype)[6:]} at column {offset}: "
              f"m1, m2, index {'equal' if exact else 'DIFFER'}, z max rel "
              f"{z_err:.3g}, second call "
              f"{'bitwise equal' if same else 'DIFFERS'}")
        if not (exact and z_err <= 1e-5 and same):
            raise AssertionError(f"bvsb partials disagree on {name}")
        if name.startswith("granite"):
            shards.setdefault(x.shape[0], []).append((x, t))
    for b, parts in shards.items():
        full = torch.cat([x for x, _ in parts], dim=1)
        tuples = torch.stack([t for _, t in parts], dim=1)
        conf, top1 = ops.bvsb_merge(tuples)
        pconf, ptop1 = bvsb_plain(full)
        c2, t2 = ops.bvsb_merge(tuples)
        err = max_err(conf, pconf)
        ok = err <= BVSB_ATOL[torch.float32] and torch.equal(top1, ptop1) \
            and torch.equal(bits(conf), bits(c2)) and torch.equal(top1, t2)
        print(f"bvsb merge of granite's 4 shards (B={b}): max|err| "
              f"{err:.3g} against bvsb_plain of the whole row, top-1 "
              f"{'equal' if torch.equal(top1, ptop1) else 'DIFFERS'}, second "
              f"call {'bitwise equal' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError("bvsb merge disagrees with bvsb_plain")
    x = torch.randn(2, 1024, device=dev)
    x[0, [100, 900]] = 20.0
    tuples = torch.stack([ops.bvsb_partials(x[:, j * 256:(j + 1) * 256]
                                            .contiguous(), j * 256)
                          for j in range(4)], dim=1)
    conf, top1 = ops.bvsb_merge(tuples)
    if not (float(conf[0]) == 0.0 and int(top1[0]) == 100):
        raise AssertionError("bvsb merge: a tie across shards must give "
                             "margin 0 at the first index")


FLASH_CASES = [(1, 16, 4, 4, 32, None), (64, 16, 8, 8, 48, None),
               (64, 16, 8, 8, 64, None), (2, 200, 8, 2, 128, None),
               (2, 200, 8, 2, 128, 64),
               # RecurrentGemma's prefill attention at B = 1: hd 256, one
               # KV head for 16, S = 3000 past the window of 2048
               (1, RG_S, 16, 1, 256, 2048),
               # both sides of the tensor-core threshold (S 48 at hd <=
               # 128, 80 above) at hd 64, 128 and 256: GQA 16:1 and 4:1,
               # windows under one 32-key tile (7, 20) and off its
               # multiples (100, 2000), S off the 32-key tile and (with 4
               # heads a group) off the 128-row tile
               (2, 40, 8, 2, 64, 20), (2, 48, 8, 2, 64, 20),
               (2, 1000, 8, 2, 64, 100), (1, 1000, 16, 1, 64, 7),
               (1, 47, 16, 1, 128, None), (1, 1000, 16, 1, 128, 20),
               (2, RG_S, 8, 2, 128, 2000), (2, 79, 16, 1, 256, 20),
               (2, 80, 16, 1, 256, 20), (1, 1000, 8, 2, 256, 100),
               (1, 999, 16, 1, 256, None),
               # the zoo's prefill attention (phase 9): granite, deepseek,
               # stablelm (hd 160, padded in the hd-256 tile), qwen2-vl
               (ZOO_B, ZOO_S, 16, 8, 64, None), (ZOO_B, ZOO_S, 16, 16, 128,
                                                 None),
               (ZOO_B, ZOO_S, 32, 8, 160, None), (ZOO_B, ZOO_S, 28, 4, 128,
                                                  None),
               (2, 333, 32, 8, 160, None), (2, 79, 32, 8, 160, None)]


def serving_flash_cases():
    """Every attention shape the main path can give the kernel: tier-low
    at the clients' B = 1, each server tier at every ladder bucket."""
    cases = []
    for tier, buckets in (("tier-low", (1,)),
                          ("tier-server-fast", BATCH_LADDER),
                          ("tier-server-heavy", BATCH_LADDER)):
        cfg = get_config(tier)
        cases += [(b, SEQ, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim, None) for b in buckets]
    return cases


def qkv(dev, b, s, h, kv, hd, dtype=torch.float32, seed=0, t=None,
        qk_scale=1.0):
    """q (B, S, H, hd) and k/v (B, T, KV, hd), T = S by default; q and k
    drawn at ``qk_scale`` times a unit normal."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple((torch.randn(b, n_pos, n, hd, generator=gen, device=dev)
                  * scale).to(dtype)
                 for n_pos, n, scale in ((s, h, qk_scale), (t or s, kv,
                                                            qk_scale),
                                         (t or s, kv, 1.0)))


def flash_kernel(q, k, v, window, kernel, causal=True):
    """One flash kernel forced (1: CUDA-core FMAs, 2: tensor cores) through
    the library's measuring entry point; not counted as a launch."""
    return _flash.run_entry(_build.library().repro_flash_attention_kernel, q,
                            k, v, causal=causal, window=window,
                            extra=(kernel,))


def strided_qkv(dev, b, s, h, kv, hd, dt, offset):
    """q, k, v as views into one packed (B, S, 3, H, hd + 1) tensor: (B, S,
    H) strides that are not the contiguous ones; ``offset`` 1 also moves
    every row start off 16 bytes, which the tensor-core kernel loads
    without cp.async."""
    gen = torch.Generator(device=dev).manual_seed(s + hd)
    packed = torch.randn(b, s, 3, h, hd + 1, generator=gen,
                         device=dev).to(dt)
    q, k, v = (packed[:, :, i, :, offset:offset + hd] for i in range(3))
    return q, k[:, :, :kv], v[:, :, :kv]


def _check_flash_out(name, out, ref, dt):
    err, atol = max_err(out, ref), FLASH_ATOL[dt]
    print(f"flash_attention {name} {str(dt)[6:]}: max|err| {err:.3g} "
          f"(atol {atol:g})")
    if not (err <= atol and out.dtype == dt):
        raise AssertionError("flash_attention kernel disagrees with its "
                             f"plain version at {name} {dt}")


def check_flash(dev):
    for b, s, h, kv, hd, window in FLASH_CASES + serving_flash_cases():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(dev, b, s, h, kv, hd, dt)
            out = ops.flash_attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            ref = flash_attention_plain(q, k, v, causal=True, window=window)
            _check_flash_out(f"(B,S,H,KV,hd)=({b},{s},{h},{kv},{hd}) "
                             f"window={window}", out, ref, dt)
    # strided (B, S, H) views on both sides of the threshold, aligned and
    # not; non-causal on both kernels
    for s in (40, 1000):
        for offset in (0, 1):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = strided_qkv(dev, 2, s, 8, 2, 64, dt, offset)
                out = ops.flash_attention(q, k, v, window=100)
                torch.cuda.synchronize()
                _check_flash_out(
                    f"strided (2,{s},8,2,64) offset={offset} window=100", out,
                    flash_attention_plain(q, k, v, window=100), dt)
    for s in (24, 300):
        q, k, v = qkv(dev, 2, s, 8, 2, 64)
        _check_flash_out(f"non-causal (2,{s},8,2,64)",
                         ops.flash_attention(q, k, v, causal=False),
                         flash_attention_plain(q, k, v, causal=False),
                         torch.float32)
    # both kernels at the same shapes around the threshold
    for b, s, h, kv, hd, window in ((64, 16, 8, 8, 64, None),
                                    (2, 63, 16, 1, 256, 20),
                                    (2, 47, 8, 2, 128, None),
                                    (1, 200, 16, 1, 256, 7)):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(dev, b, s, h, kv, hd, dt)
            ref = flash_attention_plain(q, k, v, window=window)
            for kernel in (1, 2):
                out = flash_kernel(q, k, v, window, kernel)
                torch.cuda.synchronize()
                _check_flash_out(f"kernel {kernel} (B,S,H,KV,hd)=({b},{s},"
                                 f"{h},{kv},{hd}) window={window}", out, ref,
                                 dt)
    check_flash_cross(dev)


def _check_flash_twice(name, fn, ref, dt):
    """``fn()`` against the plain version's ``ref``, and a second call
    bitwise equal to the first."""
    out = fn()
    torch.cuda.synchronize()
    same = torch.equal(fn(), out)
    err, atol = max_err(out, ref), FLASH_ATOL[dt]
    print(f"flash_attention {name} {str(dt)[6:]}: max|err| {err:.3g} (atol "
          f"{atol:g}), second call {'bitwise equal' if same else 'DIFFERS'}")
    if not (err <= atol and out.dtype == dt and same):
        raise AssertionError("flash_attention kernel disagrees with its "
                             f"plain version or itself at {name} {dt}")


def check_flash_cross(dev):
    """Seamless's attention (phase 10): its cross-attention, S = 512 text
    positions over T = 1,024 frames, non-causal, and its encoder (T = S =
    1,024, non-causal) and decoder (S = 512, causal) self-attention, on
    the kernel the shape picks; edges S 77 over T 300 and S 300 over T 77
    with each kernel forced; a strided q over T != S keys; each held to
    the plain version and repeated bitwise. Causal attention over T != S
    keys must raise."""
    cfg = get_config(SEAM_ARCH)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for dt in (torch.float32, torch.bfloat16):
        for s, t, causal in ((SEAM_S, SEAM_FRAMES, False),
                             (SEAM_FRAMES, SEAM_FRAMES, False),
                             (SEAM_S, SEAM_S, True)):
            q, k, v = qkv(dev, SEAM_B, s, h, kv, hd, dt, t=t)
            _check_flash_twice(
                f"(B,S,T,H,KV,hd)=({SEAM_B},{s},{t},{h},{kv},{hd}) "
                f"causal={causal}",
                lambda: ops.flash_attention(q, k, v, causal=causal),
                flash_attention_plain(q, k, v, causal=causal), dt)
        for s, t in ((77, 300), (300, 77)):
            q, k, v = qkv(dev, 2, s, 8, 2, 64, dt, t=t)
            ref = flash_attention_plain(q, k, v, causal=False)
            for kernel in (1, 2):
                _check_flash_twice(
                    f"kernel {kernel} (B,S,T,H,KV,hd)=(2,{s},{t},8,2,64) "
                    "causal=False",
                    lambda: flash_kernel(q, k, v, None, kernel, causal=False),
                    ref, dt)
        gen = torch.Generator(device=dev).manual_seed(1)
        packed = torch.randn(SEAM_B, SEAM_S, 2, h, hd, generator=gen,
                             device=dev).to(dt)
        q = packed[:, :, 1]
        _, k, v = qkv(dev, SEAM_B, 1, h, kv, hd, dt, t=SEAM_FRAMES)
        _check_flash_twice(
            f"strided q (B,S,2,H,hd)[:, :, 1] over T={SEAM_FRAMES} "
            "causal=False", lambda: ops.flash_attention(q, k, v, causal=False),
            flash_attention_plain(q, k, v, causal=False), dt)
    try:
        ops.flash_attention(q, k, v, causal=True)
    except ValueError:
        print("flash_attention refuses causal attention over T != S keys")
    else:
        raise AssertionError("flash_attention took causal=True with T != S")


def cap_cfg(layers=None):
    """gemma-7b with Gemma 2's attention soft cap, cut to ``layers``."""
    cfg = get_config(CAP_ARCH).with_(logit_soft_cap=CAP)
    return cfg if layers is None else cfg.with_(num_layers=layers)


# (name, B, S, T or None, H, KV, hd, causal, window): phase 12's prefill
# and training shapes, gemma's heads around the tensor-core thresholds,
# RG-like GQA with a window, non-causal T = S and T != S
CAP_FLASH_CASES = [
    (f"{CAP_ARCH} prefill", ZOO_B, ZOO_S, None, 16, 16, 256, True, None),
    (f"{CAP_ARCH} training", CAP_TRAIN_B, CAP_TRAIN_S, None, 16, 16, 256,
     True, None),
    ("gemma heads S=300", 2, 300, None, 16, 16, 256, True, None),
    ("gemma heads S=63", 2, 63, None, 16, 16, 256, True, None),
    ("RG-like window", 1, 200, None, 16, 1, 256, True, 7),
    ("GQA hd 128", 2, 47, None, 8, 2, 128, True, None),
    ("tiers S=16", 64, 16, None, 8, 8, 64, True, None),
    ("non-causal", 2, 80, None, 8, 2, 64, False, None),
    ("cross 77 over 300", 2, 77, 300, 8, 2, 64, False, None),
    ("cross 300 over 77", 2, 300, 77, 16, 16, 64, False, None)]


def check_flash_capped(dev):
    """Soft-capped flash forward (cap CAP) against its plain version with
    the cap: each case on the kernel the shape picks (counted) and, but
    the two largest, with each kernel forced, f32 and bf16, each repeated
    bitwise; the forward's lse against ``attention_lse_plain``; and the
    cap moving the plain output by more than the gate."""
    lib = _build.library()
    for name, b, s, t, h, kv, hd, causal, window in CAP_FLASH_CASES:
        big = s >= 2048
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(dev, b, s, h, kv, hd, dt, seed=s, t=t,
                          qk_scale=CAP_QK)
            ref = flash_attention_plain(q, k, v, causal=causal, window=window,
                                        soft_cap=CAP)
            free = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            moved = max_err(ref, free)
            if not moved > FLASH_ATOL[dt]:
                raise AssertionError(f"capped flash {name}: the cap moves "
                                     f"the output by {moved:.3g} only")
            shape = (b, s, h, kv, hd) if t is None else (b, s, t, h, kv, hd)
            ops.reset_launch_counts()
            out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      soft_cap=CAP)
            if ops.launch_counts()["flash_attention"] != 1:
                raise AssertionError("capped flash: not one launch")
            _check_flash_twice(
                f"soft_cap={CAP:g} {name} {shape} causal={causal} "
                f"window={window}", lambda: ops.flash_attention(
                    q, k, v, causal=causal, window=window, soft_cap=CAP),
                ref, dt)
            for kernel in () if big else (1, 2):
                _check_flash_twice(
                    f"soft_cap={CAP:g} kernel {kernel} {name} {shape}",
                    lambda: _flash.run_entry(
                        lib.repro_flash_attention_kernel, q, k, v,
                        causal=causal, window=window, soft_cap=CAP,
                        extra=(kernel,)), ref, dt)
            _, lse = _flash.run_entry(lib.repro_flash_attention, q, k, v,
                                      causal=causal, window=window,
                                      soft_cap=CAP, with_lse=True)
            err = max_err(lse, attention_lse_plain(
                q, k, causal=causal, window=window, soft_cap=CAP))
            print(f"flash_attention soft_cap={CAP:g} {name} {str(dt)[6:]}: "
                  f"lse max|err| {err:.3g} (atol {LSE_ATOL:g}); the cap "
                  f"moves the plain output by {moved:.3g}")
            if not err <= LSE_ATOL:
                raise AssertionError(f"capped flash lse disagrees at {name}")
            del q, k, v, ref, free, out, lse
            torch.cuda.empty_cache()


def check_flash_bwd_capped(dev):
    """The capped backward under autograd (FlashAttentionFn with the cap:
    one forward and two backward launches) at each capped case, f32 and
    bf16, and, but the two largest, each backward form forced: dq / dk /
    dv against ``flash_attention_bwd_plain`` with the cap on the same (q,
    k, v, o, lse, dO), a second backward bitwise equal."""
    for name, b, s, t, h, kv, hd, causal, window in CAP_FLASH_CASES:
        if name == f"{CAP_ARCH} prefill":
            continue          # the training shape stands for it
        big = s >= 2048
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_bwd_inputs(dev, b, s, t, h, kv, hd, dt,
                                           seed=s + 1, qk_scale=CAP_QK)
            for x in (q, k, v):
                x.requires_grad_()
            ops.reset_launch_counts()
            out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      soft_cap=CAP)
            runs = {"autograd": lambda: torch.autograd.grad(
                out, (q, k, v), do, retain_graph=True)}
            with torch.no_grad():
                _, lse = _flash.run_entry(
                    _build.library().repro_flash_attention, q, k, v,
                    causal=causal, window=window, soft_cap=CAP, with_lse=True)
                for kernel in () if big else (1, 2):
                    runs[f"kernel {kernel}"] = functools.partial(
                        _flash.run_bwd_entry, q, k, v, out, lse, do,
                        causal=causal, window=window, soft_cap=CAP,
                        kernel=kernel)
                ref = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                causal=causal, window=window,
                                                soft_cap=CAP)
            for form, run in runs.items():
                grads = run()
                again = run()
                torch.cuda.synchronize()
                errs = [_rel(g, r) for g, r in zip(grads, ref)]
                same = all(torch.equal(a, g) for a, g in zip(again, grads))
                print(f"flash_attention_bwd soft_cap={CAP:g} {name} {form} "
                      f"{str(dt)[6:]}: max|err|/max|ref| dq {errs[0]:.3g} dk "
                      f"{errs[1]:.3g} dv {errs[2]:.3g} (tol "
                      f"{FLASH_BWD_RTOL[dt]:g}), second backward "
                      f"{'bitwise equal' if same else 'DIFFERS'}")
                if not (max(errs) <= FLASH_BWD_RTOL[dt] and same):
                    raise AssertionError(f"capped flash backward disagrees "
                                         f"at {name} {form} {dt}")
            counts = ops.launch_counts()
            if not (counts["flash_attention"] == 1
                    and counts["flash_attention_bwd"] == 2):
                raise AssertionError(f"capped flash under autograd launched "
                                     f"{counts}")
            del q, k, v, do, out, lse, ref, grads, again
            torch.cuda.empty_cache()


def check_decode_capped(dev):
    """Capped decode (cap CAP) against its plain version with the cap in
    the three dtype pairs: phase 12's shape (gemma's 16 KV heads of 256
    over rings of ZOO_S + CAP_STEPS slots) and edges; a second call and a
    call with NaN past the lengths bitwise equal to the first."""
    w = ZOO_S + CAP_STEPS
    cases = [(ZOO_B, w, 16, 1, 256, [ZOO_S + 1] * ZOO_B),
             (ZOO_B, w, 16, 1, 256, [1, 777, w, ZOO_S + 5]),
             (4, 2048, 1, 16, 256, [2048] * 4),
             (3, 100, 2, 4, 64, [1, 100, 37]),
             (3, 100, 2, 4, 48, [1, 100, 37])]
    for b, w, kv, g, hd, lengths in cases:
        for dt, cdt in DECODE_DTYPES:
            q, k, v, lens = decode_inputs(dev, b, w, kv, g, hd, lengths, dt,
                                          cdt)
            q, k = (q.float() * CAP_QK).to(dt), (k.float() * CAP_QK).to(cdt)
            out = ops.decode_attention(q, k, v, lens, soft_cap=CAP)
            torch.cuda.synchronize()
            ref = decode_attention_plain(q, k, v, lens, soft_cap=CAP)
            moved = max_err(ref, decode_attention_plain(q, k, v, lens))
            err, atol = max_err(out, ref), DECODE_ATOL[dt]
            again = ops.decode_attention(q, k, v, lens, soft_cap=CAP)
            past = torch.arange(w, device=dev)[None, :] >= lens[:, None]
            k[past], v[past] = float("nan"), float("nan")
            poisoned = ops.decode_attention(q, k, v, lens, soft_cap=CAP)
            same = torch.equal(again, out) and torch.equal(poisoned, out)
            print(f"decode_attention soft_cap={CAP:g} (B,W,KV,G,hd)=({b},"
                  f"{w},{kv},{g},{hd}) lengths {sorted(set(lengths))} "
                  f"{dtype_name(dt, cdt)}: max|err| {err:.3g} (atol "
                  f"{atol:g}), the cap moves the plain output by "
                  f"{moved:.3g}; again and with NaN past the length: "
                  f"{'bitwise equal' if same else 'DIFFER'}")
            if not (err <= atol and same and moved > atol):
                raise AssertionError(f"capped decode disagrees at "
                                     f"{(b, w, kv, g, hd)} "
                                     f"{dtype_name(dt, cdt)}")


def check_capped(dev):
    """Phase 3's soft-cap part."""
    check_flash_capped(dev)
    check_flash_bwd_capped(dev)
    check_decode_capped(dev)


def decode_cases():
    """(B, W, KV, G, hd, lengths): RecurrentGemma's decode shape at B in
    {1, 4, 64} with lengths 1, 777, W and mixed; lengths on both sides of
    the 16-key tiles and of the splits; two KV heads (a split's K rows
    not contiguous) and groups of 8 and 4 at hd 256; small GQA rings; the
    zoo's rings, stablelm-12b's at (4, 2048, 32, 8, 160) too."""
    cases = []
    for b in (1, RG_B, 64):
        for lengths in ([1] * b, [777] * b, [2048] * b,
                        [(1, 777, 2048, 1500)[i % 4] for i in range(b)]):
            cases.append((b, 2048, 1, 16, 256, lengths))
    edges = [1, 63, 65, 2047, 2048]
    cases += [(5, 2048, 1, 16, 256, edges), (5, 2048, 2, 16, 256, edges),
              (5, 2048, 1, 8, 256, edges), (5, 2048, 2, 4, 256, edges)]
    # a small GQA ring; hd 48 (under the tile row of 64) takes plain loads
    cases += [(3, 100, 2, 4, 64, [1, 100, 37]),
              (3, 100, 2, 4, 128, [100, 1, 63]),
              (3, 100, 2, 4, 48, [1, 100, 37])]
    # the zoo's decode (phase 9): rings of ZOO_S + 16 slots; stablelm's hd
    # 160 takes the hd-256 tile with plain loads; groups of 2, 1, 4 and 7
    cases.append((ZOO_B, ZOO_S, 8, 4, 160, [ZOO_S] * ZOO_B))
    w = ZOO_S + 16
    for kv, g, hd in ((8, 2, 64), (16, 1, 128), (8, 4, 160), (4, 7, 128)):
        cases += [(ZOO_B, w, kv, g, hd, [ZOO_S + 1] * ZOO_B),
                  (ZOO_B, w, kv, g, hd, [1, 777, w, ZOO_S + 9])]
    # seamless's decode (phase 10): the cross-attention, one query over
    # the T = 1,024 cached frames, every length T; the self ring of 520
    cases += [(SEAM_B, SEAM_FRAMES, 16, 1, 64, [SEAM_FRAMES] * SEAM_B),
              (SEAM_B, SEAM_CACHE, 16, 1, 64, [SEAM_S + 1] * SEAM_B)]
    return cases


# (query dtype, cache dtype) of decode attention: f32, bf16, and an f32
# model over a bf16 cache (the JAX package's default cache), which
# computes in f32 and is held to the f32 tolerance
DECODE_DTYPES = ((torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.bfloat16))


def dtype_name(qd, cd=None):
    names = {torch.float32: "f32", torch.bfloat16: "bf16"}
    cd = qd if cd is None else cd
    return names[qd] if cd == qd else f"{names[qd]} q over {names[cd]} cache"


def decode_inputs(dev, b, w, kv, g, hd, lengths, dtype=torch.float32,
                  cache_dtype=None):
    gen = torch.Generator(device=dev).manual_seed(b * w + hd)
    q = torch.randn(b, kv * g, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, w, kv, hd, generator=gen, device=dev)
            .to(cache_dtype or dtype) for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def check_decode(dev):
    """Each case against the plain version; then a second call, and a call
    with NaN in every slot at or past the length (slots the kernel must
    never read), each bitwise equal to the first."""
    for b, w, kv, g, hd, lengths in decode_cases():
        for dt, cdt in DECODE_DTYPES:
            q, k, v, lens = decode_inputs(dev, b, w, kv, g, hd, lengths, dt,
                                          cdt)
            out = ops.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = decode_attention_plain(q, k, v, lens)
            err, atol = max_err(out, ref), DECODE_ATOL[dt]
            again = ops.decode_attention(q, k, v, lens)
            past = torch.arange(w, device=dev)[None, :] >= lens[:, None]
            k[past], v[past] = float("nan"), float("nan")
            poisoned = ops.decode_attention(q, k, v, lens)
            same = torch.equal(again, out) and torch.equal(poisoned, out)
            print(f"decode_attention (B,W,KV,G,hd)=({b},{w},{kv},{g},{hd}) "
                  f"lengths {sorted(set(lengths))} {dtype_name(dt, cdt)}: "
                  f"max|err| {err:.3g} (atol {atol:g}); again and with NaN "
                  f"past the length: {'bitwise equal' if same else 'DIFFER'}")
            if not (err <= atol and out.dtype == dt and same):
                raise AssertionError("decode_attention kernel disagrees with "
                                     f"its plain version at {(b, w, kv, g, hd)}"
                                     f" lengths {sorted(set(lengths))} "
                                     f"{dtype_name(dt, cdt)}")
    q, k, v, lens = decode_inputs(dev, 2, 64, 1, 16, 64, [64, 5])
    for qd, cd in ((torch.bfloat16, torch.float32),
                   (torch.float16, torch.float16)):
        try:
            ops.decode_attention(q.to(qd), k.to(cd), v.to(cd), lens)
        except TypeError:
            continue
        raise AssertionError(f"decode_attention took {qd} q over a {cd} "
                             "cache")
    print("decode_attention refuses bf16 q over an f32 cache and f16")


def shard_cases():
    """(B, W, KV, G, hd, m, lengths) of decode over a ring cut on its W
    slots, as phase 13 runs it: RecurrentGemma-9B's 2,048-slot local rings
    over (e)'s four model ranks (full, as after its 3,000-token prompts;
    partly filled, shards empty) and at B = 64; granite's rings of
    MESH_RING slots over (a)'s four model ranks and cut in two; a small
    ring cut eight ways."""
    rg, gr = (RG_B, 2048, 1, 16, 256), (MESH_B, MESH_RING, 8, 2, 64)
    return [rg + (4, [2048] * RG_B), rg + (4, [1, 700, 1500, 2048]),
            (64, 2048, 1, 16, 256, 4, [2048] * 64),
            gr + (4, [MESH_S + 1] * MESH_B),
            gr + (2, [1, 600, MESH_RING, MESH_S + 3]),
            (3, 128, 2, 4, 64, 8, [1, 10, 128])]


def check_decode_shards(dev):
    """Each rank's decode partial entry against its plain version over the
    kernel's splits (m, l and acc within DECODE_ATOL plus 1e-4 relative),
    a second call bitwise equal; the merge entry over the ranks' partials
    summed (the gather) against the plain merge and against the whole
    ring's plain decode (DECODE_ATOL), a second call bitwise equal; three
    dtype pairs, uncapped and at gemma's cap (q and k drawn at CAP_QK)."""
    for b, w, kv, g, hd, m, lengths in shard_cases():
        ws = w // m
        ns = _decode.shard_splits(b, kv, ws, _build.sm_count(dev), m)[0]
        for dt, cdt in DECODE_DTYPES:
            for cap in (None, CAP):
                q, k, v, lens = decode_inputs(dev, b, w, kv, g, hd, lengths,
                                              dt, cdt)
                if cap:
                    q, k = (q.float() * CAP_QK).to(dt), \
                        (k.float() * CAP_QK).to(cdt)
                parts, p_err, same, close = [], 0.0, True, True
                for j in range(m):
                    sk = k[:, j * ws:(j + 1) * ws].contiguous()
                    sv = v[:, j * ws:(j + 1) * ws].contiguous()
                    got = ops.decode_attention_partials(q, sk, sv, lens, j, m,
                                                        cap)
                    same &= torch.equal(got, ops.decode_attention_partials(
                        q, sk, sv, lens, j, m, cap))
                    ref = _decode.decode_attention_partials_plain(
                        q, sk, sv, lens, j, m, cap, ns)
                    diff = (got - ref).abs()
                    p_err = max(p_err, float(diff.max()))
                    close &= bool((diff <= DECODE_ATOL[dt]
                                   + 1e-4 * ref.abs()).all())
                    parts.append(got)
                gathered = torch.stack(parts).sum(0)
                out = ops.decode_attention_merge(gathered, q, kv)
                torch.cuda.synchronize()
                same &= torch.equal(out, ops.decode_attention_merge(
                    gathered, q, kv))
                err = max(max_err(out, _decode.decode_attention_merge_plain(
                    gathered, q, kv)), max_err(out, decode_attention_plain(
                        q, k, v, lens, cap)))
                ok = close and same and err <= DECODE_ATOL[dt] \
                    and out.dtype == dt
                print(f"decode shards (B,W,KV,G,hd)=({b},{w},{kv},{g},{hd}) "
                      f"over {m} ranks, {ns} splits a rank, lengths "
                      f"{sorted(set(lengths))} {dtype_name(dt, cdt)}"
                      f"{' capped' if cap else ''}: partials max|err| "
                      f"{p_err:.3g}, merged max|err| {err:.3g} (atol "
                      f"{DECODE_ATOL[dt]:g}); again: "
                      f"{'bitwise equal' if same else 'DIFFER'}")
                if not ok:
                    raise AssertionError(
                        f"decode partial / merge entries disagree at "
                        f"{(b, w, kv, g, hd)} over {m} ranks "
                        f"{dtype_name(dt, cdt)} cap {cap}")


def rglru_inputs(dev, b, s, d, with_h0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    # a in (0.499, 0.999), the range the RG-LRU's gates give
    a = torch.rand(b, s, d, generator=gen, device=dev) * 0.5 + 0.499
    u = torch.randn(b, s, d, generator=gen, device=dev)
    h0 = torch.randn(b, d, generator=gen, device=dev) if with_h0 else None
    return a, u, h0


def rglru_cases(dev, dt, with_h0):
    """(name, a, u, h0, forced per-element path) in ``dt``: RecurrentGemma's
    shape (a ragged last tile: 3000 steps are no multiple of 32 or 64); S
    under one tile (1, 7); D off a strip (300, 4100; in bf16 off 16 bytes
    too, so per-element); a [:, :, 1:] view (base 4 or 2 bytes off 16, so
    per-element); a view strided in time (x[:, ::2], still on the ring);
    and RG's shape forced onto the per-element path. Views are cut after
    the cast."""
    def inputs(b, s, d, seed, view=lambda x: x):
        a, u, h0 = rglru_inputs(dev, b, s, d, with_h0, seed=seed)
        a, u = view(a.to(dt)), view(u.to(dt))
        return a, u, None if h0 is None else h0[:, :a.shape[2]].contiguous()

    cases = [(f"({b},{s},{d})", *inputs(b, s, d, s + d), False)
             for b, s, d in ((RG_B, RG_S, 4096), (1, 1, 256), (2, 7, 256),
                             (3, 129, 300), (2, RG_S, 4100))]
    cases.append(("(2,300,513)[:, :, 1:]",
                  *inputs(2, 300, 513, 3, lambda x: x[:, :, 1:]), False))
    cases.append(("(2,600,512)[:, ::2]",
                  *inputs(2, 600, 512, 4, lambda x: x[:, ::2]), False))
    cases.append((f"({RG_B},{RG_S},4096) forced per-element",
                  *inputs(RG_B, RG_S, 4096, 5), True))
    return cases


def check_rglru(dev):
    """Each case bit for bit against the plain loop (torch.equal): both
    round each step's product and sum alike."""
    for dt in (torch.float32, torch.bfloat16):
        for with_h0 in (False, True):
            for name, a, u, h0, elem in rglru_cases(dev, dt, with_h0):
                h = _rglru.run_entry(a, u, h0, aligned=False) if elem \
                    else ops.rglru_scan(a, u, h0)
                torch.cuda.synchronize()
                same = torch.equal(h, rglru_scan_plain(a, u, h0))
                path = "per-element" if elem or not _rglru.is_aligned(a, u) \
                    else "ring, plan (steps, stages) " + str(_rglru.tiles(
                        *a.shape, a.element_size(), _build.sm_count(dev)))
                print(f"rglru_scan {name} {str(dt)[6:]} h0={with_h0}: "
                      f"{path}: {'bitwise equal' if same else 'DIFFERS'}")
                if not (same and h.dtype == torch.float32):
                    raise AssertionError(f"rglru_scan kernel differs from its "
                                         f"plain version at {name} {dt} "
                                         f"h0={with_h0}")


def _rel(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return max_err(got, ref) / float(ref.float().abs().max())


def flash_bwd_cases():
    """(name, B, S, T or None, H, KV, hd, causal, window): the training
    paths' attention (the cascade pair at S = 16 on the CUDA-core forward,
    granite-moe-1b-a400m, RecurrentGemma's window), deepseek-moe-16b's (G
    = 1, hd 128) and seamless-m4t-medium's encoder (non-causal T = S) and
    cross-attention (T != S)."""
    def heads(name):
        cfg = get_config(name)
        return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rg = get_config(RG_ARCH)
    return [("tier-server-fast", PAIR_BS, SEQ, None,
             *heads("tier-server-fast"), True, None),
            ("tier-low", PAIR_BS, SEQ, None, *heads("tier-low"), True, None),
            (GRANITE_ARCH, GRANITE_B, GRANITE_S, None, *heads(GRANITE_ARCH),
             True, None),
            (RG_ARCH, RGT_B, RGT_S, None, *heads(RG_ARCH), True,
             rg.local_attn_window),
            ("deepseek-moe-16b", ZOO_B, ZOO_S, None,
             *heads("deepseek-moe-16b"), True, None),
            (f"{SEAM_ARCH} encoder", SEAM_B, SEAM_FRAMES, None,
             *heads(SEAM_ARCH), False, None),
            (f"{SEAM_ARCH} cross", SEAM_B, SEAM_S, SEAM_FRAMES,
             *heads(SEAM_ARCH), False, None)]


def flash_bwd_inputs(dev, b, s, t, h, kv, hd, dt, seed=0, qk_scale=1.0):
    """q, k, v as ``qkv`` makes them and an output gradient dO (B, S, H,
    hd), in ``dt``."""
    q, k, v = qkv(dev, b, s, h, kv, hd, dt, seed=seed, t=t,
                  qk_scale=qk_scale)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return q, k, v, torch.randn(b, s, h, hd, generator=gen,
                                device=dev).to(dt)


def check_flash_bwd(dev):
    """Flash attention under autograd at each case, f32 and bf16: one
    forward (FlashAttentionFn) and two backward launches, the forward's
    lse against the plain log-sum-exp, dq / dk / dv against
    ``flash_attention_bwd_plain`` on the same (q, k, v, o, lse, dO), the
    second backward bitwise equal to the first."""
    for name, b, s, t, h, kv, hd, causal, window in flash_bwd_cases():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_bwd_inputs(dev, b, s, t, h, kv, hd, dt)
            for x in (q, k, v):
                x.requires_grad_()
            ops.reset_launch_counts()
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            grads = torch.autograd.grad(out, (q, k, v), do,
                                        retain_graph=True)
            again = torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            with torch.no_grad():
                _, lse = _flash.run_entry(
                    _build.library().repro_flash_attention, q, k, v,
                    causal=causal, window=window, with_lse=True)
                lse_err = max_err(lse, attention_lse_plain(
                    q, k, causal=causal, window=window))
                ref = flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                causal=causal, window=window)
            errs = [_rel(g, r) for g, r in zip(grads, ref)]
            same = all(torch.equal(a, g) for a, g in zip(again, grads))
            shape = (b, s, h, kv, hd) if t is None else (b, s, t, h, kv, hd)
            print(f"flash_attention_bwd {name} {shape} causal={causal} "
                  f"window={window} {str(dt)[6:]}: max|err|/max|ref| dq "
                  f"{errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (tol "
                  f"{FLASH_BWD_RTOL[dt]:g}), lse max|err| {lse_err:.3g} "
                  f"(atol {LSE_ATOL:g}), second backward "
                  f"{'bitwise equal' if same else 'DIFFERS'}, launches "
                  f"forward {counts['flash_attention']} backward "
                  f"{counts['flash_attention_bwd']}")
            if not (max(errs) <= FLASH_BWD_RTOL[dt] and lse_err <= LSE_ATOL
                    and same and counts["flash_attention"] == 1
                    and counts["flash_attention_bwd"] == 2
                    and all(g.dtype == dt for g in grads)):
                raise AssertionError(f"flash_attention backward kernel "
                                     f"disagrees at {name} {dt}")
            del q, k, v, do, out, grads, again, ref, lse
            torch.cuda.empty_cache()


def check_rglru_bwd(dev):
    """The scan under autograd (RGLRUScanFn): one forward and one backward
    launch, da / du / dh0 bit for bit the plain reverse loop, in f32 and
    bf16, with and without h0, at RecurrentGemma's training shape and
    ragged ones."""
    for dt in (torch.float32, torch.bfloat16):
        for with_h0 in (False, True):
            for b, s, d in ((RGT_B, RGT_S, 4096), (3, 129, 300), (1, 1, 32)):
                a, u, h0 = rglru_inputs(dev, b, s, d, with_h0, seed=s + d)
                a, u = a.to(dt).requires_grad_(), u.to(dt).requires_grad_()
                ins = (a, u) + ((h0.requires_grad_(),) if with_h0 else ())
                dh = torch.randn(b, s, d, device=dev)
                ops.reset_launch_counts()
                h = ops.rglru_scan(a, u, h0)
                grads = torch.autograd.grad(h, ins, dh)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                with torch.no_grad():
                    da, du, dh0 = rglru_scan_bwd_plain(a, h, dh, h0)
                same = torch.equal(grads[0], da.to(dt)) and torch.equal(
                    grads[1], du.to(dt)) and (
                        not with_h0 or torch.equal(grads[2], dh0))
                print(f"rglru_scan_bwd ({b},{s},{d}) {str(dt)[6:]} "
                      f"h0={with_h0}: {'bitwise equal' if same else 'DIFFERS'}"
                      f", launches forward {counts['rglru_scan']} backward "
                      f"{counts['rglru_scan_bwd']}")
                if not (same and counts["rglru_scan"] == 1
                        and counts["rglru_scan_bwd"] == 1):
                    raise AssertionError(f"rglru_scan backward kernel differs "
                                         f"from its plain loop at ({b},{s},"
                                         f"{d}) {dt} h0={with_h0}")


def check_rglru_bwd_paths(dev):
    """The scan's backward through ``run_bwd_entry`` (not counted): the
    planned path, the per-element path forced, and the ring forced where
    its copies can serve, each (da, du, dh0) bit for bit the plain reverse
    loop, in f32 and bf16 a, with and without h0: RecurrentGemma's
    training shape (S = 3000 no multiple of the ring's steps), D off a
    strip (300; in bf16 off 16 bytes, so per-element), S under a tile, a
    strided in time (a [:, ::2] view, still on the ring) and a [:, :, 1:]
    view (off 16 bytes: per-element)."""
    for dt in (torch.float32, torch.bfloat16):
        for with_h0 in (False, True):
            for name, b, s, d, view in (
                    (f"({RGT_B},{RGT_S},4096)", RGT_B, RGT_S, 4096, None),
                    ("(3,129,300)", 3, 129, 300, None),
                    ("(2,7,256)", 2, 7, 256, None),
                    ("(2,600,512)[:, ::2]", 2, 600, 512, "time"),
                    ("(2,300,513)[:, :, 1:]", 2, 300, 513, "offset")):
                a, u, h0 = rglru_inputs(dev, b, s, d, with_h0, seed=s + d)
                a, u = a.to(dt), u.to(dt)
                if view == "time":
                    a, u = a[:, ::2], u[:, ::2]
                elif view == "offset":
                    a, u = a[:, :, 1:], u[:, :, 1:]
                if h0 is not None:
                    h0 = h0[:, :a.shape[2]].contiguous()
                h = _rglru.run_entry(a, u, h0)
                dh = torch.randn(h.shape, device=dev)
                ref = rglru_scan_bwd_plain(a, h, dh, h0)
                ring = _rglru.is_aligned_bwd(a, h, dh, h0)
                cells = []
                for path in ("plan", "per-element") + (
                        ("ring",) if ring else ()):
                    got = _rglru.run_bwd_entry(
                        a, h, dh, h0, aligned={"plan": None, "ring": True,
                                               "per-element": False}[path])
                    torch.cuda.synchronize()
                    same = all(x is None and y is None or torch.equal(x, y)
                               for x, y in zip(got, ref))
                    cells.append(f"{path} "
                                 f"{'bitwise equal' if same else 'DIFFERS'}")
                    if not same:
                        raise AssertionError(f"rglru_scan_bwd {name} {dt} "
                                             f"h0={with_h0} {path} differs "
                                             "from its plain loop")
                plan = _rglru.bwd_tiles(*a.shape, a.element_size(),
                                        _build.sm_count(dev))
                print(f"rglru_scan_bwd {name} {str(dt)[6:]} h0={with_h0} "
                      f"(planned {'ring ' + str(plan) if ring else 'per-element'}"
                      f"): {'; '.join(cells)}")


def check_grad_guard(dev):
    """BvSB and decode attention have no backward: a CUDA call that
    autograd would record raises, and launches nothing."""
    x = torch.randn(4, 2048, device=dev, requires_grad=True)
    q = torch.randn(2, 8, 64, device=dev, requires_grad=True)
    kc = torch.randn(2, 64, 2, 64, device=dev)
    lengths = torch.tensor([64, 10], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    for name, call in (("bvsb", lambda: ops.bvsb(x)),
                       ("decode_attention",
                        lambda: ops.decode_attention(q, kc, kc, lengths))):
        try:
            call()
        except RuntimeError as err:
            if "no backward" not in str(err):
                raise
        else:
            raise AssertionError(f"{name} under grad returned a detached "
                                 "output")
    if any(ops.launch_counts().values()):
        raise AssertionError("a refused call launched a kernel")
    print("grad guard: bvsb and decode_attention under grad raise, nothing "
          "launched")


def flex_library(q, k, v, causal, cap, do=None):
    """(one call of ``torch.nn.attention.flex_attention``, compiled, with a
    tanh ``score_mod`` c tanh(s / c) and a causal block mask where
    ``causal``, on q (B, S, H, hd) and k / v (B, T, KV, hd) transposed to
    its (B, H, S, hd); with ``do``, the call is its backward through
    autograd, the forward run once outside), or (None, the reason) where
    the card's install does not compile or run it. SDPA has no score
    modifier, so this is the one PyTorch call that computes capped
    attention; the port never calls it. Prints the seconds its compile
    and first call took."""
    t0 = time.perf_counter()
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        fn = torch.compile(flex_attention)

        def score_mod(score, b, h, q_idx, kv_idx):
            return torch.tanh(score / cap) * cap

        mask = None
        if causal:
            mask = create_block_mask(
                lambda b, h, q_idx, kv_idx: q_idx >= kv_idx, None, None,
                q.shape[1], k.shape[1], device=q.device)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        gqa = q.shape[2] != k.shape[2]
        if do is None:
            def call():
                return fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                          enable_gqa=gqa)
            out = call().transpose(1, 2)
        else:
            qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
            o_t = fn(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                     enable_gqa=gqa)
            do_t = do.transpose(1, 2).contiguous()

            def call():
                return torch.autograd.grad(o_t, (qt, kt, vt), do_t,
                                           retain_graph=True)
            out = [g.transpose(1, 2) for g in call()]
        torch.cuda.synchronize()
        print(f"flex attention{' backward' if do is not None else ''} on q "
              f"{tuple(q.shape)}, k {tuple(k.shape)}: compiled and called "
              f"once in {time.perf_counter() - t0:.1f} s")
        return call, out
    except Exception as err:  # noqa: BLE001 - the reason is the result
        torch.cuda.synchronize()
        return None, f"{type(err).__name__}: {str(err).splitlines()[0][:160]}"


class Timer:
    """Kernel / plain / library device times (``time_ms``) beside the bound,
    per shape, each shape timed once, on inputs shaped as the main path
    gives them (float32 unless a row says bf16); the kernel's output on
    the timed inputs is held to its plain version's within the float32
    tolerance (the RG-LRU scan: bit for bit)."""

    def __init__(self, dev, rates):
        self.dev, self.rates = dev, rates
        self.bw, self.flops = rates.hbm, rates.fp32
        self.rows = {}

    def _row(self, key, kernel, plain, library, bound, err, atol, shape,
             plain_spin=True, bound_fp32=None, dt="f32", library_note=None):
        """``library`` None: no single PyTorch call computes the function.
        ``plain_spin`` False: the plain version launches more kernels than
        the launch queue holds, so it is timed without the spin (an upper
        bound: it includes the device's waits for the host).
        ``bound_fp32``: the bound at the FP32 CUDA-core rate, beside a
        ``bound`` at the tensor-core rate."""
        if not err <= atol:
            raise AssertionError(f"{key[0]} {key[1]}: max|err| {err:.3g} "
                                 f"above atol {atol:g}")
        ms, by = bound
        k_ms, call_ms = time_ms(kernel)
        p_ms = time_ms(plain, spin=True)[0] if plain_spin else \
            time_ms(plain, iters=3, warmup=1, spin=False)[0]
        l_ms = None if library is None else time_ms(library)[0]
        r = self.rows[key] = dict(
            ms=k_ms, call_ms=call_ms, plain_ms=p_ms, library_ms=l_ms,
            bound_ms=ms, bound_by=by, max_abs_err=err, shape=list(shape))
        fp32 = ""
        if bound_fp32 is not None:
            r["bound_fp32_ms"], r["bound_fp32_by"] = bound_fp32
            fp32 = (f", FP32 CUDA-core bound {bound_fp32[0] * 1e3:.4f} us "
                    f"({bound_fp32[1]})")
        lib = "none" if l_ms is None else f"{l_ms * 1e3:.2f} us"
        if library_note:
            r["library_note"] = library_note
            lib += f" ({library_note})"
        print(f"time {key[0]} {key[1]} {tuple(shape)} {dt}: kernel "
              f"{k_ms * 1e3:.2f} us on the device ({call_ms * 1e3:.2f} us "
              f"per call on the host), plain {p_ms * 1e3:.2f} us"
              f"{'' if plain_spin else ' (host-bound, no spin)'}, library "
              f"{lib}, bound {ms * 1e3:.4f} us ({by}){fp32}, max|err| "
              f"{err:.3g}")
        return r

    def bvsb(self, b, v=2048):
        if ("bvsb", f"B={b}") in self.rows:
            return self.rows[("bvsb", f"B={b}")]
        x = (torch.randn(b, SEQ, v, device=self.dev) * 4)[:, -1, :]
        (conf, top1), (pconf, ptop1) = ops.bvsb(x), bvsb_plain(x)
        if not torch.equal(top1, ptop1):
            raise AssertionError(f"bvsb B={b}: top-1 differs")
        return self._row(
            ("bvsb", f"B={b}"), lambda: ops.bvsb(x), lambda: bvsb_plain(x),
            lambda: torch.topk(torch.softmax(x, dim=-1), 2, dim=-1),
            bvsb_bound_ms(b, v, 4, self.bw, self.flops),
            max_err(conf, pconf), BVSB_ATOL[torch.float32], (b, v))

    def bvsb_rows(self, b, v, arch=RG_ARCH):
        """Contiguous (B, V) rows, as the serving head hands them over."""
        key = ("bvsb", f"{arch} B={b}")
        x = torch.randn(b, v, device=self.dev) * 4
        (conf, top1), (pconf, ptop1) = ops.bvsb(x), bvsb_plain(x)
        if not torch.equal(top1, ptop1):
            raise AssertionError(f"bvsb {key[1]}: top-1 differs")
        return self._row(
            key, lambda: ops.bvsb(x), lambda: bvsb_plain(x),
            lambda: torch.topk(torch.softmax(x, dim=-1), 2, dim=-1),
            bvsb_bound_ms(b, v, 4, self.bw, self.flops),
            max_err(conf, pconf), BVSB_ATOL[torch.float32], (b, v))

    def bvsb_partials(self, b, arch=GRANITE_ARCH, m=4):
        """The partial entry on model rank 0's shard of ``arch``'s head cut
        in ``m`` (B, PV / m) f32; library: amax + logsumexp + top-2 on the
        shard (what the tuple holds). Bound: the shard read once and 16
        bytes a row written, four operations an element."""
        pv = common.padded_vocab(get_config(arch).vocab_size)
        v = pv // m
        x = torch.randn(b, v, device=self.dev) * 4
        t, ref = ops.bvsb_partials(x, 0), bvsb_partials_plain(x, 0)
        if not torch.equal(t[:, [0, 1, 3]], ref[:, [0, 1, 3]]):
            raise AssertionError(f"bvsb partials B={b}: m1, m2 or the "
                                 "index differ")
        # the error: BvSB from the kernel's tuple against the plain one's
        err = max_err(bvsb_merge_plain(t[:, None])[0],
                      bvsb_merge_plain(ref[:, None])[0])

        def library():
            return (torch.amax(x, dim=-1), torch.logsumexp(x, dim=-1),
                    torch.topk(x, 2, dim=-1))
        return self._row(
            ("bvsb_partials", f"{arch} shard of {m} B={b}"),
            lambda: ops.bvsb_partials(x, 0),
            lambda: bvsb_partials_plain(x, 0), library,
            bvsb_partials_bound_ms(b, v, 4, self.bw, self.flops),
            err, BVSB_ATOL[torch.float32], (b, v))

    def bvsb_merge(self, b, m=4, arch=GRANITE_ARCH):
        """The merge entry over (B, m, 4) tuples of ``arch``'s head cut in
        m; no library call computes it. Bound: the tuples read once, conf
        and top-1 written, about 12 operations a tuple."""
        pv = common.padded_vocab(get_config(arch).vocab_size)
        x = torch.randn(b, pv, device=self.dev) * 4
        parts = torch.stack([ops.bvsb_partials(
            x[:, j * pv // m:(j + 1) * pv // m].contiguous(), j * pv // m)
            for j in range(m)], dim=1)
        (conf, top1), (pconf, ptop1) = ops.bvsb_merge(parts), bvsb_plain(x)
        if not torch.equal(top1, ptop1):
            raise AssertionError(f"bvsb merge B={b}: top-1 differs")
        return self._row(
            ("bvsb_merge", f"{arch} {m} shards B={b}"),
            lambda: ops.bvsb_merge(parts), lambda: bvsb_merge_plain(parts),
            None, bvsb_merge_bound_ms(b, m, self.bw, self.flops),
            max_err(conf, pconf), BVSB_ATOL[torch.float32], (b, m, 4))

    def _shard_inputs(self, b, w, kv, g, hd, m):
        """q, model rank 0's shard of a full ring of w slots cut in m, the
        ring's lengths (all w), and the shard's split count."""
        q, k, v, lens = decode_inputs(self.dev, b, w, kv, g, hd, [w] * b)
        ws = w // m
        ns = _decode.shard_splits(b, kv, ws, _build.sm_count(self.dev),
                                  m)[0]
        return q, k, v, lens, ns, ws

    def decode_partials(self, arch, b, w, kv, g, hd, m=4):
        """The decode partial entry on model rank 0's shard (B, W/m, KV,
        hd) f32 of ``arch``'s full ring cut in m; no single PyTorch call
        gives the partials. Bound: the shard's valid slots, q and the
        lengths read once, this rank's splits of the buffer written once
        (the zeros the entry writes over the other ranks' splits, for the
        gather, are not the function's work), a q.k and a p.v FMA per
        (query head, slot, head dim)."""
        q, k, v, lens, ns, ws = self._shard_inputs(b, w, kv, g, hd, m)
        sk, sv = k[:, :ws].contiguous(), v[:, :ws].contiguous()
        got = ops.decode_attention_partials(q, sk, sv, lens, 0, m)
        ref = _decode.decode_attention_partials_plain(q, sk, sv, lens, 0, m,
                                                      None, ns)
        return self._row(
            ("decode_attention_partials", f"{arch} shard of {m} B={b}"),
            lambda: ops.decode_attention_partials(q, sk, sv, lens, 0, m),
            lambda: _decode.decode_attention_partials_plain(
                q, sk, sv, lens, 0, m, None, ns), None,
            decode_partials_bound_ms(q, sk, lens, 0, ns, self.bw, self.flops),
            max_err(got, ref), DECODE_ATOL[torch.float32], (b, ws, kv, g, hd))

    def decode_merge(self, arch, b, w, kv, g, hd, m=4):
        """The decode merge entry over the m ranks' gathered partials of
        ``arch``'s full ring, against the whole ring's plain decode; no
        single PyTorch call computes it. Bound: the partials read once, the
        output written once, a multiply-add of l and of acc and an exp per
        (split, query head, head dim) element."""
        q, k, v, lens, ns, ws = self._shard_inputs(b, w, kv, g, hd, m)
        parts = torch.stack([ops.decode_attention_partials(
            q, k[:, j * ws:(j + 1) * ws].contiguous(),
            v[:, j * ws:(j + 1) * ws].contiguous(), lens, j, m)
            for j in range(m)]).sum(0)
        out = ops.decode_attention_merge(parts, q, kv)
        return self._row(
            ("decode_attention_merge", f"{arch} {m} shards B={b}"),
            lambda: ops.decode_attention_merge(parts, q, kv),
            lambda: _decode.decode_attention_merge_plain(parts, q, kv), None,
            decode_merge_bound_ms(parts, q, kv, self.bw, self.flops),
            max_err(out, decode_attention_plain(q, k, v, lens)),
            DECODE_ATOL[torch.float32], (b, kv, m * ns, g, hd))

    def flash_rg(self, b=RG_B, s=RG_S, window=2048):
        key = ("flash_attention", f"{RG_ARCH} B={b}")
        q, k, v = qkv(self.dev, b, s, 16, 1, 256)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        i = torch.arange(s, device=self.dev)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        err = max_err(ops.flash_attention(q, k, v, window=window),
                      flash_attention_plain(q, k, v, window=window))
        bound, fp32 = flash_bounds_ms(
            q, k, self.bw, self.flops, self.rates.tensor_peak(q.dtype), window,
            tensor_cores=_flash.uses_tensor_cores(s, 256))
        row = self._row(
            key, lambda: ops.flash_attention(q, k, v, window=window),
            lambda: flash_attention_plain(q, k, v, window=window),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True),
            bound, err, FLASH_ATOL[torch.float32], (b, s, 16, 1, 256, window),
            bound_fp32=fp32)
        # the same call with the GQA group's heads not packed into the
        # tile's rows: K and V expanded to 16 heads (stride 0), so each
        # block takes 128 positions of one head
        ku, vu = k.expand(-1, -1, 16, -1), v.expand(-1, -1, 16, -1)
        unpacked = max_err(ops.flash_attention(q, ku, vu, window=window),
                           ops.flash_attention(q, k, v, window=window))
        u_ms = time_ms(
            lambda: ops.flash_attention(q, ku, vu, window=window))[0]
        print(f"time flash_attention {key[1]} heads not packed: "
              f"{u_ms * 1e3:.2f} us on the device against "
              f"{row['ms'] * 1e3:.2f} packed, max|diff| {unpacked:.3g}")
        row["unpacked_ms"] = u_ms
        # the CUDA-core kernel, forced at the same shape
        f_ms = time_ms(lambda: flash_kernel(q, k, v, window, 1), iters=5,
                       warmup=2)[0]
        print(f"time flash_attention {key[1]} CUDA-core kernel forced: "
              f"{f_ms * 1e3:.2f} us on the device")
        row["fma_ms"] = f_ms
        return row

    def decode_rg(self, b=RG_B, w=2048, dt=torch.float32, cache_dt=None):
        """Every ring full (length W), as on every decode step of the
        path: its prompts of 3,000 tokens fill the 2048-slot rings."""
        return self.decode_at(RG_ARCH, b, w, 1, 16, 256, dt, cache_dt)

    def decode_at(self, arch, b, w, kv, g, hd, dt=torch.float32,
                  cache_dt=None, soft_cap=None):
        """``arch``'s decode shape with every ring full (length W). The
        SDPA yardstick takes the cache in q's type (SDPA takes one type
        for all three); under ``soft_cap`` (q and k drawn at CAP_QK) the
        yardstick is flex attention with the cap (``flex_library``)."""
        cache_dt = cache_dt or dt
        tag = "" if (dt, cache_dt) == (torch.float32,) * 2 else \
            " " + dtype_name(dt, cache_dt)
        if soft_cap:
            tag += " capped"
        key = ("decode_attention", f"{arch} B={b}{tag}")
        q, k, v, lens = decode_inputs(self.dev, b, w, kv, g, hd, [w] * b,
                                      dt, cache_dt)
        if soft_cap:
            q, k = (q.float() * CAP_QK).to(dt), \
                (k.float() * CAP_QK).to(cache_dt)
        qt = q[:, :, None, :]
        kt, vt = (c.transpose(1, 2).to(dt) for c in (k, v))
        mask = (torch.arange(w, device=self.dev)[None, :]
                < lens[:, None])[:, None, None, :]
        ref = decode_attention_plain(q, k, v, lens, soft_cap)
        err = max_err(ops.decode_attention(q, k, v, lens, soft_cap=soft_cap),
                      ref)
        library, note = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)), None
        if soft_cap:
            library, out = flex_library(q[:, None], k.to(dt), v.to(dt),
                                        False, soft_cap)
            note = out if library is None else \
                f"flex attention, max|diff| {max_err(out[:, 0], ref):.3g}"
        return self._row(
            key, lambda: ops.decode_attention(q, k, v, lens,
                                              soft_cap=soft_cap),
            lambda: decode_attention_plain(q, k, v, lens, soft_cap),
            library, decode_bound_ms(q, k, lens, self.bw, self.flops), err,
            DECODE_ATOL[dt], (b, w, kv, g, hd), dt=dtype_name(dt, cache_dt),
            library_note=note)

    def rglru_rg(self, b=RG_B, s=RG_S, d=4096, dt=torch.float32):
        name = "f32" if dt == torch.float32 else "bf16"
        key = ("rglru_scan", f"{RG_ARCH} B={b}" + (" bf16" if name == "bf16"
                                                   else ""))
        a, u, _ = rglru_inputs(self.dev, b, s, d, False, seed=1)
        a, u = a.to(dt), u.to(dt)
        if not torch.equal(ops.rglru_scan(a, u), rglru_scan_plain(a, u)):
            raise AssertionError(f"rglru_scan {key[1]}: differs from its "
                                 "plain version")
        return self._row(
            key, lambda: ops.rglru_scan(a, u), lambda: rglru_scan_plain(a, u),
            None, rglru_bound_ms(a, self.bw, self.flops), 0.0, 0.0,
            (b, s, d), plain_spin=False, dt=name)

    def flash(self, arch, b, s=16, t=None, causal=True, form="",
              soft_cap=None):
        """Attention at ``arch``'s heads, B prompts of S positions over T
        keys (T = S unless given; T != S is non-causal), causal unless
        said; ``form`` names a row beside the arch's causal one. The
        library is SDPA on the same inputs; under ``soft_cap`` (q and k
        drawn at CAP_QK) flex attention with the cap (``flex_library``)."""
        key = ("flash_attention", f"{arch}{form} B={b}")
        if key in self.rows:
            return self.rows[key]
        cfg = get_config(arch)
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = qkv(self.dev, b, s, h, kv, hd, t=t,
                      qk_scale=CAP_QK if soft_cap else 1.0)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        ref = flash_attention_plain(q, k, v, causal=causal, soft_cap=soft_cap)
        err = max_err(ops.flash_attention(q, k, v, causal=causal,
                                          soft_cap=soft_cap), ref)
        bound, fp32 = flash_bounds_ms(
            q, k, self.bw, self.flops, self.rates.tensor_peak(q.dtype),
            causal=causal,
            tensor_cores=_flash.uses_tensor_cores(s, hd, k.shape[1]))
        library, note = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=kv != h)), None
        if soft_cap:
            library, out = flex_library(q, k, v, causal, soft_cap)
            note = out if library is None else \
                f"flex attention, max|diff| {max_err(out, ref):.3g}"
        return self._row(
            key, lambda: ops.flash_attention(q, k, v, causal=causal,
                                             soft_cap=soft_cap),
            lambda: flash_attention_plain(q, k, v, causal=causal,
                                          soft_cap=soft_cap),
            library, bound, err, FLASH_ATOL[torch.float32],
            (b, s, h, kv, hd) if t is None else (b, s, t, h, kv, hd),
            bound_fp32=fp32, library_note=note)

    def flash_bwd(self, name, b, s, t, h, kv, hd, causal, window,
                  soft_cap=None):
        """The backward kernels (``run_bwd_entry``: D, dK/dV, dQ) at a
        training path's shape, f32, on the forward kernel's output and lse;
        the plain version the FA2 formulas in PyTorch; the library SDPA's
        backward through autograd (its forward run once outside the
        timing); under ``soft_cap`` (q and k drawn at CAP_QK) flex
        attention's backward with the cap (``flex_library``)."""
        key = ("flash_attention_bwd", f"{name} B={b}")
        if key in self.rows:
            return self.rows[key]
        q, k, v, do = flash_bwd_inputs(self.dev, b, s, t, h, kv, hd,
                                       torch.float32,
                                       qk_scale=CAP_QK if soft_cap else 1.0)
        out, lse = _flash.run_entry(_build.library().repro_flash_attention,
                                    q, k, v, causal=causal, window=window,
                                    soft_cap=soft_cap, with_lse=True)

        def run():
            return _flash.run_bwd_entry(q, k, v, out, lse, do, causal=causal,
                                        window=window, soft_cap=soft_cap)

        def plain():
            return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                             causal=causal, window=window,
                                             soft_cap=soft_cap)
        ref = plain()
        err = max(_rel(g, r) for g, r in zip(run(), ref))
        bound, fp32 = flash_bwd_bounds_ms(
            q, k, self.bw, self.flops, self.rates.tensor_peak(q.dtype),
            window, causal)
        note = None
        if soft_cap:
            library, got = flex_library(q, k, v, causal, soft_cap, do=do)
            note = got if library is None else (
                "flex attention's backward, max|diff|/max|ref| "
                f"{max(_rel(g, r) for g, r in zip(got, ref)):.3g}")
        else:
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            if window is None:
                o_t = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=kv != h)
            else:
                i = torch.arange(s, device=self.dev)
                mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                                     < window)
                o_t = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=kv != h)
            do_t = do.transpose(1, 2).contiguous()

            def library():
                return torch.autograd.grad(o_t, (qt, kt, vt), do_t,
                                           retain_graph=True)
        del ref
        return self._row(
            key, run, plain, library, bound, err,
            FLASH_BWD_RTOL[torch.float32],
            (b, s, h, kv, hd) if t is None else (b, s, t, h, kv, hd),
            bound_fp32=fp32, library_note=note)

    def rglru_bwd(self, b=RGT_B, s=RGT_S, d=4096, dt=torch.float32):
        """The scan's backward at RecurrentGemma's training shape (and B =
        1), bit for bit against the plain reverse loop, on the planned ring;
        beside it the per-element path forced (``elem_ms``), timed in the
        same run. No PyTorch call computes it."""
        name = "f32" if dt == torch.float32 else "bf16"
        key = ("rglru_scan_bwd", f"{RG_ARCH} B={b}" + (" bf16" if name ==
                                                       "bf16" else ""))
        a, u, h0 = rglru_inputs(self.dev, b, s, d, True, seed=3)
        a, u = a.to(dt), u.to(dt)
        h = _rglru.run_entry(a, u, h0)
        dh = torch.randn(b, s, d, device=self.dev)
        ref = rglru_scan_bwd_plain(a, h, dh, h0)
        for aligned in (None, False):
            got = _rglru.run_bwd_entry(a, h, dh, h0, aligned=aligned)
            if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                raise AssertionError(f"rglru_scan_bwd {key[1]} aligned="
                                     f"{aligned}: differs from its plain "
                                     "version")
        row = self._row(
            key, lambda: _rglru.run_bwd_entry(a, h, dh, h0),
            lambda: rglru_scan_bwd_plain(a, h, dh, h0), None,
            rglru_bwd_bound_ms(a, self.bw, self.flops), 0.0, 0.0, (b, s, d),
            plain_spin=False, dt=name)
        row["elem_ms"] = time_ms(
            lambda: _rglru.run_bwd_entry(a, h, dh, h0, aligned=False))[0]
        row["plan"] = list(_rglru.bwd_tiles(b, s, d, a.element_size(),
                                            _build.sm_count(self.dev)))
        print(f"time rglru_scan_bwd {key[1]}: ring (steps, stages) "
              f"{tuple(row['plan'])} {row['ms'] * 1e3:.2f} us, per-element "
              f"path {row['elem_ms'] * 1e3:.2f} us, on the device; "
              f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the bound")
        return row

    def flash_threshold(self, seqs=(16, 32, 40, 48, 64, 80, 96, 128, 256),
                        forward=True):
        """Device us of both flash kernels, forced, over S at the tiers'
        shapes and RecurrentGemma's heads (f32): where the tensor-core
        kernel starts to win sets the entry point's threshold. Then the
        same for the two backward forms (``run_bwd_entry`` forced, on the
        forward kernel's output and lse; the tiers train at B = 64), which
        sets the backward's threshold; ``forward`` False sweeps only
        those."""
        shapes = [(name, b, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
                  for name, b in (("tier-low", 1), ("tier-server-fast", 8),
                                  ("tier-server-heavy", 64), (RG_ARCH, 1))
                  for cfg in (get_config(name),)]
        for name, b, h, kv, hd in shapes if forward else ():
            cells = []
            for s in seqs:
                q, k, v = qkv(self.dev, b, s, h, kv, hd)
                fma_ms, tc_ms = (time_ms(lambda: flash_kernel(q, k, v, None,
                                                              kernel))[0]
                                 for kernel in (1, 2))
                pick = "tc" if _flash.uses_tensor_cores(s, hd) else "fma"
                cells.append(f"S={s} {fma_ms * 1e3:.2f}/{tc_ms * 1e3:.2f}"
                             f"({pick})")
            print(f"flash threshold {name} (B,H,KV,hd)=({b},{h},{kv},{hd}) "
                  f"f32, device us fma/tc (picked): {'; '.join(cells)}")
        for name, _, h, kv, hd in shapes:
            b = 1 if name == RG_ARCH else PAIR_BS
            cells = []
            for s in seqs:
                q, k, v, do = flash_bwd_inputs(self.dev, b, s, None, h, kv,
                                               hd, torch.float32)
                out, lse = _flash.run_entry(
                    _build.library().repro_flash_attention, q, k, v,
                    with_lse=True)
                fma_ms, tc_ms = (time_ms(lambda: _flash.run_bwd_entry(
                    q, k, v, out, lse, do, kernel=kernel))[0]
                                 for kernel in (1, 2))
                pick = "tc" if _flash.uses_tensor_cores_bwd(s, hd) else "fma"
                cells.append(f"S={s} {fma_ms * 1e3:.2f}/{tc_ms * 1e3:.2f}"
                             f"({pick})")
            print(f"flash backward threshold {name} (B,H,KV,hd)=({b},{h},"
                  f"{kv},{hd}) f32, device us fma/tc (picked): "
                  f"{'; '.join(cells)}")

    def flash_bwd_splits(self, splits=(1, 2, 3, 4, 6, 8, 12, 16)):
        """Device us of the backward at RecurrentGemma's and granite's
        training shapes (f32) with the tensor-core dK/dV grid split
        ``splits`` ways, forced, beside the plan's pick (``bwd_splits``)."""
        rg = get_config(RG_ARCH)
        for name, b, s, cfg, window in (
                (RG_ARCH, RGT_B, RGT_S, rg, rg.local_attn_window),
                (GRANITE_ARCH, GRANITE_B, GRANITE_S, get_config(GRANITE_ARCH),
                 None)):
            h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
            q, k, v, do = flash_bwd_inputs(self.dev, b, s, None, h, kv, hd,
                                           torch.float32)
            out, lse = _flash.run_entry(
                _build.library().repro_flash_attention, q, k, v,
                window=window, with_lse=True)
            pick = _flash.bwd_splits(b, s, s, h, kv, hd, window,
                                     _build.sm_count(self.dev))
            cells = []
            for n in splits:
                ms = time_ms(lambda: _flash.run_bwd_entry(
                    q, k, v, out, lse, do, window=window, kernel=2,
                    splits=n), iters=10, warmup=3)[0]
                cells.append(f"{n}: {ms * 1e3:.2f}")
            print(f"flash backward splits {name} ({b},{s},{h},{kv},{hd}) "
                  f"window {window} f32, device us by splits (plan {pick}): "
                  f"{'; '.join(cells)}")

    def flash_bwd_parts(self, name, b, s, h, kv, hd, window):
        """Device ms a launch of each backward kernel at a training shape
        (f32), from a profiled run of three calls."""
        q, k, v, do = flash_bwd_inputs(self.dev, b, s, None, h, kv, hd,
                                       torch.float32)
        out, lse = _flash.run_entry(_build.library().repro_flash_attention,
                                    q, k, v, window=window, with_lse=True)
        _flash.run_bwd_entry(q, k, v, out, lse, do, window=window)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                _flash.run_bwd_entry(q, k, v, out, lse, do, window=window)
            torch.cuda.synchronize()
        parts = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "flash_bwd" in e.key]
        if not parts:
            raise AssertionError("the profiled backward traced no kernel")
        cells = [f"{re.sub(r'<.*', '', e.key).split('::')[-1]} "
                 f"{e.self_device_time_total / 1e3 / e.count:.3f} ms "
                 f"({e.count} launches)"
                 for e in sorted(parts, key=lambda e: -e.self_device_time_total)]
        print(f"flash backward parts {name} ({b},{s},{h},{kv},{hd}) window "
              f"{window} f32, device ms a launch (profiled, 3 calls): "
              f"{'; '.join(cells)}")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
class RecordingClient(DeviceClient):
    """A device client that keeps every confidence it computes."""

    def __post_init__(self):
        super().__post_init__()
        self.confs = []

    def run_local(self, tokens):
        out = super().run_local(tokens)
        self.confs.append(out[0])
        return out


class RecordingEngine(ServerEngine):
    """A server engine that keeps every batch record it executes."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.records = []

    def execute(self, record):
        record = super().execute(record)
        self.records.append(record)
        return record


def fleet(models, max_in_flight=1, samples=SAMPLES):
    """A fresh cascade: clients, engine, scheduler and data (``samples`` a
    device), all seeded."""
    clients = [RecordingClient(i, models["tier-low"], DEVICE_PROFILES["low"],
                               SLO, WINDOW, THRESHOLD)
               for i in range(N_DEVICES)]
    engine = RecordingEngine([
        ServedModel("tier-server-fast", models["tier-server-fast"],
                    SERVER_PROFILES["inceptionv3"]),
        ServedModel("tier-server-heavy", models["tier-server-heavy"],
                    SERVER_PROFILES["efficientnetb3"])],
        max_in_flight=max_in_flight)
    sched = make_scheduler("multitasc++", N_DEVICES,
                           server_profile=SERVER_PROFILES["inceptionv3"],
                           slo=SLO, init_threshold=THRESHOLD)
    rng = np.random.default_rng(0)
    data = [[rng.integers(0, VOCAB, SEQ).astype(np.int32)
             for _ in range(samples)] for _ in range(N_DEVICES)]
    return clients, engine, sched, data


def cascade(models, run=run_cascade, max_in_flight=1, samples=SAMPLES):
    clients, engine, sched, data = fleet(models, max_in_flight, samples)
    res = run(clients, engine, sched, data, window=WINDOW,
              model_switching=True)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return clients, engine, res


def _top_kernels(prof, n=6):
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]
    return busy, sum(e.count for e in kernels), top


def profile_main_path(models, name="main path", **kw):
    """Device time of a cascade of PROFILE_SAMPLES samples a device under
    torch.profiler; the idle share compares it with the wall of the same
    cascade run just before without the profiler. The profiler's cost
    grows with the launches it traces (the whole run's 356,049 took 91.2 s
    under it against 7.573 s without, on an NVIDIA H100 80GB HBM3 at
    700 W), so the run is cut from SAMPLES to PROFILE_SAMPLES a device.
    Only CUDA activity is traced: the host-side operator records are not
    read."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    cascade(models, samples=PROFILE_SAMPLES, **kw)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cascade(models, samples=PROFILE_SAMPLES, **kw)
    busy, launches, top = _top_kernels(prof, 8)
    if busy <= 0:
        raise AssertionError("the profiled rerun traced no device time")
    print(f"{name} device time (profiled rerun of {PROFILE_SAMPLES} of the "
          f"{SAMPLES} samples a device, {time.perf_counter() - t0:.1f} s "
          f"with the profiler): {busy:.4f} s busy over {wall:.3f} s of "
          f"unprofiled wall of the same run, idle share "
          f"{1 - busy / wall:.4f}; {launches} kernel launches")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def build_models(dev):
    g = torch.Generator().manual_seed(0)
    return {name: init_params(cfg, g, device=dev) for name, cfg in (
        ("tier-low", get_config("tier-low").with_(init_scale=LOW_INIT_SCALE)),
        ("tier-server-fast", get_config("tier-server-fast")),
        ("tier-server-heavy", get_config("tier-server-heavy")))}


def main_path(dev):
    models = build_models(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    clients, engine, res = cascade(models)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    n = N_DEVICES * SAMPLES
    answered = sum(len(r["requests"]) for r in engine.records)
    forwarded = round(res.forwarded_frac * n)
    layers = {name: get_config(name).num_layers for name in models}
    want_flash = n * layers["tier-low"] + sum(layers[r["model"]]
                                              for r in engine.records)
    confs = np.concatenate([np.asarray(c.confs) for c in clients]
                           + [r["conf"] for r in engine.records])
    served = sorted({r["model"] for r in engine.records})
    print(f"main path: completed {res.completed}/{n}, sr {res.sr:.4f}, "
          f"forwarded_frac {res.forwarded_frac:.4f}, switches {res.switches},"
          f" server batches {len(engine.records)} (models {served}, buckets "
          f"{sorted(set(engine.batch_history))}), windows "
          f"{len(res.timeline['t'])}, "
          f"wall {wall:.3f} s on the card; virtual-clock throughput "
          f"{res.throughput:.2f}/s (paper profiles, not a card number)")
    print(f"main path launches: {counts} (expected bvsb "
          f"{n + len(engine.records)}, flash_attention {want_flash})")
    checks = {
        "completed": res.completed == n,
        "every forwarded sample answered": answered == forwarded
        and len(engine.queue) == 0 and engine.in_flight == 0
        and all(r["conf"] is not None and len(r["conf"]) == len(r["requests"])
                for r in engine.records),
        "bvsb launches": counts["bvsb"] == n + len(engine.records),
        "flash_attention launches": counts["flash_attention"] == want_flash,
        "no decode, scan or backward launches":
            counts["decode_attention"] == counts["rglru_scan"] == 0
            and counts["flash_attention_bwd"] == counts["rglru_scan_bwd"] == 0,
        "finite confidences": bool(np.isfinite(confs).all())
        and len(confs) == n + answered,
        "some samples kept local, some forwarded":
            0 < res.forwarded_frac < 1,
        "S(C) switched the server model": res.switches >= 1,
        "both server models served batches":
            served == ["tier-server-fast", "tier-server-heavy"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")

    profile_main_path(models)

    # one 64-sample tier-server-heavy batch: card vs the same weights on CPU
    heavy = models["tier-server-heavy"]
    rng = np.random.default_rng(1)
    cpu = build_model(heavy.cfg, device="cpu")
    cpu.load_state_dict(heavy.state_dict())
    tokens = rng.integers(0, 2048, (64, SEQ)).astype(np.int32)
    fn = classify_fn(heavy, 64)
    conf, pred = fn(heavy, torch.as_tensor(tokens, device=dev))
    with torch.inference_mode():
        last = cpu(torch.as_tensor(tokens))[0][:, -1, :]
    cconf, cpred = ops.bvsb(last)
    top2 = torch.topk(last, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOP2_GAP
    err = max_err(conf.cpu(), cconf)
    same = torch.equal(pred.cpu()[clear], cpred[clear])
    print(f"tier-server-heavy classify, 64 samples, card vs CPU: max|conf "
          f"err| {err:.3g} (atol {CLASSIFY_CONF_ATOL:g}), top-1 equal on "
          f"{int(clear.sum())}/64 rows with top-2 gap > {TOP2_GAP:g}: {same}")
    if not (err <= CLASSIFY_CONF_ATOL and same):
        raise AssertionError("tier-server-heavy on the card disagrees with "
                             "the CPU")
    return counts, engine, dict(models=models, res=res, wall=wall)


# ---------------------------------------------------------------------------
# phase 5: RecurrentGemma-9B prefill + decode
# ---------------------------------------------------------------------------
def rg_expected_launches(cfg, steps):
    kinds = cfg.pattern
    return {**NO_LAUNCHES, "bvsb": 1 + steps,
            "flash_attention": kinds.count("lattn"),
            "rglru_scan": kinds.count("rglru"),
            "decode_attention": kinds.count("lattn") * steps}


def ring_keys(model, tokens, layer):
    """The rotated keys (S, KV, hd) of ``layer`` (an lattn layer) for the
    first prompt, recomputed at batch 1 from the layers below it."""
    cfg = model.cfg
    with torch.inference_mode():
        x = common.embed_apply(model.embed.table, tokens[:1])
        positions = torch.arange(tokens.shape[1], device=x.device)[None]
        for below in model.layers[:layer]:
            x = below(x, positions, cfg)[0]
        lyr = model.layers[layer]
        _, k, _ = attention._qkv(lyr.attn, lyr.norm1(x, cfg.norm_eps), cfg)
        return common.apply_rope(k, positions, cfg.rope_theta)[0]


def recurrentgemma_path(dev):
    cfg = get_config(RG_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    print(f"{RG_ARCH}: {cfg.num_layers} layers {cfg.pattern.count('rglru')} "
          f"rglru / {cfg.pattern.count('lattn')} lattn, {n_params} "
          f"parameters, {weights_gb:.3f} GB float32, drawn on the card in "
          f"{init_s:.3f} s")

    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (RG_B, RG_S)),
                             device=dev)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    lattn = cfg.pattern.index("lattn")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    conf, top1, cache = prefill(tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    ring = cache[lattn]["k"][0].clone()     # before decode overwrites it
    confs, tops = [conf], [top1]
    pos = torch.full((RG_B,), RG_S, device=dev)
    t0 = time.perf_counter()
    for i in range(RG_STEPS):
        conf, top1, cache = serve(top1[:, None], cache, pos + i)
        confs.append(conf)
        tops.append(top1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = rg_expected_launches(cfg, RG_STEPS)
    confs, tops = torch.stack(confs), torch.stack(tops)
    w = ring.shape[0]
    keys = ring_keys(model, tokens, lattn)
    kept = torch.arange(RG_S - w, RG_S, device=dev)
    ring_err = max_err(ring[kept % w], keys[kept])
    shifted_err = max_err(ring[(kept + 1) % w], keys[kept])
    print(f"{RG_ARCH} prefill of {RG_B} x {RG_S} tokens: wall {prefill_s:.3f} "
          "s on the card")
    print(f"{RG_ARCH} decode of {RG_STEPS} steps at B={RG_B}: wall "
          f"{decode_s:.3f} s on the card ({decode_s / RG_STEPS * 1e3:.2f} ms "
          "per step)")
    print(f"{RG_ARCH} path: peak device memory {peak_gb:.3f} GB; launches "
          f"{counts} (expected {want}); conf range [{float(confs.min()):.3g},"
          f" {float(confs.max()):.3g}]; ring of layer {lattn}: positions "
          f"{RG_S - w}..{RG_S - 1} at slot pos % {w}, max|err| "
          f"{ring_err:.3g} (atol {RING_ATOL:g}; one slot off: "
          f"{shifted_err:.3g})")
    checks = {
        "launches": counts == want,
        "finite confidences": bool(torch.isfinite(confs).all()),
        "top-1 in the vocab": bool(((tops >= 0)
                                    & (tops < cfg.vocab_size)).all()),
        "shapes": confs.shape == tops.shape == (RG_STEPS + 1, RG_B),
        "ring holds the last W positions at pos % W":
            ring_err <= RING_ATOL < shifted_err,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{RG_ARCH} path checks failed: {failed}")
    del cache, keys, ring
    profile_serving(RG_ARCH, prefill, serve, (tokens,), top1,
                    torch.full((RG_B,), RG_S, device=dev), prefill_s,
                    decode_s / RG_STEPS)
    rg_check_cpu(model, dev)
    return counts, dict(init_s=init_s, prefill_s=prefill_s,
                        decode_s=decode_s, peak_gb=peak_gb)


def profile_serving(name, prefill, serve, args, top1, pos, prefill_s, step_s,
                    steps=4):
    """Device time by kernel of a second prefill (``prefill(*args)``) and
    ``steps`` decode steps from ``pos`` under torch.profiler (CUDA activity
    only); busy time against the unprofiled run's wall time gives the idle
    share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, cache = prefill(*args)
        torch.cuda.synchronize()
    busy, launches, top = _top_kernels(prof)
    print(f"{name} prefill device time (profiled rerun): {busy:.4f} s busy"
          f" over {prefill_s:.3f} s of unprofiled wall, idle share "
          f"{1 - busy / prefill_s:.4f}; {launches} kernel launches")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            _, top1, cache = serve(top1[:, None], cache, pos + i)
        torch.cuda.synchronize()
    busy, launches, top = _top_kernels(prof)
    wall = step_s * steps
    print(f"{name} decode device time (profiled rerun of {steps} steps): "
          f"{busy:.4f} s busy over {wall:.3f} s of unprofiled wall, idle "
          f"share {1 - busy / wall:.4f}; {launches} kernel launches")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


def rg_check_cpu(model, dev):
    """One super-block of the same weights at full width, card against
    CPU: prefill of (2, 300) and 4 decode steps, each fed the card's
    top-1. BvSB within CLASSIFY_CONF_ATOL; top-1 equal wherever the CPU's
    top-2 logit gap exceeds TOP2_GAP."""
    cfg = model.cfg.with_(num_layers=RG_CHECK_LAYERS)
    card = build_model(cfg, device=dev)
    card.load_state_dict(model.state_dict(), strict=False)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    table = cpu.head_table
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (RG_CHECK_B, RG_CHECK_S)))
    t0 = time.perf_counter()
    prefill, serve = make_prefill_step(card), make_serve_step(card)
    conf, top1, cache = prefill(tokens.to(dev))
    with torch.inference_mode():
        hidden, ccache = cpu(tokens, collect_cache=True, return_hidden=True)
    errs, same, clear_rows = [], True, 0
    for i in range(RG_CHECK_STEPS + 1):
        with torch.inference_mode():
            cconf, ctop1 = head_bvsb(hidden[:, -1:], table, cfg.vocab_size)
            top2 = torch.topk(hidden[:, -1] @ table.T, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > TOP2_GAP
        errs.append(max_err(conf.cpu(), cconf))
        same &= torch.equal(top1.cpu()[clear], ctop1[clear])
        clear_rows += int(clear.sum())
        if i == RG_CHECK_STEPS:
            break
        pos = torch.full((RG_CHECK_B,), RG_CHECK_S + i)
        tok = top1.cpu()[:, None]
        conf, top1, cache = serve(tok.to(dev), cache, pos.to(dev))
        with torch.inference_mode():
            hidden, ccache = cpu.decode_step(tok, ccache, pos,
                                             return_hidden=True)
    n = RG_CHECK_B * (RG_CHECK_STEPS + 1)
    print(f"{RG_ARCH} {RG_CHECK_LAYERS} layers at full width, prefill "
          f"{RG_CHECK_B} x {RG_CHECK_S} + {RG_CHECK_STEPS} decode steps, "
          f"card vs CPU: max|conf err| {max(errs):.3g} (atol "
          f"{CLASSIFY_CONF_ATOL:g}), top-1 equal on {clear_rows}/{n} rows "
          f"with top-2 gap > {TOP2_GAP:g}: {same} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not (max(errs) <= CLASSIFY_CONF_ATOL and same):
        raise AssertionError(f"{RG_ARCH} on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 6: the paper's simulator (calibration, then the lane-aligned sweep)
# ---------------------------------------------------------------------------
# (a) the heterogeneous fleet of benchmarks/fig11_heterogeneous.py at the
# paper's scale: 100 devices, tiers low/mid/high round-robin, SLO 0.15 s,
# server efficientnetb3, 5,000 samples a device, 3 schedulers x 3 seeds
SIM_N, SIM_S, SIM_SLO, SIM_SEEDS = 100, 5000, 0.15, (0, 1, 2)
SIM_SCHEDULERS = ("multitasc++", "multitasc", "static")
SIM_TIERS = ("low", "mid", "high")
SIM_SERVER = "efficientnetb3"
# (b) the changing environment: the same fleet under churn and MMPP
# arrivals, switching over three server models, one lane per scheduler
SIM_ENV = ScenarioSpec("churn+mmpp",
                       churn=ChurnSpec(join_frac=0.3, leave_frac=0.3),
                       arrivals=ArrivalSpec(kind="mmpp"))
SIM_ENV_SERVERS = ("inceptionv3", "efficientnetb3", "deit-base")
# cut from the paper's 5,000: under arrivals the devices' completions no
# longer coincide, so (b) takes about N events a sample (94 a sample at
# N = 100), and its CPU check runs one trip per event
SIM_ENV_S = 200
# the width sweep over (a)'s fleet, and the profiled rerun's size
# (the profiler's processing costs ~0.15 ms a kernel, hence the short rerun)
SIM_WIDTHS, SIM_WIDTH_S, SIM_PROFILE_S = (1, 9, 64, 256), 600, 30
SIM_CPU_LANES = 3        # lanes of (a) and of (b) also run on the CPU
# card against CPU: these equal, the float sums over devices within
# tests/test_torch_sim.py's AGG_RTOL
SIM_EXACT = ("completed", "forwarded_frac", "queue_left", "queue_peak",
             "n_events", "per_device_sr", "per_device_acc", "final_thresh")
SIM_EXACT_TRACES = ("server_idx", "fwd", "active")
SIM_AGG = ("sr", "accuracy", "throughput")
SIM_AGG_TRACES = ("thresh", "sr", "acc")
SIM_AGG_RTOL = 1e-5


def sim_fleet():
    profs = [DEVICE_PROFILES[SIM_TIERS[i % 3]] for i in range(SIM_N)]
    return (np.arange(SIM_N, dtype=np.int32) % 3,
            np.array([p.latency for p in profs], np.float32),
            np.array([p.accuracy for p in profs]))


@functools.lru_cache(maxsize=None)
def sim_static_threshold(server):
    """fig11's static threshold: the paper's calibration protocol on each
    tier's calibration split against the server, averaged over tiers."""
    return float(np.mean([calibration.calibrate_static_threshold(
        cal.confidence, cal.correct_light, cal.correct_heavy[:, 0])[0]
        for cal in (synthetic.calibration_set(DEVICE_PROFILES[t].accuracy,
                                              server.accuracy)
                    for t in SIM_TIERS)]))


@functools.lru_cache(maxsize=4)
def sim_inputs(kind, lanes, samples):
    """run_sweep's arguments for lanes ``lanes`` (a range) of fleet (a)
    "hetero" or (b) "env": lane i runs scheduler i % 3 on seed i // 3. A
    lane's inputs depend only on its index, so any subset of lanes is the
    same points. Cached: the width sweep and the profiled rerun call each
    twice or more (the streams are host set-up, not the card's work)."""
    tier, lat, accs = sim_fleet()
    seeds = [i // 3 for i in lanes]
    uniq = sorted(set(seeds))
    rows = [uniq.index(x) for x in seeds]
    if kind == "hetero":
        servers = (SERVER_PROFILES[SIM_SERVER],)
        kw = dict(tier_ids=tier)
        spec_kw = dict(static_threshold=sim_static_threshold(servers[0]))
    else:
        servers = tuple(SERVER_PROFILES[n] for n in SIM_ENV_SERVERS)
        r = scenarios.realize(SIM_ENV, uniq, SIM_N, samples, lat)
        kw = dict(tier_ids=tier, c_upper=[DEFAULT_C_UPPER[t]
                                          for t in SIM_TIERS],
                  join_t=r["join_t"][rows], leave_t=r["leave_t"][rows])
        spec_kw = dict(model_switching=True,
                       static_threshold=sim_static_threshold(servers[0]))
    streams = synthetic.batched_device_streams(
        uniq, SIM_N, samples, accs, [p.accuracy for p in servers])
    streams = {k: v[rows] for k, v in streams.items()}
    if kind == "env":
        streams["arrive"] = r["arrive"][rows]
    specs = [jaxsim.JaxSimSpec(SIM_SCHEDULERS[i % 3], SIM_N, samples,
                               **spec_kw) for i in lanes]
    return (specs, streams, lat, np.full(SIM_N, SIM_SLO, np.float32),
            servers), kw


def sim_cpu_lanes(kind, samples):
    """The first SIM_CPU_LANES lanes through the port on the CPU (run in a
    worker process beside the card's runs); returns (metrics, wall s)."""
    torch.set_num_threads(1)
    args, kw = sim_inputs(kind, range(SIM_CPU_LANES), samples)
    t0 = time.perf_counter()
    out = jaxsim.run_sweep(*args, device="cpu", **kw)
    return out, time.perf_counter() - t0


def sim_run(dev, kind, lanes, samples):
    """One card run: (metrics, wall s, loop trips)."""
    args, kw = sim_inputs(kind, lanes, samples)
    trips = jaxsim.stats.trips
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = jaxsim.run_sweep(*args, device=dev, **kw)
    wall = time.perf_counter() - t0
    return out, wall, jaxsim.stats.trips - trips


def sim_line(name, out, wall, trips, where="on the card"):
    events = int(out["n_events"].sum())
    return (f"{name}: B={len(out['sr'])}, wall {wall:.3f} s {where}, "
            f"{trips} loop trips ({wall / trips * 1e6:.2f} us a trip), "
            f"{events} lane-events ({events / wall:.0f} lane-events/s), "
            f"n_events per lane {out['n_events'].min()}-"
            f"{out['n_events'].max()}")


def sim_compare(name, card, cpu):
    """Lanes 0..k-1 of the card's run against the CPU's k lanes."""
    k = len(cpu["sr"])
    bad = [key for key in SIM_EXACT
           if not np.array_equal(card[key][:k], cpu[key])]
    bad += [f"traces.{key}" for key in SIM_EXACT_TRACES
            if not np.array_equal(card["traces"][key][:k],
                                  cpu["traces"][key], equal_nan=True)]
    worst = 0.0
    for key in SIM_AGG + tuple(f"traces.{t}" for t in SIM_AGG_TRACES):
        a = card["traces"][key[7:]] if key.startswith("traces.") else card[key]
        b = cpu["traces"][key[7:]] if key.startswith("traces.") else cpu[key]
        a, b = np.asarray(a[:k], np.float64), np.asarray(b, np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            bad.append(key)
            continue
        m = ~np.isnan(a)
        rel = np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]), 1e-30)
        err = float(rel.max()) if rel.size else 0.0
        worst = max(worst, err)
        if err > SIM_AGG_RTOL:
            bad.append(f"{key} (rel {err:.3g})")
    print(f"{name}: card lanes 0-{k - 1} against the CPU: "
          f"{', '.join(SIM_EXACT + SIM_EXACT_TRACES)} "
          f"{'equal' if not bad else 'DIFFER'}; {', '.join(SIM_AGG)} and "
          f"the traces' {', '.join(SIM_AGG_TRACES)} within max rel "
          f"{worst:.3g} (rtol {SIM_AGG_RTOL:g})")
    if bad:
        raise AssertionError(f"{name}: the card's lanes differ from the "
                             f"CPU's in {bad}")


def sim_check_result(name, out, samples, lanes, churn=False):
    """Finite metrics in range and no sample counted twice; without churn
    the MultiTASC++ lanes (i % 3 == 0) must finish every sample and drain
    their queue, which the paper's point is that it keeps up with (a
    congested MultiTASC or Static lane can reach its window budget with
    samples still queued, as in the JAX package)."""
    n = SIM_N * samples
    pp = np.array([i % 3 == 0 for i in lanes])
    checks = {
        "finite metrics": all(np.isfinite(out[k]).all()
                              for k in ("sr", "accuracy", "throughput")),
        "completed + queued <= samples":
            ((out["completed"] + out["queue_left"] <= n)
             & (out["completed"] > 0)).all(),
        "sr in [0, 100]": ((out["sr"] >= 0) & (out["sr"] <= 100)).all(),
        "some forwarded, some local":
            ((out["forwarded_frac"] > 0) & (out["forwarded_frac"] < 1)).all(),
    }
    if not churn:
        checks["MultiTASC++ lanes complete every sample and drain"] = (
            (out["completed"][pp] == n) & (out["queue_left"][pp] == 0)).all()
    failed = [k for k, ok in checks.items() if not ok]
    print(f"{name}: sr {np.round(out['sr'], 3).tolist()}, accuracy "
          f"{np.round(out['accuracy'], 4).tolist()}, forwarded_frac "
          f"{np.round(out['forwarded_frac'], 4).tolist()}, completed "
          f"{out['completed'].tolist()}, queue_left "
          f"{out['queue_left'].tolist()}, queue_peak "
          f"{out['queue_peak'].tolist()}")
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")


def sim_calibration_inputs(dev):
    """Light-model logits on the card, and labels: the light model right
    more often where its BvSB is high (about 74% in all, near the paper's
    light models), the heavy model at 85%."""
    gen = torch.Generator(device=dev).manual_seed(4)
    logits = torch.randn(10_000, 1000, generator=gen, device=dev) * 10
    pconf, _ = calibration.score_logits(logits.cpu())
    rng = np.random.default_rng(4)
    correct_l = (rng.random(10_000) < 0.3 + 0.7 * pconf).astype(np.int8)
    correct_h = (rng.random(10_000) < 0.85).astype(np.int8)
    return logits, correct_l, correct_h


def sim_check_scoring(logits):
    """BvSB of the calibration logits, card against CPU (not counted)."""
    conf, _ = calibration.score_logits(logits)
    pconf, _ = calibration.score_logits(logits.cpu())
    err = float(np.abs(conf - pconf).max())
    print(f"calibration scoring of (10000, 1000) logits, card vs CPU: BvSB "
          f"max|err| {err:.3g} (atol {BVSB_ATOL[torch.float32]:g})")
    if not err <= BVSB_ATOL[torch.float32]:
        raise AssertionError("calibration scoring on the card disagrees "
                             "with the CPU")


def sim_calibration(logits, correct_l, correct_h):
    """The paper's calibration protocol over the logits scored on the card
    (one BvSB launch) against the same on the CPU: the same threshold."""
    t, info = calibration.calibrate_from_logits(logits, correct_l, correct_h)
    pt, pinfo = calibration.calibrate_from_logits(logits.cpu(), correct_l,
                                                  correct_h)
    print(f"calibration from (10000, 1000) logits: card threshold {t:.6f}, "
          f"CPU {pt:.6f}, forward fraction {info['forward_fraction']:.4f}")
    if not (t == pt and info == pinfo):
        raise AssertionError("calibration on the card disagrees with the CPU")


def simulator_path(dev):
    """Calibration and both fleets on the card, launch counters around
    them; the first lanes of each also on the CPU in worker processes
    started first, held to the card's; then the width sweep and a
    profiled rerun."""
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn) as pool:
        cpu = {"hetero": pool.submit(sim_cpu_lanes, "hetero", SIM_S),
               "env": pool.submit(sim_cpu_lanes, "env", SIM_ENV_S)}
        cal = sim_calibration_inputs(dev)
        sim_check_scoring(cal[0])
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        sim_calibration(*cal)
        hetero, h_wall, h_trips = sim_run(dev, "hetero",
                                          range(3 * len(SIM_SEEDS)), SIM_S)
        env, e_wall, e_trips = sim_run(dev, "env", range(3), SIM_ENV_S)
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(sim_line(f"simulator (a) hetero fleet N={SIM_N} S={SIM_S}",
                       hetero, h_wall, h_trips))
        sim_check_result("simulator (a)", hetero, SIM_S,
                         range(3 * len(SIM_SEEDS)))
        print(sim_line(f"simulator (b) churn + MMPP + switching N={SIM_N} "
                       f"S={SIM_ENV_S}", env, e_wall, e_trips))
        sim_check_result("simulator (b)", env, SIM_ENV_S, range(3),
                         churn=True)
        switched = np.nanmax(env["traces"]["server_idx"], axis=1)
        print(f"simulator (b): highest server index reached per lane "
              f"{switched.tolist()}; peak device memory {peak_gb:.3f} GB; "
              f"launches {counts}; {jaxsim.GRAPH_TRIPS} trips a graph")
        if counts != {**NO_LAUNCHES, "bvsb": 1}:
            raise AssertionError(f"simulator path launches {counts}")
        t0 = time.perf_counter()
        width_ref = sim_widths(dev)
        t1 = time.perf_counter()
        sim_profile(dev)
        t2 = time.perf_counter()
        for name, card, kind, samples in (("simulator (a)", hetero, "hetero",
                                           SIM_S),
                                          ("simulator (b)", env, "env",
                                           SIM_ENV_S)):
            out, wall = cpu[kind].result()
            print(f"{name}: the port on the CPU, not the card ({SIM_CPU_LANES}"
                  f" lanes, one thread in a worker process): wall "
                  f"{wall:.3f} s for {int(out['n_events'].sum())} "
                  f"lane-events")
            sim_compare(name, card, out)
        print(f"simulator phase seconds: width sweep {t1 - t0:.1f}, profiled "
              f"rerun {t2 - t1:.1f}, waiting for the CPU lanes "
              f"{time.perf_counter() - t2:.1f}")
    return counts, dict(hetero=hetero, hetero_wall=h_wall, env_wall=e_wall,
                        peak_gb=peak_gb, width_ref=width_ref)


def sim_widths(dev):
    """(a)'s fleet at SIM_WIDTH_S samples for each B, one call each: its
    wall includes building the buffers, the eager warm-up trips and the
    graph's capture, as a user's first call of a structure does. Returns
    the run of B = 9, (a)'s lanes, and its wall: phase 8's reference."""
    runs = {}
    for b in SIM_WIDTHS:
        out, wall, trips = sim_run(dev, "hetero", range(b), SIM_WIDTH_S)
        runs[b] = out, wall
        print(sim_line(f"simulator width B={b} S={SIM_WIDTH_S}", out, wall,
                       trips))
    return runs[3 * len(SIM_SEEDS)]


def sim_profile(dev):
    """Device busy time of a warm rerun of (a)'s B=9 at SIM_PROFILE_S under
    torch.profiler (CUDA activity), against its unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile
    lanes = range(3 * len(SIM_SEEDS))
    sim_run(dev, "hetero", lanes, SIM_PROFILE_S)
    _, wall, trips = sim_run(dev, "hetero", lanes, SIM_PROFILE_S)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim_run(dev, "hetero", lanes, SIM_PROFILE_S)
    busy, launches, top = _top_kernels(prof, 8)
    if busy <= 0:
        raise AssertionError("the profiled simulator rerun traced no device "
                             "time")
    print(f"simulator device time (profiled warm rerun of (a) B=9 "
          f"S={SIM_PROFILE_S}): {busy:.4f} s busy over {wall:.3f} s of "
          f"unprofiled wall, idle share {1 - busy / wall:.4f}; {launches} "
          f"kernel launches over {trips} trips ({launches / trips:.1f} a "
          f"trip, the loads and reads of the run included)")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 7: the async transport, the replay and the segmented frontier
# ---------------------------------------------------------------------------
TRANSPORT_SLOTS = (1, 2)
# (b) tests/test_serving_differential.py's scenarios and sizes
REPLAY_N, REPLAY_S, REPLAY_SEED, REPLAY_SLO = 10, 80, 11, 0.16
REPLAY_SERVERS = (ServerProfile("sdiff-fast", "synthetic", 0.90, 0.045, 16),
                  ServerProfile("sdiff-heavy", "synthetic", 0.94, 0.070, 16))
REPLAY_SCENARIOS = ("steady", "churn", "churn_drift")
# (c) 5,000 devices (benchmarks/fig_scale.py's 10,000 halved to fit the
# script's time limit: the card's two runs took 43.5 s and the CPU's lane
# 82.9 s at 10,000): n_pad 5,120, the automatic segment width 128. The
# three tiers round-robin, each device's latency its tier's times a
# jitter in [0.9, 1.1] (benchmarks/fig_scale.py's steady state: few
# simultaneous completions, so the two frontiers take nearly the same
# trips), MultiTASC++ with switching over phase 6's three servers, three
# seeds. S = 3: about one trip a device completion, ~15,000 trips a run
SEG_N, SEG_S, SEG_SEEDS = 5_000, 3, (0, 1, 2)


def same_result(a, b):
    """Every CascadeResult field equal (NaN equal to NaN)."""
    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "timeline":
            if x.keys() != y.keys() or any(
                    not np.array_equal(np.asarray(x[k], np.float64),
                                       np.asarray(y[k], np.float64),
                                       equal_nan=True)
                    for k in x if k != "model") or x["model"] != y["model"]:
                bad.append(f.name)
        elif not np.array_equal(np.asarray(x), np.asarray(y),
                                equal_nan=True):
            bad.append(f.name)
    return bad


def transport_path(dev, ref_run, ref_counts):
    """(a): run_transport at each slot count against run_cascade at the
    same slots, launch counts around each run; the walls; a profiled
    2-slot rerun. Returns the transport runs' launch counts, summed."""
    models = ref_run["models"]
    refs = {1: (ref_run["res"], ref_counts, ref_run["wall"])}
    total = dict.fromkeys(ref_counts, 0)
    walls = {}
    for slots in TRANSPORT_SLOTS:
        if slots not in refs:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            _, _, res = cascade(models, max_in_flight=slots)
            refs[slots] = (res, ops.launch_counts(),
                           time.perf_counter() - t0)
        ref, want, ref_wall = refs[slots]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, engine, res = cascade(models, run_transport, slots)
        walls[slots] = time.perf_counter() - t0
        got = ops.launch_counts()
        total = {k: total[k] + got[k] for k in total}
        bad = same_result(res, ref)
        print(f"transport (a) {slots} slot(s): run_transport wall "
              f"{walls[slots]:.3f} s against run_cascade {ref_wall:.3f} s "
              f"on the card; completed {res.completed}, sr {res.sr:.4f}, "
              f"switches {res.switches}, server batches "
              f"{len(engine.records)}; every CascadeResult field "
              f"{'equal' if not bad else 'DIFFERS in ' + str(bad)}; "
              f"launches {got} ({'equal' if got == want else 'DIFFER from'}"
              f" run_cascade's {want})")
        if bad or got != want:
            raise AssertionError(f"run_transport at {slots} slot(s) differs "
                                 f"from run_cascade")
    profile_main_path(models, "transport (a) 2 slots", run=run_transport,
                      max_in_flight=2)
    return total


def replay_scenario(name):
    rng = np.random.default_rng(2)
    lat = (0.06 * rng.uniform(0.9, 1.1, REPLAY_N)).astype(np.float32)
    streams = synthetic.device_streams(REPLAY_N, REPLAY_S, 0.70,
                                       [0.90, 0.94], REPLAY_SEED)
    r = scenarios.realize(scenarios.SCENARIOS[name], [REPLAY_SEED],
                          REPLAY_N, REPLAY_S, lat)
    if r["arrive"] is not None:
        streams["arrive"] = r["arrive"][0]
    return streams, lat, r["join_t"][0], r["leave_t"][0]


def as_lane(out):
    """A ``jaxsim.run`` dict with its batch axis back, for sim_compare."""
    lane = {k: np.asarray(v)[None] for k, v in out.items() if k != "traces"}
    lane["traces"] = {k: np.asarray(v)[None]
                      for k, v in out["traces"].items()}
    return lane


def replay_path(dev):
    """(b): serving_vs_sim with the simulator half on the card, its deltas
    within SERVING_TOL, and the card's simulator held to the CPU's."""
    t0 = time.perf_counter()
    for scn in REPLAY_SCENARIOS:
        streams, lat, join_t, leave_t = replay_scenario(scn)
        for sched in SIM_SCHEDULERS:
            args = (sched, streams, lat,
                    np.full(REPLAY_N, REPLAY_SLO, np.float32),
                    REPLAY_SERVERS)
            kw = dict(join_t=join_t, leave_t=leave_t,
                      model_switching=scn == "churn_drift")
            live, sim, d = serving_vs_sim(*args, device=dev, **kw)
            _, cpu, _ = serving_vs_sim(*args, device="cpu", **kw)
            tol = SERVING_TOL[sched]
            ok = (d["d_completed"] == 0 and d["d_sr"] <= tol["sr"]
                  and d["d_thr_rel"] <= tol["thr_rel"]
                  and d["d_fwd"] <= tol["fwd"] and live.completed > 0)
            print(f"replay (b) {scn} {sched}: live sr {live.sr:.4f}, "
                  f"completed {live.completed}; deltas "
                  f"{ {k: round(v, 6) for k, v in d.items()} } "
                  f"{'within' if ok else 'OUTSIDE'} SERVING_TOL {tol}")
            if not ok:
                raise AssertionError(f"replay {scn} {sched} outside "
                                     f"SERVING_TOL")
            sim_compare(f"replay (b) {scn} {sched}", as_lane(sim),
                        as_lane(cpu))
    print(f"replay (b): 9 scenarios, card and CPU simulator halves, "
          f"{time.perf_counter() - t0:.1f} s")


def seg_inputs(n, samples, lanes):
    """run_sweep's arguments for (c)'s fleet of ``n`` devices, its first
    ``lanes`` seeds."""
    tier = np.arange(n) % 3
    profs = [DEVICE_PROFILES[SIM_TIERS[t]] for t in tier]
    lat = (np.array([p.latency for p in profs], np.float32)
           * np.random.default_rng(1).uniform(0.9, 1.1, n)
           ).astype(np.float32)
    servers = tuple(SERVER_PROFILES[x] for x in SIM_ENV_SERVERS)
    streams = synthetic.batched_device_streams(
        SEG_SEEDS[:lanes], n, samples, [p.accuracy for p in profs],
        [p.accuracy for p in servers])
    specs = [jaxsim.JaxSimSpec("multitasc++", n, samples,
                               model_switching=True)] * lanes
    kw = dict(tier_ids=tier, c_upper=[DEFAULT_C_UPPER[t] for t in SIM_TIERS])
    return (specs, streams, lat, np.full(n, SIM_SLO, np.float32),
            servers), kw


def seg_cpu_lane(n, samples):
    """The first lane of (c), segmented, through the port on the CPU (in a
    worker process); returns (metrics, wall s)."""
    torch.set_num_threads(1)
    args, kw = seg_inputs(n, samples, 1)
    t0 = time.perf_counter()
    out = jaxsim.run_sweep(*args, device="cpu", **kw)
    return out, time.perf_counter() - t0


def graph_replay_cost(args, kw, frontier_seg):
    """Kernels and device us of one replay of the engine's captured graph
    (GRAPH_TRIPS trips; finished lanes still run every kernel), under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    static, _, _, _, b, _ = jaxsim._prepare(
        *args, kw["tier_ids"], kw["c_upper"], None, None,
        frontier_seg=frontier_seg)
    eng = jaxsim._engine(static, b, "cuda")
    eng.graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.graph.replay()
        torch.cuda.synchronize()
    busy, launches, _ = _top_kernels(prof)
    return launches / jaxsim.GRAPH_TRIPS, busy / jaxsim.GRAPH_TRIPS * 1e6


def seg_path(dev, cpu_lane):
    """(c): the 5,000-device fleet segmented and flat on the card, equal
    but in n_events; lane 0 against the CPU."""
    args, kw = seg_inputs(SEG_N, SEG_S, len(SEG_SEEDS))
    static = jaxsim._static_of(args[0][0], len(args[4]), 0.05, SEG_N)
    print(f"segmented (c): {SEG_N} devices, n_pad {static.n_pad}, segment "
          f"width {static.seg} ({static.n_pad // static.seg} segments), "
          f"S={SEG_S}, B={len(SEG_SEEDS)}")
    if not static.seg:
        raise AssertionError("(c) did not take the segmented frontier")
    runs = {}
    for seg in (None, False):
        trips = jaxsim.stats.trips
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = jaxsim.run_sweep(*args, device=dev, frontier_seg=seg, **kw)
        wall = time.perf_counter() - t0
        trips = jaxsim.stats.trips - trips
        kernels, dev_us = graph_replay_cost(args, kw, seg)
        runs[seg] = out
        name = "segmented" if seg is None else "flat"
        print(sim_line(f"segmented (c) {name} frontier", out, wall, trips)
              + f"; one graph replay: {kernels:.1f} kernels a trip, "
              f"{dev_us:.2f} device us a trip")
    seg, flat = runs[None], runs[False]
    checks = {
        "finite metrics": all(np.isfinite(seg[k]).all()
                              for k in ("sr", "accuracy", "throughput")),
        "every sample completed, the queue drained":
            ((seg["completed"] == SEG_N * SEG_S)
             & (seg["queue_left"] == 0)).all(),
        "some forwarded, some local":
            ((seg["forwarded_frac"] > 0) & (seg["forwarded_frac"] < 1)).all(),
    }
    print(f"segmented (c): sr {np.round(seg['sr'], 3).tolist()}, accuracy "
          f"{np.round(seg['accuracy'], 4).tolist()}, forwarded_frac "
          f"{np.round(seg['forwarded_frac'], 4).tolist()}, completed "
          f"{seg['completed'].tolist()}, queue_peak "
          f"{seg['queue_peak'].tolist()}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"segmented (c) checks failed: {failed}")
    bad = [k for k in seg if k not in ("traces", "n_events")
           and not np.array_equal(seg[k], flat[k])]
    bad += [f"traces.{k}" for k in seg["traces"]
            if not np.array_equal(seg["traces"][k], flat["traces"][k],
                                  equal_nan=True)]
    print(f"segmented (c): segmented against flat on the card, every output "
          f"but n_events {'equal bit for bit' if not bad else bad}; "
          f"n_events {seg['n_events'].tolist()} against "
          f"{flat['n_events'].tolist()}; highest server index "
          f"{np.nanmax(seg['traces']['server_idx'], axis=1).tolist()}")
    if bad:
        raise AssertionError(f"segmented frontier differs from the flat one "
                             f"in {bad}")
    out, wall = cpu_lane.result()
    print(f"segmented (c): the port on the CPU, not the card (lane 0, one "
          f"thread in a worker process): wall {wall:.3f} s for "
          f"{int(out['n_events'].sum())} lane-events")
    sim_compare("segmented (c)", seg, out)


def transport_replay_seg_path(dev, ref_run, ref_counts):
    """Phase 7; returns the transport runs' launch counts."""
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        cpu_lane = pool.submit(seg_cpu_lane, SEG_N, SEG_S)
        counts = transport_path(dev, ref_run, ref_counts)
        ops.reset_launch_counts()
        replay_path(dev)
        seg_path(dev, cpu_lane)
        after = ops.launch_counts()
    print(f"replay (b) and segmented (c) launches: {after}")
    if any(after.values()):
        raise AssertionError(f"replay / segmented phases launched {after}")
    return counts


# ---------------------------------------------------------------------------
# phase 8: the sharded sweeps over torch.distributed, SHARD_RANKS ranks on
# the one card (a gloo world group: NCCL refuses two ranks on one GPU, and
# gloo carries CUDA tensors through the host)
# ---------------------------------------------------------------------------
SHARD_RANKS = 4
SHARD_GROUP_TIMEOUT_S = 300      # a collective nobody answers fails here
SHARD_JOIN_TIMEOUT_S = 900       # the parent's deadline for all ranks
# (b) runs phase 7c's first lane (S 3, seed 0) with its fleet cut from
# 5,000 devices to 500 (n_pad 512, a segment a rank): four ranks sharing
# one card spend 6-21 ms an event in the exchange through the host
# (PERF.md; an H100 80GB HBM3 at 700 W), so 10,000 devices' 30,085
# events took 244-624 s, 2,000 devices' 6,021 events 57 s and 1,000
# devices' 3,011 34-44 s, too long for the whole script's time limit
SHARD_N = 500
# tests/test_scale.py's rules for the device-sharded engine against the
# local segmented one: dynamics exact, the float sums over the ranks'
# partial sums within these relative tolerances
SHARD_EXACT = ("completed", "queue_left", "queue_peak", "sr", "throughput",
               "forwarded_frac", "per_device_sr", "per_device_acc",
               "final_thresh", "n_events")
SHARD_EXACT_TRACES = ("active", "server_idx", "fwd")
SHARD_ULP = {"accuracy": (1e-6, 0.0)}
SHARD_ULP_TRACES = {"thresh": (1e-5, 1e-5), "sr": (1e-5, 1e-5),
                    "acc": (1e-5, 1e-5)}


def shard_timed(dev_type, fn):
    """``fn()`` on every rank from a barrier: (result, wall s, the
    change in jaxsim.stats_snapshot())."""
    if dev_type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()
    before = jaxsim.stats_snapshot()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    after = jaxsim.stats_snapshot()
    return out, wall, {k: after[k] - before[k] for k in after}


def shard_rank(rank, rendezvous, out_dir, dev_type, work, args):
    """One rank: join the gloo world group through ``rendezvous``, build
    the mesh, run ``work(mesh, device, *args)``, and pickle its result to
    ``out_dir``, or the traceback and exit non-zero."""
    try:
        torch.set_num_threads(1)
        if dev_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "gloo", init_method=f"file://{rendezvous}",
            world_size=SHARD_RANKS, rank=rank,
            timeout=datetime.timedelta(seconds=SHARD_GROUP_TIMEOUT_S))
        mesh = make_sweep_mesh((SHARD_RANKS,), device_type=dev_type)
        result = work(mesh, torch.device(dev_type), *args)
        dist.destroy_process_group()
    except Exception:
        result = {"error": traceback.format_exc()}
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    if "error" in result:
        sys.exit(1)


def phase8_work(mesh, dev, sweep_s, seg_n):
    """A rank's share of phase 8: (a) (a)'s 9 lanes at ``sweep_s`` samples
    through run_sweep_sharded, (b) phase 7c's first lane (``seg_n`` devices)
    through run_device_sharded."""
    args, kw = sim_inputs("hetero", range(3 * len(SIM_SEEDS)), sweep_s)
    sweep = shard_timed(dev.type, lambda: jaxsim.run_sweep_sharded(
        *args, mesh=mesh, device=dev, **kw))
    (specs, streams, lat, slo, servers), kw = seg_inputs(seg_n, SEG_S, 1)
    fleet = shard_timed(dev.type, lambda: jaxsim.run_device_sharded(
        specs[0], streams, lat, slo, servers, mesh=mesh, device=dev, **kw))
    return {"sweep": sweep, "fleet": fleet}


def shard_ranks(dev_type, work, *args):
    """Spawn SHARD_RANKS ranks (torch.multiprocessing) running ``work``
    (a module-level function), rendezvousing through a file under build/;
    wait for them within SHARD_JOIN_TIMEOUT_S and return each rank's
    result and the wall. Any rank's failure raises here, and the others
    are stopped."""
    out = ROOT / "build" / "sharded"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ctx = torch_mp.get_context("spawn")
    procs = [ctx.Process(target=shard_rank,
                         args=(r, str(out / "rendezvous"), str(out),
                               dev_type, work, args))
             for r in range(SHARD_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + SHARD_JOIN_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs) and time.perf_counter() < \
                deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    results, failed = [], []
    for r, p in enumerate(procs):
        path = out / f"rank{r}.pkl"
        res = pickle.loads(path.read_bytes()) if path.exists() else {}
        if p.exitcode != 0 or "error" in res:
            failed.append((r, p.exitcode, res.get(
                "error", "no result: stopped or timed out")))
        results.append(res)
    if failed:
        # the ranks that failed on their own first (exit code 1), then those
        # stopped here or failing in a collective with them
        failed.sort(key=lambda f: (f[1] != 1, f[0]))
        raise AssertionError("sharded ranks failed: " + "\n".join(
            f"rank {r} (exit code {code}):\n{err}" for r, code, err in failed))
    return results, time.perf_counter() - t0


def shard_compare(got, ref, exact, exact_traces, tol, tol_traces):
    """``got`` against ``ref``: ``exact`` keys and traces bit for bit
    (NaN equal to NaN), the others within (rtol, atol)."""
    bad = [k for k in exact
           if not np.array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                 equal_nan=True)
           or np.asarray(got[k]).dtype != np.asarray(ref[k]).dtype]
    bad += [f"traces.{k}" for k in exact_traces
            if not np.array_equal(got["traces"][k], ref["traces"][k],
                                  equal_nan=True)]
    worst = {}
    for key, (rtol, atol) in list(tol.items()) + [
            (f"traces.{k}", v) for k, v in tol_traces.items()]:
        a = got["traces"][key[7:]] if key.startswith("traces.") else got[key]
        b = ref["traces"][key[7:]] if key.startswith("traces.") else ref[key]
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            bad.append(key)
            continue
        m = ~np.isnan(a)
        worst[key] = float(np.max(np.abs(a[m] - b[m])
                                  / np.maximum(np.abs(b[m]), 1e-30),
                                  initial=0.0))
        if not np.allclose(a[m], b[m], rtol=rtol, atol=atol):
            bad.append(f"{key} (rel {worst[key]:.3g})")
    return bad, worst


def sharded_path(dev, sweep_ref, sweep_s=SIM_S, seg_n=SHARD_N):
    """Phase 8: SHARD_RANKS ranks on the card. (a) run_sweep_sharded of
    (a)'s 9 lanes at ``sweep_s`` samples, every field on every rank equal
    to a run_sweep of them on the card bit for bit (the whole script
    passes phase 6's width-sweep run at SIM_WIDTH_S), 9 points counted
    as sharded; (b) run_device_sharded of phase 7c's first lane
    cut to ``seg_n`` devices, held to the same lane through the local
    segmented engine under tests/test_scale.py's rules. ``sweep_ref`` is
    (that run's result, its wall)."""
    results, spawn_wall = shard_ranks(dev.type, phase8_work, sweep_s, seg_n)
    hetero, h_wall = sweep_ref
    b = len(hetero["sr"])
    for r, res in enumerate(results):
        out, _, st = res["sweep"]
        bad, _ = shard_compare(out, hetero, tuple(k for k in hetero
                                                      if k != "traces"),
                               tuple(hetero["traces"]), {}, {})
        if bad or st["sharded_points"] != b:
            raise AssertionError(f"sharded (a) rank {r} differs from the "
                                 f"local run in {bad}, sharded_points "
                                 f"{st['sharded_points']}")
    walls = [res["sweep"][1] for res in results]
    trips = [res["sweep"][2]["trips"] for res in results]
    events = int(hetero["n_events"].sum())
    print(f"sharded (a) run_sweep_sharded of (a)'s lanes (N={SIM_N} "
          f"S={sweep_s}, B={b} padded to "
          f"{-(-b // SHARD_RANKS) * SHARD_RANKS}, {SHARD_RANKS} gloo ranks "
          f"on one card): every field on every rank equal bit for bit to "
          f"the local run_sweep, sharded_points {b}; wall "
          f"{max(walls):.3f} s (ranks {', '.join(f'{w:.3f}' for w in walls)})"
          f" against the local run's {h_wall:.3f} s; loop trips per rank "
          f"{trips} ({max(walls) / max(trips) * 1e6:.2f} us a trip); "
          f"{events} lane-events ({max(walls) / events * 1e6:.2f} us a "
          f"lane-event)")

    # (b)'s reference: the same lane through the local segmented engine
    args, kw = seg_inputs(seg_n, SEG_S, 1)
    trips = jaxsim.stats.trips
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    seg_out = jaxsim.run_sweep(*args, frontier_seg=True, device=dev, **kw)
    seg_wall = time.perf_counter() - t0
    seg_trips = jaxsim.stats.trips - trips
    lane0 = {k: v[0] for k, v in seg_out.items() if k != "traces"}
    lane0["traces"] = {k: v[0] for k, v in seg_out["traces"].items()}
    worst = {}
    for r, res in enumerate(results):
        out, _, st = res["fleet"]
        bad, worst = shard_compare(out, lane0, SHARD_EXACT,
                                   SHARD_EXACT_TRACES, SHARD_ULP,
                                   SHARD_ULP_TRACES)
        if bad or st["device_sharded_points"] != 1:
            raise AssertionError(f"sharded (b) rank {r} differs from the "
                                 f"local segmented lane in {bad}")
    out, _, st = results[0]["fleet"]
    walls = [res["fleet"][1] for res in results]
    coll_s = [res["fleet"][2]["collective_ns"] / 1e9 for res in results]
    n_ev = int(out["n_events"])
    print(f"sharded (b) run_device_sharded of phase 7c's lane 0 cut from "
          f"{SEG_N} to {seg_n} devices (n_pad "
          f"{-(-seg_n // (128 * SHARD_RANKS)) * 128 * SHARD_RANKS} over "
          f"{SHARD_RANKS} ranks, S={SEG_S}, seed {SEG_SEEDS[0]}): "
          f"{', '.join(SHARD_EXACT + SHARD_EXACT_TRACES)} equal bit for "
          f"bit on every rank, n_events {n_ev}; "
          f"{', '.join(f'{k} max rel {v:.3g}' for k, v in worst.items())}")
    print(f"sharded (b): wall {max(walls):.3f} s (ranks "
          f"{', '.join(f'{w:.3f}' for w in walls)}) against the local "
          f"segmented run's {seg_wall:.3f} s ({seg_trips} trips); "
          f"{st['trips']} loop trips, {n_ev} events, "
          f"{max(walls) / n_ev * 1e6:.2f} us an event; {st['collectives']} "
          f"collectives ({st['collectives'] / n_ev:.3f} an event), "
          f"{max(coll_s):.3f} s inside them on the slowest rank "
          f"({max(c / w for c, w in zip(coll_s, walls)):.4f} of the wall; "
          f"ranks {', '.join(f'{c:.3f}' for c in coll_s)} s)")
    print(f"sharded: {SHARD_RANKS} ranks spawned, run and joined in "
          f"{spawn_wall:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: the decoder zoo (MoE, dense GQA, Qwen2-VL's M-RoPE)
# ---------------------------------------------------------------------------
def zoo_expected_launches(cfg, steps):
    """One flash launch an attention layer at the prefill, one decode
    launch an attention layer a step, one BvSB launch a call."""
    n = sum(kind in ("attn", "lattn") for kind in cfg.pattern)
    return {**NO_LAUNCHES, "bvsb": 1 + steps, "flash_attention": n,
            "decode_attention": n * steps}


def zoo_inputs(cfg, dev, b, n_text, n_embeds, seed):
    """(tokens (B, n_text), and for the VLM vision embeddings, for the
    encoder-decoder audio frame embeddings, (B, n_embeds, d) from a
    generator on ``dev``, else None)."""
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n_text)),
                             device=dev)
    if cfg.family != "vlm" and not cfg.is_encoder_decoder:
        return tokens, None
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tokens, torch.randn(b, n_embeds, cfg.d_model, generator=gen,
                               device=dev)


def moe_hooks(model, fn):
    """Forward hooks on every MoE sublayer of ``model``: ``fn(module,
    input)`` of each call, appended to a list per layer index. Returns
    (that dict, the hooks' handles)."""
    out = {}

    def hook(i):
        return lambda mod, args, _: out.setdefault(i, []).append(
            fn(mod, args[0]))
    handles = [layer.moe.register_forward_hook(hook(i))
               for i, layer in enumerate(model.layers)
               if hasattr(layer, "moe")]
    return out, handles


def moe_dropped(cfg):
    """``fn`` for ``moe_hooks``: the call's assignments dropped at the
    capacity, as a tensor on the call's device."""
    def count(mod, x):
        n = x.shape[0] * x.shape[1]
        _, ids, _ = moe.route(x.reshape(n, -1), mod.router, cfg)
        return (~moe.dispatch(ids, cfg.num_experts,
                              moe.capacity(n, cfg))[2]).sum()
    return count


def zoo_model(dev, name, layers, steps, cfg=None):
    """One zoo model (``cfg``, by default ``name``'s config) through the
    serving entry points: random weights drawn on the card,
    ``make_prefill_step`` on ZOO_B prompts of ZOO_S positions, then
    ``steps`` ``make_serve_step`` decode steps feeding back each top-1, the
    launch counters read around them; for MoE a second prefill, bitwise
    equal to the first, counting the drops; a profiled rerun; the card
    against the CPU. Returns (launch counts, walls)."""
    cfg = cfg or get_config(name)
    cfg = cfg if layers is None else cfg.with_(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    cut = "" if layers is None else \
        f" (depth cut from {get_config(name).num_layers})"
    if cfg.logit_soft_cap:
        cut += f", attention soft cap {cfg.logit_soft_cap:g}"
    print(f"{name}: {cfg.num_layers} layers{cut}, {cfg.param_count()} "
          f"parameters (param_count; {cfg.active_param_count()} active), "
          f"{weights_gb:.3f} GB float32 with the padded vocab, drawn on the "
          f"card in {init_s:.3f} s")
    v = ZOO_VISION if cfg.family == "vlm" else 0
    tokens, vision = zoo_inputs(cfg, dev, ZOO_B, ZOO_S - v, v, 4)
    cache_len = ZOO_S + steps
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    conf, top1, cache = prefill(tokens, cache_len, vision)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    confs, tops = [conf], [top1]
    pos = torch.full((ZOO_B,), ZOO_S, device=dev)
    t0 = time.perf_counter()
    for i in range(steps):
        conf, top1, cache = serve(top1[:, None], cache, pos + i)
        confs.append(conf)
        tops.append(top1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del cache
    want = zoo_expected_launches(cfg, steps)
    confs, tops = torch.stack(confs), torch.stack(tops)
    what = f"{v} vision embeddings + {ZOO_S - v} tokens" if v else \
        f"{ZOO_S} tokens"
    print(f"{name} prefill of {ZOO_B} x ({what}), cache of {cache_len} "
          f"slots: wall {prefill_s:.3f} s on the card")
    print(f"{name} decode of {steps} steps at B={ZOO_B}: wall {decode_s:.3f} "
          f"s on the card ({decode_s / steps * 1e3:.2f} ms per step)")
    print(f"{name} path: peak device memory {peak_gb:.3f} GB; launches "
          f"{counts} (expected {want}); conf range "
          f"[{float(confs.min()):.3g}, {float(confs.max()):.3g}]")
    checks = {
        "launches": counts == want,
        "finite confidences": bool(torch.isfinite(confs).all()),
        "top-1 in the vocab": bool(((tops >= 0)
                                    & (tops < cfg.vocab_size)).all()),
        "shapes": confs.shape == tops.shape == (steps + 1, ZOO_B),
    }
    if cfg.is_moe:
        drops, handles = moe_hooks(model, moe_dropped(cfg))
        try:
            conf2, top2, _ = prefill(tokens, cache_len, vision)
        finally:
            for h in handles:
                h.remove()
        same = torch.equal(conf2, confs[0]) and torch.equal(top2, tops[0])
        checks["a second prefill bitwise equal"] = same
        n = ZOO_B * ZOO_S
        print(f"{name} prefill: assignments dropped at the capacity "
              f"({moe.capacity(n, cfg)} rows an expert) per MoE layer, of "
              f"{n * cfg.num_experts_per_tok}: "
              f"{[int(d[0]) for _, d in sorted(drops.items())]}; a second "
              f"prefill {'bitwise equal' if same else 'DIFFERS'}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} path checks failed: {failed}")
    profile_serving(name, prefill, serve, (tokens, cache_len, vision),
                    tops[0], pos, prefill_s, decode_s / steps)
    zoo_check_cpu(model, dev)
    return counts, dict(params=cfg.param_count(), init_s=init_s,
                        prefill_s=prefill_s, step_ms=decode_s / steps * 1e3,
                        peak_gb=peak_gb)


def zoo_check_cpu(model, dev):
    """ZOO_CHECK_LAYERS layers of the same weights at full width, card
    against CPU: a prefill of ZOO_CHECK_B x ZOO_CHECK_S (Qwen2-VL: as many
    vision embeddings, then the tokens) and ZOO_CHECK_STEPS decode steps,
    each fed the card's top-1. BvSB within CLASSIFY_CONF_ATOL; top-1 equal
    wherever the CPU's top-2 logit gap exceeds TOP2_GAP. MoE: on every
    call, the card's routing of its own input equals the CPU's of its own
    wherever the CPU's k-th and (k+1)-th router probabilities lie more than
    ROUTE_GAP apart; a prompt with a token routed otherwise (a near tie,
    counted) is left out of the BvSB and top-1 comparison. Each MoE layer
    also runs on the CPU's prefill input on both sides: outputs within
    MOE_ATOL on the tokens whose routing and kept assignments agree, and
    two card calls bitwise equal."""
    cfg = model.cfg.with_(num_layers=ZOO_CHECK_LAYERS)
    card = build_model(cfg, device=dev)
    card.load_state_dict(model.state_dict(), strict=False)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    table, b, k, d = cpu.head_table, ZOO_CHECK_B, cfg.num_experts_per_tok, \
        cfg.d_model
    v = ZOO_CHECK_S if cfg.family == "vlm" else 0
    tokens, vision = zoo_inputs(cfg, "cpu", b, ZOO_CHECK_S, v, 5)
    n_pos = v + ZOO_CHECK_S
    t0 = time.perf_counter()
    (card_in, card_h), (cpu_in, cpu_h) = (
        moe_hooks(m, lambda mod, x: x.detach().clone()) for m in (card, cpu))
    steps = []
    try:
        prefill, serve = make_prefill_step(card), make_serve_step(card)
        conf, top1, cache = prefill(
            tokens.to(dev), n_pos + ZOO_CHECK_STEPS,
            None if vision is None else vision.to(dev))
        with torch.inference_mode():
            hidden, ccache = cpu(tokens, vision_embeds=vision,
                                 collect_cache=True,
                                 cache_len=n_pos + ZOO_CHECK_STEPS,
                                 return_hidden=True)
        for i in range(ZOO_CHECK_STEPS + 1):
            with torch.inference_mode():
                cconf, ctop1 = head_bvsb(hidden[:, -1:], table,
                                         cfg.vocab_size)
                top2 = torch.topk(hidden[:, -1] @ table.T, 2, dim=-1).values
            steps.append((conf.cpu(), cconf, top1.cpu(), ctop1,
                          top2[:, 0] - top2[:, 1]))
            if i == ZOO_CHECK_STEPS:
                break
            pos = torch.full((b,), n_pos + i)
            tok = top1.cpu()[:, None]
            conf, top1, cache = serve(tok.to(dev), cache, pos.to(dev))
            with torch.inference_mode():
                hidden, ccache = cpu.decode_step(tok, ccache, pos,
                                                 return_hidden=True)
    finally:
        for h in card_h + cpu_h:
            h.remove()
    # routing, call by call, each side on its own inputs
    unsure = torch.zeros(b, dtype=torch.bool)
    near, routed = 0, True
    for layer in sorted(cpu_in):
        for xc, xk in zip(card_in[layer], cpu_in[layer]):
            with torch.inference_mode():
                ids_c = moe.route(xc.reshape(-1, d),
                                  card.layers[layer].moe.router, cfg)[1].cpu()
                _, ids_k, probs = moe.route(xk.reshape(-1, d),
                                            cpu.layers[layer].moe.router, cfg)
            srt = probs.sort(dim=-1, descending=True).values
            clear = srt[:, k - 1] - srt[:, k] > ROUTE_GAP
            near += int((~clear).sum())
            routed &= bool((ids_c.sort(-1).values == ids_k.sort(-1).values)
                           .all(-1)[clear].all())
            unsure |= (ids_c != ids_k).any(-1).view(b, -1).any(-1)
    # each MoE layer on the same input, card against CPU
    moe_err, repeat, agreed, n = 0.0, True, 0, b * n_pos
    for layer in sorted(cpu_in):
        x = cpu_in[layer][0]
        pk, pc = cpu.layers[layer].moe, card.layers[layer].moe
        with torch.inference_mode():
            y_cpu = moe.moe_apply(pk, x, cfg).reshape(n, d)
            y_card = moe.moe_apply(pc, x.to(dev), cfg)
            repeat &= torch.equal(y_card, moe.moe_apply(pc, x.to(dev), cfg))
            ids = [moe.route(x.to(m_dev).reshape(n, d), m.router, cfg)[1]
                   for m, m_dev in ((pk, "cpu"), (pc, dev))]
            keeps = [moe.dispatch(i, cfg.num_experts, moe.capacity(n, cfg))
                     [2].cpu().view(n, k) for i in ids]
        agree = (ids[0] == ids[1].cpu()).all(-1) & (keeps[0] == keeps[1]) \
            .all(-1)
        agreed += int(agree.sum())
        moe_err = max(moe_err, max_err(y_card.reshape(n, d).cpu()[agree],
                                       y_cpu[agree]))
    rows = ~unsure
    errs, same, clear_rows = [], True, 0
    for conf_c, cconf, top_c, ctop, gap in steps:
        errs.append(max_err(conf_c[rows], cconf[rows]) if rows.any() else 0.0)
        clear = (gap > TOP2_GAP) & rows
        same &= torch.equal(top_c[clear], ctop[clear])
        clear_rows += int(clear.sum())
    name, n_moe = cfg.name, len(cpu_in)
    print(f"{name} {ZOO_CHECK_LAYERS} layers at full width, prefill {b} x "
          f"{n_pos} positions + {ZOO_CHECK_STEPS} decode steps, card vs CPU: "
          f"max|conf err| {max(errs):.3g} (atol {CLASSIFY_CONF_ATOL:g}) on "
          f"{int(rows.sum())}/{b} prompts, top-1 equal on {clear_rows}/"
          f"{b * (ZOO_CHECK_STEPS + 1)} rows with top-2 gap > {TOP2_GAP:g}: "
          f"{same} ({time.perf_counter() - t0:.1f} s)")
    if n_moe:
        print(f"{name} {n_moe} MoE layers, card vs CPU: routing ids equal "
              f"where the k-th / (k+1)-th gap > {ROUTE_GAP:g}: {routed}; "
              f"{near} near-tie token calls; same input: max|err| "
              f"{moe_err:.3g} (atol {MOE_ATOL:g}) on {agreed}/{n * n_moe} "
              f"tokens routed and kept alike; two card calls "
              f"{'bitwise equal' if repeat else 'DIFFER'}")
    if not (max(errs) <= CLASSIFY_CONF_ATOL and same and rows.any()
            and routed and moe_err <= MOE_ATOL and repeat):
        raise AssertionError(f"{name} on the card disagrees with the CPU")


def zoo_path(dev):
    """Phase 9: each of ZOO_MODELS in turn, freed before the next. Returns
    (launch counts summed over the models, each model's walls)."""
    total, walls = {}, {}
    for name, layers, steps in ZOO_MODELS:
        counts, walls[name] = zoo_model(dev, name, layers, steps)
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        torch.cuda.empty_cache()
    return total, walls


def dispatch_forms(dev):
    """The MoE dispatch's scan in two forms, in turns, at granite's and
    deepseek's prefill of ZOO_B x ZOO_S tokens: JAX's ``cumsum`` down the
    (N k, E) one-hot ("column") and ``moe.dispatch`` ("row")."""
    for name in ("granite-moe-1b-a400m", "deepseek-moe-16b"):
        cfg = get_config(name)
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        n = ZOO_B * ZOO_S
        cap = moe.capacity(n, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        ids = torch.randint(0, e, (n, k), generator=gen, device=dev)
        flat = ids.reshape(-1)

        def column():
            return torch.gather(F.one_hot(flat, e).cumsum(0) - 1, 1,
                                flat[:, None])[:, 0]

        def row():
            return moe.dispatch(ids, e, cap)

        _, rows, keep = row()
        if not torch.equal(rows, torch.where(keep, column(), 0)):
            raise AssertionError(f"{name}: the two scans give other rows")
        times = [(form, time_ms(fn)[0])
                 for form, fn in (("column", column), ("row", row),
                                  ("row", row), ("column", column))]
        print(f"{name} dispatch of {n} x {k} assignments over {e} experts, "
              "device ms in turns (column: JAX's cumsum down the one-hot; "
              "row: moe.dispatch): "
              + "; ".join(f"{form} {ms:.4f}" for form, ms in times))


# ---------------------------------------------------------------------------
# phase 10: the rest of the zoo (xLSTM-350M, SeamlessM4T-medium)
# ---------------------------------------------------------------------------
def zoo10_expected_launches(cfg, steps):
    """xLSTM: one BvSB launch a call and nothing else (its cells are plain
    PyTorch, as the JAX package runs them through XLA). The
    encoder-decoder: one flash launch an encoder layer and two a decoder
    layer (self and cross) at the prefill, two decode launches a decoder
    layer a step (self and cross), one BvSB launch a call."""
    want = {**NO_LAUNCHES, "bvsb": 1 + steps}
    if cfg.is_encoder_decoder:
        want.update(flash_attention=cfg.encoder_layers + 2 * cfg.num_layers,
                    decode_attention=2 * cfg.num_layers * steps)
    return want


def cell_loop_walls(model, dev, b, s):
    """Wall seconds of one mLSTM and one sLSTM layer of ``model`` over (B,
    S) positions on the card: the chunk loop against the sequential
    position loop."""
    cfg = model.cfg
    x = torch.randn(b, s, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9))
    walls = {}
    with torch.inference_mode():
        for layer in model.layers[:2]:
            block = xlstm.mlstm_block if layer.kind == "mlstm" \
                else xlstm.slstm_block
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            block(getattr(layer, layer.kind), x, cfg)
            torch.cuda.synchronize()
            walls[layer.kind] = time.perf_counter() - t0
    return walls


def zoo10_model(dev, name):
    """One model at full width and depth through the serving entry points:
    random weights drawn on the card, ``make_prefill_step`` (seamless over
    its audio frames), ``make_serve_step`` decode steps feeding back each
    top-1, the launch counters read around them; a profiled rerun; the
    card against the CPU. Returns (launch counts, walls)."""
    cfg = get_config(name)
    seam = cfg.is_encoder_decoder
    b, s, steps = (SEAM_B, SEAM_S, SEAM_STEPS) if seam else \
        (XLSTM_B, XLSTM_S, XLSTM_STEPS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    layout = f"{cfg.encoder_layers} encoder + {cfg.num_layers} decoder" \
        if seam else f"{cfg.num_layers} ({'/'.join(cfg.layer_pattern)})"
    print(f"{name}: {layout} layers, full width and depth, {n_params} "
          f"parameters with the padded vocab ({cfg.param_count()} by "
          f"param_count), {weights_gb:.3f} GB float32, drawn on the card in "
          f"{init_s:.3f} s")
    tokens, audio = zoo_inputs(cfg, dev, b, s, SEAM_FRAMES, 6)
    cache_len = SEAM_CACHE if seam else None
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    conf, top1, cache = prefill(tokens, cache_len, audio_embeds=audio)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    confs, tops = [conf], [top1]
    pos = torch.full((b,), s, device=dev)
    t0 = time.perf_counter()
    for i in range(steps):
        conf, top1, cache = serve(top1[:, None], cache, pos + i)
        confs.append(conf)
        tops.append(top1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = zoo10_expected_launches(cfg, steps)
    confs, tops = torch.stack(confs), torch.stack(tops)
    if seam:
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache_ok = all(
            c["cross"][0].shape == (b, SEAM_FRAMES, kv, hd)
            and c["cross"][0].dtype == torch.float32
            and c["self"]["k"].shape == (b, SEAM_CACHE, kv, hd)
            for c in cache)
        what = f"{SEAM_FRAMES} audio frames + {s} tokens, self rings of " \
            f"{SEAM_CACHE} slots"
    else:
        cache_ok = all(t.dtype == torch.float32 and bool(torch.isfinite(t)
                                                         .all())
                       for c in cache for t in c.values())
        what = f"{s} tokens"
    del cache
    print(f"{name} prefill of {b} x ({what}): wall {prefill_s:.3f} s on the "
          "card")
    print(f"{name} decode of {steps} steps at B={b}: wall {decode_s:.3f} s "
          f"on the card ({decode_s / steps * 1e3:.2f} ms per step)")
    print(f"{name} path: peak device memory {peak_gb:.3f} GB; launches "
          f"{counts} (expected {want}); conf range "
          f"[{float(confs.min()):.3g}, {float(confs.max()):.3g}]")
    checks = {
        "launches": counts == want,
        "finite confidences": bool(torch.isfinite(confs).all()),
        "top-1 in the vocab": bool(((tops >= 0)
                                    & (tops < cfg.vocab_size)).all()),
        "shapes": confs.shape == tops.shape == (steps + 1, b),
        "cache": cache_ok,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} path checks failed: {failed}")
    if seam:
        profile_serving(name, prefill, serve, (tokens, cache_len, None,
                                               audio),
                        tops[0], pos, prefill_s, decode_s / steps)
    else:
        walls = cell_loop_walls(model, dev, b, s)
        print(f"{name} cells over {b} x {s} positions, one layer each: "
              f"mLSTM (chunks of {xlstm.CHUNK}) {walls['mlstm']:.4f} s, "
              f"sLSTM (one step a position) {walls['slstm']:.4f} s, "
              f"{walls['slstm'] / s * 1e6:.1f} us a position")
        short = tokens[:, :XLSTM_PROFILE_S]
        t0 = time.perf_counter()
        _, top_short, _ = prefill(short)
        torch.cuda.synchronize()
        profile_serving(f"{name} (prefill of {XLSTM_PROFILE_S} tokens)",
                        prefill, serve, (short,), top_short,
                        torch.full((b,), XLSTM_PROFILE_S, device=dev),
                        time.perf_counter() - t0, decode_s / steps)
    zoo10_check_cpu(model, dev)
    return counts, dict(params=cfg.param_count(), init_s=init_s,
                        prefill_s=prefill_s,
                        step_ms=decode_s / steps * 1e3, peak_gb=peak_gb)


def _rel_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def zoo10_check_cpu(model, dev):
    """The same weights at full width, cut in depth, card against CPU: a
    prefill (xLSTM: XLSTM_CHECK_B x XLSTM_CHECK_S tokens, its first mLSTM
    and sLSTM layer; seamless: 2 + 2 layers over SEAM_CHECK_FRAMES frames,
    prompts of SEAM_CHECK_S tokens) and ZOO10_CHECK_STEPS decode steps,
    each fed the card's top-1. BvSB within CLASSIFY_CONF_ATOL; top-1 equal
    wherever the CPU's top-2 logit gap exceeds TOP2_GAP; a second card
    prefill bitwise equal to the first (confidences, top-1 and the whole
    cache); for xLSTM the states after the prefill (mLSTM C, n; sLSTM h,
    c, n, m) within STATE_RTOL of the CPU's."""
    cfg = model.cfg
    seam = cfg.is_encoder_decoder
    if seam:
        cut = cfg.with_(num_layers=SEAM_CHECK_LAYERS,
                        encoder_layers=SEAM_CHECK_LAYERS)
        b, s, frames = SEAM_CHECK_B, SEAM_CHECK_S, SEAM_CHECK_FRAMES
    else:
        cut = cfg.with_(num_layers=XLSTM_CHECK_LAYERS)
        b, s, frames = XLSTM_CHECK_B, XLSTM_CHECK_S, 0
    steps = ZOO10_CHECK_STEPS
    card = build_model(cut, device=dev)
    keys = set(card.state_dict())
    card.load_state_dict({k: v for k, v in model.state_dict().items()
                          if k in keys})
    cpu = build_model(cut, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    tokens, audio = zoo_inputs(cut, "cpu", b, s, frames, 7)
    extra = {} if audio is None else {"audio_embeds": audio}
    cache_len = s + steps if seam else None
    t0 = time.perf_counter()
    prefill, serve = make_prefill_step(card), make_serve_step(card)

    def card_prefill():
        return prefill(tokens.to(dev), cache_len, audio_embeds=None
                       if audio is None else audio.to(dev))

    def leaves(cache):
        return [t for c in cache for t in (
            [*c["self"].values(), *c["cross"]] if seam else c.values())]
    conf, top1, cache = card_prefill()
    conf2, top1_2, cache2 = card_prefill()
    repeat = torch.equal(bits(conf), bits(conf2)) and \
        torch.equal(top1, top1_2) and all(
            torch.equal(x, y) for x, y in zip(leaves(cache), leaves(cache2)))
    del cache2
    with torch.inference_mode():
        hidden, ccache = cpu(tokens, collect_cache=True, cache_len=cache_len,
                             return_hidden=True, **extra)
    state_err = 0.0 if seam else max(
        _rel_err(c[k], cc[k]) for c, cc in zip(cache, ccache) for k in c)
    table = cpu.head_table
    errs, same, clear_rows = [], True, 0
    for i in range(steps + 1):
        with torch.inference_mode():
            cconf, ctop1 = head_bvsb(hidden[:, -1:], table, cfg.vocab_size)
            top2 = torch.topk(hidden[:, -1] @ table.T, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > TOP2_GAP
        errs.append(max_err(conf.cpu(), cconf))
        same &= torch.equal(top1.cpu()[clear], ctop1[clear])
        clear_rows += int(clear.sum())
        if i == steps:
            break
        pos = torch.full((b,), s + i)
        tok = top1.cpu()[:, None]
        conf, top1, cache = serve(tok.to(dev), cache, pos.to(dev))
        with torch.inference_mode():
            hidden, ccache = cpu.decode_step(tok, ccache, pos,
                                             return_hidden=True)
    what = f"{SEAM_CHECK_LAYERS} + {SEAM_CHECK_LAYERS} layers, {b} x " \
        f"{frames} frames and {s} tokens" if seam else \
        f"{XLSTM_CHECK_LAYERS} layers ({'/'.join(cut.pattern)}), {b} x {s} " \
        "tokens"
    states = "" if seam else f", states after the prefill max rel err " \
        f"{state_err:.3g} (rtol {STATE_RTOL:g})"
    print(f"{cfg.name} {what} at full width + {steps} decode steps, card vs "
          f"CPU: max|conf err| {max(errs):.3g} (atol {CLASSIFY_CONF_ATOL:g}),"
          f" top-1 equal on {clear_rows}/{b * (steps + 1)} rows with top-2 "
          f"gap > {TOP2_GAP:g}: {same}{states}; a second card prefill "
          f"{'bitwise equal' if repeat else 'DIFFERS'} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not (max(errs) <= CLASSIFY_CONF_ATOL and same and repeat
            and state_err <= STATE_RTOL):
        raise AssertionError(f"{cfg.name} on the card disagrees with the "
                             "CPU")


def zoo10_path(dev):
    """Phase 10: xlstm-350m, then seamless-m4t-medium, each freed before
    the next. Returns (launch counts summed over both, each one's
    walls)."""
    total, walls = {}, {}
    for name in (XLSTM_ARCH, SEAM_ARCH):
        counts, walls[name] = zoo10_model(dev, name)
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        torch.cuda.empty_cache()
    return total, walls


def zoo10_rows(timer):
    """Phase 3's timing rows at phase 10's shapes: seamless's flash forms
    (encoder T = S non-causal, decoder self causal, cross S over T
    non-causal), its decode (self ring, and the cross K/V in f32 and in
    bf16 under an f32 query) and both models' BvSB heads."""
    cfg = get_config(SEAM_ARCH)
    kv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.resolved_head_dim
    return {
        "flash_attention": {
            "encoder": timer.flash(SEAM_ARCH, SEAM_B, SEAM_FRAMES,
                                   causal=False, form=" encoder"),
            "decoder self": timer.flash(SEAM_ARCH, SEAM_B, SEAM_S,
                                        form=" decoder self"),
            "cross (T != S)": timer.flash(SEAM_ARCH, SEAM_B, SEAM_S,
                                          t=SEAM_FRAMES, causal=False,
                                          form=" cross")},
        "decode_attention": {
            "self": timer.decode_at(f"{SEAM_ARCH} self", SEAM_B, SEAM_CACHE,
                                    kv, g, hd),
            "cross": timer.decode_at(f"{SEAM_ARCH} cross", SEAM_B,
                                     SEAM_FRAMES, kv, g, hd),
            "cross f32 q over bf16": timer.decode_at(
                f"{SEAM_ARCH} cross", SEAM_B, SEAM_FRAMES, kv, g, hd,
                cache_dt=torch.bfloat16)},
        "bvsb": {arch: timer.bvsb_rows(
            n, common.padded_vocab(get_config(arch).vocab_size), arch)
            for arch, n in ((XLSTM_ARCH, XLSTM_B), (SEAM_ARCH, SEAM_B))},
    }


def zoo_only(dev, timer):
    """``chip_smoke.py zoo``: phase 3's attention and BvSB checks and its
    zoo timing rows (phases 9 and 10), the dispatch's two forms, then
    phases 9 and 10."""
    t0 = time.perf_counter()
    check_bvsb(dev)
    check_flash(dev)
    check_decode(dev)
    for name, _, _ in ZOO_MODELS:
        cfg = get_config(name)
        kv = cfg.num_kv_heads
        timer.flash(name, ZOO_B, ZOO_S)
        timer.decode_at(name, ZOO_B, ZOO_S, kv, cfg.num_heads // kv,
                        cfg.resolved_head_dim)
    zoo10_rows(timer)
    dispatch_forms(dev)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    zoo_path(dev)
    t2 = time.perf_counter()
    zoo10_path(dev)
    print(f"phase seconds: checks, timing rows and dispatch forms "
          f"{t1 - t0:.1f}, zoo {t2 - t1:.1f}, rest of the zoo "
          f"{time.perf_counter() - t2:.1f}")
    return 0


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------
class PairData:
    """examples/serve_cascade.py's task: batches of PAIR_BS sequences from
    the classification stream, the label at the last position (-100
    elsewhere)."""

    def __init__(self):
        self.toks, self.labels = classification_stream(
            PAIR_N, SEQ, PAIR_VOCAB, PAIR_CLASSES, 0)

    def batch_at(self, step, bs=PAIR_BS):
        i = (step * bs) % (len(self.toks) - bs)
        lbl = np.full((bs, SEQ), -100, np.int32)
        lbl[:, -1] = self.labels[i:i + bs]
        return {"tokens": self.toks[i:i + bs], "labels": lbl}


def _attn_layers(cfg):
    """Attention calls a forward makes: an encoder-decoder's encoder layers
    and its decoder layers twice (self and cross)."""
    if cfg.is_encoder_decoder:
        return cfg.encoder_layers + 2 * cfg.num_layers
    return sum(kind in ("attn", "lattn") for kind in cfg.pattern)


@contextlib.contextmanager
def flash_form_counts():
    """Tally ``ops.flash_attention`` calls by form while the block runs:
    "causal" (T = S), "non-causal" (T = S) and "cross" (non-causal over
    T != S keys)."""
    real, tally = ops.flash_attention, {}

    def counted(q, k, v, *a, causal=True, **kw):
        form = "causal" if causal else (
            "non-causal" if q.shape[1] == k.shape[1] else "cross")
        tally[form] = tally.get(form, 0) + 1
        return real(q, k, v, *a, causal=causal, **kw)
    ops.flash_attention = counted
    try:
        yield tally
    finally:
        ops.flash_attention = real


def train_expected_launches(cfg, steps, remat):
    """A training step launches one flash forward an attention layer (two
    with remat: the forward and its recompute) and one flash backward; an
    RG-LRU layer one scan forward (two with remat) and one scan backward;
    nothing else."""
    n, r = _attn_layers(cfg), cfg.pattern.count("rglru")
    fwd = 2 if remat else 1
    return {**NO_LAUNCHES,
            "flash_attention": fwd * n * steps, "flash_attention_bwd": n * steps,
            "rglru_scan": fwd * r * steps, "rglru_scan_bwd": r * steps}


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def pair_path(dev):
    """(a): tier-server-fast trained PAIR_STEPS steps through
    ``trainer.train`` (remat off, as the example), then tier-low distilled
    from it through ``make_distill_step``. The heavy model's loss falls,
    the light model's kd falls, and the launches are the expected ones
    (the teacher's forward under no_grad: the forward kernel alone)."""
    heavy_cfg = get_config("tier-server-fast").with_(vocab_size=PAIR_VOCAB)
    light_cfg = get_config("tier-low").with_(vocab_size=PAIR_VOCAB)
    data = PairData()
    heavy = init_model(heavy_cfg, 0, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, hist = train(heavy, data, PAIR_STEPS, TrainConfig(
        adamw=opt.AdamWConfig(lr=3e-3, total_steps=PAIR_STEPS,
                              warmup_steps=10),
        remat=False, log_every=20), verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    heavy_counts = ops.launch_counts()

    light = init_model(light_cfg, 7, device=dev)
    step = make_distill_step(light, heavy, DistillConfig())
    state = opt.init(trainable(light))
    ops.reset_launch_counts()
    kds = []
    t0 = time.perf_counter()
    for i in range(PAIR_STEPS):
        state, m = step(state, data.batch_at(i))
        kds.append(float(m["kd"]))
    distill_s = time.perf_counter() - t0
    distill_counts = ops.launch_counts()

    with torch.no_grad():
        batch = to_device(data.batch_at(0, bs=512), dev)
        pred = heavy(batch["tokens"])[0][:, -1, :PAIR_VOCAB].argmax(-1)
        acc = float((pred == batch["labels"][:, -1]).float().mean())
    want_heavy = train_expected_launches(heavy_cfg, PAIR_STEPS, False)
    want_distill = train_expected_launches(light_cfg, PAIR_STEPS, False)
    want_distill["flash_attention"] += _attn_layers(heavy_cfg) * PAIR_STEPS
    losses = [r["loss"] for r in hist]
    trail = " -> ".join("%.4f" % x for x in losses)
    print(f"training (a) tier-server-fast: {PAIR_STEPS} steps of "
          f"{PAIR_BS} x {SEQ}, loss {trail}"
          f", {train_s * 1e3 / PAIR_STEPS:.2f} ms a step, accuracy on 512 "
          f"training samples {acc:.3f}; launches {heavy_counts}")
    print(f"training (a) tier-low distilled: kd {kds[0]:.4f} -> "
          f"{kds[-1]:.4f} (mean of the first / last 5: "
          f"{np.mean(kds[:5]):.4f} / {np.mean(kds[-5:]):.4f}), "
          f"{distill_s * 1e3 / PAIR_STEPS:.2f} ms a step; launches "
          f"{distill_counts}")
    checks = {
        "heavy loss falls": losses[-1] < losses[0],
        "light kd falls": np.mean(kds[-5:]) < np.mean(kds[:5]),
        "finite": bool(np.isfinite(losses).all() and np.isfinite(kds).all()),
        "heavy launches": heavy_counts == want_heavy,
        "distill launches": distill_counts == want_distill,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"training (a) checks failed: {failed}")
    return _add_counts(dict(heavy_counts), distill_counts), dict(
        step_ms=train_s * 1e3 / PAIR_STEPS,
        distill_ms=distill_s * 1e3 / PAIR_STEPS, loss=losses, kd=kds)


def lm_train_path(dev, tag, cfg, b, s, steps, seed, frames=None,
                  profiled=True):
    """``steps`` steps of ``launch.distributed.make_train_step`` (remat) on
    ``cfg`` at full width, B x S tokens of ``SyntheticLM`` (and an
    encoder-decoder's B x ``frames`` seeded audio frame embeddings),
    weights drawn on the card: finite losses, the first near ln(vocab),
    the expected launches (flash's forward also by form, each form's
    calls twice its layers a step with the recompute), peak memory at most
    TRAIN_PEAK_GB; then, where ``profiled``, a profiled step for the
    device's idle share."""
    t0 = time.perf_counter()
    model = init_model(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    data = SyntheticLM(DataConfig(cfg.vocab_size, s, b, seed=seed),
                       device=dev)
    batches = [data.batch_at(i) for i in range(steps)]
    if cfg.is_encoder_decoder:
        gen = torch.Generator(device=dev).manual_seed(seed)
        for batch in batches:
            batch["audio_embeds"] = torch.randn(b, frames, cfg.d_model,
                                                generator=gen, device=dev)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    step = make_train_step(model, remat=True, adamw=opt.AdamWConfig(
        warmup_steps=2, total_steps=steps))
    state = opt.init(trainable(model))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    walls, rows = [], []
    with flash_form_counts() as forms:
        for batch in batches:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rows.append({k: float(v) for k, v in m.items()})
    counts = ops.launch_counts()
    if cfg.is_encoder_decoder:
        want_forms = {"non-causal": 2 * cfg.encoder_layers * steps,
                      "causal": 2 * cfg.num_layers * steps,
                      "cross": 2 * cfg.num_layers * steps}
    else:
        want_forms = {"causal": 2 * _attn_layers(cfg) * steps} \
            if _attn_layers(cfg) else {}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = train_expected_launches(cfg, steps, True)
    step_s = float(np.mean(walls[1:])) if steps > 1 else walls[0]
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, batches[0])
            torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
        busy, launches, top = _top_kernels(prof)
    ln_v = float(np.log(cfg.vocab_size))
    first_ce = ln_v + cfg.init_scale ** 2 * TRUNC_VAR * cfg.d_model / 2
    losses = ", ".join("%.4f" % r["loss"] for r in rows)
    norms = ", ".join("%.4g" % r["grad_norm"] for r in rows)
    ms = ", ".join("%.1f" % (w * 1e3) for w in walls)
    print(f"training ({tag}) {cfg.name} ({cfg.num_layers} layers, {n_params} "
          f"parameters): init {init_s:.3f} s, {steps} SyntheticLM batches of "
          f"{b} x {s} in {data_s:.3f} s; losses {losses} (ce "
          f"{rows[0]['ce']:.4f} first, ln V {ln_v:.4f}, random weights' "
          f"{first_ce:.4f}; aux "
          f"{rows[0]['aux']:.4g}); grad norms {norms}; steps {ms} ms, "
          f"{b * s / step_s:.1f} tokens/s; peak {peak_gb:.3f} GB; launches "
          f"{counts}; flash forward calls by form {forms}")
    if profiled:
        print(f"training ({tag}) device time (profiled step): {busy:.4f} s "
              f"busy over {step_s:.4f} s of unprofiled wall (a step's mean), "
              f"idle share {1 - busy / step_s:.4f}; the profiled step's own "
              f"wall {prof_s:.4f} s; {launches} kernel launches")
        for e in top:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"{e.count:6d}x  {e.key[:90]}")
    else:
        busy = None
        print(f"training ({tag}): no profiled step (the sLSTM's position "
              f"loop makes too many launches for the profiler)")
    checks = {
        "finite": all(np.isfinite(list(r.values())).all() for r in rows),
        "profiled step traced device time": not profiled or busy > 0,
        "flash forms": forms == want_forms,
        "first ce as random weights give": abs(rows[0]["ce"] - first_ce)
        <= FIRST_CE_ATOL,
        "launches": counts == want,
        "peak memory": peak_gb <= TRAIN_PEAK_GB,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"training ({tag}) checks failed: {failed} "
                             f"(launches {counts}, expected {want})")
    del model, state, step, batches, data
    torch.cuda.empty_cache()
    return counts, dict(params=n_params, init_s=init_s, step_ms=step_s * 1e3,
                        tokens_per_s=b * s / step_s, peak_gb=peak_gb,
                        idle=None if busy is None else 1 - busy / step_s,
                        loss=[r["loss"] for r in rows])


def train_check_cpu(dev, arch, layers, cfg=None):
    """``arch`` (or ``cfg``) at full width and ``layers`` layers, the same
    weights and
    batch (TRAIN_CHECK_B x TRAIN_CHECK_S tokens) on the card and the CPU,
    the gradients of the train step's loss (``make_loss_fn``): the loss
    within 1e-5 relative, each leaf within 1e-4 of its max |g|, the
    global norm within 1e-4 relative; on the card remat on and off give
    bitwise-equal gradients, and the remat run launches the kernels."""
    cfg = (cfg or get_config(arch)).with_(num_layers=layers)
    if cfg.is_encoder_decoder:
        cfg = cfg.with_(encoder_layers=layers)
    card = init_model(cfg, 1, device=dev)
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size,
                          (TRAIN_CHECK_B, TRAIN_CHECK_S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.concatenate(
        [tokens[:, 1:], np.full((TRAIN_CHECK_B, 1), -100, np.int32)], 1)}
    if cfg.is_encoder_decoder:   # the audio frames of phase 10's check
        batch["audio_embeds"] = rng.standard_normal(
            (TRAIN_CHECK_B, SEAM_CHECK_FRAMES, cfg.d_model)).astype(
                np.float32)

    def grads(model, remat):
        return grads_of(make_loss_fn(model, remat=remat), trainable(model),
                        to_device(batch, model.device))

    ops.reset_launch_counts()
    loss_c, _, g_c = grads(card, True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _, _, g_off = grads(card, False)
    loss_p, _, g_p = grads(cpu, True)
    gn_c, gn_p = float(opt.global_norm(g_c)), float(opt.global_norm(g_p))
    errs = {n: _rel(g_c[n].cpu(), g_p[n]) for n in g_p}
    worst = max(errs, key=errs.get)
    same = all(torch.equal(g_c[n], g_off[n]) for n in g_c)
    loss_err = abs(float(loss_c) - float(loss_p)) / abs(float(loss_p))
    want = train_expected_launches(cfg, 1, True)
    print(f"training card vs CPU {arch} ({layers} layers, {TRAIN_CHECK_B} x "
          f"{TRAIN_CHECK_S}): loss {float(loss_c):.6f} / {float(loss_p):.6f} "
          f"(rel {loss_err:.3g}), grad norm {gn_c:.6g} / {gn_p:.6g} (rel "
          f"{abs(gn_c - gn_p) / gn_p:.3g}), worst leaf {worst} "
          f"{errs[worst]:.3g} of its max |g| (tol {TRAIN_GRAD_TOL:g}) over "
          f"{len(errs)} leaves; remat on vs off on the card "
          f"{'bitwise equal' if same else 'DIFFER'}; launches {counts}")
    if not (loss_err <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_TOL
            and abs(gn_c - gn_p) <= TRAIN_GNORM_RTOL * gn_p and same
            and counts == want):
        raise AssertionError(f"training card vs CPU {arch} disagrees")
    return counts


def training_path(dev):
    """Phase 11: (a) the cascade pair, (b) granite-moe-1b-a400m at full
    width and depth, (c) RecurrentGemma-9B at full width over one
    super-block, then each of (b) and (c) at cut depth against the CPU.
    Returns (launches of (a) - (c), the paths' figures)."""
    counts, out = {}, {}
    pc, out["pair"] = pair_path(dev)
    _add_counts(counts, pc)
    gc, out[GRANITE_ARCH] = lm_train_path(
        dev, "b", get_config(GRANITE_ARCH), GRANITE_B, GRANITE_S,
        GRANITE_STEPS, 0)
    _add_counts(counts, gc)
    rc, out[RG_ARCH] = lm_train_path(
        dev, "c", get_config(RG_ARCH).with_(num_layers=RGT_LAYERS), RGT_B,
        RGT_S, RGT_STEPS, 1)
    _add_counts(counts, rc)
    for arch, layers in TRAIN_CHECK_LAYERS.items():
        train_check_cpu(dev, arch, layers)
        torch.cuda.empty_cache()
    return counts, out


def train_rows(timer):
    """Phase 3's timing rows of the backward kernels at the training
    paths' shapes (and the forms of the zoo's other attention)."""
    flash = {name: timer.flash_bwd(name, b, s, t, h, kv, hd, causal, window)
             for name, b, s, t, h, kv, hd, causal, window in flash_bwd_cases()
             if name != "tier-low"}
    for name, b, s, t, h, kv, hd, causal, window in flash_bwd_cases():
        if name in (GRANITE_ARCH, RG_ARCH):
            timer.flash_bwd_parts(name, b, s, h, kv, hd, window)
    timer.flash_bwd_splits()
    scan = {"f32": timer.rglru_bwd(), "bf16": timer.rglru_bwd(
        dt=torch.bfloat16), "b1": timer.rglru_bwd(b=1)}
    return {"flash_attention_bwd": flash, "rglru_scan_bwd": scan}


def train_only(dev, timer):
    """``chip_smoke.py train``: phase 3's backward-kernel checks and timing
    rows, then phase 11."""
    t0 = time.perf_counter()
    check_flash_bwd(dev)
    check_rglru_bwd(dev)
    check_rglru_bwd_paths(dev)
    check_grad_guard(dev)
    train_rows(timer)
    timer.flash_threshold(forward=False)
    plan_sweep(torch.cuda.get_device_name(dev), [("rglru_scan", "BWD_STEPS")])
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    training_path(dev)
    print(f"phase seconds: backward checks and timing rows {t1 - t0:.1f}, "
          f"training {time.perf_counter() - t1:.1f}")
    return 0


# ---------------------------------------------------------------------------
# phase 12: soft-capped attention (gemma-7b's widths, Gemma 2's cap)
# ---------------------------------------------------------------------------
def cap_rows(timer):
    """Phase 3's timing rows of the capped kernels at gemma-7b's shapes,
    each beside the uncapped row at the same shape: the prefill (ZOO_B,
    ZOO_S, 16, 16, 256) forward and backward, and decode over rings of
    ZOO_S + CAP_STEPS slots, full."""
    cfg = get_config(CAP_ARCH)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = {"flash_attention": {}, "flash_attention_bwd": {},
            "decode_attention": {}}
    for tag, cap in (("capped", CAP), ("uncapped", None)):
        form = " capped" if cap else ""
        rows["flash_attention"][tag] = timer.flash(
            CAP_ARCH, ZOO_B, ZOO_S, form=form, soft_cap=cap)
        rows["flash_attention_bwd"][tag] = timer.flash_bwd(
            CAP_ARCH + form, ZOO_B, ZOO_S, None, h, kv, hd, True, None,
            soft_cap=cap)
        rows["decode_attention"][tag] = timer.decode_at(
            CAP_ARCH, ZOO_B, ZOO_S + CAP_STEPS, kv, h // kv, hd,
            soft_cap=cap)
        torch.cuda.empty_cache()
    return rows


def softcap_path(dev):
    """Phase 12: gemma-7b at full width with Gemma 2's attention soft cap,
    served at CAP_LAYERS layers (``zoo_model``: ZOO_B prompts of ZOO_S
    positions, CAP_STEPS decode steps, one flash launch a layer at the
    prefill, layers x steps decode launches, 1 + steps BvSB; then 2 layers
    card against CPU on 2 x 64, BvSB within 1e-5, top-1), then trained at
    CAP_TRAIN_LAYERS through ``make_train_step`` with remat
    (``lm_train_path``: two flash forward and one backward launch a layer
    a step), then the card against the CPU at 2 layers on 1 x 256 tokens
    (``train_check_cpu``). Returns (launch counts, figures)."""
    counts, serving = zoo_model(dev, CAP_ARCH, CAP_LAYERS, CAP_STEPS,
                                cfg=cap_cfg())
    torch.cuda.empty_cache()
    tc, training = lm_train_path(dev, "softcap", cap_cfg(CAP_TRAIN_LAYERS),
                                 CAP_TRAIN_B, CAP_TRAIN_S, CAP_TRAIN_STEPS, 2)
    _add_counts(counts, tc)
    train_check_cpu(dev, CAP_ARCH, CAP_CHECK_LAYERS, cfg=cap_cfg())
    torch.cuda.empty_cache()
    return counts, dict(serving=serving, training=training)


def softcap_only(dev, timer):
    """``chip_smoke.py softcap``: phase 3's soft-cap checks and capped
    timing rows, then phase 12."""
    t0 = time.perf_counter()
    check_capped(dev)
    cap_rows(timer)
    t1 = time.perf_counter()
    softcap_path(dev)
    print(f"phase seconds: soft-cap checks and timing rows {t1 - t0:.1f}, "
          f"soft-capped gemma-7b {time.perf_counter() - t1:.1f}")
    return 0


# ---------------------------------------------------------------------------
# phase 13: the step factories over a (data, model) mesh; training of the
# encoder-decoder and of xLSTM
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def collective_clock():
    """Time every ``torch.distributed.all_reduce`` while the block runs,
    the device synchronised before each (so the clock holds the exchange
    alone): yields a tally {"n": calls, "s": seconds}."""
    real, tally = dist.all_reduce, {"n": 0, "s": 0.0}

    def timed(tensor, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(tensor, *a, **kw)
        torch.cuda.synchronize()
        tally["s"] += time.perf_counter() - t0
        tally["n"] += 1
        return out
    dist.all_reduce = timed
    try:
        yield tally
    finally:
        dist.all_reduce = real


def clock_of(clock, wall, logical):
    """A clocked step's tally: the all_reduces the clock timed (its "n"
    and "s"), the wall, and the same collectives as ``MeshContext``'s
    counter books them (the logical operations, their calls and ring
    bytes a rank), which must be as many."""
    if logical.calls != clock["n"]:
        raise AssertionError(f"the mesh context booked {logical.calls} "
                             f"collectives of a step that made {clock['n']} "
                             "all_reduces")
    return dict(clock, wall=wall, logical=logical.as_dict())


def mesh_tokens(cfg, dev, b, s, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev)


def mesh_expected_launches(cfg, steps, ring_cut=True):
    """A prefill and ``steps`` serve steps on a mesh: one flash launch an
    attention layer and one scan an RG-LRU layer; an attention layer a
    step one decode partial and one merge launch over rings cut on their
    slots (else one whole-ring decode launch); one BvSB partial and one
    merge launch a call (no whole-row BvSB)."""
    n = _attn_layers(cfg)
    decode = {"decode_attention_partials": n * steps,
              "decode_attention_merge": n * steps} if ring_cut else \
        {"decode_attention": n * steps}
    return {**NO_LAUNCHES, "flash_attention": n,
            "rglru_scan": cfg.pattern.count("rglru"), **decode,
            "bvsb_partials": 1 + steps, "bvsb_merge": 1 + steps}


def _timed(fn):
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_serve(model, mesh, dev, tokens, steps, cache_len=MESH_RING):
    """A prefill into rings of ``cache_len`` slots (min(cache_len, window)
    for a windowed layer) and ``steps`` serve steps feeding back top-1 on
    every rank, the counters read around them: (per-step (conf, top1) on
    the host, launches, prefill s, a serve step's s (mean after the
    first), the collectives' tally of one more clocked serve step)."""
    prefill = make_prefill_step(model, mesh)
    serve = make_serve_step(model, mesh)
    b, s = tokens.shape
    ops.reset_launch_counts()
    (conf, top1, cache), prefill_s = _timed(
        lambda: prefill(tokens, cache_len=cache_len))
    out, walls = [(conf.cpu(), top1.cpu())], []
    for i in range(steps):
        pos = torch.full((b,), s + i, dtype=torch.long, device=dev)
        (conf, top1, cache), w = _timed(
            lambda: serve(top1[:, None], cache, pos))
        out.append((conf.cpu(), top1.cpu()))
        walls.append(w)
    counts = ops.launch_counts()
    pos = torch.full((b,), s + steps, dtype=torch.long, device=dev)
    with collective_clock() as clock, counting_collectives() as logical:
        _, clocked = _timed(lambda: serve(top1[:, None], cache, pos))
    return out, counts, prefill_s, float(np.mean(walls[1:])), \
        clock_of(clock, clocked, logical)


def mesh_grads(cfg, dev, mesh, rows):
    """The gradients of the train step's loss at MESH_GRAD_LAYERS layers on
    ``rows`` rows of TRAIN_CHECK_S tokens, on this rank's model of the mesh
    (summed over the data group) and on the one-card model of the same
    weights on each data rank's rows alone, the latter averaged (every
    row has the same count of labels, so den_r / den = 1 / rows): the
    worst leaf's max |mesh - one-card| over its max |one-card| (a leaf the
    model ranks cut against its part), and the losses."""
    from repro_torch.launch.distributed import make_loss_fn as loss_of
    from repro_torch.models.common import mesh_context
    from repro_torch.models.model import model_parts, part_index
    from repro_torch.training.trainer import all_reduce_grads, data_rows
    cfg = cfg.with_(num_layers=MESH_GRAD_LAYERS)
    mctx = mesh_context(mesh)
    gen = torch.Generator(device=dev)
    model = init_params(cfg, gen.manual_seed(MESH_SEED), device=dev,
                        mesh=mesh)
    local = init_params(cfg, gen.manual_seed(MESH_SEED), device=dev)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size,
                          (rows, TRAIN_CHECK_S)).astype(np.int32)
    batch = to_device({"tokens": tokens, "labels": np.concatenate(
        [tokens[:, 1:], np.full((rows, 1), -100, np.int32)], 1)}, dev)
    loss, _, g = grads_of(loss_of(model, remat=True, mctx=mctx),
                          trainable(model), data_rows(batch, mctx))
    all_reduce_grads(g, mctx)
    ref, ref_loss = None, 0.0
    for r in range(rows):
        lr, _, gr = grads_of(loss_of(local, remat=True), trainable(local),
                             {k: v[r:r + 1] for k, v in batch.items()})
        ref = gr if ref is None else {k: ref[k] + gr[k] for k in ref}
        ref_loss += float(lr) / rows
    ref = {k: v / rows for k, v in ref.items()}
    parts = model_parts(model)
    errs = {k: _rel(v, ref[k][part_index(*parts[k]) if k in parts else ()])
            for k, v in g.items()}
    worst = max(errs, key=errs.get)
    return {"worst": worst, "err": errs[worst], "leaves": len(errs),
            "loss": float(loss), "ref_loss": ref_loss}


def _rank_layout(model):
    """What a rank holds of the layout: the shapes of its first attention
    layer's wq / wk and of its first RG-LRU's w_gate (where the model has
    them), and its parameter GB."""
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    out = {"params_gb": n / 1e9, "params_bytes": n}
    for name, p in model.named_parameters():
        leaf = name.split(".", 2)[-1]
        if leaf in ("attn.wq", "attn.wk", "rglru.w_gate", "mlp.w_gate",
                    "embed.table") and leaf not in out:
            out[leaf] = tuple(p.shape)
    return out


def rg_mesh_cfg():
    cfg = get_config(RG_ARCH)
    return cfg if RGM_LAYERS is None else cfg.with_(num_layers=RGM_LAYERS)


def rg_mesh_tokens(cfg, dev):
    rng = np.random.default_rng(21)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (RGM_B, RGM_S)),
                           device=dev)


def rg_mesh_work(dev):
    """(e): RecurrentGemma-9B's weights drawn on every rank, each keeping
    its parts, a prefill of RGM_B x RGM_S tokens and RGM_STEPS serve steps
    on an RGM_SHAPE mesh."""
    from repro_torch.launch.mesh import make_model_mesh
    cfg = rg_mesh_cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    mesh = make_model_mesh(RGM_SHAPE, device_type="cuda")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps, counts, prefill_s, step_s, clock = mesh_serve(
        model, mesh, dev, rg_mesh_tokens(cfg, dev), RGM_STEPS,
        cache_len=RGM_S + RGM_STEPS + 1)
    out = dict(steps=steps, counts=counts, prefill_s=prefill_s,
               step_s=step_s, clock=clock, init_s=init_s,
               layout=_rank_layout(model), free_gb=free_gb,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model
    torch.cuda.empty_cache()
    return out


def stored_bytes(params, state) -> int:
    """Bytes a rank stores for training: its parameters and AdamW's state
    (the two moments and the step)."""
    ts = [*params.values(), *state["mu"].values(), *state["nu"].values(),
          state["step"]]
    return sum(t.numel() * t.element_size() for t in ts)


def mesh_train(model, mesh, dev, steps, b, s):
    """``steps`` train steps (remat) of ``b`` x ``s`` SyntheticLM tokens
    on this rank's ``model``, the last one clocked: the losses, the
    unclocked walls, the clocked step's all_reduces, the launches and the
    GB the rank stores (its parameters and AdamW's moments)."""
    params = trainable(model)
    state = opt.init(params)
    stored = stored_bytes(params, state)
    data = SyntheticLM(DataConfig(model.cfg.vocab_size, s, b,
                                  seed=MESH_SEED), device=dev)
    step = make_train_step(model, mesh, remat=True, adamw=opt.AdamWConfig(
        warmup_steps=2, total_steps=steps))
    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(steps - 1):
        (state, m), w = _timed(lambda: step(state, data.batch_at(i)))
        losses.append(float(m["loss"]))
        walls.append(w)
    with collective_clock() as tally, counting_collectives() as logical:
        (state, m), w = _timed(lambda: step(state, data.batch_at(
            steps - 1)))
    losses.append(float(m["loss"]))
    return dict(losses=losses, walls=walls, counts=ops.launch_counts(),
                clock=clock_of(tally, w, logical), stored_gb=stored / 1e9,
                stored_bytes=stored)


def xlstm_mesh_tokens(cfg, dev):
    rng = np.random.default_rng(23)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (XLM_B, XLM_S)),
                           device=dev)


def xlstm_mesh_work(dev):
    """(d): xlstm-350m's weights drawn on every rank, each keeping its
    heads, on an XLM_SHAPE mesh: a prefill of XLM_B x XLM_S tokens and
    XLM_STEPS serve steps, then XLSTMT_STEPS train steps (remat) of
    XLSTMT_B x XLSTMT_S SyntheticLM tokens."""
    from repro_torch.launch.mesh import make_model_mesh
    cfg = get_config(XLSTM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_model_mesh(XLM_SHAPE, device_type="cuda")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps, counts, prefill_s, step_s, clock = mesh_serve(
        model, mesh, dev, xlstm_mesh_tokens(cfg, dev), XLM_STEPS)
    out = dict(steps=steps, counts=counts, prefill_s=prefill_s,
               step_s=step_s, clock=clock, init_s=init_s,
               layout={"mlstm.w_up": tuple(model.layers[0].mlstm.w_up.shape),
                       "slstm.w_in": tuple(model.layers[1].slstm.w_in.shape)})
    out["train"] = mesh_train(model, mesh, dev, XLSTMT_STEPS, XLSTMT_B,
                              XLSTMT_S)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    return out


def mesh_work(_, dev):
    """A rank's share of phase 13: (a) on the MESH_SHAPE mesh, then (b) on
    (2, 2), then (e) and (d); its results, launches, walls, collectives and
    peak memory."""
    from repro_torch.launch.mesh import make_model_mesh
    cfg = get_config(GRANITE_ARCH)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    mesh = make_model_mesh(MESH_SHAPE, device_type="cuda")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = mesh_tokens(cfg, dev, MESH_B, MESH_S, MESH_SEED)
    steps, counts, prefill_s, step_s, clock = mesh_serve(
        model, mesh, dev, tokens, MESH_STEPS)
    out["a_serve"] = dict(steps=steps, counts=counts, prefill_s=prefill_s,
                          step_s=step_s, clock=clock, init_s=init_s,
                          experts=tuple(model.layers[0].moe.w_gate.shape),
                          layout=_rank_layout(model))
    out["a_train"] = mesh_train(model, mesh, dev, MESH_TRAIN_STEPS,
                                MESH_TRAIN_B, MESH_S)
    del model
    torch.cuda.empty_cache()
    out["a_grads"] = mesh_grads(cfg, dev, mesh, TRAIN_CHECK_B)
    out["a_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    mesh = make_model_mesh((2, 2), device_type="cuda")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev, mesh=mesh)
    steps, counts, prefill_s, step_s, clock = mesh_serve(
        model, mesh, dev, tokens, MESH22_STEPS, cache_len=MESH22_RING)
    out["b_serve"] = dict(steps=steps, counts=counts, prefill_s=prefill_s,
                          step_s=step_s, clock=clock,
                          experts=tuple(model.layers[0].moe.w_gate.shape))
    del model
    torch.cuda.empty_cache()
    out["b_grads"] = mesh_grads(cfg, dev, mesh, 2)
    out["b_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    for key, fsdp, n in (("b_fsdp", True, MESH_TRAIN_STEPS),
                         ("b_resident", False, 1)):
        torch.cuda.reset_peak_memory_stats()
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(
            MESH_SEED), device=dev, mesh=mesh, fsdp=fsdp)
        out[key] = mesh_train(model, mesh, dev, n, MESH_TRAIN_B, MESH_S)
        out[key]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model
        torch.cuda.empty_cache()
    out["e"] = rg_mesh_work(dev)
    out["d"] = xlstm_mesh_work(dev)
    return out


def _same_steps(results, key):
    """Every rank's conf and top-1 of every step equal bit for bit."""
    ref = results[0][key]["steps"]
    return all(torch.equal(bits(c), bits(c0)) and torch.equal(t, t0)
               for res in results
               for (c, t), (c0, t0) in zip(res[key]["steps"], ref))


def _one_rank_steps(model, dev, tokens, steps, cache_len=MESH_RING):
    """The one-card prefill and the serve steps fed the tokens ``steps``
    (a list of (B,) top-1 from the mesh run), conf and top-1 a step."""
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    b, s = tokens.shape
    conf, top1, cache = prefill(tokens, cache_len=cache_len)
    out = [(conf.cpu(), top1.cpu())]
    for i, (_, fed) in enumerate(steps[:-1]):
        pos = torch.full((b,), s + i, dtype=torch.long, device=dev)
        conf, top1, cache = serve(fed.to(dev)[:, None], cache, pos)
        out.append((conf.cpu(), top1.cpu()))
    return out


def _steps_err(got, ref):
    """(max |conf - ref| over the steps, top-1 equal at every step)."""
    err = max(max_err(c, rc) for (c, _), (rc, _) in zip(got, ref))
    return err, all(torch.equal(t, rt) for (_, t), (_, rt) in zip(got, ref))


def _one_rank_gapped(model, dev, tokens, steps, cache_len):
    """``_one_rank_steps`` through the model's layers and ``head_bvsb`` (as
    the one-card step factories run them), with each position's top-2
    logit gap over the whole head: (conf, top1, gap) a step."""
    cfg, table = model.cfg, model.head_table
    b, s = tokens.shape
    out = []

    def emit(hidden):
        conf, top1 = head_bvsb(hidden, table, cfg.vocab_size)
        top2 = torch.topk(hidden[:, -1].float() @ table.float().T, 2).values
        out.append((conf.cpu(), top1.cpu(), (top2[:, 0] - top2[:, 1]).cpu()))
    with torch.inference_mode():
        hidden, cache = model(tokens, collect_cache=True, cache_len=cache_len,
                              return_hidden=True)
        emit(hidden[:, -1:])
        for i, (_, fed) in enumerate(steps[:-1]):
            pos = torch.full((b,), s + i, dtype=torch.long, device=dev)
            hidden, cache = model.decode_step(fed.to(dev)[:, None], cache,
                                              pos, return_hidden=True)
            emit(hidden)
    return out


def rg_mesh_check(dev, e, results):
    """(e) against the one-card run of the same weights and tokens, fed
    the mesh run's top-1: BvSB within BVSB_ATOL, top-1 equal wherever the
    one-card top-2 logit gap exceeds TOP2_GAP; every rank bitwise equal;
    the launches; the peaks. Prints the walls and the all_reduces."""
    cfg = rg_mesh_cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev)
    tokens = rg_mesh_tokens(cfg, dev)
    t0 = time.perf_counter()
    ref = _one_rank_gapped(model, dev, tokens, e["steps"],
                           RGM_S + RGM_STEPS + 1)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    err = max(max_err(c, rc) for (c, _), (rc, _, _) in zip(e["steps"], ref))
    clear = [g > TOP2_GAP for _, _, g in ref]
    top1 = all(torch.equal(t[m], rt[m]) for (_, t), (_, rt, _), m
               in zip(e["steps"], ref, clear))
    n_clear = sum(int(m.sum()) for m in clear)
    same = all(torch.equal(bits(c), bits(c0)) and torch.equal(t, t0)
               for res in results
               for (c, t), (c0, t0) in zip(res["e"]["steps"], e["steps"]))
    want = mesh_expected_launches(cfg, RGM_STEPS)
    bad = [r for r, res in enumerate(results) if res["e"]["counts"] != want]
    peaks = [res["e"]["peak_gb"] for res in results]
    c = e["clock"]
    print(f"mesh (e) {RG_ARCH} at full width, {cfg.num_layers} layers, on a "
          f"{RGM_SHAPE} mesh ({MESH_RANKS} gloo ranks on one card; a rank "
          f"holds {e['layout']}; init {e['init_s']:.3f} s): prefill "
          f"{RGM_B} x {RGM_S} {e['prefill_s']:.3f} s "
          f"({RGM_B * RGM_S / e['prefill_s']:.1f} tokens/s), {RGM_STEPS} "
          f"serve steps {e['step_s'] * 1e3:.2f} ms a step; BvSB max|err| "
          f"{err:.3g} against the one-card run (its prefill and steps "
          f"{ref_s:.3f} s, peak {one_peak:.3f} GB), top-1 "
          f"{'equal' if top1 else 'DIFFERS'} at the {n_clear} of "
          f"{len(clear) * RGM_B} positions whose top-2 gap exceeds "
          f"{TOP2_GAP:g}, every rank "
          f"{'bitwise equal' if same else 'DIFFERS'}; a clocked serve step "
          f"{c['wall'] * 1e3:.2f} ms, {c['n']} all_reduces "
          f"{c['s'] * 1e3:.2f} ms ({c['s'] / c['wall']:.4f} of it); each "
          f"rank's peak {', '.join('%.3f' % x for x in peaks)} GB (together "
          f"{sum(peaks):.3f}, limit {RGM_PEAK_GB}); launches a rank "
          f"{e['counts']}")
    checks = {"(e) BvSB": err <= BVSB_ATOL[torch.float32] and top1,
              "(e) ranks equal": same, "(e) launches": not bad,
              "(e) peaks": sum(peaks) <= RGM_PEAK_GB}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh (e) checks failed: {failed} (launches "
                             f"off on ranks {bad})")
    return dict(prefill_s=e["prefill_s"], step_ms=e["step_s"] * 1e3,
                share=c["s"] / c["wall"], n_all_reduce=c["n"],
                peak_gb=max(peaks))


def fsdp_report(results):
    """(b)'s training stored FSDP and resident: prints each rank's stored
    GB (parameters and moments), its peak, the losses, the walls and the
    all_reduces of a clocked step of each; checks that the first-step
    losses agree within TRAIN_LOSS_RTOL, every rank's losses are equal,
    and FSDP stores less a rank."""
    runs = {k: [res[k] for res in results] for k in ("b_fsdp", "b_resident")}
    f0, r0 = runs["b_fsdp"][0], runs["b_resident"][0]
    first_err = abs(f0["losses"][0] - r0["losses"][0]) / abs(r0["losses"][0])
    for key, label in (("b_fsdp", "stored FSDP over the data ranks"),
                       ("b_resident", "resident (fsdp=False)")):
        rs = runs[key]
        c = rs[0]["clock"]
        print(f"mesh (b) training {label}: {len(rs[0]['losses'])} step(s) of "
              f"{MESH_TRAIN_B} x {MESH_S} (remat), losses "
              f"{', '.join('%.6f' % x for x in rs[0]['losses'])}; each "
              f"rank stores {', '.join('%.3f' % r['stored_gb'] for r in rs)}"
              f" GB (parameters and moments), peaks "
              f"{', '.join('%.3f' % r['peak_gb'] for r in rs)} GB; unclocked "
              f"steps {', '.join('%.1f' % (w * 1e3) for w in rs[0]['walls'])}"
              f" ms; a clocked step {c['wall'] * 1e3:.1f} ms, {c['n']} "
              f"all_reduces {c['s'] * 1e3:.1f} ms ({c['s'] / c['wall']:.4f} "
              f"of it; gloo between four processes on one card: host "
              f"copies, not a fabric)")
    print(f"mesh (b) first-step loss FSDP {f0['losses'][0]:.6f} / resident "
          f"{r0['losses'][0]:.6f} (rel {first_err:.3g}, tol "
          f"{TRAIN_LOSS_RTOL:g})")
    stored = {k: max(r["stored_gb"] for r in rs) for k, rs in runs.items()}
    checks = {
        "(b) FSDP first loss": first_err <= TRAIN_LOSS_RTOL,
        "(b) FSDP ranks equal": all(
            r["losses"] == rs[0]["losses"] for rs in runs.values()
            for r in rs),
        "(b) FSDP stores less": stored["b_fsdp"] < stored["b_resident"],
    }
    figures = {k: dict(stored_gb=stored[k],
                       stored_bytes=max(r["stored_bytes"] for r in rs),
                       logical=rs[0]["clock"]["logical"],
                       peak_gb=max(r["peak_gb"] for r in rs),
                       step_ms=rs[0]["clock"]["wall"] * 1e3,
                       n_all_reduce=rs[0]["clock"]["n"],
                       share=rs[0]["clock"]["s"] / rs[0]["clock"]["wall"])
               for k, rs in runs.items()}
    return dict(checks=checks, figures=figures)


def xlstm_mesh_check(dev, d, results):
    """(d) against the one-card run of the same weights and tokens, fed
    the mesh run's top-1: BvSB within BVSB_ATOL, top-1 equal wherever the
    one-card top-2 logit gap exceeds TOP2_GAP, every rank bitwise equal;
    the first train step's loss within TRAIN_LOSS_RTOL of the one-card
    step's on the same batch; the launches."""
    cfg = get_config(XLSTM_ARCH)
    torch.cuda.empty_cache()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev)
    t0 = time.perf_counter()
    ref = _one_rank_gapped(model, dev, xlstm_mesh_tokens(cfg, dev),
                           d["steps"], MESH_RING)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    data = SyntheticLM(DataConfig(cfg.vocab_size, XLSTMT_S, XLSTMT_B,
                                  seed=MESH_SEED), device=dev)
    step = make_train_step(model, remat=True, adamw=opt.AdamWConfig(
        warmup_steps=2, total_steps=XLSTMT_STEPS))
    t0 = time.perf_counter()
    _, met = step(opt.init(trainable(model)), data.batch_at(0))
    ref_loss = float(met["loss"])
    ref_step_s = time.perf_counter() - t0
    del model, step
    torch.cuda.empty_cache()
    err = max(max_err(c, rc) for (c, _), (rc, _, _) in zip(d["steps"], ref))
    clear = [g > TOP2_GAP for _, _, g in ref]
    top1 = all(torch.equal(t[m], rt[m]) for (_, t), (_, rt, _), m
               in zip(d["steps"], ref, clear))
    n_clear = sum(int(m.sum()) for m in clear)
    same = all(torch.equal(bits(c), bits(c0)) and torch.equal(t, t0)
               for res in results
               for (c, t), (c0, t0) in zip(res["d"]["steps"], d["steps"]))
    losses = d["train"]["losses"]
    loss_err = abs(losses[0] - ref_loss) / abs(ref_loss)
    same_losses = all(res["d"]["train"]["losses"] == losses
                      for res in results)
    want = (mesh_expected_launches(cfg, XLM_STEPS),
            train_expected_launches(cfg, XLSTMT_STEPS, True))
    bad = [r for r, res in enumerate(results)
           if (res["d"]["counts"], res["d"]["train"]["counts"]) != want]
    peaks = [res["d"]["peak_gb"] for res in results]
    c, tc = d["clock"], d["train"]["clock"]
    print(f"mesh (d) {XLSTM_ARCH} at full width and depth on a {XLM_SHAPE} "
          f"mesh (one mLSTM and one sLSTM head a rank, {d['layout']}; init "
          f"{d['init_s']:.3f} s): prefill {XLM_B} x {XLM_S} "
          f"{d['prefill_s']:.3f} s, {XLM_STEPS} serve steps "
          f"{d['step_s'] * 1e3:.2f} ms a step; BvSB max|err| {err:.3g} "
          f"against the one-card run (its prefill and steps {ref_s:.3f} s), "
          f"top-1 {'equal' if top1 else 'DIFFERS'} at the {n_clear} of "
          f"{len(clear) * XLM_B} positions whose top-2 gap exceeds "
          f"{TOP2_GAP:g}, every rank "
          f"{'bitwise equal' if same else 'DIFFERS'}; a clocked serve step "
          f"{c['wall'] * 1e3:.2f} ms, {c['n']} all_reduces "
          f"{c['s'] * 1e3:.2f} ms ({c['s'] / c['wall']:.4f} of it)")
    print(f"mesh (d) training: {XLSTMT_STEPS} steps of {XLSTMT_B} x "
          f"{XLSTMT_S} (remat), losses "
          f"{', '.join('%.6f' % x for x in losses)}, the first against the "
          f"one-card step's {ref_loss:.6f} (rel {loss_err:.3g}; its wall "
          f"{ref_step_s:.3f} s), every rank's equal: {same_losses}; steps "
          f"{', '.join('%.1f' % (w * 1e3) for w in d['train']['walls'])} "
          f"ms, a clocked step {tc['wall'] * 1e3:.1f} ms, {tc['n']} "
          f"all_reduces ({tc['s'] / tc['wall']:.4f} of it); each rank's "
          f"peak {', '.join('%.3f' % x for x in peaks)} GB;"
          f" launches a rank {d['counts']} (serve), "
          f"{d['train']['counts']} (train)")
    checks = {"(d) BvSB": err <= BVSB_ATOL[torch.float32] and top1,
              "(d) ranks equal": same and same_losses,
              "(d) first loss": loss_err <= TRAIN_LOSS_RTOL,
              "(d) launches": not bad}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh (d) checks failed: {failed} (launches "
                             f"off on ranks {bad})")
    return dict(prefill_s=d["prefill_s"], step_ms=d["step_s"] * 1e3,
                train_ms=d["train"]["walls"][-1] * 1e3, peak_gb=max(peaks),
                loss=losses)


def mesh_lm_path(dev):
    """Phase 13 (a), (b), (d) and (e): MESH_RANKS ranks spawned on the
    card, each running ``mesh_work``; every rank's conf and top-1 equal bit
    for bit; (e) and (d) held to their one-card runs (``rg_mesh_check``,
    ``xlstm_mesh_check``); (b)'s FSDP training to its resident step
    (``fsdp_report``);
    (a) held to the one-card steps on the same weights and tokens (BvSB
    within BVSB_ATOL, top-1 equal, the train losses within
    TRAIN_LOSS_RTOL), (b)'s rows to one-card runs on each data rank's rows
    alone; the gradients at cut depth within TRAIN_GRAD_TOL of their
    leaf's max |g|; the launches each rank counted against what the steps
    make; the ranks' peaks together within MESH_PEAK_GB. Returns (the
    launches summed over the ranks, the walls)."""
    torch.cuda.empty_cache()
    results, spawn_wall = shard_ranks(dev.type, mesh_work)
    cfg = get_config(GRANITE_ARCH)
    a, b = results[0]["a_serve"], results[0]["b_serve"]
    tokens = mesh_tokens(cfg, dev, MESH_B, MESH_S, MESH_SEED)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        MESH_SEED), device=dev)
    ref = _one_rank_steps(model, dev, tokens, a["steps"])
    a_err, a_top1 = _steps_err(a["steps"], ref)
    half = MESH_B // 2
    b_ref = [_one_rank_steps(model, dev, tokens[r * half:(r + 1) * half],
                             [(c[r * half:(r + 1) * half],
                               t[r * half:(r + 1) * half])
                              for c, t in b["steps"]], MESH22_RING)
             for r in range(2)]
    b_ref = [(torch.cat([x[i][0] for x in b_ref]),
              torch.cat([x[i][1] for x in b_ref]))
             for i in range(MESH22_STEPS + 1)]
    b_err, b_top1 = _steps_err(b["steps"], b_ref)
    data = SyntheticLM(DataConfig(cfg.vocab_size, MESH_S, MESH_TRAIN_B,
                                  seed=MESH_SEED), device=dev)
    step = make_train_step(model, remat=True, adamw=opt.AdamWConfig(
        warmup_steps=2, total_steps=MESH_TRAIN_STEPS))
    state = opt.init(trainable(model))
    ref_losses, ref_walls = [], []
    for i in range(MESH_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, data.batch_at(i))
        ref_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ref_walls.append(time.perf_counter() - t0)
    del model, state, step
    torch.cuda.empty_cache()
    losses = results[0]["a_train"]["losses"]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(losses, ref_losses))
    same_losses = all(res["a_train"]["losses"] == losses for res in results)
    want = {"a_serve": mesh_expected_launches(cfg, MESH_STEPS),
            "a_train": train_expected_launches(cfg, MESH_TRAIN_STEPS, True),
            "b_serve": mesh_expected_launches(cfg, MESH22_STEPS,
                                              ring_cut=False),
            "b_fsdp": train_expected_launches(cfg, MESH_TRAIN_STEPS, True),
            "b_resident": train_expected_launches(cfg, 1, True)}
    bad_counts = [(r, k) for r, res in enumerate(results)
                  for k in want if res[k]["counts"] != want[k]]
    peaks = [res["a_peak_gb"] for res in results], \
        [res["b_peak_gb"] for res in results], \
        [res["b_fsdp"]["peak_gb"] for res in results], \
        [res["b_resident"]["peak_gb"] for res in results]
    fsdp = fsdp_report(results)
    grads = {k: max((res[k] for res in results), key=lambda g: g["err"])
             for k in ("a_grads", "b_grads")}
    n_tok = MESH_B * MESH_S
    print(f"mesh (a) {GRANITE_ARCH} at full width and depth on a "
          f"{MESH_SHAPE} mesh ({MESH_RANKS} gloo ranks on one card, experts "
          f"{a['experts']} a rank, a rank holds {a['layout']}; rings of "
          f"{MESH_RING} slots; init {a['init_s']:.3f} s): prefill "
          f"{MESH_B} x {MESH_S} {a['prefill_s']:.3f} s ({n_tok / a['prefill_s']:.1f} "
          f"tokens/s), {MESH_STEPS} serve steps {a['step_s'] * 1e3:.2f} ms a "
          f"step; BvSB max|err| {a_err:.3g} against the one-card steps, "
          f"top-1 {'equal' if a_top1 else 'DIFFERS'}, every rank "
          f"{'bitwise equal' if _same_steps(results, 'a_serve') else 'DIFFERS'}"
          f"; a clocked serve step {a['clock']['wall'] * 1e3:.2f} ms, "
          f"{a['clock']['n']} all_reduces {a['clock']['s'] * 1e3:.2f} ms "
          f"({a['clock']['s'] / a['clock']['wall']:.4f} of it)")
    tr = results[0]["a_train"]
    print(f"mesh (a) training: {MESH_TRAIN_STEPS} steps of {MESH_TRAIN_B} x "
          f"{MESH_S} (remat), losses "
          f"{', '.join('%.6f' % x for x in losses)} against the one-card "
          f"{', '.join('%.6f' % x for x in ref_losses)} (max rel "
          f"{loss_err:.3g}), every rank's equal: {same_losses}; steps "
          f"{', '.join('%.1f' % (w * 1e3) for w in tr['walls'])} ms "
          f"({MESH_TRAIN_B * MESH_S / tr['walls'][-1]:.1f} tokens/s at the "
          f"last unclocked; the one-card steps "
          f"{', '.join('%.1f' % (w * 1e3) for w in ref_walls)} ms); a clocked "
          f"step {tr['clock']['wall'] * 1e3:.1f} ms, {tr['clock']['n']} "
          f"all_reduces {tr['clock']['s'] * 1e3:.1f} ms "
          f"({tr['clock']['s'] / tr['clock']['wall']:.4f} of it)")
    print(f"mesh (b) the same weights on a (2, 2) mesh (experts "
          f"{b['experts']} a rank; rings of {MESH22_RING} slots, whole on "
          f"every rank): prefill {b['prefill_s']:.3f} s, "
          f"{MESH22_STEPS} serve steps {b['step_s'] * 1e3:.2f} ms a step; "
          f"each data rank's rows against one-card runs on those rows alone "
          f"(their own capacity): BvSB max|err| {b_err:.3g}, top-1 "
          f"{'equal' if b_top1 else 'DIFFERS'}, every rank "
          f"{'bitwise equal' if _same_steps(results, 'b_serve') else 'DIFFERS'}"
          f"; a clocked serve step {b['clock']['wall'] * 1e3:.2f} ms, "
          f"{b['clock']['n']} all_reduces "
          f"({b['clock']['s'] / b['clock']['wall']:.4f} of it); launches a "
          f"rank {b['counts']}")
    for k, rows in (("a_grads", TRAIN_CHECK_B), ("b_grads", 2)):
        g = grads[k]
        print(f"mesh ({k[0]}) gradients at {MESH_GRAD_LAYERS} layers on "
              f"{rows} x {TRAIN_CHECK_S}: loss {g['loss']:.6f} / one-card "
              f"{g['ref_loss']:.6f}; worst leaf over the ranks {g['worst']} "
              f"{g['err']:.3g} of its max |g| (tol {TRAIN_GRAD_TOL:g}) over "
              f"{g['leaves']} leaves a rank")
    print(f"mesh: each rank's peak {', '.join('%.3f' % p for p in peaks[0])}"
          f" GB in (a) (the dense layers whole on every rank: 8.153 GB a "
          f"rank), {', '.join('%.3f' % p for p in peaks[1])} GB in (b) "
          f"(together {sum(peaks[0]):.3f} / {sum(peaks[1]):.3f}, limit "
          f"{MESH_PEAK_GB}); launches a rank {results[0]['a_serve']['counts']}"
          f" (a serve), {results[0]['a_train']['counts']} (a train), "
          f"{results[0]['b_serve']['counts']} (b serve), "
          f"{results[0]['b_fsdp']['counts']} (b FSDP train); {MESH_RANKS} "
          f"ranks spawned, run and joined in {spawn_wall:.1f} s")
    checks = {
        "(a) BvSB": a_err <= BVSB_ATOL[torch.float32] and a_top1,
        "(a) ranks equal": _same_steps(results, "a_serve"),
        "(a) losses": loss_err <= TRAIN_LOSS_RTOL and same_losses,
        "(b) BvSB": b_err <= BVSB_ATOL[torch.float32] and b_top1,
        "(b) ranks equal": _same_steps(results, "b_serve"),
        "gradients": all(g["err"] <= TRAIN_GRAD_TOL and abs(
            g["loss"] - g["ref_loss"]) <= TRAIN_LOSS_RTOL * abs(g["ref_loss"])
            for g in grads.values()),
        "launches": not bad_counts,
        "peaks": max(sum(p) for p in peaks) <= MESH_PEAK_GB,
        **fsdp["checks"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh checks failed: {failed} (launches off "
                             f"at {bad_counts})")
    e = rg_mesh_check(dev, results[0]["e"], results)
    xl = xlstm_mesh_check(dev, results[0]["d"], results)
    total = {}
    for res in results:
        for k in want:
            _add_counts(total, res[k]["counts"])
        for counts in (res["e"]["counts"], res["d"]["counts"],
                       res["d"]["train"]["counts"]):
            _add_counts(total, counts)
    return total, dict(prefill_s=a["prefill_s"], step_ms=a["step_s"] * 1e3,
                       train_ms=tr["walls"][-1] * 1e3,
                       peak_gb=max(sum(p) for p in peaks),
                       rank_peak_gb=max(peaks[0]), rg=e, xlstm=xl,
                       fsdp=fsdp["figures"],
                       a_serve=dict(params_bytes=max(
                           res["a_serve"]["layout"]["params_bytes"]
                           for res in results), n_all_reduce=a["clock"]["n"],
                           logical=a["clock"]["logical"],
                           peak_gb=max(peaks[0])))


def mesh_path(dev):
    """Phase 13: (a), (b), (d) and (e) over the ranks; (c) seamless
    trained on the card at full width and depth; (f) seamless and xLSTM
    against the CPU at 2 layers. Returns (launches, figures)."""
    counts, out = mesh_lm_path(dev)
    sc, out["seamless"] = lm_train_path(
        dev, "13c", get_config(SEAM_ARCH), SEAMT_B, SEAMT_S, SEAMT_STEPS, 2,
        frames=SEAMT_FRAMES)
    _add_counts(counts, sc)
    for arch in (SEAM_ARCH, XLSTM_ARCH):
        train_check_cpu(dev, arch, 2)
        torch.cuda.empty_cache()
    return counts, out


def mesh_rows(timer):
    """Phase 3's rows of the partial and merge entries: BvSB's at granite's
    shard (phase 13's B and 64), decode attention's at RecurrentGemma-9B's
    ring cut in four ((e)'s B and 64) and at granite's ((a)'s)."""
    rg, gr = (RG_ARCH, 2048, 1, 16, 256), (GRANITE_ARCH, MESH_RING, 8, 2, 64)
    rows = {"bvsb_partials": {f"B={b}": timer.bvsb_partials(b)
                              for b in (MESH_B, 64)},
            "bvsb_merge": {f"B={b}": timer.bvsb_merge(b)
                           for b in (MESH_B, 64)}}
    for name, fn in (("decode_attention_partials", timer.decode_partials),
                     ("decode_attention_merge", timer.decode_merge)):
        rows[name] = {f"B={RGM_B}": fn(rg[0], RGM_B, *rg[1:]),
                      "B=64": fn(rg[0], 64, *rg[1:]),
                      "granite": fn(gr[0], MESH_B, *gr[1:])}
    return rows


def mesh_only(dev, timer):
    """``mesh``: the partial and merge checks and rows of phase 3, then
    phase 13."""
    check_bvsb_partials(dev)
    check_decode_shards(dev)
    mesh_rows(timer)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts, out = mesh_path(dev)
    t1 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        dry = pool.submit(dryrun_mesh_cells, _build.sm_count(dev)).result()
    dryrun_check({"a_serve": out["a_serve"], **out["fsdp"]}, dry)
    print(f"phase seconds: mesh and the new training paths "
          f"{t1 - t0:.1f}, the dry-run against it "
          f"{time.perf_counter() - t1:.1f}; launches {counts}")
    return 0


# ---------------------------------------------------------------------------
# phase 14: the plan autotuner, the dry-run against phase 13, timer floors
# ---------------------------------------------------------------------------
TUNED_TMP = ROOT / "build" / "tuned_plans_smoke.json"
# flash's tensor-core rule without the library, held to the library's
# choice over these (S, T, hd)
TC_RULE_SEQS, TC_RULE_HDS = (16, 39, 40, 47, 48, 79, 80, 512), (32, 128,
                                                                 160, 256)


def plan_sweep(card, knobs=None):
    """(a): ``autotune.sweep`` of every plan constant (or of ``knobs``),
    each candidate held to its plain version at every sweep shape (BvSB
    and decode in float32 at BVSB_ATOL / DECODE_ATOL's float32 figures,
    top-1 exact; the scan bit for bit) and printed against its bound; the
    swept results. Fails if any candidate at any shape disagrees."""
    assert autotune.F32_ATOL == {"bvsb": BVSB_ATOL[torch.float32],
                                 "decode_attention":
                                     DECODE_ATOL[torch.float32]}
    swept = {knob: autotune.sweep(knob) for knob in knobs or
             autotune.CANDIDATES}
    autotune.report(swept, card)
    bad = autotune.failures(swept)
    if bad:
        raise AssertionError("kernels disagree with their plain versions "
                             "at swept plans: " + "; ".join(bad))
    return swept


def tuned_plans_check(dev, swept, card):
    """(a) the winners persisted to a file under build/ and reloaded; then a
    plan other than the one in force (BvSB's fastest other BLOCKS_PER_SM)
    persisted and reloaded: ``cache_token`` changes, the serving
    executable cache takes a new entry, and the cascade's server BvSB
    (tier-server-heavy's classify at its bucket of 8) under it equals the
    default plans' within BVSB_ATOL, top-1 exact. The defaults are put
    back and the token with them."""
    from repro_torch.serving import executables
    default_token = ops.cache_token(dev)
    TUNED_TMP.unlink(missing_ok=True)
    winners = autotune.winners_of(swept)
    in_force = autotune.persist(winners, card, TUNED_TMP)
    changed = in_force != ops.DEFAULT_PLANS
    if (ops.cache_token(dev) != default_token) != changed:
        raise AssertionError("cache_token does not follow the plans")
    print(f"autotune winners on {card}: {json.dumps(winners, sort_keys=True)}"
          f"; persisted to {TUNED_TMP.name} and reloaded: plans "
          f"{'differ from' if changed else 'equal'} the defaults")
    model = build_models(dev)["tier-server-heavy"]
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, VOCAB, (8, SEQ)), device=dev)
    ops.reload_plans(TUNED_TMP.with_suffix(".none"))
    conf0, top0 = executables.classify_fn(model, 8)(model, tokens)
    other = next(r["value"] for r in swept[("bvsb", "BLOCKS_PER_SM")]
                 if r["numerics_ok"] and not r["current"])
    before = executables.cache_stats()["executables"]
    autotune.persist({"bvsb": {"BLOCKS_PER_SM": other}}, card, TUNED_TMP)
    token = ops.cache_token(dev)
    conf, top1 = executables.classify_fn(model, 8)(model, tokens)
    err = max_err(conf, conf0)
    ok = token != default_token and torch.equal(top1, top0) and \
        err <= BVSB_ATOL[torch.float32] and \
        executables.cache_stats()["executables"] == before + 1
    print(f"autotune reload: bvsb.BLOCKS_PER_SM={other} in force, "
          f"cache_token {default_token} -> {token}, a new executable, the "
          f"cascade's server BvSB max|err| {err:.3g} (tol "
          f"{BVSB_ATOL[torch.float32]:g}), top-1 equal {torch.equal(top1, top0)}")
    ops.reload_plans(TUNED_TMP.with_suffix(".none"))
    TUNED_TMP.unlink(missing_ok=True)
    if not ok or ops.cache_token(dev) != default_token or \
            ops.plans() != ops.DEFAULT_PLANS:
        raise AssertionError("the reloaded plans do not serve the cascade's "
                             "BvSB, or the defaults did not come back")


def tensor_core_rule_check():
    """The roofline's flash work takes the tensor-core rule without the
    library (``flash_attention.tensor_core_rule``): held to the library's
    choice, forward and backward."""
    bad = [(s, t, hd, bwd) for s in TC_RULE_SEQS for t in TC_RULE_SEQS
           for hd in TC_RULE_HDS for bwd in (False, True)
           if _flash.tensor_core_rule(s, hd, t, bwd) != (
               _flash.uses_tensor_cores_bwd if bwd else
               _flash.uses_tensor_cores)(s, hd, t)]
    if bad:
        raise AssertionError(f"tensor_core_rule differs from the library at "
                             f"{bad[:4]}")
    print(f"tensor_core_rule = the library's choice at "
          f"{len(TC_RULE_SEQS) ** 2 * len(TC_RULE_HDS) * 2} (S, T, hd, "
          "direction)")


def dryrun_mesh_cells(sms):
    """(b)'s dry-run, in a process of its own (a fake process group of
    MESH_RANKS ranks, this process rank 0): phase 13's granite cells on
    ``meta`` in f32, the decode splits planned for ``sms`` SMs: (a)'s serve
    step on MESH_SHAPE into rings of MESH_RING slots, (b)'s train step of
    MESH_TRAIN_B x MESH_S on (2, 2), stored FSDP and resident."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_model_mesh
    _build.META_SMS = sms
    cfg = get_config(GRANITE_ARCH)
    serve = InputShape("phase13_serve", MESH_S, MESH_B, "decode")
    train = InputShape("phase13_train", MESH_S, MESH_TRAIN_B, "train")
    out = {}
    with dryrun.fake_world(MESH_RANKS):
        mesh = make_model_mesh(MESH_SHAPE, device_type="cpu")
        out["a_serve"] = dryrun.dry_run(cfg, serve, mesh, dtype=torch.float32,
                                        cache_len=MESH_RING)
        mesh = make_model_mesh((2, 2), device_type="cpu")
        for key, fsdp in (("b_fsdp", True), ("b_resident", False)):
            out[key] = dryrun.dry_run(cfg, train, mesh, dtype=torch.float32,
                                      fsdp=fsdp, accum_steps=1)
    return out


def dryrun_check(measured, dry):
    """(b): the dry-run's bytes a rank equal phase 13's measured ones
    exactly ((a)'s parameters; (b)'s parameters and AdamW's state), its
    collectives the measured step's, call for call and bytes for bytes of
    every logical kind (the gather buffers' dtype aside: the dry-run
    decodes over bf16 rings, phase 13 over the prefill's f32 ones, so (a)'s
    bytes are printed, not compared); its peak estimate printed beside the
    measured peak."""
    rows = (("a_serve", "params_bytes", "param_bytes_per_device"),
            ("b_fsdp", "stored_bytes", None), ("b_resident", "stored_bytes",
                                               None))
    ok = True
    for key, have, want in rows:
        d = dry[key]
        got = d[want] if want else d["param_bytes_per_device"] + \
            d["opt_bytes_per_device"]
        m = measured[key]
        same_bytes = got == m[have]
        same_calls = d["collective_calls"] == m["n_all_reduce"]
        same_ops = {k: v["calls"] for k, v in d["collectives"].items()} == \
            {k: v["calls"] for k, v in m["logical"].items()}
        same_ring = key == "a_serve" or {
            k: v["bytes"] for k, v in d["collectives"].items()} == {
            k: v["bytes"] for k, v in m["logical"].items()}
        ok &= same_bytes and same_calls and same_ops and same_ring
        print(f"dry-run vs phase 13 {key}: stored a rank {got} B (measured "
              f"{m[have]} B, equal {same_bytes}); collectives "
              f"{d['collective_calls']} (measured {m['n_all_reduce']} "
              f"all_reduces; by kind equal {same_ops}, ring bytes equal "
              f"{same_ring}: {json.dumps(d['collectives'])}); peak estimate "
              f"{d['memory_analysis']['peak_bytes'] / 1e9:.3f} GB (measured "
              f"{m['peak_gb']:.3f} GB); dry-run {d['wall_s']} s on the CPU")
    if not ok:
        raise AssertionError("the dry-run disagrees with phase 13's "
                             "measurement")


def timer_floor_check():
    """(c): ``time_ms``'s events span at least MIN_RES_MULT times their
    documented resolution (a short kernel grows its calls until they do)
    and ``time_blocked``'s block at least MIN_RES_MULT times
    perf_counter's."""
    x = torch.ones(1024, device="cuda")
    floor_ms = timing.MIN_RES_MULT * timing.EVENT_RESOLUTION_MS
    ms, _ = time_ms(lambda: x.add_(1.0), iters=1)
    per, block, reps = timing.time_blocked(
        lambda: (x.add_(1.0), torch.cuda.synchronize()))
    floor_s = timing.MIN_RES_MULT * timing.timer_resolution()
    print(f"timer floors: CUDA event resolution "
          f"{timing.EVENT_RESOLUTION_MS * 1e3:.1f} us (documented), span "
          f"floor {floor_ms * 1e3:.1f} us; a 1,024-float add "
          f"{ms * 1e3:.3f} us on the device; time_blocked {reps} reps in "
          f"{block * 1e6:.1f} us >= {floor_s * 1e6:.3f} us "
          f"({per * 1e6:.3f} us a call, synchronised)")
    if block < floor_s or not ms > 0:
        raise AssertionError("a timed span is under its floor")


def tuning_path(dev, measured):
    """Phase 14: (a) the plan sweep, the tuned file round trip (keyed by
    the card's name, as ``ops.reload_plans`` reads it) and the
    tensor-core rule; (b) the dry-run of phase 13's cells (a process of
    its own, started first) against ``measured``; (c) the timer floors."""
    card = torch.cuda.get_device_name(dev)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        dry = pool.submit(dryrun_mesh_cells, _build.sm_count(dev))
        swept = plan_sweep(card)
        tuned_plans_check(dev, swept, card)
        tensor_core_rule_check()
        timer_floor_check()
        dryrun_check(measured, dry.result())


def main(argv) -> int:
    if argv not in ([], ["zoo"], ["train"], ["softcap"], ["mesh"]):
        print("usage: chip_smoke.py [zoo | train | softcap | mesh]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    rates = rates_for(card)

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        _build.build(verbose=True)
    sys.stderr.write(log.getvalue())
    print_ptxas(log.getvalue())
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (set-up; "
          f"{len(_build.sources())} sources, key {_build.build_key()})")
    if argv == ["zoo"]:
        return zoo_only(dev, Timer(dev, rates))
    if argv == ["train"]:
        return train_only(dev, Timer(dev, rates))
    if argv == ["softcap"]:
        return softcap_only(dev, Timer(dev, rates))
    if argv == ["mesh"]:
        return mesh_only(dev, Timer(dev, rates))

    t1 = time.perf_counter()
    laps = []
    for check in (check_bvsb, check_flash, check_decode, check_rglru,
                  check_flash_bwd, check_rglru_bwd, check_rglru_bwd_paths,
                  check_grad_guard, check_capped, check_bvsb_partials,
                  check_decode_shards):
        t = time.perf_counter()
        check(dev)
        laps.append((check.__name__, time.perf_counter() - t))
    timer = Timer(dev, rates)
    t = time.perf_counter()
    for b in (1, 16, 64):
        timer.bvsb(b)
    timer.flash("tier-low", 1)
    for tier in ("tier-server-fast", "tier-server-heavy"):
        for b in (16, 64):
            timer.flash(tier, b)
    timer.flash_threshold()
    rg_rows = {"bvsb": timer.bvsb_rows(RG_B, 256_000),
               "flash_attention": timer.flash_rg(),
               "decode_attention": timer.decode_rg(),
               "rglru_scan": timer.rglru_rg()}
    b64_rows = {"bvsb": timer.bvsb_rows(64, 256_000),
                "decode_attention": timer.decode_rg(b=64)}
    decode_rows = {"bf16": timer.decode_rg(dt=torch.bfloat16),
                   "f32_over_bf16_cache": timer.decode_rg(
                       cache_dt=torch.bfloat16)}
    scan_rows = {"bf16": timer.rglru_rg(dt=torch.bfloat16),
                 "b1": timer.rglru_rg(b=1)}
    laps.append(("the serving paths' times", time.perf_counter() - t))
    t = time.perf_counter()
    # the zoo's prefill and decode attention (phase 9), rings full
    zoo_rows = {"flash_attention": {}, "decode_attention": {}}
    for name, _, _ in ZOO_MODELS:
        cfg = get_config(name)
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        zoo_rows["flash_attention"][name] = timer.flash(name, ZOO_B, ZOO_S)
        zoo_rows["decode_attention"][name] = timer.decode_at(
            name, ZOO_B, ZOO_S, kv, cfg.num_heads // kv, hd)
    laps.append(("the zoo's times", time.perf_counter() - t))
    timing = {}
    for name, rows in (("rest of the zoo", zoo10_rows),
                       ("training", train_rows), ("soft cap", cap_rows),
                       ("mesh", mesh_rows)):
        t = time.perf_counter()
        timing[name] = rows(timer)
        laps.append((f"{name} times", time.perf_counter() - t))
    zoo10_timing, train_timing, cap_timing, mesh_timing = timing.values()
    torch.cuda.empty_cache()
    print("kernels phase seconds: " + ", ".join(f"{name} {sec:.1f}"
                                                for name, sec in laps))

    t2 = time.perf_counter()
    counts, engine, cascade_run = main_path(dev)
    t3 = time.perf_counter()
    rg_counts, rg = recurrentgemma_path(dev)
    t4 = time.perf_counter()
    sim_counts, sim = simulator_path(dev)
    t5 = time.perf_counter()
    transport_counts = transport_replay_seg_path(dev, cascade_run, counts)
    t6 = time.perf_counter()
    torch.cuda.empty_cache()
    sharded_path(dev, sim["width_ref"], sweep_s=SIM_WIDTH_S)
    t7 = time.perf_counter()
    zoo_counts, zoo = zoo_path(dev)
    t8 = time.perf_counter()
    zoo10_counts, zoo10 = zoo10_path(dev)
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    train_counts, trained = training_path(dev)
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    cap_counts, capped = softcap_path(dev)
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    mesh_counts, meshed = mesh_path(dev)
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    tuning_path(dev, {"a_serve": meshed["a_serve"], **meshed["fsdp"]})
    print(f"phase seconds: build {t1 - t0:.1f}, kernels {t2 - t1:.1f}, "
          f"cascade path with its profiled rerun {t3 - t2:.1f}, "
          f"{RG_ARCH} path with its CPU check {t4 - t3:.1f}, simulator "
          f"with its CPU check, width sweep and profiled rerun "
          f"{t5 - t4:.1f}, transport + replay + segmented frontier "
          f"{t6 - t5:.1f}, sharded sweeps {t7 - t6:.1f}, zoo with its "
          f"profiled reruns and CPU checks {t8 - t7:.1f}, rest of the zoo "
          f"with its profiled reruns and CPU checks {t9 - t8:.1f}, "
          f"training with its CPU checks {t10 - t9:.1f}, soft-capped "
          f"{CAP_ARCH} with its CPU checks {t11 - t10:.1f}, mesh and the new "
          f"training paths with their CPU checks {t12 - t11:.1f}, plan "
          f"sweep, tuned plans, dry-run against phase 13 and timer floors "
          f"{time.perf_counter() - t12:.1f}; all phases "
          f"{time.perf_counter() - t0:.1f}")

    # the kernels line times each kernel at the RecurrentGemma path's shape;
    # BvSB and flash also at the cascade's most frequent server batch (the
    # clients' B = 1 calls are launch-bound)
    pairs = [(r["model"], r["bucket"]) for r in engine.records]
    tier, bucket = max(set(pairs), key=pairs.count)
    cascade_rows = {"bvsb": timer.bvsb(bucket),
                    "flash_attention": timer.flash(tier, bucket)}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fp32_ms", "library_ms", "call_ms", "shape")
    kernels = []
    for name, source, replaces in (
            ("bvsb", "bvsb.cu", "src/repro/kernels/bvsb.py:82"),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:81"),
            ("decode_attention", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:59"),
            ("rglru_scan", "rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:44"),
            ("flash_attention_bwd", "flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:81"),
            ("rglru_scan_bwd", "rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:44"),
            ("bvsb_partials", "bvsb.cu", "src/repro/kernels/bvsb.py:82"),
            ("bvsb_merge", "bvsb.cu", "src/repro/kernels/bvsb.py:82"),
            ("decode_attention_partials", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:59"),
            ("decode_attention_merge", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:59")):
        by_path = {"cascade": counts[name], RG_ARCH: rg_counts[name],
                   "simulator": sim_counts[name],
                   "transport": transport_counts[name],
                   "zoo": zoo_counts[name],
                   "rest of the zoo": zoo10_counts[name],
                   "training": train_counts[name],
                   "softcap": cap_counts[name],
                   "mesh (summed over the ranks)": mesh_counts[name]}
        # a backward kernel's row: RecurrentGemma's training shape; the
        # partial and merge entries': BvSB's at granite's shard, decode's
        # at RecurrentGemma's ring cut in four, at phase 13's B
        row = rg_rows.get(name) or (
            mesh_timing[name][f"B={MESH_B}"] if name in mesh_timing else
            train_timing[name][RG_ARCH if name == "flash_attention_bwd"
                               else "f32"])
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{source}",
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "path": "mesh" if name in mesh_timing else RG_ARCH,
                 **{k: row[k] for k in keys if k in row}}
        if name in mesh_timing:
            entry["b64"] = {k: mesh_timing[name]["B=64"][k] for k in keys
                            if k in mesh_timing[name]["B=64"]}
        if name in cascade_rows:
            entry["cascade"] = {k: cascade_rows[name][k] for k in keys
                                if k in cascade_rows[name]}
        if name in b64_rows:
            entry["b64"] = {k: b64_rows[name][k] for k in keys
                            if k in b64_rows[name]}
        extra = {"rglru_scan": scan_rows,
                 "decode_attention": decode_rows}.get(name, {})
        if name.startswith("decode_attention_"):
            extra = {GRANITE_ARCH: mesh_timing[name]["granite"]}
        entry.update({tag: {k: row[k] for k in keys if k in row}
                      for tag, row in extra.items()})
        if name in zoo_rows:
            entry["zoo"] = {arch: {k: row[k] for k in keys if k in row}
                            for arch, row in zoo_rows[name].items()}
        if name in zoo10_timing:
            entry["rest of the zoo"] = {
                form: {k: row[k] for k in keys if k in row}
                for form, row in zoo10_timing[name].items()}
        if name in train_timing:
            entry["training"] = {
                form: {k: r[k] for k in keys if k in r}
                for form, r in train_timing[name].items()}
        if name in cap_timing:
            entry["soft_cap"] = {
                form: {k: r[k] for k in keys + ("library_note",) if k in r}
                for form, r in cap_timing[name].items()}
        if name == "rglru_scan_bwd":
            entry["per_element_ms"] = {
                tag: r["elem_ms"] for tag, r in train_timing[name].items()}
        if name in ("flash_attention", "flash_attention_bwd"):
            entry["forms"] = ["causal or windowed, T = S",
                              "non-causal, T = S",
                              "non-causal over T != S keys (cross-attention)",
                              f"soft_cap (c tanh(s / c), {CAP_ARCH} c = "
                              f"{CAP:g}) on any of the above"]
        if name == "decode_attention":
            entry["forms"] = ["ring of W slots, lengths", f"soft_cap ("
                              f"{CAP_ARCH} c = {CAP:g})"]
        kernels.append(entry)
    print(f"{RG_ARCH} path seconds: init {rg['init_s']:.3f}, prefill "
          f"{rg['prefill_s']:.3f}, decode {rg['decode_s']:.3f}; peak "
          f"{rg['peak_gb']:.3f} GB; simulator (a) {sim['hetero_wall']:.3f} "
          f"s, (b) {sim['env_wall']:.3f} s, peak {sim['peak_gb']:.3f} GB")
    for name, w in {**zoo, **zoo10}.items():
        print(f"{name} path: {w['params']} parameters, init "
              f"{w['init_s']:.3f} s, prefill {w['prefill_s']:.3f} s, decode "
              f"{w['step_ms']:.2f} ms a step, peak {w['peak_gb']:.3f} GB")
    print(f"{CAP_ARCH} soft-capped path: serving {capped['serving']['params']}"
          f" parameters, prefill {capped['serving']['prefill_s']:.3f} s, "
          f"decode {capped['serving']['step_ms']:.2f} ms a step; training "
          f"{capped['training']['step_ms']:.1f} ms a step, "
          f"{capped['training']['tokens_per_s']:.1f} tokens/s, peak "
          f"{capped['training']['peak_gb']:.3f} GB")
    print(f"mesh path: (a) prefill {meshed['prefill_s']:.3f} s, serve "
          f"{meshed['step_ms']:.2f} ms a step, training "
          f"{meshed['train_ms']:.1f} ms a step, the ranks' peaks together "
          f"{meshed['peak_gb']:.3f} GB (a rank at most "
          f"{meshed['rank_peak_gb']:.3f}); (e) {RG_ARCH} prefill "
          f"{meshed['rg']['prefill_s']:.3f} s, serve "
          f"{meshed['rg']['step_ms']:.2f} ms a step "
          f"({meshed['rg']['n_all_reduce']} all_reduces, "
          f"{meshed['rg']['share']:.4f} of a step), a rank's peak at most "
          f"{meshed['rg']['peak_gb']:.3f} GB; (b) training a rank stores "
          f"{meshed['fsdp']['b_fsdp']['stored_gb']:.3f} GB FSDP / "
          f"{meshed['fsdp']['b_resident']['stored_gb']:.3f} resident, peak "
          f"{meshed['fsdp']['b_fsdp']['peak_gb']:.3f} / "
          f"{meshed['fsdp']['b_resident']['peak_gb']:.3f} GB, a step "
          f"{meshed['fsdp']['b_fsdp']['step_ms']:.1f} / "
          f"{meshed['fsdp']['b_resident']['step_ms']:.1f} ms; (d) "
          f"{XLSTM_ARCH} prefill {meshed['xlstm']['prefill_s']:.3f} s, serve "
          f"{meshed['xlstm']['step_ms']:.2f} ms a step, training "
          f"{meshed['xlstm']['train_ms']:.1f} ms a step; seamless training "
          f"{meshed['seamless']['step_ms']:.1f} ms a step")
    for name in (GRANITE_ARCH, RG_ARCH):
        w = trained[name]
        print(f"{name} training: {w['params']} parameters, "
              f"{w['step_ms']:.1f} ms a step, {w['tokens_per_s']:.1f} "
              f"tokens/s, peak {w['peak_gb']:.3f} GB, idle share "
              f"{w['idle']:.4f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
