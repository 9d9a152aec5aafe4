"""Training of the encoder-decoder (seamless-m4t-medium) and of xLSTM
(xlstm-350m) held to the JAX package on the CPU, at ``reduced()`` size.

``Model.loss`` differentiated by autograd against ``jax.grad`` of the
JAX ``Model.loss`` on the same weights (carried across by
``params_from_jax``) and a numpy batch from a seed (seamless: seeded
audio frame embeddings; xLSTM: two mLSTM chunks, so the state carries
across a chunk in the backward); remat on against off; one step of
``launch.distributed.make_train_step`` against the JAX one on an
Auto-axis (1, 1) mesh; the trainer's own step on an encoder-decoder.

Tolerances, those of tests/test_torch_grads.py: the loss 1e-5 relative;
each leaf's gradient within 1e-4 of that leaf's max |g| (float32 sums in
another order); the train step's metrics 1e-5 relative, its first
moments 1e-4 of a leaf's max, its parameters within 2 lr of JAX's; remat
bitwise (the recompute repeats the forward's operations).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import distributed as jdist
from repro.models import xlstm as jxlstm
from repro.models.model import build_model as jbuild_model
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.launch import distributed as dist
from repro_torch.models import xlstm
from repro_torch.models.model import params_from_jax
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import (TrainConfig, make_train_step,
                                          trainable)
from test_torch_grads import (GRAD_TOL, LOSS_RTOL, _check_grads, _jax_leaf,
                              _leaf_err)

torch.set_num_threads(2)

# arch -> (B, S): seamless over its reduced 64 frames; xLSTM over two
# mLSTM chunks of 128
CASES = {"seamless-m4t-medium": (2, 16), "xlstm-350m": (2, 256)}


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
            assert repr(cfg) == repr(jcfg)
            jm = jbuild_model(jcfg)
            tree = jax.tree.map(np.asarray, jm.init(
                jax.random.key(17 + list(CASES).index(name))))
            cache[name] = (jm, tree, cfg)
        return cache[name]

    return get


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -100, np.int32)],
                            axis=1)
    labels[0, :3] = -100                   # some ignored positions
    batch = {"tokens": tokens, "labels": labels}
    if cfg.is_encoder_decoder:
        batch["audio_embeds"] = rng.standard_normal(
            (b, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def _inputs(batch):
    audio = batch.get("audio_embeds")
    return {} if audio is None else {"audio_embeds": torch.from_numpy(audio)}


def _port_grads(model, batch, remat=False, labels=True):
    params = trainable(model)
    loss, met = model.loss(
        torch.from_numpy(batch["tokens"]),
        torch.from_numpy(batch["labels"]) if labels else None,
        remat=remat, **_inputs(batch))
    gs = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), met, dict(zip(params, gs))


@pytest.mark.parametrize("name", list(CASES))
def test_loss_gradients_match_jax(built, name):
    jm, tree, cfg = built(name)
    batch = _batch(cfg, *CASES[name], 1)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: jm.loss(p, bt), has_aux=True))(tree, batch)
    model = params_from_jax(tree, cfg, device="cpu")
    loss, met, grads = _port_grads(model, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    for g in grads.values():
        assert torch.isfinite(g).all()
    assert _check_grads(model, grads, jgrads, cfg) == len(grads)


@pytest.mark.parametrize("name", list(CASES))
def test_default_labels_are_the_shifted_tokens(built, name):
    """``loss`` without labels takes the tokens shifted by one, -100 last,
    as JAX's ``Model.loss`` does."""
    jm, tree, cfg = built(name)
    batch = _batch(cfg, *CASES[name], 2)
    del batch["labels"]
    jloss, _ = jm.loss(tree, batch)
    model = params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        loss, _ = model.loss(torch.from_numpy(batch["tokens"]),
                             **_inputs(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_remat_gives_the_same_gradients(built, name):
    """Per-layer checkpointing (the encoder's layers, the decoder's with
    their cross K/V; xLSTM's cells): the recompute repeats the forward, so
    the gradients are bitwise those of no remat."""
    jm, tree, cfg = built(name)
    batch = _batch(cfg, *CASES[name], 3)
    out = [_port_grads(params_from_jax(tree, cfg, device="cpu"), batch,
                       remat=remat) for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for key in out[0][2]:
        assert torch.equal(out[0][2][key], out[1][2][key]), key


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("name,accum", [("seamless-m4t-medium", 1),
                                        ("seamless-m4t-medium", 2),
                                        ("xlstm-350m", 1)])
def test_train_step_matches_jax(built, mesh, name, accum):
    """One step of the port's ``make_train_step`` (remat on, the batch's
    ``audio_embeds`` for seamless) against the JAX package's on a (1, 1)
    mesh from the same weights and batch."""
    jm, tree, cfg = built(name)
    b, s = CASES[name]
    batch = _batch(cfg, 2 * b, s, 4)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    jstep = jax.jit(jdist.make_train_step(jm, mesh, remat=True,
                                          accum_steps=accum, adamw=jcfg))
    with mesh:
        jparams, jstate, jmet = jstep(tree, jopt.init(tree), batch)

    model = params_from_jax(tree, cfg, device="cpu")
    step = dist.make_train_step(model, remat=True, accum_steps=accum,
                                adamw=opt.AdamWConfig(
                                    **dataclasses.asdict(jcfg)))
    state, met = step(opt.init(trainable(model)), batch)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert float(met[key]) == pytest.approx(
            float(jmet[key]), rel=LOSS_RTOL, abs=1e-7), key
    lr = float(met["lr"])
    for pname, p in model.named_parameters():
        mu = _jax_leaf(jstate["mu"], pname, cfg)
        assert _leaf_err(state["mu"][pname].numpy(), mu) <= GRAD_TOL, pname
        ref = _jax_leaf(jparams, pname, cfg)
        assert np.abs(p.detach().numpy() - ref).max() <= 2 * lr + 1e-7, pname


def test_trainer_step_trains_an_encoder_decoder(built):
    """``training.trainer.make_train_step`` passes an encoder-decoder
    batch's ``audio_embeds`` to ``loss``; microbatched it gives the
    full batch's gradient (the loss is a mean per microbatch, so equal
    label counts make the two equal)."""
    jm, tree, cfg = built("seamless-m4t-medium")
    batch = _batch(cfg, 4, 16, 5)
    batch["labels"][:, :3] = -100          # the same count in every row
    moments = []
    for micro in (None, 2):
        model = params_from_jax(tree, cfg, device="cpu")
        step = make_train_step(model, TrainConfig(microbatch=micro))
        state, met = step(opt.init(trainable(model)), batch)
        assert np.isfinite(float(met["loss"]))
        moments.append(state["mu"])
    for key in moments[0]:
        assert _leaf_err(moments[1][key].numpy(),
                         moments[0][key].numpy()) <= GRAD_TOL, key


def test_mlstm_gradient_is_finite_where_the_decay_overflows():
    """Above the diagonal a chunk's log-weights can pass 88 (forget gates
    near -8 over a chunk), where exp overflows. The forward masks them
    out; the backward must not turn inf * 0 into NaN. JAX's does (its
    ``where`` after the exp): the divergence ROADMAP.md records."""
    rng = np.random.default_rng(7)
    b, s, h, p = 1, 128, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    log_i = torch.zeros(b, s, h, requires_grad=True)
    log_f = torch.full((b, s, h), -8.0, requires_grad=True)
    out, _ = xlstm.mlstm_parallel(q, k, v, log_i, log_f)
    assert torch.isfinite(out).all()
    grads = torch.autograd.grad(out.sum(), (q, k, v, log_i, log_f))
    for g in grads:
        assert torch.isfinite(g).all()
    jgrad = jax.grad(lambda *a: jxlstm.mlstm_parallel(*a)[0].sum(),
                     argnums=4)(*(t.detach().numpy() for t in (
                         q, k, v, log_i, log_f)))
    assert np.isnan(np.asarray(jgrad)).any()
