"""The port's training pieces held to the JAX package on the CPU: AdamW,
checkpoints across the two packages, the data streams, the trainer's
microbatching, its loss going down, and distillation.

Tolerances: one AdamW update 1e-6 relative (a leaf's max |diff| over its
max |ref|; float32 ops in the same order, sums over leaves in another);
the learning-rate schedule 1e-6 relative; checkpoints and the
classification stream bitwise; microbatched against full-batch
gradients 1e-4 of a leaf's max |g| (float32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.models.model import init_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data
from repro_torch.training import optimizer as opt
from repro_torch.training.distill import (DistillConfig, kd_loss,
                                          make_distill_step)
from repro_torch.training.trainer import (TrainConfig, make_train_step,
                                          train, trainable)

torch.set_num_threads(2)

RTOL = 1e-6
GRAD_TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / (scale if scale > 0 else 1.0)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal(5) * scale).astype(np.float32),
            "emb": {"table": (rng.standard_normal((7, 6)) * scale)
                    .astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _torch(flat):
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step0,grad_scale", [(0, 1.0), (7, 1.0), (3, 50.0),
                                              (150, 1e-3)])
def test_adamw_update_matches_jax(step0, grad_scale):
    """One update from the same params, grads and state (step0 prior
    steps): params, mu, nu within 1e-6 relative, the same step, lr and
    grad_norm within 1e-6 relative; grad_scale 50 clips."""
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=200)
    params, grads = _tree(0), _tree(1, grad_scale)
    mu, nu = _tree(2, 0.1), jax.tree.map(np.abs, _tree(3, 0.01))
    jstate = {"mu": mu, "nu": nu, "step": jnp.asarray(step0, jnp.int32)}
    jp, js, jm = jopt.update(params, grads, jstate, cfg)

    pcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    p = _torch(_flat(params))
    state = {"mu": _torch(_flat(mu)), "nu": _torch(_flat(nu)),
             "step": torch.tensor(step0, dtype=torch.int32)}
    p, state, m = opt.update(p, _torch(_flat(grads)), state, pcfg)
    for name, ref in _flat(jax.tree.map(np.asarray, jp)).items():
        assert _rel(p[name].numpy(), ref) <= RTOL, name
    for key in ("mu", "nu"):
        for name, ref in _flat(jax.tree.map(np.asarray, js[key])).items():
            assert _rel(state[key][name].numpy(), ref) <= RTOL, (key, name)
    assert int(state["step"]) == int(js["step"]) == step0 + 1
    for key in ("lr", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= RTOL * abs(
            float(jm[key])), key


def test_adamw_schedule_matches_jax():
    cfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=60)
    pcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 11, 35, 59, 60, 80):
        ref = float(jopt.schedule(cfg, jnp.asarray(step)))
        got = float(opt.schedule(pcfg, torch.tensor(step)))
        assert abs(got - ref) <= RTOL * max(abs(ref), 1e-12), step
    assert float(opt.schedule(pcfg, torch.tensor(5))) == pytest.approx(1.5e-3)
    assert float(opt.schedule(pcfg, torch.tensor(60))) == pytest.approx(3e-4)


def test_adamw_clips_before_the_moments_and_decays_matrices_only():
    cfg = opt.AdamWConfig(lr=1e-2, weight_decay=0.5, grad_clip=1.0,
                          warmup_steps=0, total_steps=10)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.full((2, 2), 3.0), "b": torch.zeros(2)}
    state = opt.init(p)
    p, state, m = opt.update(p, g, state, cfg)
    assert float(m["grad_norm"]) == pytest.approx(6.0)
    # mu = (1 - b1) * g * clip, clip = 1 / 6
    torch.testing.assert_close(state["mu"]["w"],
                               torch.full((2, 2), 0.1 * 3.0 / 6.0),
                               rtol=1e-6, atol=0)
    # a zero gradient moves a vector by nothing, and decays no 1-D tensor
    assert torch.equal(p["b"], torch.ones(2))
    # the matrix: the Adam step (about 1) plus the decay 0.5 * 1
    lr = float(m["lr"])
    torch.testing.assert_close(p["w"], torch.full((2, 2), 1 - lr * 1.5),
                               rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _ckpt_tree():
    rng = np.random.default_rng(4)
    return {"embed": {"table": rng.standard_normal((5, 3)).astype(np.float32)},
            "blocks": [{"w": rng.standard_normal((3, 3)).astype(np.float32),
                        "h": rng.standard_normal((2, 4)).astype(
                            ml_dtypes.bfloat16)},
                       {"w": rng.standard_normal((3, 3)).astype(np.float32),
                        "n": np.arange(4, dtype=np.int32)}]}


def _as_torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _as_torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch_tree(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _bits(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    arr = np.asarray(t)
    return arr.view(np.uint16) if arr.dtype == jnp.bfloat16 else arr


def test_checkpoint_jax_written_restores_in_the_port(tmp_path):
    tree = _ckpt_tree()
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, tree, step=12)
    template = {"embed": {"table": torch.zeros(5, 3)},
                "blocks": [{"w": torch.zeros(3, 3),
                            "h": torch.zeros(2, 4, dtype=torch.bfloat16)},
                           {"w": torch.zeros(3, 3),
                            "n": torch.zeros(4, dtype=torch.int32)}]}
    got, step = ckpt.restore(path, template)
    assert step == 12
    ref = _as_torch_tree(tree)
    for (a, b) in ((got["embed"]["table"], ref["embed"]["table"]),
                   (got["blocks"][0]["w"], ref["blocks"][0]["w"]),
                   (got["blocks"][0]["h"], ref["blocks"][0]["h"]),
                   (got["blocks"][1]["n"], ref["blocks"][1]["n"])):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_checkpoint_port_written_restores_in_jax(tmp_path):
    tree = _ckpt_tree()
    path = str(tmp_path / "port.npz")
    ckpt.save(path, _as_torch_tree(tree), step=3)
    got, step = jckpt.restore(path, tree)
    assert step == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, {"w": torch.zeros(3, 2)})
    with pytest.raises(KeyError):
        ckpt.restore(path, {"v": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        jckpt.restore(path, {"w": np.zeros((3, 2), np.float32)})


def test_save_model_round_trips_a_module(tmp_path):
    cfg = get_config("tier-low").with_(vocab_size=64)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.bfloat16)
    path = str(tmp_path / "m.npz")
    ckpt.save_model(path, model, step=5)
    keys = set(np.load(path).files)
    assert "__bf16__layers/0/attn/wq" in keys and "__step__" in keys
    other = init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                        dtype=torch.bfloat16)
    assert ckpt.restore_model(path, other) == 5
    for (n, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [(2048, 16, 256, 8, 0), (50, 7, 1000, 3, 5)])
def test_classification_stream_is_bitwise_the_jax_packages(args):
    t, l = data.classification_stream(*args)
    jt, jl = jdata.classification_stream(*args)
    assert t.dtype == jt.dtype and l.dtype == jl.dtype
    assert np.array_equal(t, jt) and np.array_equal(l, jl)


def test_transition_logits_are_the_jax_packages():
    for a, b in zip(data._transition_logits(300, 3),
                    jdata._transition_logits(300, 3)):
        assert np.array_equal(a, b)


def test_synthetic_lm_is_deterministic_in_range_and_shifted():
    cfg = data.DataConfig(vocab_size=5000, seq_len=24, global_batch=3, seed=2)
    lm = data.SyntheticLM(cfg, device="cpu")
    b0, again, b1 = lm.batch_at(0), lm.batch_at(0), lm.batch_at(1)
    assert torch.equal(b0["tokens"], again["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    t, lbl = b0["tokens"], b0["labels"]
    assert t.shape == lbl.shape == (3, 24) and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < min(cfg.vocab_size, 4096)
    assert torch.equal(lbl[:, :-1], t[:, 1:]) and (lbl[:, -1] == -100).all()
    other = lm.batch_at(0, batch=2, seq_len=8)
    assert other["tokens"].shape == (2, 8)


def test_synthetic_lm_follows_its_transition():
    """The chain's next token is drawn from softmax(0.5 a[tok] b + topic b):
    over many steps the tokens the transition favours come up far more
    often than uniform."""
    cfg = data.DataConfig(vocab_size=64, seq_len=400, global_batch=4, seed=0)
    lm = data.SyntheticLM(cfg, device="cpu")
    t = lm.batch_at(0)["tokens"].long()
    a, b = data._transition_logits(64, 0)
    logits = torch.from_numpy(a)[t[:, :-1]] @ torch.from_numpy(b) * 0.5
    ranks = (logits > logits.gather(-1, t[:, 1:, None])).sum(-1).float()
    # uniform draws would rank 31.5 on average
    assert float(ranks.mean()) < 16


# ---------------------------------------------------------------------------
# trainer and distillation
# ---------------------------------------------------------------------------
class TaskData:
    """examples/serve_cascade.py's task: the label at the last position."""

    def __init__(self, vocab=256, seq_len=16, n_classes=8, bs=16):
        self.toks, self.labels = data.classification_stream(
            512, seq_len, vocab, n_classes, 0)
        self.bs, self.seq_len = bs, seq_len

    def batch_at(self, step):
        bs = self.bs
        i = (step * bs) % (len(self.toks) - bs)
        lbl = np.full((bs, self.seq_len), -100, np.int32)
        lbl[:, -1] = self.labels[i:i + bs]
        return {"tokens": self.toks[i:i + bs], "labels": lbl}


def _tier(name="tier-low", seed=0):
    cfg = get_config(name).with_(vocab_size=256)
    return init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def test_microbatch_matches_full_batch():
    """Microbatches of 4 against the whole batch of 8: the same loss and
    grad norm, and the same first moments (mu = 0.1 clip g) within 1e-4
    of each leaf's max."""
    batch = TaskData(bs=8).batch_at(0)
    states, metrics = [], []
    for mb in (None, 4):
        model = _tier()
        step = make_train_step(model, TrainConfig(
            microbatch=mb, remat=False, adamw=opt.AdamWConfig(warmup_steps=0)))
        state, m = step(opt.init(trainable(model)), batch)
        states.append(state)
        metrics.append(m)
    for key in ("loss", "ce", "grad_norm"):
        assert float(metrics[1][key]) == pytest.approx(
            float(metrics[0][key]), rel=GRAD_TOL)
    for name, ref in states[0]["mu"].items():
        assert _rel(states[1]["mu"][name].numpy(), ref.numpy()) <= GRAD_TOL, \
            name


def test_trainer_loss_decreases_and_checkpoints(tmp_path):
    model = _tier()
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=3e-3, warmup_steps=5,
                                             total_steps=30),
                       remat=True, log_every=5, ckpt_every=10,
                       ckpt_path=str(tmp_path / "m.npz"))
    _, state, hist = train(model, TaskData(), 30, tcfg, verbose=False)
    assert [r["step"] for r in hist] == [0, 5, 10, 15, 20, 25, 29]
    assert set(hist[0]) >= {"step", "loss", "lr", "grad_norm", "wall", "ce",
                            "aux"}
    first = np.mean([r["loss"] for r in hist[:2]])
    last = np.mean([r["loss"] for r in hist[-2:]])
    assert last < first - 0.5, (first, last)
    assert int(state["step"]) == 30
    assert ckpt.restore_model(str(tmp_path / "m.npz"), _tier(seed=3)) == 20


def test_kd_loss_matches_jax():
    from repro.training import distill as jdistill
    rng = np.random.default_rng(0)
    s, t = (rng.standard_normal((3, 5, 11)).astype(np.float32)
            for _ in range(2))
    ref = float(jdistill.kd_loss(s, t, 2.0))
    got = float(kd_loss(torch.from_numpy(s), torch.from_numpy(t), 2.0))
    assert got == pytest.approx(ref, rel=1e-6)


def test_distillation_reduces_kd():
    """tier-server-fast trained briefly, then tier-low distilled from it:
    the student's kd falls, and the teacher takes no update."""
    data_ = TaskData()
    teacher = _tier("tier-server-fast")
    train(teacher, data_, 10, TrainConfig(
        adamw=opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10),
        remat=False), verbose=False)
    before = {n: p.detach().clone() for n, p in teacher.named_parameters()}
    student = _tier("tier-low", seed=7)
    dcfg = DistillConfig(adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=30))
    step = make_distill_step(student, teacher, dcfg)
    state = opt.init(trainable(student))
    kds = []
    for s in range(30):
        state, m = step(state, data_.batch_at(s))
        kds.append(float(m["kd"]))
    assert np.mean(kds[-5:]) < np.mean(kds[:5]), kds
    for n, p in teacher.named_parameters():
        assert torch.equal(p, before[n]), n
