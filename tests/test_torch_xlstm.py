"""The port's xLSTM (mLSTM and sLSTM cells, the xlstm-350m decoder) held
to the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both sides; weights
come from the JAX package's initialisers, carried across by
``params_from_jax`` (or copied leaf by leaf for a single block).

Tolerances: group norm 1e-5 (float32 mean, variance and rsqrt in another
order); the cells, their states and the model's forward logits and
prefill states 1e-4 absolute and relative (float32 einsums and sums in
another order; the mLSTM's state C grows as e^8 times k v, hence the
relative part); decode steps 5e-3, as tests/test_models.py and the
port's other decode tests gate decode; the step factories' BvSB 1e-6 and
top-1 equal wherever JAX's top-2 logit gap exceeds 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import distributed as jdist
from repro.models import common as jcommon
from repro.models import xlstm as jxlstm
from repro.models.common import KeyGen
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.launch.distributed import make_prefill_step, make_serve_step
from repro_torch.models import common, xlstm
from repro_torch.models.model import build_model, init_params, params_from_jax

torch.set_num_threads(2)

NORM_ATOL = 1e-5
TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_ATOL = 5e-3
CONF_ATOL = 1e-6
GAP = 1e-4
ARCH = "xlstm-350m"


def _np(x):
    return np.asarray(x)


def _close(a, b, **tol):
    np.testing.assert_allclose(a.numpy() if torch.is_tensor(a) else a,
                               _np(b), **(tol or TOL))


# ---------------------------------------------------------------------------
# group norm and the cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 5, 4, 64), (3, 4, 256), (1, 1, 4, 7)])
def test_groupnorm_matches_jax(shape):
    x = (np.random.default_rng(0).standard_normal(shape) * 3 + 1).astype(
        np.float32)
    out = common.groupnorm(torch.from_numpy(x))
    _close(out, jcommon.groupnorm(jnp.asarray(x), shape[-2]),
           atol=NORM_ATOL, rtol=0)
    # the population variance: a row of two values normalises to -1, +1
    pair = common.groupnorm(torch.tensor([[1.0, 3.0]]))
    np.testing.assert_allclose(pair.numpy(), [[-1.0, 1.0]], atol=1e-5)
    assert common.groupnorm(torch.from_numpy(x).bfloat16()).dtype == \
        torch.bfloat16


def _mlstm_inputs(b, s, h, p, seed, log_f=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    k /= np.sqrt(p)
    log_i = np.clip(rng.standard_normal((b, s, h)) * 3, -8, 8).astype(
        np.float32)
    if log_f is None:
        log_f = np.array(jax.nn.log_sigmoid(np.clip(
            rng.standard_normal((b, s, h)) * 2 + 3, -8, 8).astype(
                np.float32)))
    else:
        log_f = np.full((b, s, h), log_f, np.float32)
    return q, k, v, log_i, log_f


def _mlstm_state(b, h, p, seed):
    rng = np.random.default_rng(seed)
    return {"C": rng.standard_normal((b, h, p, p)).astype(np.float32),
            "n": rng.standard_normal((b, h, p)).astype(np.float32)}


def _t_state(st):
    return {k: torch.from_numpy(v) for k, v in st.items()}


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_parallel_matches_jax(s, with_state):
    """S 64 (one chunk) and 256 (two chunks of 128), from zeros or from a
    given (C, n)."""
    b, h, p = 2, 4, 32
    q, k, v, li, lf = _mlstm_inputs(b, s, h, p, s)
    state = _mlstm_state(b, h, p, 1) if with_state else None
    jh, jst = jxlstm.mlstm_parallel(q, k, v, li, lf, state)
    th, tst = xlstm.mlstm_parallel(
        *map(torch.from_numpy, (q, k, v, li, lf)),
        None if state is None else _t_state(state))
    assert th.dtype == torch.float32 and th.shape == (b, s, h, p)
    _close(th, jh)
    for key in ("C", "n"):
        _close(tst[key], jst[key])


def test_mlstm_parallel_drops_inf_above_the_diagonal():
    """log f at its clamp (-8) everywhere: above the diagonal bsum_t -
    bsum_j reaches +8 x 127, so exp gives inf there; the output stays
    finite and equal to JAX's."""
    q, k, v, li, lf = _mlstm_inputs(1, 128, 2, 16, 3,
                                    log_f=float(jax.nn.log_sigmoid(-8.0)))
    th, tst = xlstm.mlstm_parallel(*map(torch.from_numpy, (q, k, v, li, lf)))
    jh, _ = jxlstm.mlstm_parallel(q, k, v, li, lf)
    assert torch.isfinite(th).all() and torch.isfinite(tst["C"]).all()
    _close(th, jh)


def test_mlstm_parallel_needs_whole_chunks():
    q, k, v, li, lf = _mlstm_inputs(1, 200, 2, 8, 0)
    with pytest.raises(ValueError, match="chunk"):
        xlstm.mlstm_parallel(*map(torch.from_numpy, (q, k, v, li, lf)))


def test_mlstm_decode_cell_matches_jax():
    b, h, p = 3, 4, 32
    q, k, v, li, lf = _mlstm_inputs(b, 1, h, p, 5)
    st = _mlstm_state(b, h, p, 6)
    args = (q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0])
    jh, jst = jxlstm.mlstm_decode_cell(*args, st)
    th, tst = xlstm.mlstm_decode_cell(*map(torch.from_numpy, args),
                                      _t_state(st))
    _close(th, jh)
    for key in ("C", "n"):
        _close(tst[key], jst[key])


def _blocks(cfg, seed):
    """(JAX mLSTM params, port MLSTM, JAX sLSTM params, port SLSTM), the
    port's holding the JAX initialiser's weights."""
    kg = KeyGen(jax.random.key(seed))
    out = []
    for init, cls in ((jxlstm.mlstm_init, xlstm.MLSTM),
                      (jxlstm.slstm_init, xlstm.SLSTM)):
        jp = jax.tree.map(np.asarray, init(kg, cfg, jnp.float32))
        mod = cls(cfg, device="cpu", dtype=torch.float32)
        with torch.no_grad():
            for name, t in mod.named_parameters():
                assert t.shape == jp[name].shape, name
                t.copy_(torch.from_numpy(np.array(jp[name])))
        assert {n for n, _ in mod.named_parameters()} == set(jp)
        out += [jp, mod]
    return out


def _slstm_state(b, d, nh, seed):
    rng = np.random.default_rng(seed)
    p = d // nh
    return {"h": rng.standard_normal((b, d)).astype(np.float32),
            "c": rng.standard_normal((b, nh, p)).astype(np.float32),
            "n": rng.uniform(0.5, 2, (b, nh, p)).astype(np.float32),
            "m": rng.uniform(-2, 2, (b, nh, p)).astype(np.float32)}


@pytest.mark.parametrize("floor", [False, True])
def test_slstm_step_matches_jax(floor):
    """A random state, and (``floor``) one with n 0 and m 40, so that the
    step's input gate exp(li - m_new) is under 1e-10 and n_new falls under
    its 1e-6 floor."""
    cfg = get_config(ARCH).reduced()
    _, _, jp, mod = _blocks(cfg, 0)
    b, d, nh = 3, cfg.d_model, cfg.slstm_num_heads
    xw = (np.random.default_rng(1).standard_normal((b, 4 * d)) * 2).astype(
        np.float32)
    st = _slstm_state(b, d, nh, 2)
    if floor:
        st["n"][:], st["m"][:] = 0.0, 40.0
        assert (_np(jxlstm._slstm_step(jp, xw, st, nh)["n"]) < 1e-6).all()
    jst = jxlstm._slstm_step(jp, xw, st, nh)
    tst = xlstm.slstm_step(mod, torch.from_numpy(xw), _t_state(st), nh)
    for key in ("h", "c", "n", "m"):
        _close(tst[key], jst[key])


@pytest.mark.parametrize("head", [0, 3])
def test_slstm_w_in_quarter_holds_one_heads_four_gates(head):
    """The sLSTM cell reshapes its gate pre-activations (B, 4d) to (B, H,
    p, 4), so the contiguous quarter ``head`` of w_in's and b_in's 4d
    columns (what model rank ``head`` of four holds) is that head's four
    gates: the cell run on that quarter alone, with r's head and the
    head's state and no other head's, gives JAX's whole block's state of
    that head (c, n, m: the z, i and f gates) and its h (the o gate) at
    every position. The gate-major quarter (gate k's columns [k d + head
    p, k d + (head + 1) p)) does not."""
    cfg = get_config(ARCH).reduced()
    _, _, jp, mod = _blocks(cfg, 7)
    b, s, d, nh = 2, 12, cfg.d_model, cfg.slstm_num_heads
    hd = d // nh
    rng = np.random.default_rng(8)
    jp["b_in"] = (rng.standard_normal(4 * d) * 0.5).astype(np.float32)
    with torch.no_grad():
        mod.b_in.copy_(torch.from_numpy(jp["b_in"]))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    st0 = _slstm_state(b, d, nh, 9)
    xw = x @ jp["w_in"] + jp["b_in"]
    jst, jh = st0, []
    for t in range(s):
        jst = jxlstm._slstm_step(jp, xw[:, t], jst, nh)
        jh.append(_np(jst["h"]))
    heads = slice(head * hd, (head + 1) * hd)

    def run(cols):
        st = {k: torch.from_numpy(np.ascontiguousarray(
            v[:, heads] if k == "h" else v[:, head:head + 1]))
            for k, v in st0.items()}
        xq = torch.from_numpy(np.ascontiguousarray(xw[..., cols]))
        r = mod.r[head:head + 1]
        hs = []
        for t in range(s):
            st = xlstm.slstm_step(mod, xq[:, t], st, 1, r)
            hs.append(st["h"])
        return st, torch.stack(hs, 1)

    st, hs = run(np.arange(head * 4 * hd, (head + 1) * 4 * hd))
    _close(hs, np.stack(jh, 1)[..., heads])
    for key in ("c", "n", "m"):
        _close(st[key], _np(jst[key])[:, head:head + 1])
    gate_major = np.concatenate([k * d + np.arange(head * hd, (head + 1) * hd)
                                 for k in range(4)])
    st, hs = run(gate_major)
    assert not np.allclose(hs.numpy(), np.stack(jh, 1)[..., heads], **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_xlstm_blocks_match_jax(with_state):
    """Both blocks over 48 positions, from the initial states or given
    ones, then one decode step each: outputs and states."""
    cfg = get_config(ARCH).reduced()
    jm, mm, js, ms = _blocks(cfg, 1)
    b, s, d = 2, 48, cfg.d_model
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s + 1, d)).astype(np.float32)
    mst = _mlstm_state(b, cfg.num_heads, d // cfg.num_heads, 4) \
        if with_state else None
    sst = _slstm_state(b, d, cfg.slstm_num_heads, 5) if with_state else None
    for jblock, tblock, jdec, tdec, jp, mod, st in (
            (jxlstm.mlstm_block, xlstm.mlstm_block, jxlstm.mlstm_block_decode,
             xlstm.mlstm_block_decode, jm, mm, mst),
            (jxlstm.slstm_block, xlstm.slstm_block, jxlstm.slstm_block_decode,
             xlstm.slstm_block_decode, js, ms, sst)):
        jout, jst = jblock(jp, x[:, :s], cfg, st)
        with torch.inference_mode():
            out, tst = tblock(mod, torch.from_numpy(x[:, :s]), cfg,
                              None if st is None else _t_state(st))
        _close(out, jout)
        for key in jst:
            _close(tst[key], jst[key])
        jout, jst = jdec(jp, x[:, s:], cfg, jst)
        with torch.inference_mode():
            out, tst = tdec(mod, torch.from_numpy(x[:, s:]), cfg, tst)
        _close(out, jout, atol=DECODE_ATOL)
        for key in jst:
            _close(tst[key], jst[key], atol=DECODE_ATOL)


# ---------------------------------------------------------------------------
# the reduced xlstm-350m
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params (numpy tree), port model, cfg) of the reduced
    config: one mLSTM and one sLSTM layer, d 256, 4 heads."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert repr(cfg) == repr(jcfg) and cfg.pattern == ("mlstm", "slstm")
    jm = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(11)))
    return jm, tree, params_from_jax(tree, cfg, device="cpu"), cfg


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_states(jcache, i):
    """Layer i's state in the JAX cache: one stacked super-block."""
    return {k: v[0] for k, v in jcache["blocks"][i].items()}


@pytest.mark.parametrize("s", [16, 256])
def test_xlstm_forward_and_prefill_states_match_jax(pair, s):
    """Forward logits and the states after the prefill (collect_cache),
    at S 16 (one chunk) and 256 (two)."""
    jm, tree, model, cfg = pair
    tokens = _tokens(cfg, 2, s, s)
    jlogits, jcache, _ = jax.jit(lambda p, t: jm.forward(
        p, {"tokens": t}, collect_cache=True))(tree, tokens)
    with torch.inference_mode():
        logits, cache = model(torch.from_numpy(tokens), collect_cache=True)
    assert logits.shape == jlogits.shape == (2, s, 1024)
    _close(logits, jlogits)
    assert [sorted(c) for c in cache] == [["C", "n"], ["c", "h", "m", "n"]]
    for i, entry in enumerate(cache):
        jentry = _jax_states(jcache, i)
        for key, value in entry.items():
            assert value.dtype == torch.float32
            _close(value, jentry[key])


@pytest.mark.parametrize("from_empty", [False, True])
def test_xlstm_decode_matches_jax(pair, from_empty):
    """Prefill 12 tokens then 4 decode steps, or 8 steps from the empty
    default cache (float32 states whatever its dtype): each step's logits
    against JAX's decode and JAX's teacher-forced forward, the states
    against JAX's at the end."""
    jm, tree, model, cfg = pair
    b, s, n = 2, 12, 4
    tokens = _tokens(cfg, b, s + n, 7)
    jfull = _np(jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0])(
        tree, tokens))
    if from_empty:
        s, n = 0, 8
        jcache = jm.init_cache(tree, b, n)
        cache = model.init_cache(b, n)
    else:
        _, jcache, _ = jax.jit(lambda p, t: jm.forward(
            p, {"tokens": t}, collect_cache=True))(tree, tokens[:, :s])
        with torch.inference_mode():
            _, cache = model(torch.from_numpy(tokens[:, :s]),
                             collect_cache=True)
    jdec = jax.jit(lambda *a: jm.decode_step(*a))
    for t in range(s, s + n):
        pos = np.full((b,), t, np.int32)
        jlg, jcache = jdec(tree, tokens[:, t:t + 1], jcache, pos)
        with torch.inference_mode():
            lg, cache = model.decode_step(torch.from_numpy(tokens[:, t:t + 1]),
                                          cache, torch.from_numpy(pos).long())
        _close(lg, jlg, atol=DECODE_ATOL)
        _close(lg[:, 0], jfull[:, t], atol=DECODE_ATOL)
    for i, entry in enumerate(cache):
        for key, value in entry.items():
            assert value.dtype == torch.float32
            _close(value, _jax_states(jcache, i)[key], atol=DECODE_ATOL)


@pytest.fixture(scope="module")
def mesh():
    # Auto axes: jax 0.9's default (Explicit) makes the JAX package's
    # head-sharded attention raise (see tests/test_torch_decode.py)
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _agree(conf, top1, jconf, jtop1, hidden, table):
    np.testing.assert_allclose(conf.numpy(), _np(jconf), atol=CONF_ATOL)
    logits = hidden[:, -1].astype(np.float64) @ table.T.astype(np.float64)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    assert clear.any()
    assert np.array_equal(top1.numpy()[clear], _np(jtop1)[clear])


def test_xlstm_prefill_and_serve_steps_match_jax(pair, mesh):
    """Prefill of 2 prompts of 32 tokens, then 4 decode steps feeding back
    JAX's top-1, against the JAX package's step factories on a (1, 1)
    mesh."""
    jm, tree, model, cfg = pair
    jprefill = jax.jit(jdist.make_prefill_step(jm, mesh))
    jserve = jax.jit(jdist.make_serve_step(jm, mesh, 2))
    table = tree["embed"]["table"]
    tokens = _tokens(cfg, 2, 32, 9)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    with mesh:
        jconf, jtop1, jcache = jprefill(tree, {"tokens": tokens})
    conf, top1, cache = prefill(torch.from_numpy(tokens))
    with torch.inference_mode():
        hidden, _ = model(torch.from_numpy(tokens), return_hidden=True)
    _agree(conf, top1, jconf, jtop1, hidden.numpy(), table)
    tok = np.array(jtop1)
    for i in range(4):
        pos = np.full((2,), 32 + i, np.int32)
        with mesh:
            jconf, jtop1, jcache = jserve(tree, tok[:, None], jcache, pos)
        with torch.inference_mode():
            hidden, _ = model.decode_step(
                torch.from_numpy(tok[:, None]),
                [{k: x.clone() for k, x in c.items()} for c in cache],
                torch.from_numpy(pos).long(), return_hidden=True)
        conf, top1, cache = serve(torch.from_numpy(tok[:, None]), cache,
                                  torch.from_numpy(pos).long())
        _agree(conf, top1, jconf, jtop1, hidden.numpy(), table)
        tok = np.array(jtop1)


# ---------------------------------------------------------------------------
# parameters: layout, init and dtypes
# ---------------------------------------------------------------------------
def test_xlstm_layout_init_and_float32_gates():
    """The layers hold no MLP; b_if is 0 (input gates) and 3 (forget
    gates), b_in 0; the gate weights, their biases and r stay float32 in a
    bf16 model, which runs."""
    cfg = get_config(ARCH).reduced()
    m = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.bfloat16)
    mlstm, slstm = (layer for layer in m.layers)
    assert (mlstm.kind, slstm.kind) == ("mlstm", "slstm")
    assert not any(hasattr(layer, a) for layer in m.layers
                   for a in ("norm2", "mlp", "moe"))
    h = cfg.num_heads
    assert mlstm.mlstm.b_if.tolist() == [0.0] * h + [xlstm.FORGET_BIAS] * h
    assert (slstm.slstm.b_in == 0).all()
    f32 = {"w_if", "b_if", "b_in", "r"}
    for name, p in m.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        assert p.dtype == (torch.float32 if leaf in f32 else torch.bfloat16)
        if leaf not in ("scale", "b_if", "b_in"):
            assert p.float().std() > 0, name
    with torch.inference_mode():
        logits, _ = m(torch.randint(0, cfg.vocab_size, (1, 8)))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits[..., :cfg.vocab_size].float()).all()
    full = build_model(get_config(ARCH), device="meta")
    assert sum(p.numel() for p in full.parameters()) > 0
    assert [layer.kind for layer in full.layers] == ["mlstm", "slstm"] * 12
