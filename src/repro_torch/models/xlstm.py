"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, strictly sequential).

Counterpart of the JAX package's ``models/xlstm.py``, in its order of
operations: the gate clamps at +-8 before ``logsigmoid``, ``k / sqrt(p)``
as a division, the mLSTM's output over ``max(|q . n|, 1)``, the sLSTM's
``n`` floored at 1e-6. The JAX package runs both cells through XLA (its
``lax.scan``), with no Pallas kernel, so here they are plain PyTorch too:

* ``mlstm_parallel`` is a Python loop over chunks of CHUNK positions:
  inside a chunk the pairwise decays are dense products, the state (C, n)
  carries from one chunk to the next;
* ``slstm_block`` is a Python loop over the positions, one recurrent
  step (a block-diagonal product with ``r``) a position.

Decode carries O(1) state: mLSTM (C (B, H, p, p), n (B, H, p)), sLSTM
(h (B, d), c, n, m (B, H, p)), all float32 whatever the model's dtype.

Over model ranks (``common.MeshContext``) a block whose heads the ranks
divide (``layout.xlstm_split``) is cut by heads: rank j computes heads
[j H/m, (j+1) H/m), every feature being head-major.

* mLSTM: ``w_up``'s rank columns are its cell-input and output-gate
  columns (``layout.mlstm_up_columns``); the cell input xc is gathered
  over the model group (``MeshContext.gather_model``, its gradient
  reduce-scattered back) before wq / wk / wv, which hold the rank's heads'
  columns, and the gates; ``w_if`` / ``b_if`` stay whole, as JAX
  replicates them, and the rank reads its (i, f) columns through
  ``into_model``. The chunkwise cell, the group norm and silu(z) are the
  rank's heads'; ``w_down`` holds their rows, its partial products leave
  through ``out_of_model``.
* sLSTM: ``w_in`` / ``b_in``'s contiguous quarter (m = 4) is one head's
  four gates, since the cell reshapes them to (B, H, p, 4); ``b_in`` and
  the recurrent ``r`` stay whole, as JAX replicates them, read at the
  rank's heads through ``into_model``. The position loop runs on the
  rank's heads with no collective a position; h (B, S, d/m) is gathered
  over the model group for the FFN, whose ``w_ff1`` holds the rank's
  columns and ``w_ff2`` its rows (summed through ``out_of_model``).

The decode states hold the rank's heads: C (B, H/m, p, p), n (B, H/m, p),
h (B, d/m), c, n, m (B, H/m, p) (``cache_spec`` cuts C on its p rows and
keeps the other states but h whole; a storage departure, the values
unchanged).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common, layout

CHUNK = 128
GATE_CLAMP = 8.0
FORGET_BIAS = 3.0   # the mLSTM's forget-gate bias at init (input gates 0)
ZERO_INIT = ("b_in",)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
class MLSTM(nn.Module):
    """mLSTM parameters, named and shaped as the JAX ``mlstm_init`` makes
    them: w_up (d, 3d) = [cell input (2d) | output gate (d)], wq/wk/wv
    (2d, d), w_if (2d, 2H) and b_if (2H,) float32, w_down (d, d); over
    model ranks that divide H, the rank's heads' parts (``heads``: its
    first head and count)."""

    def __init__(self, cfg, *, device, dtype, mctx=common.LOCAL):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        kw = dict(mctx=mctx, device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.tp = layout.xlstm_split(cfg, "mlstm", mctx.model_size)
        self.heads = mctx.part(h, "the mLSTM's heads") if self.tp else (0, h)
        common.cut_param(self, ("mlstm", "w_up"), (d, 3 * d), cfg, **kw)
        for leaf in ("wq", "wk", "wv"):
            common.cut_param(self, ("mlstm", leaf), (2 * d, d), cfg, **kw)
        self.w_if = common.param(2 * d, 2 * h, **f32)
        self.b_if = common.param(2 * h, **f32)
        common.cut_param(self, ("mlstm", "w_down"), (d, d), cfg, **kw)


def init_gate_bias_(b_if: torch.Tensor) -> torch.Tensor:
    """The JAX package's b_if: 0 for the H input gates, FORGET_BIAS for
    the H forget gates."""
    h = b_if.shape[0] // 2
    with torch.no_grad():
        b_if[:h] = 0.0
        b_if[h:] = FORGET_BIAS
    return b_if


def _mlstm_qkvg(p: MLSTM, x, nh, mctx=common.LOCAL):
    """q, k, v (B, S, hn, p), the gates (B, S, hn) and z (B, S, hn p) of
    the rank's hn heads of the ``nh``."""
    b, s, d = x.shape
    hd = d // nh
    h0, hn = p.heads
    w_if, b_if = p.w_if, p.b_if
    if p.tp:
        x = mctx.into_model(x)
        cols = torch.cat([torch.arange(h0, h0 + hn, device=x.device),
                          nh + torch.arange(h0, h0 + hn, device=x.device)])
        w_if = mctx.into_model(w_if)[:, cols]
        b_if = mctx.into_model(b_if)[cols]
    u = x @ p.w_up
    c = 2 * hn * hd
    xc, z = u[..., :c], u[..., c:]
    if p.tp:
        xc = mctx.gather_model(xc, 2)
    q = (xc @ p.wq).reshape(b, s, hn, hd)
    k = (xc @ p.wk).reshape(b, s, hn, hd) / float(hd) ** 0.5
    v = (xc @ p.wv).reshape(b, s, hn, hd)
    gl = xc.float() @ w_if + b_if
    log_i = torch.clamp(gl[..., :hn], -GATE_CLAMP, GATE_CLAMP)   # (B, S, hn)
    log_f = F.logsigmoid(torch.clamp(gl[..., hn:], -GATE_CLAMP, GATE_CLAMP))
    return q, k, v, log_i, log_f, z


def mlstm_init_state(batch, nh, hd, device=None):
    return {"C": torch.zeros(batch, nh, hd, hd, device=device),
            "n": torch.zeros(batch, nh, hd, device=device)}


def mlstm_parallel(q, k, v, log_i, log_f, state=None):
    """Chunkwise mLSTM. q/k/v: (B, S, H, p); gates (B, S, H) float32;
    state: None or dict(C (B, H, p, p), n (B, H, p)) float32. Returns (h
    (B, S, H, p) float32, new state). S must be a multiple of min(CHUNK,
    S), as the JAX package asserts.

    Within a chunk the weight of key j for query t is exp(bsum_t - bsum_j
    + li_j) (bsum the running sum of log f): at most e^8 on and below the
    diagonal, but above it bsum_t - bsum_j can be large and positive, so
    exp would give inf there. Those log-weights are set to -inf before the
    exp: the forward's zeros are JAX's (whose ``where`` drops the inf),
    and the backward sends 0, not inf * 0 = NaN, into them (JAX's
    gradient is NaN there, ROADMAP.md's divergences)."""
    b, s, nh, hd = q.shape
    c = min(CHUNK, s)
    if s % c:
        raise ValueError(f"mlstm_parallel: S = {s} is no multiple of the "
                         f"chunk {c}")
    if state is None:
        state = mlstm_init_state(b, nh, hd, q.device)
    big_c, n = state["C"], state["n"]
    causal = torch.tril(torch.ones(c, c, dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    hs = []
    for t0 in range(0, s, c):
        qi, ki, vi = (x[:, t0:t0 + c].float() for x in (q, k, v))
        li, lf = log_i[:, t0:t0 + c], log_f[:, t0:t0 + c]
        bsum = torch.cumsum(lf, dim=1)                          # (B, c, H)
        # intra-chunk
        logw = bsum[:, :, None, :] - bsum[:, None, :, :] + li[:, None, :, :]
        w = torch.exp(logw.masked_fill(~causal, float("-inf")))  # (B,t,j,H)
        scores = torch.einsum("bthp,bjhp->btjh", qi, ki) * w
        num = torch.einsum("btjh,bjhq->bthq", scores, vi)
        den = scores.sum(dim=2)                                 # (B, c, H)
        # inter-chunk
        qw = qi * torch.exp(bsum)[..., None]
        num = num + torch.einsum("bthp,bhpq->bthq", qw, big_c)
        den = den + torch.einsum("bthp,bhp->bth", qw, n)
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # state update
        wj = torch.exp(bsum[:, -1:, :] - bsum + li)             # (B, c, H)
        decay = torch.exp(bsum[:, -1, :])                       # (B, H)
        big_c = big_c * decay[:, :, None, None] + torch.einsum(
            "bjh,bjhp,bjhq->bhpq", wj, ki, vi)
        n = n * decay[:, :, None] + torch.einsum("bjh,bjhp->bhp", wj, ki)
    return torch.cat(hs, dim=1), {"C": big_c, "n": n}


def mlstm_decode_cell(q1, k1, v1, li, lf, state):
    """One step. q1/k1/v1: (B, H, p); li/lf: (B, H). Returns (h, state)."""
    f = torch.exp(lf)[:, :, None, None]
    i = torch.exp(li)[:, :, None, None]
    q1, k1, v1 = q1.float(), k1.float(), v1.float()
    big_c = state["C"] * f + i * torch.einsum("bhp,bhq->bhpq", k1, v1)
    n = state["n"] * f[..., 0] + i[..., 0] * k1
    num = torch.einsum("bhp,bhpq->bhq", q1, big_c)
    den = torch.einsum("bhp,bhp->bh", q1, n)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    return h, {"C": big_c, "n": n}


def _mlstm_out(p: MLSTM, h, z, x, mctx=common.LOCAL):
    b, s = x.shape[:2]
    h = common.groupnorm(h).reshape(b, s, -1)
    out = (h.to(x.dtype) * F.silu(z)) @ p.w_down
    return mctx.out_of_model(out) if p.tp else out


def mlstm_block(p: MLSTM, x, cfg, state=None, mctx=common.LOCAL):
    """x: (B, S, d) -> (out (B, S, d), state of the rank's heads). Full
    sequence (prefill)."""
    q, k, v, li, lf, z = _mlstm_qkvg(p, x, cfg.num_heads, mctx)
    h, new_state = mlstm_parallel(q, k, v, li, lf, state)
    return _mlstm_out(p, h, z, x, mctx), new_state


def mlstm_block_decode(p: MLSTM, x1, cfg, state, mctx=common.LOCAL):
    q, k, v, li, lf, z = _mlstm_qkvg(p, x1, cfg.num_heads, mctx)
    h, new_state = mlstm_decode_cell(q[:, 0], k[:, 0], v[:, 0], li[:, 0],
                                     lf[:, 0], state)
    return _mlstm_out(p, h[:, None], z, x1, mctx), new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTM(nn.Module):
    """sLSTM parameters, named and shaped as the JAX ``slstm_init`` makes
    them: w_in (d, 4d), b_in (4d,) float32, the block-diagonal recurrent
    r (H, p, 4p) float32, the GeLU FFN w_ff1 (d, f), w_ff2 (f, d) with f =
    4d/3 rounded up to a multiple of 128; over model ranks that divide H,
    the rank's heads' columns of w_in (``heads``: its first head and
    count) and its share of the FFN's features."""

    def __init__(self, cfg, *, device, dtype, mctx=common.LOCAL):
        super().__init__()
        d, h = cfg.d_model, cfg.slstm_num_heads
        hd = d // h
        f_ff = ((4 * d // 3) + 127) // 128 * 128
        kw = dict(mctx=mctx, device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.tp = layout.xlstm_split(cfg, "slstm", mctx.model_size)
        self.heads = mctx.part(h, "the sLSTM's heads") if self.tp else (0, h)
        common.cut_param(self, ("slstm", "w_in"), (d, 4 * d), cfg, **kw)
        self.b_in = common.param(4 * d, **f32)
        self.r = common.param(h, hd, 4 * hd, **f32)
        common.cut_param(self, ("slstm", "w_ff1"), (d, f_ff), cfg, **kw)
        common.cut_param(self, ("slstm", "w_ff2"), (f_ff, d), cfg, **kw)
        if self.tp and f_ff % mctx.model_size:
            raise ValueError(f"the sLSTM's FFN of {f_ff} does not split over "
                             f"{mctx.model_size} model ranks")


def _rank_r(p: SLSTM, mctx):
    """The recurrent weights of the rank's heads."""
    if not p.tp:
        return p.r
    h0, hn = p.heads
    return mctx.into_model(p.r)[h0:h0 + hn]


def slstm_step(p: SLSTM, xw_t, st, nh, r=None):
    """One recurrent step. xw_t: (B, 4 nh p) float32, the input
    projection of ``nh`` heads; st: their state dict; ``r`` their
    recurrent weights (p.r by default). Returns the new state."""
    r = p.r if r is None else r
    b = xw_t.shape[0]
    d = xw_t.shape[1] // 4
    hprev = st["h"].reshape(b, nh, d // nh)
    rec = torch.einsum("bhp,hpq->bhq", hprev, r).reshape(b, 4 * d)
    g = (xw_t + rec).reshape(b, nh, d // nh, 4)
    z = torch.tanh(g[..., 0])
    li = torch.clamp(g[..., 1], -GATE_CLAMP, GATE_CLAMP)
    lf = F.logsigmoid(torch.clamp(g[..., 2], -GATE_CLAMP, GATE_CLAMP))
    o = torch.sigmoid(g[..., 3])
    m_new = torch.maximum(lf + st["m"], li)
    i = torch.exp(li - m_new)
    f = torch.exp(lf + st["m"] - m_new)
    c_new = f * st["c"] + i * z
    n_new = f * st["n"] + i
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return {"h": h_new.reshape(b, d), "c": c_new, "n": n_new, "m": m_new}


def slstm_init_state(batch, d, nh, device=None):
    hd = d // nh
    return {
        "h": torch.zeros(batch, d, device=device),
        "c": torch.zeros(batch, nh, hd, device=device),
        "n": torch.zeros(batch, nh, hd, device=device),
        "m": torch.full((batch, nh, hd), -GATE_CLAMP, device=device),
    }


def _slstm_out(p: SLSTM, h, x, nh, mctx=common.LOCAL):
    """The group norm of the rank's heads' h (B, S, nh p), then the FFN
    over the gathered h."""
    b, s = x.shape[:2]
    h = common.groupnorm(h.reshape(b, s, nh, -1)).reshape(b, s, -1)
    if p.tp:
        h = mctx.gather_model(h, 2)
    gelu = common.activation("gelu")
    out = gelu(h.to(x.dtype) @ p.w_ff1) @ p.w_ff2
    return mctx.out_of_model(out) if p.tp else out


def _slstm_in(p: SLSTM, x, mctx=common.LOCAL):
    """x (B, ..., d) -> the rank's heads' gate pre-activations (B, ...,
    4 hn p) float32."""
    b_in = p.b_in
    if p.tp:
        x = mctx.into_model(x)
        n = p.w_in.shape[1]
        lo = p.heads[0] * n // p.heads[1]
        b_in = mctx.into_model(b_in)[lo:lo + n]
    return x.float() @ p.w_in.float() + b_in


def slstm_block(p: SLSTM, x, cfg, state=None, mctx=common.LOCAL):
    """x: (B, S, d) -> (out, state of the rank's heads): one
    ``slstm_step`` a position."""
    b, s, d = x.shape
    nh = p.heads[1]
    st = slstm_init_state(b, d * nh // cfg.slstm_num_heads, nh, x.device) \
        if state is None else state
    xw = _slstm_in(p, x, mctx)
    r = _rank_r(p, mctx)
    hs = []
    for t in range(s):
        st = slstm_step(p, xw[:, t], st, nh, r)
        hs.append(st["h"])
    return _slstm_out(p, torch.stack(hs, dim=1), x, nh, mctx), st


def slstm_block_decode(p: SLSTM, x1, cfg, state, mctx=common.LOCAL):
    nh = p.heads[1]
    st = slstm_step(p, _slstm_in(p, x1[:, 0], mctx), state, nh,
                    _rank_r(p, mctx))
    return _slstm_out(p, st["h"][:, None], x1, nh, mctx), st
