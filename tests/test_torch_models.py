"""The port's dense decoder held to the JAX package on the CPU.

JAX initialises the weights; ``params_from_jax`` carries them across; the
same numpy tokens go through both forwards. Logits within 1e-4 (float32
matmuls and sums in another order), BvSB within 1e-6, top-1 equal
wherever JAX's top-2 logit gap exceeds 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.common import padded_vocab
from repro_torch.models.model import build_model, init_params, params_from_jax

torch.set_num_threads(2)

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CONF_ATOL = 1e-6
GAP = 1e-4

CONFIGS = {
    "tier-low": lambda g: g("tier-low"),
    "tier-server-fast": lambda g: g("tier-server-fast"),
    "tier-low-v1000": lambda g: g("tier-low").with_(vocab_size=1000),
    # off-tier variant: GQA, sliding window, qk-norm and the GELU MLP
    "tier-low-gqa-window": lambda g: g("tier-low").with_(
        num_kv_heads=2, sliding_window=5, qk_norm=True, mlp_act="gelu"),
}


@pytest.fixture(scope="module")
def pairs():
    """name -> (jax forward, jax params (numpy tree), torch cfg)."""
    out = {}
    for i, (name, make) in enumerate(CONFIGS.items()):
        jcfg, tcfg = make(jget_config), make(get_config)
        jm = jbuild_model(jcfg)
        params = jm.init(jax.random.key(i))
        fwd = jax.jit(lambda p, t, jm=jm: jm.forward(p, {"tokens": t})[0])
        out[name] = (fwd, jax.tree.map(np.asarray, params), tcfg)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch", [1, 8])
def test_forward_matches_jax(pairs, name, batch):
    fwd, tree, tcfg = pairs[name]
    model = params_from_jax(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(batch).integers(
        0, tcfg.vocab_size, (batch, 16)).astype(np.int32)
    jlogits = np.asarray(fwd(tree, tokens))
    with torch.inference_mode():
        logits = model(torch.from_numpy(tokens))[0].numpy()
    assert logits.shape == jlogits.shape == \
        (batch, 16, padded_vocab(tcfg.vocab_size))
    np.testing.assert_allclose(logits, jlogits, **LOGIT_TOL)

    last, jlast = logits[:, -1], jlogits[:, -1]
    conf, pred = ops.bvsb(torch.from_numpy(last))
    jconf, jpred = map(np.asarray, jops.bvsb(jlast))
    np.testing.assert_allclose(conf.numpy(), jconf, atol=CONF_ATOL)
    top2 = np.sort(jlast, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP
    assert np.array_equal(pred.numpy()[clear], jpred[clear])


def test_padded_vocab_columns_masked(pairs):
    _, tree, tcfg = pairs["tier-low-v1000"]
    model = params_from_jax(tree, tcfg, device="cpu")
    with torch.inference_mode():
        logits, _ = model(torch.zeros(2, 16, dtype=torch.int32))
    assert logits.shape[-1] == 1024
    assert (logits[..., 1000:] == torch.finfo(torch.float32).min).all()
    assert torch.isfinite(logits[..., :1000]).all()


def test_converter_unstacks_layers(pairs):
    _, tree, tcfg = pairs["tier-server-fast"]
    model = params_from_jax(tree, tcfg, device="cpu")
    stacked = tree["blocks"][0]["attn"]["wq"]
    assert stacked.shape == (6, 384, 384)
    for i, layer in enumerate(model.layers):
        assert np.array_equal(layer.attn.wq.detach().numpy(), stacked[i])
    assert np.array_equal(model.embed.table.numpy(), tree["embed"]["table"])


def test_converter_rejects_wrong_shape_and_extra_leaf(pairs):
    _, tree, tcfg = pairs["tier-low"]
    bad = jax.tree.map(lambda x: x, tree)
    bad["blocks"][0]["mlp"]["w_up"] = bad["blocks"][0]["mlp"]["w_up"][:, :, :-1]
    with pytest.raises(ValueError, match="w_up"):
        params_from_jax(bad, tcfg, device="cpu")
    extra = dict(tree, lm_head={"table": tree["embed"]["table"]})
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(extra, tcfg, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(missing, tcfg, device="cpu")


def test_init_params_distribution_and_seed():
    cfg = get_config("tier-low")
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("scale"):
            assert (pa == 1).all(), name
        else:
            assert not torch.equal(pa, pc), name
            assert pa.abs().max() <= 2 * cfg.init_scale, name
    w = a.layers[0].mlp.w_up
    # std of a unit normal truncated to [-2, 2] is 0.8796
    assert abs(float(w.std()) / cfg.init_scale - 0.8796) < 0.02


def test_unported_families_raise():
    """An unknown arch raises. The families that raised here before they
    were ported now run: the xLSTM and encoder-decoder configs build on the
    CPU, and soft-capped attention (tier-low with a cap of 30, weights
    drawn at 0.1 so that the scores reach the cap) agrees with the JAX
    package's forward within LOGIT_TOL, and differs from the uncapped
    model's."""
    for name in ("xlstm-350m", "seamless-m4t-medium"):
        model = build_model(get_config(name).reduced(), device="cpu")
        assert model.device == torch.device("cpu")
        assert sum(p.numel() for p in model.parameters()) > 0
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    jcfg, cfg = (g("tier-low").with_(logit_soft_cap=30.0, init_scale=0.1)
                 for g in (jget_config, get_config))
    jm = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(9)))
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jlogits = np.asarray(jax.jit(
        lambda p, t: jm.forward(p, {"tokens": t})[0])(tree, tokens))
    with torch.inference_mode():
        logits = params_from_jax(tree, cfg, device="cpu")(
            torch.from_numpy(tokens))[0].numpy()
        free = params_from_jax(tree, cfg.with_(logit_soft_cap=None),
                               device="cpu")(torch.from_numpy(tokens))[0]
    np.testing.assert_allclose(logits, jlogits, **LOGIT_TOL)
    assert np.abs(logits - free.numpy()).max() > 100 * LOGIT_TOL["atol"]
