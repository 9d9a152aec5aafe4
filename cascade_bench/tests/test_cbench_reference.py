"""The plain reference against the program on the CPU at a tiny width:
the last position's logits, BvSB and top-1, with the capacity rule
dropping assignments."""

import numpy as np
import pytest
import torch

from cascade_bench import check, harness, reference, weights
from repro_torch.models import moe as program_moe
from repro_torch.models.model import build_model
from repro_torch.serving import executables


def program(cfg, seed):
    model = build_model(harness.arch_config(cfg), device="cpu")
    weights.load_into(model, cfg, seed)
    return model


@pytest.mark.parametrize("tie", [True, False])
def test_last_logits_match_the_program(tiny_cell, tie):
    cfg = dict(tiny_cell.config, tie_embeddings=tie)
    model = program(cfg, 11)
    toks = torch.as_tensor(weights.tokens(1, 6, 12, cfg["vocab_size"], 11)[0])
    with torch.inference_mode():
        logits, _ = model(toks)
    mine = reference.last_logits(weights.reference_weights(cfg, 11, "cpu"),
                                 cfg, toks)
    np.testing.assert_allclose(mine.numpy(),
                               logits[:, -1, :cfg["vocab_size"]].numpy(),
                               rtol=0, atol=2e-6)


def test_capacity_drops_are_followed(tiny_cell):
    """Six samples of 12 tokens, 4 experts top-2: capacity 45 rows an
    expert for 144 assignments; the draws overfill one, and both sides
    drop the same."""
    cfg = dict(tiny_cell.config)
    model = program(cfg, 5)
    toks = torch.as_tensor(weights.tokens(1, 6, 12, cfg["vocab_size"], 5)[0])
    w = weights.reference_weights(cfg, 5, "cpu")
    seen = {}
    orig = program_moe.local_expert_compute

    def spy(x_flat, *a, **kw):
        seen["ids"] = a[4]
        return orig(x_flat, *a, **kw)

    program_moe.local_expert_compute = spy
    try:
        conf, pred = executables.classify_fn(model, 6)(model, toks)
    finally:
        program_moe.local_expert_compute = orig
    loads = torch.bincount(seen["ids"].reshape(-1), minlength=4)
    assert int(loads.max()) > program_moe.capacity(72, model.cfg)
    ref_conf, ref_top1, _ = reference.bvsb(reference.last_logits(w, cfg,
                                                                 toks))
    np.testing.assert_array_equal(pred.numpy(), ref_top1.numpy())
    np.testing.assert_allclose(conf.numpy(), ref_conf.numpy(), atol=1e-7)


def test_bvsb_matches_the_programs_plain_version():
    from repro_torch.kernels.bvsb import bvsb_plain
    logits = torch.randn(5, 301, generator=torch.Generator().manual_seed(0))
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1   # a tied maximum
    conf, top1, p1 = reference.bvsb(logits)
    c2, t2 = bvsb_plain(logits)
    np.testing.assert_array_equal(top1.numpy(), t2.numpy())
    np.testing.assert_allclose(conf.numpy(), c2.numpy(), atol=1e-7)
    assert float(conf[2]) == 0.0
    assert torch.all(p1 >= conf)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -12], dtype=torch.float32)
    got = reference._round_tf32(x)
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10])
    assert torch.equal(got, want)



def test_the_widest_error_holds_every_sample():
    ref = np.zeros((3, 5))
    ref[:, 0] = 1.0
    conf, p1 = np.full(3, 0.5), np.full(3, 0.5)
    books = {"served_twice": 0, "lost": 0}
    right = check.sample_readings(conf, np.zeros(3, int), ref, conf, p1)
    wrong = check.sample_readings(conf, np.array([0, 0, 3]), ref, conf, p1)
    assert check.numbers([right], books)["sample_err_max"] == 0.0
    got = check.numbers([right, wrong], books)
    assert got["sample_err_max"] == 1.0      # one sample of six off by 1
    assert got["sample_err_p90"] == pytest.approx(0.5)
    assert check.numbers([], books)["sample_err_max"] == np.inf
