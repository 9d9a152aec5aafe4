"""The frozen counts against hand counts at a tiny size, and against the
program's own roofline counts they were copied from."""
import pytest

from cascade_bench import counts
from repro_torch.roofline import analysis as ra

CFG = {"num_layers": 3, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
       "head_dim": 2, "d_ff": 6, "moe_d_ff": 4, "vocab_size": 10,
       "num_experts": 4, "num_experts_per_tok": 2, "num_shared_experts": 1,
       "first_dense_layers": 1}


def test_flash_pairs_by_hand():
    assert counts.flash_pairs(4, 4) == 1 + 2 + 3 + 4
    assert counts.flash_pairs(5, 5, window=2) == 1 + 2 + 2 + 2 + 2
    assert counts.flash_pairs(3, 7, causal=False) == 21


def test_flash_work_by_hand():
    w = counts.flash_work(2, 3, 3, 4, 2, 8)
    assert w.bytes == (2 * 2 * 3 * 4 * 8 + 2 * 2 * 3 * 2 * 8) * 4
    assert w.flops == 3 * 4 * 8 * 6 * 2 * 4      # 3xTF32, 6 pairs
    assert w.rate == counts.TF32_FLOPS
    assert w.bound_s() == max(w.bytes / 3.35e12, w.flops / 495e12)


@pytest.mark.parametrize("shape", [(1, 197, 197, 16, 8, 64),
                                   (32, 64, 64, 16, 16, 128)])
def test_flash_work_equals_the_programs(shape):
    mine = counts.flash_work(*shape)
    theirs = ra.flash_work(*shape, 4)
    assert (mine.bytes, mine.flops) == (theirs.bytes, theirs.flops)
    assert theirs.rate == "tf32"


def test_bvsb_work_by_hand_and_the_programs():
    w = counts.bvsb_work(3, 100)
    assert (w.bytes, w.flops) == (3 * 100 * 4 + 24, 1200)
    theirs = ra.bvsb_work(3, 100, 4)
    assert (w.bytes, w.flops) == (theirs.bytes, theirs.flops)


def test_classify_flops_by_hand():
    # per token, each layer: q, k, v, o projections 8*8 + 8*4 + 8*4 + 8*8
    proj = 64 + 32 + 32 + 64
    dense = 3 * 8 * 6
    moe = 3 * 8 * 4 * (2 + 1) + 8 * 4          # 2 routed + 1 shared, router
    per_token = 2 * (3 * proj + dense + 2 * moe)
    attn = 3 * 4 * 2 * 4 * (1 + 2 + 3 + 4 + 5)   # layers x 4 hd H pairs
    head = 2 * 8 * 10
    want = 2 * (5 * per_token + attn + head)
    assert counts.classify_flops(CFG, 2, 5) == want
