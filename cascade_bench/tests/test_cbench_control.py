"""The control at a test size: the reference computed in TF32 in the
program's place, and the reference with its answers altered, each fail a
number that sound runs of the program pass, judged by ``check.verdict``
against the cell's limits (on the CPU the TF32 products are emulated by
rounding their operands)."""
import pytest

from cascade_bench import check, harness


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9, 4_000_000_007])
def test_control_fails_where_the_program_passes(tiny_cell, seed):
    out = harness.run_cell(tiny_cell, seed, 1.0, False, device="cpu",
                           control=True)
    assert out["correct"], out["checks"]
    control_ok, _ = check.verdict(out["control"], tiny_cell.limits)
    assert not control_ok
    assert out["control"]["sample_err_p90"] > \
        100 * out["checks"]["sample_err_p90"]["value"]
    altered_ok, _ = check.verdict(out["altered"], tiny_cell.limits)
    assert not altered_ok
