"""On the card: a whole run of the test-size cell through the CUDA
kernels, the program's numbers an order below the TF32 control's."""
import pytest

from cascade_bench import harness


@pytest.mark.cuda
def test_run_on_the_card_separates_from_the_control(tiny_cell, card):
    out = harness.run_cell(tiny_cell, 2 ** 31 + 3, 2.0, False,
                           device=str(card), control=True)
    prog = {k: v["value"] for k, v in out["checks"].items()}
    assert prog["served_twice"] == 0 and prog["lost"] == 0
    assert out["control"]["sample_err_max"] > 10 * prog["sample_err_max"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
