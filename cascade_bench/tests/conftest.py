"""The benchmark's own tests: run them from the repository's root with
``python -m pytest cascade_bench/tests``; those marked ``cuda`` run on a
card only and skip elsewhere."""
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def tiny_cell():
    """A cell at a test size: the granite and deepseek blocks (GQA, a dense
    first layer, routed and shared experts, an untied head) on 8 devices."""
    from cascade_bench import catalog
    bench = catalog.load_benchmark()
    return catalog.Cell("tiny", 1, _load(DATA / "configs" / "tiny-moe.json"),
                        _load(DATA / "traffic" / "tiny-fleet.json"),
                        _load(DATA / "limits" / "tiny.json"),
                        bench["end_to_end"], bench["per_layer"])


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
