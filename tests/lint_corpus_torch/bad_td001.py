"""TD001 corpus: a float64 op in a recorded entry point."""
import torch


def _build():
    def fn(x):
        # BUG: the sum runs in float64
        return x.double().sum().float()
    return fn, (torch.zeros(4, dtype=torch.float32),), {}


LINT_TRACE_ENTRIES = [
    {"name": "corpus-f64-entry", "build": _build},
]
