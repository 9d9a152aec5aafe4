"""TD002 corpus: an op whose dtype follows the default dtype — under
torch.set_default_dtype(torch.float64) the entry dispatches other ops."""
import torch


def _build():
    def fn(x):
        # BUG: torch.tensor(0.5) should say dtype=torch.float32
        return x * torch.tensor(0.5)
    return fn, (torch.zeros(4, dtype=torch.float32),), {}


LINT_TRACE_ENTRIES = [
    {"name": "corpus-default-dtype", "build": _build},
]
