"""TD004 corpus: a buffer the load fills that the run never reads — a
host-to-device copy for nothing."""
import torch


def _build():
    buffers = {"x": torch.zeros(4, dtype=torch.float32),
               "dead": torch.zeros(8, dtype=torch.float32)}

    def run():
        buffers["x"].add_(1.0)
    return buffers, run


LINT_LOAD_ENTRIES = [
    {"name": "corpus-dead-buffer", "build": _build},
]
