"""LM002 corpus: the window boundary writes a carry buffer that is not a
BOUNDARY_FIELD (nor a trace row)."""
import torch


def _boundary(t, frontier):
    closes = (t.max() > 1.0).to(t.dtype)
    # BUG: the boundary writes 'frontier', which is not a boundary field
    return t + closes, frontier * (1.0 - closes)


def body(st):
    act = st["active"]
    gate = act.to(st["t"].dtype)
    t = st["t"] + 0.05 * gate
    t2, frontier = _boundary(t, st["frontier"])
    return {"active": act, "frontier": frontier, "t": t2,
            "traces": {"sr": st["traces"]["sr"]}}


LINT_LANE_ENTRY = {
    "name": "corpus-boundary-overreach",
    "body": body,
    "st0": {"active": torch.ones(4, dtype=torch.bool),
            "frontier": torch.zeros(4, dtype=torch.float32),
            "t": torch.zeros(4, dtype=torch.float32),
            "traces": {"sr": torch.zeros(4, dtype=torch.float32)}},
    "boundary_fields": ("t",),
}
