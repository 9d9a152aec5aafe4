"""LM001 corpus: a lane-carry write of real data that bypasses the
active-lane gate — an inactive lane would keep stepping."""
import torch


def _boundary(st, t):
    closes = (t.max() > 1.0).to(torch.float32)
    return st["traces"]["sr"] + closes


def body(st):
    act = st["active"]
    gate = act.to(st["t"].dtype)
    t = st["t"] + 0.05 * gate                     # properly gated
    sr = _boundary(st, t)
    # BUG: real data, no dependence on the active predicate
    frontier = st["t"] * 2.0
    return {"active": act, "frontier": frontier, "t": t,
            "traces": {"sr": sr}}


LINT_LANE_ENTRY = {
    "name": "corpus-unmasked-write",
    "body": body,
    "st0": {"active": torch.ones(4, dtype=torch.bool),
            "frontier": torch.zeros(4, dtype=torch.float32),
            "t": torch.zeros(4, dtype=torch.float32),
            "traces": {"sr": torch.zeros(4, dtype=torch.float32)}},
    "boundary_fields": ("t",),
}
