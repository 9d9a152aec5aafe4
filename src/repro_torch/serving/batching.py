"""Dynamic batching (paper Sec. V-A).

The paper draws "the maximum batch size feasible with the current request
queue length" from the ladder B = {1,2,4,8,16,32,64}, capped per model at
its diminishing-returns point.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.configs.cascade_tiers import BATCH_LADDER


def pick_bucket(queue_len: int, max_batch: int,
                ladder: Sequence[int] = BATCH_LADDER) -> int:
    """Largest ladder batch <= min(queue_len, max_batch); 0 if nothing
    can be dispatched.

    ``max_batch`` is respected *exactly*: when no ladder entry fits under
    ``min(queue_len, max_batch)`` the answer is 0 (do not dispatch), never
    a batch above the cap. The ladder need not be sorted.
    """
    cap = min(queue_len, max_batch)
    if cap <= 0:
        return 0
    feasible = [x for x in ladder if 0 < x <= cap]
    return max(feasible) if feasible else 0
