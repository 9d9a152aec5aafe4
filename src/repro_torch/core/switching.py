"""Server model switching (paper Sec. IV-E).

Decision over the set of all device thresholds C (c_i^k, tier k):

  S(C) = -1  switch to a *faster* model, if some tier has ALL of its
             thresholds below c_lower (the controller is squeezing that
             tier hard -> the server is too slow);
         +1  switch to a *heavier* model, if EVERY device in EVERY tier
             is above its tier's c_upper^k (thresholds are saturating ->
             server headroom is going unused);
          0  otherwise.

Evaluated once per window on CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DEFAULT_C_LOWER = 0.05
DEFAULT_C_UPPER = {"low": 0.85, "mid": 0.80, "high": 0.75}


def decide(thresholds, tier_ids, n_tiers, c_lower, c_upper_per_tier,
           active=None):
    """Vectorized S(C).

    thresholds: (N,); tier_ids: (N,) int in [0, n_tiers);
    c_upper_per_tier: (n_tiers,). Returns a scalar int32 tensor in
    {-1, 0, +1}.
    """
    thresholds = torch.as_tensor(thresholds)
    tier_ids = torch.as_tensor(tier_ids).long()
    active = (torch.ones(thresholds.shape, dtype=torch.bool) if active is None
              else torch.as_tensor(active, dtype=torch.bool))

    below = (thresholds < c_lower) | ~active
    above = (thresholds > torch.as_tensor(c_upper_per_tier)[tier_ids]) | ~active

    oh = F.one_hot(tier_ids, n_tiers).float()
    tier_count = oh.sum(dim=0)
    tier_active = (oh * active[:, None].float()).sum(dim=0)
    tier_all_below = (oh * below[:, None]).sum(dim=0) >= tier_count
    tier_nonempty = tier_active > 0

    any_tier_all_below = torch.any(tier_all_below & tier_nonempty)
    all_above = torch.all(above) & torch.any(active)

    one = torch.tensor(1, dtype=torch.int32)
    return torch.where(any_tier_all_below, -one,
                       torch.where(all_above, one, 0 * one))
