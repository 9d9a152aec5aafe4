"""Server model switching (paper Sec. IV-E).

Decision over the set of all device thresholds C (c_i^k, tier k):

  S(C) = -1  switch to a *faster* model, if some tier has ALL of its
             thresholds below c_lower (the controller is squeezing that
             tier hard -> the server is too slow);
         +1  switch to a *heavier* model, if EVERY device in EVERY tier
             is above its tier's c_upper^k (thresholds are saturating ->
             server headroom is going unused);
          0  otherwise.

Evaluated once per window, for one fleet (N,) or a batch of lanes
(B, N), on the device of the thresholds.
"""
from __future__ import annotations

import torch

from repro_torch.core.multitascpp import lane_values

DEFAULT_C_LOWER = 0.05
DEFAULT_C_UPPER = {"low": 0.85, "mid": 0.80, "high": 0.75}


def decide(thresholds, tier_ids, n_tiers, c_lower, c_upper_per_tier,
           active=None):
    """Vectorized S(C).

    thresholds: (N,) or (B, N); tier_ids: int in [0, n_tiers), like
    thresholds; c_lower: scalar or (B,); c_upper_per_tier: (n_tiers,) or
    (B, n_tiers); active: optional bool like thresholds. Returns an int32
    tensor in {-1, 0, +1}: 0-d for one fleet, (B,) for lanes. Runs on the
    thresholds' device.
    """
    return decide_from_partials(decide_partials(
        thresholds, tier_ids, n_tiers, c_lower, c_upper_per_tier, active))


def decide_partials(thresholds, tier_ids, n_tiers, c_lower,
                    c_upper_per_tier, active=None):
    """Per-shard partial sums of ``decide``'s reductions.

    A fleet whose device axis is split over ranks
    (``jaxsim.run_device_sharded``) computes these over each rank's slice,
    sums them over the ranks, and feeds the totals to
    ``decide_from_partials``: the same S(C) as ``decide`` over the whole
    fleet, since every quantity the decision compares is a sum over
    devices. Counts are exact in float32 up to 2^24 devices.

    Arguments as ``decide``'s, (N,) or (B, N). Returns float32 tensors:
    ``count``, ``active``, ``below`` (..., n_tiers) and ``not_above``,
    ``any_active`` (...).
    """
    thresholds = torch.as_tensor(thresholds)
    dev = thresholds.device
    tier_ids = torch.as_tensor(tier_ids, device=dev).long()
    active = (torch.ones(thresholds.shape, dtype=torch.bool, device=dev)
              if active is None
              else torch.as_tensor(active, dtype=torch.bool, device=dev))
    c_lower = lane_values(c_lower, thresholds, thresholds.dtype)
    c_upper = torch.as_tensor(c_upper_per_tier, dtype=thresholds.dtype,
                              device=dev)
    if c_upper.dim() < thresholds.dim():
        c_upper = c_upper.expand(thresholds.shape[:-1] + c_upper.shape)
    below = (thresholds < c_lower) | ~active
    above = (thresholds > torch.gather(c_upper, -1, tier_ids)) | ~active
    # one-hot tiers, (..., N, tiers); a comparison, not F.one_hot, whose
    # range checks may read the tensor back on the host
    oh = (tier_ids[..., None]
          == torch.arange(n_tiers, device=dev)).float()
    return {
        "count": oh.sum(dim=-2),
        "active": (oh * active[..., None].float()).sum(dim=-2),
        "below": (oh * below[..., None]).sum(dim=-2),
        "not_above": (~above).sum(dim=-1).float(),
        "any_active": active.sum(dim=-1).float(),
    }


def decide_from_partials(p):
    """S(C) from (already summed) ``decide_partials`` output: int32, 0-d
    for one fleet, (B,) for lanes."""
    tier_all_below = p["below"] >= p["count"]
    tier_nonempty = p["active"] > 0
    any_tier_all_below = torch.any(tier_all_below & tier_nonempty, dim=-1)
    all_above = (p["not_above"] == 0) & (p["any_active"] > 0)
    one = torch.ones((), dtype=torch.int32, device=p["count"].device)
    return torch.where(any_tier_all_below, -one,
                       torch.where(all_above, one, 0 * one))
