"""Neighborhood-aggregation primitive (port of ``cognn_tpu/ops/aggregate.py``).

The engines' plain sparse path funnels aggregation through
:func:`segment_sum_rows`, which replaces the reference's oblivious grouped ADD
over destination-sorted edge slots (``SecureAggregation::
prefix_network_aggregate``, `optimize-gcn/gcn.h:309-342`). Its shape depends
only on padded sizes, never on values.
"""

from __future__ import annotations

import math

import torch


def segment_sum_rows(vals: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Sum rows of ``vals [..., E, D]`` into ``[..., num_segments, D]`` by
    ``seg_ids [..., E]``, independently for each leading index.

    Out-of-range ids are dropped, as ``jax.ops.segment_sum`` drops them; ids
    need not be sorted."""
    *batch, E, D = vals.shape
    B = math.prod(batch)
    seg = seg_ids.reshape(B, E).to(torch.int64)
    base = torch.arange(B, device=vals.device)[:, None] * num_segments
    trash = B * num_segments
    flat = torch.where((seg >= 0) & (seg < num_segments), seg + base, trash)
    out = vals.new_zeros(trash + 1, D)
    out.index_add_(0, flat.reshape(-1), vals.reshape(B * E, D))
    return out[:trash].reshape(*batch, num_segments, D)
