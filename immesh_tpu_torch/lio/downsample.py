"""Voxel-grid scan downsampling — port of immesh_tpu/lio/downsample.py
(reference pcl::VoxelGrid `downSizeFilterSurf`, voxel_mapping.cpp:1888-1891):
quantize → exact coordinate dedup → segment mean, to a fixed (K, 3) output
with a validity mask."""

from __future__ import annotations

from typing import Tuple

import torch

from immesh_tpu_torch.core.ops import div, segment_sum
from immesh_tpu_torch.map.hash import frame_unique_coords


def voxel_downsample(pts: torch.Tensor, mask: torch.Tensor, leaf: float,
                     k_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts: (N, 3), mask: (N,) → ((K, 3) cell means, (K,) mask)."""
    c = torch.floor(div(pts, leaf)).to(torch.int32)
    seg, first, _ = frame_unique_coords(c, mask, k_out)
    ok = seg < k_out

    w = ok.to(pts.dtype)
    feats = torch.cat([pts * w[:, None], w[:, None]], dim=-1)
    agg = segment_sum(feats, seg, k_out)  # rows of id k_out are dropped
    cnt = torch.clamp(agg[:, 3], min=1.0)
    out = agg[:, 0:3] / cnt[:, None]
    out_mask = (first < pts.shape[0]) & (agg[:, 3] > 0)
    return out, out_mask
