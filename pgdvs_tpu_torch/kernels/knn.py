"""Brute-force KNN mean distance + statistical outlier removal (torch).

Counterpart of ``pgdvs_tpu.kernels.knn`` (same-set mode), the Open3D-style
statistical outlier removal the reference runs on the dynamic point cloud
(the reference's ``pgdvs/renderers/pgdvs_renderer_dyn.py:405-457``): for
every valid point, the mean of its K nearest **squared** distances to the
other valid points; a point is kept when that mean lies below
``median + std_thres * std`` of the cloud's means.

This is plain tensor code on both devices (the JAX package does it in XLA,
not Pallas). The distance matrix is never materialised whole: the valid
points are compacted, then a running top-K list per query is merged with
one [query tile, candidate tile] block of squared distances at a time, so
memory is bounded by the tiles. Distances use the JAX package's formula
``|q|^2 - 2 q.c + |c|^2`` (clamped at 0), so both give the same neighbours
and near-equal means.
"""

from __future__ import annotations

import torch

_BIG = 1e30
QUERY_TILE = 8192
CAND_TILE = 2048


def knn_mean_sq_dist(points: torch.Tensor, valid=None, k: int = 50,
                     tile: int = CAND_TILE, query_tile: int = QUERY_TILE):
    """Mean squared distance from each valid point to its K nearest other
    valid points (the point itself excluded).

    Args:
      points: [N, 3]; valid: [N] bool (default all valid).
      k: neighbour count. Where fewer than K other valid points exist the
        missing neighbours count as 1e30, as in the JAX package.
      tile / query_tile: candidate / query block sizes (memory only).

    Returns mean_d2 [N] float32, 1e30 at invalid points.
    """
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    idx = torch.nonzero(valid, as_tuple=True)[0]
    pts = points[idx].float()
    m = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)
    means = torch.empty((m,), dtype=torch.float32, device=dev)
    for q0 in range(0, m, query_tile):
        q = pts[q0:q0 + query_tile]
        q_sq = sq[q0:q0 + query_tile]
        q_ids = torch.arange(q0, q0 + q.shape[0], device=dev)
        best = torch.full((q.shape[0], k), _BIG, dtype=torch.float32, device=dev)
        for c0 in range(0, m, tile):
            c = pts[c0:c0 + tile]
            cross = q @ c.T
            d2 = torch.clamp(q_sq[:, None] - 2.0 * cross + sq[None, c0:c0 + tile],
                             min=0.0)
            c_ids = torch.arange(c0, c0 + c.shape[0], device=dev)
            d2 = torch.where(q_ids[:, None] == c_ids[None, :],
                             torch.full_like(d2, _BIG), d2)
            merged = torch.cat([best, d2], dim=1)
            best = torch.topk(merged, k, dim=1, largest=False, sorted=True).values
        means[q0:q0 + query_tile] = best.mean(dim=1)
    out = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    out[idx] = means
    return out


def masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the valid entries; the lower middle element for an even
    count (as torch.median)."""
    n = x.shape[0]
    cnt = int(valid.sum())
    srt = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf")))).values
    return srt[min(max((cnt - 1) // 2, 0), n - 1)]


def masked_std(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Unbiased (n - 1) standard deviation over the valid entries."""
    cnt = max(int(valid.sum()), 1)
    zero = torch.zeros_like(x)
    mean = torch.sum(torch.where(valid, x, zero)) / cnt
    var = torch.sum(torch.where(valid, (x - mean) ** 2, zero)) / max(cnt - 1, 1)
    return torch.sqrt(var)


def statistical_outlier_mask(points: torch.Tensor, valid=None, k: int = 50,
                             std_thres: float = 0.1, tile: int = CAND_TILE):
    """Open3D-style statistical outlier mask over a (padded) point cloud.

    Returns keep [N] bool (valid and mean-KNN squared distance below the
    threshold) and the threshold, median + std_thres * std over the valid
    points' means.
    """
    if valid is None:
        valid = torch.ones((points.shape[0],), dtype=torch.bool, device=points.device)
    mean_d2 = knn_mean_sq_dist(points, valid, k=k, tile=tile)
    thres = masked_median(mean_d2, valid) + masked_std(mean_d2, valid) * std_thres
    return valid & (mean_d2 < thres), thres
