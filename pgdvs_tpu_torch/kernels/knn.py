"""Brute-force KNN mean distance + statistical outlier removal (torch).

Counterpart of ``pgdvs_tpu.kernels.knn``, the Open3D-style statistical
outlier removal the reference runs on the dynamic point cloud (the
reference's ``pgdvs/renderers/pgdvs_renderer_dyn.py:405-457``): for every
valid point, the mean of its K nearest **squared** distances to the other
valid points; a point is kept when that mean lies below
``median + std_thres * std`` of the cloud's means, or below a threshold
given from outside. The cross-set mode measures each valid query against a
second cloud instead (the track renderer's distance to the base cloud,
``pgdvs_renderer_dyn_track.py:296-338``): every valid candidate counts and
nothing is excluded as the query itself.

This is plain tensor code on both devices (the JAX package does it in XLA,
not Pallas). The distance matrix is never materialised whole: the valid
points are compacted, then a running top-K list per query is merged with
one [query tile, candidate tile] block of squared distances at a time, so
memory is bounded by the tiles. Distances use the JAX package's formula
``|q|^2 - 2 q.c + |c|^2`` (clamped at 0), so both give the same neighbours
and near-equal means.

A cloud with fewer candidates than K is the exception: every mean then
carries the 1e30 stand-in of the missing neighbours, and whether the
filter keeps all points or none turns on the last bit of float32 sums of
those stand-ins (the std of equal means is 0, or inf once one sum rounds
away). There the per-point mean and ``masked_std`` sum in the order of the
JAX package's XLA CPU reductions (``xla_order_sum``), a fixed sequence of
float32 adds that the card repeats bit for bit.
"""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.utils import tracing

_BIG = 1e30
QUERY_TILE = 8192
CAND_TILE = 2048
XLA_REDUCE_WINDOW = 32


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        s = s + x[..., j]
    return s


def xla_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of XLA's CPU reduce: up to 32
    elements left to right from 0; a longer dim is zero-padded to a multiple
    of 32 (the lower half of the pad in front), each window of 32 summed
    left to right, and the window sums reduced again the same way."""
    n = x.shape[-1]
    if n <= XLA_REDUCE_WINDOW:
        return _sequential_sum(x)
    pad = -n % XLA_REDUCE_WINDOW
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return xla_order_sum(_sequential_sum(x.reshape(*x.shape[:-1], -1, XLA_REDUCE_WINDOW)))


def knn_mean_sq_dist(points: torch.Tensor, valid=None, k: int = 50,
                     tile: int = CAND_TILE, query_tile: int = QUERY_TILE,
                     candidates=None, cand_valid=None, exclude_self: bool = True):
    """Mean squared distance from each valid query to its K nearest valid
    candidates.

    Args:
      points: [N, 3] queries; valid: [N] bool (default all valid).
      k: neighbour count. Where fewer than K candidates exist the missing
        neighbours count as 1e30, as in the JAX package.
      tile / query_tile: candidate / query block sizes (memory only).
      candidates: optional [M, 3] second cloud (cross-set mode), with
        cand_valid [M] bool (default all valid). Without it the candidates
        are the valid queries themselves, each query excluded
        (``exclude_self`` must then stay True, as in the JAX package).

    Returns mean_d2 [N] float32, 1e30 at invalid points.
    """
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    same_set = candidates is None
    with tracing.span("sync"):
        idx = torch.nonzero(valid, as_tuple=True)[0]
    pts = points[idx].float()
    sq = torch.sum(pts * pts, dim=-1)
    if same_set:
        if not exclude_self:
            raise ValueError("same-set knn always excludes self")
        cands, c_sq = pts, sq
    else:
        if cand_valid is not None:
            candidates = candidates[cand_valid]
        cands = candidates.float()
        c_sq = torch.sum(cands * cands, dim=-1)
    m = pts.shape[0]
    # Fewer candidates than K: each mean carries the 1e30 stand-in, so take
    # it as XLA does (its sum times the float32 reciprocal of K).
    xla_mean = (m - 1 if same_set else cands.shape[0]) < k
    inv_k = torch.full((), 1.0 / k, dtype=torch.float32, device=dev)
    means = torch.empty((m,), dtype=torch.float32, device=dev)
    for q0 in range(0, m, query_tile):
        q = pts[q0:q0 + query_tile]
        q_sq = sq[q0:q0 + query_tile]
        q_ids = torch.arange(q0, q0 + q.shape[0], device=dev)
        best = torch.full((q.shape[0], k), _BIG, dtype=torch.float32, device=dev)
        for c0 in range(0, cands.shape[0], tile):
            c = cands[c0:c0 + tile]
            cross = q @ c.T
            d2 = torch.clamp(q_sq[:, None] - 2.0 * cross + c_sq[None, c0:c0 + tile],
                             min=0.0)
            if same_set:
                c_ids = torch.arange(c0, c0 + c.shape[0], device=dev)
                d2 = torch.where(q_ids[:, None] == c_ids[None, :],
                                 torch.full_like(d2, _BIG), d2)
            merged = torch.cat([best, d2], dim=1)
            best = torch.topk(merged, k, dim=1, largest=False, sorted=True).values
        means[q0:q0 + query_tile] = xla_order_sum(best) * inv_k if xla_mean else best.mean(dim=1)
    out = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    out[idx] = means
    return out


def masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the valid entries; the lower middle element for an even
    count (as torch.median)."""
    n = x.shape[0]
    with tracing.span("sync"):
        cnt = int(valid.sum())
    srt = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf")))).values
    return srt[min(max((cnt - 1) // 2, 0), n - 1)]


def masked_std(x: torch.Tensor, valid: torch.Tensor, xla_order: bool = False) -> torch.Tensor:
    """Unbiased (n - 1) standard deviation over the valid entries; with
    ``xla_order`` both sums run in the order of XLA's CPU reduce over the
    whole (padded) vector."""
    with tracing.span("sync"):
        cnt = max(int(valid.sum()), 1)
    zero = torch.zeros_like(x)
    total = xla_order_sum if xla_order else torch.sum
    mean = total(torch.where(valid, x, zero)) / cnt
    var = total(torch.where(valid, (x - mean) ** 2, zero)) / max(cnt - 1, 1)
    return torch.sqrt(var)


def statistical_outlier_mask(points: torch.Tensor, valid=None, k: int = 50,
                             std_thres: float = 0.1, tile: int = CAND_TILE,
                             dist_thres=None):
    """Open3D-style statistical outlier mask over a (padded) point cloud.

    Returns keep [N] bool (valid and mean-KNN squared distance below the
    threshold) and the threshold: ``dist_thres`` where given (the track
    renderer reuses the base cloud's, ``pgdvs_renderer_dyn_track.py:355-362``),
    else median + std_thres * std over the valid points' means (with fewer
    than K + 1 valid points, the std in XLA's order: see the module's note).
    """
    with tracing.span("dynamic.knn", device=points.device):
        if valid is None:
            valid = torch.ones((points.shape[0],), dtype=torch.bool, device=points.device)
        mean_d2 = knn_mean_sq_dist(points, valid, k=k, tile=tile)
        if dist_thres is None:
            with tracing.span("sync"):
                n_valid = int(valid.sum())
            std = masked_std(mean_d2, valid, xla_order=n_valid <= k)
            thres = masked_median(mean_d2, valid) + std * std_thres
        else:
            thres = dist_thres
        return valid & (mean_d2 < thres), thres
