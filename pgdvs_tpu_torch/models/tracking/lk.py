"""Pyramidal Lucas-Kanade point tracking in torch.

Counterpart of ``pgdvs_tpu.models.tracking.lk``: a classical, weight-free
tracker filling the reference's tracker slot (dense tracking of the
dynamic-mask pixels across the ±K track frames,
``pgdvs_renderer_dyn_track.py:398-558``):

  * a grey pyramid per frame (``n_levels`` levels, 2x2 mean downsampling);
  * per level, inverse-additive LK: a window of radius ``radius`` around
    the estimate, ``iters`` Gauss-Newton steps on the template's gradients;
  * queries live on different home frames; a forward and a backward chain
    run frame to frame over all queries, each query taking the chain's
    position once the chain has passed its home frame;
  * visibility = in bounds AND the window's mean absolute grey error
    against the home frame's window below ``vis_err_thres``; the home frame
    is always visible.

The JAX package's ``fori_loop`` and ``scan`` are Python loops over
iterations and frames here, each step one batch of tensor ops over a whole
query chunk on the frames' device. No query's track depends on another's,
so queries are tracked ``query_chunk_size`` at a time (memory only).
"""

from __future__ import annotations

import dataclasses

import torch

from pgdvs_tpu_torch.core.interpolate import bilinear_sample


def _to_gray(frames):
    return 0.299 * frames[..., 0] + 0.587 * frames[..., 1] + 0.114 * frames[..., 2]


def _downsample2x(img):
    """2x2 mean of [T, H, W] (odd edges dropped)."""
    t, h, w = img.shape
    h2, w2 = h // 2, w // 2
    return img[:, : h2 * 2, : w2 * 2].reshape(t, h2, 2, w2, 2).mean(dim=(2, 4))


def _window_offsets(radius: int, device):
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return ox.reshape(-1), oy.reshape(-1)


def _sample_window(img, x, y, ox, oy):
    """img [H, W]; x, y [N] -> [N, (2r+1)^2] edge-clamped bilinear samples."""
    xs = x[:, None] + ox[None, :]
    ys = y[:, None] + oy[None, :]
    return bilinear_sample(img[..., None], xs, ys, zero_pad=False)[..., 0]


def _lk_refine(img_a, img_b, pos_a, pos_b, radius: int, iters: int, ox, oy):
    """Refine pos_b so that img_b(pos_b + w) matches img_a(pos_a + w)."""
    patch_a = _sample_window(img_a, pos_a[:, 0], pos_a[:, 1], ox, oy)
    gx = (_sample_window(img_a, pos_a[:, 0] + 0.5, pos_a[:, 1], ox, oy)
          - _sample_window(img_a, pos_a[:, 0] - 0.5, pos_a[:, 1], ox, oy))
    gy = (_sample_window(img_a, pos_a[:, 0], pos_a[:, 1] + 0.5, ox, oy)
          - _sample_window(img_a, pos_a[:, 0], pos_a[:, 1] - 0.5, ox, oy))
    gxx = torch.sum(gx * gx, dim=1)
    gxy = torch.sum(gx * gy, dim=1)
    gyy = torch.sum(gy * gy, dim=1)
    det = gxx * gyy - gxy * gxy
    inv_ok = torch.abs(det) > 1e-8
    det = torch.where(inv_ok, det, torch.ones_like(det))
    pos = pos_b
    for _ in range(iters):
        diff = _sample_window(img_b, pos[:, 0], pos[:, 1], ox, oy) - patch_a
        bx = torch.sum(diff * gx, dim=1)
        by = torch.sum(diff * gy, dim=1)
        step = torch.stack([(gyy * bx - gxy * by) / det, (gxx * by - gxy * bx) / det], dim=-1)
        step = torch.clamp(step, -radius * 2.0, radius * 2.0)
        pos = pos - torch.where(inv_ok[:, None], step, torch.zeros_like(step))
    return pos


def _lk_track(gray, pyr, queries, query_valid, n_levels, radius, iters, vis_thres):
    t_n, h, w = gray.shape
    ox, oy = _window_offsets(radius, gray.device)
    home = queries[:, 0].to(torch.int32)
    home_xy = queries[:, 1:3].float()
    zeros = torch.zeros_like(home_xy)

    def step_pair(src_t, dst_t, pos):
        cur = pos
        for lvl in reversed(range(n_levels)):
            s = 2.0 ** lvl
            cur = _lk_refine(pyr[lvl][src_t], pyr[lvl][dst_t], pos / s, cur / s,
                             radius, iters, ox, oy) * s
        return cur

    def advance(pos, new_pos, active, starts):
        return torch.where(starts[:, None], home_xy,
                           torch.where(active[:, None], new_pos, pos))

    # forward chain t -> t + 1: fwd[t] = positions at frame t + 1
    pos = torch.where((home == 0)[:, None], home_xy, zeros)
    fwd = []
    for t in range(t_n - 1):
        pos = advance(pos, step_pair(t, t + 1, pos), home <= t, home == t + 1)
        fwd.append(pos)
    # backward chain t -> t - 1: bwd[t - 1] = positions at frame t - 1
    pos = torch.where((home == t_n - 1)[:, None], home_xy, zeros)
    bwd = [None] * (t_n - 1)
    for t in range(t_n - 1, 0, -1):
        pos = advance(pos, step_pair(t, t - 1, pos), home >= t, home == t - 1)
        bwd[t - 1] = pos

    home_patch = torch.zeros((home.shape[0], ox.shape[0]), dtype=torch.float32,
                             device=gray.device)
    for t in range(t_n):
        patch = _sample_window(gray[t], home_xy[:, 0], home_xy[:, 1], ox, oy)
        home_patch = torch.where((home == t)[:, None], patch, home_patch)

    tracks, visibles = [], []
    for t in range(t_n):
        fwd_pos = fwd[t - 1] if t >= 1 else home_xy
        bwd_pos = bwd[t] if t <= t_n - 2 else home_xy
        pos = torch.where((t == home)[:, None], home_xy,
                          torch.where((t > home)[:, None], fwd_pos, bwd_pos))
        patch = _sample_window(gray[t], pos[:, 0], pos[:, 1], ox, oy)
        err = torch.mean(torch.abs(patch - home_patch), dim=1)
        inb = (pos[:, 0] >= 0) & (pos[:, 0] <= w - 1) & (pos[:, 1] >= 0) & (pos[:, 1] <= h - 1)
        vis = (inb & (err < vis_thres) & query_valid) | ((home == t) & query_valid)
        tracks.append(pos)
        visibles.append(vis)
    return torch.stack(tracks, dim=1), torch.stack(visibles, dim=1)


@dataclasses.dataclass(frozen=True)
class LucasKanadeTracker:
    """Chained pyramidal LK tracker with photometric visibility.

    ``query_chunk_size`` bounds the working set ([chunk, window^2] floats
    per sample): 65536 queries take well under 1 GB, where the JAX
    package's 8192 was sized for TPU HBM.
    """

    n_levels: int = 3
    radius: int = 4
    iters: int = 8
    vis_err_thres: float = 0.08  # mean-abs photometric error (gray, [0,1])
    query_chunk_size: int = 65536

    @torch.no_grad()
    def __call__(self, frames, queries, query_valid=None):
        """Track query points across all frames.

        Args:
          frames: [T, H, W, 3] in [0, 1].
          queries: [N, 3] (home frame t, x, y).
          query_valid: [N] bool (default all valid).

        Returns tracks [N, T, 2] float (x, y) and visibles [N, T] bool.
        """
        n = queries.shape[0]
        if query_valid is None:
            query_valid = torch.ones((n,), dtype=torch.bool, device=queries.device)
        gray = _to_gray(frames.float())
        pyr = [gray]
        for _ in range(self.n_levels - 1):
            pyr.append(_downsample2x(pyr[-1]))
        args = (self.n_levels, self.radius, self.iters, self.vis_err_thres)
        cs = self.query_chunk_size
        outs = [_lk_track(gray, pyr, queries[i:i + cs], query_valid[i:i + cs], *args)
                for i in range(0, max(n, 1), cs)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
