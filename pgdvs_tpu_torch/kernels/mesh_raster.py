"""Grid-mesh triangle rasterization (torch).

Counterpart of ``pgdvs_tpu.kernels.mesh_raster``, which replaces
pytorch3d's ``MeshRasterizer`` + ``SimpleShader`` for the reference's
``dyn_render_type='mesh'`` (``pgdvs_renderer_dyn.py:542-669``): the pixels
of a source frame form a grid mesh (two triangles per pixel, the vertices
its lifted 3D points), rendered into the target camera with barycentric
vertex colours and a z-buffer.

The faces are a static topology over the H x W vertex grid with validity
masks; each face rasterizes into a fixed window around its projected
centroid (a face wider than the window is dropped). Two passes: a z-buffer
by ``scatter_reduce_(..., "amin")``, then the colours of the front surface
summed by ``index_add_`` and normalised. The window's taps are recomputed
in the second pass rather than held: at 288x550 the 49 taps of every face
would take about 0.4 GB. Plain tensor code on both devices (XLA in the JAX
package, not Pallas); on the card ``index_add_``'s atomics make the sums
agree with the CPU to float32 rounding.
"""

from __future__ import annotations

import torch

from pgdvs_tpu_torch.core import cameras

_FAR = 1e30


def grid_mesh_faces(h: int, w: int, device=None):
    """Two triangles per pixel over an [H, W] vertex grid: face
    [(r, c), (r+1, c), (r+1, c+1)] and [(r, c), (r+1, c+1), (r, c+1)]
    (``pgdvs_renderer_dyn.py:559-581``). Returns faces [2HW, 3] int64
    (index 0 where a vertex falls off the grid) and face_ok [2HW] bool."""
    r, c = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")
    r, c = r.reshape(-1), c.reshape(-1)
    f1 = torch.stack([r * w + c, (r + 1) * w + c, (r + 1) * w + c + 1], dim=-1)
    f2 = torch.stack([r * w + c, (r + 1) * w + c + 1, r * w + c + 1], dim=-1)
    inb = (r + 1 < h) & (c + 1 < w)
    face_ok = torch.cat([inb, inb])
    faces = torch.where(face_ok[:, None], torch.cat([f1, f2]), torch.zeros_like(f1[:1]))
    return faces, face_ok


@torch.no_grad()
def rasterize_grid_mesh(verts, colors, vert_valid, flat_cam, image_hw, window: int = 3,
                        depth_band: float = 0.005):
    """Rasterize a pixel-grid mesh into a target camera.

    Args:
      verts: [H*W, 3] world vertices (one per source pixel); colors:
        [H*W, 3]; vert_valid: [H*W] bool; flat_cam: [34].
      image_hw: (H, W), the source grid and the target image size.
      window: half-extent of each face's rasterization window.

    Returns rgb [H, W, 3] and mask [H, W, 1].
    """
    h, w = image_hw
    dev = verts.device
    faces, face_ok = grid_mesh_faces(h, w, dev)
    f_valid = face_ok & vert_valid.bool()[faces].all(dim=1)
    uv, z, in_front = cameras.project_points(verts.float(), flat_cam)
    f_valid = f_valid & in_front[faces].all(dim=1)

    tri_uv = uv[faces]       # [F, 3, 2]
    tri_z = z[faces]         # [F, 3]
    tri_col = colors.float()[faces]  # [F, 3, 3]
    center = tri_uv.mean(dim=1)
    cx = torch.round(center[:, 0]).to(torch.int64)
    cy = torch.round(center[:, 1]).to(torch.int64)
    ext = (tri_uv - center[:, None, :]).abs().amax(dim=(1, 2))
    f_valid = f_valid & (ext <= window + 0.5)

    a, b, c = tri_uv[:, 0], tri_uv[:, 1], tri_uv[:, 2]
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1])
    det_ok = det.abs() > 1e-12
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    f_valid = f_valid & det_ok

    def tap(dx, dy):
        """(pixel index, depth, colour, covered) of every face at the
        window tap (dx, dy); index h * w where the tap misses."""
        px, py = cx + dx, cy + dy
        fx, fy = px.float(), py.float()
        w1 = ((b[:, 0] - fx) * (c[:, 1] - fy) - (c[:, 0] - fx) * (b[:, 1] - fy)) / det_safe
        w2 = ((c[:, 0] - fx) * (a[:, 1] - fy) - (a[:, 0] - fx) * (c[:, 1] - fy)) / det_safe
        w3 = 1.0 - w1 - w2
        inside = (w1 >= 0) & (w2 >= 0) & (w3 >= 0)
        ok = f_valid & inside & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        z_px = w1 * tri_z[:, 0] + w2 * tri_z[:, 1] + w3 * tri_z[:, 2]
        idx = torch.where(ok, py * w + px, torch.full_like(px, h * w))
        return idx, z_px, (w1, w2, w3), ok

    offsets = [(dx, dy) for dy in range(-window, window + 1)
               for dx in range(-window, window + 1)]
    zbuf = torch.full((h * w + 1,), _FAR, dtype=torch.float32, device=dev)
    for dx, dy in offsets:
        idx, z_px, _bary, ok = tap(dx, dy)
        zbuf.scatter_reduce_(0, idx, torch.where(ok, z_px, torch.full_like(z_px, _FAR)),
                             reduce="amin")

    num = torch.zeros((h * w + 1, 3), dtype=torch.float32, device=dev)
    den = torch.zeros((h * w + 1,), dtype=torch.float32, device=dev)
    for dx, dy in offsets:
        idx, z_px, (w1, w2, w3), ok = tap(dx, dy)
        front = z_px <= zbuf[idx.clamp(0, h * w - 1)] * (1.0 + depth_band)
        wgt = (ok & front).float()
        col_px = (w1[:, None] * tri_col[:, 0] + w2[:, None] * tri_col[:, 1]
                  + w3[:, None] * tri_col[:, 2])
        num.index_add_(0, idx, col_px * wgt[:, None])
        den.index_add_(0, idx, wgt)

    num = num[:h * w].reshape(h, w, 3)
    den = den[:h * w].reshape(h, w, 1)
    mask = (den > 0).float()
    return num / torch.clamp(den, min=1e-8) * mask, mask
