"""Plain reference of one PGDVS novel view (Zhao et al., ICLR 2024).

Written from the method's description and the renderer input contract
(flat 34-vector cameras ``[h, w, K (16), c2w (16)]``, images channel-last),
in plain torch, with no kernel and nothing of the program:

* static layer: rays through integer pixel centres; samples uniform in
  inverse depth between the near and far bound; each sample projected into
  every spatial source; rgb and ResUNet features read there by the
  configuration's sampler (``reference/samplers/<sampler>.py``); a view is
  valid where the sample is in front of
  the source, inside its image, and off its dynamic mask (interpolated
  mask <= 1e-3); then GNT (``nets.GNT``); depth = sum of weights x z.
* dynamic layer: the dynamic pixels of the first temporal source lifted by
  their depth, advected by the forward flow to the second source and lifted
  there, interpolated linearly to the target time (``dynamic_cloud``);
  statistical outlier removal (``knn_means``: the mean of the K nearest
  squared distances, kept below ``outlier_threshold``, median + t * std;
  ``splat_reach``: the pixels that a point's decision can change); then softmax splatting
  (Niklaus and Liu, CVPR 2020) of the first source's kept pixels, the rest
  replaced by clamped noise, weighted by exp(-alpha * the photometric error
  of the backward warp); mask = splatted mask > 1e-3 (``splat_layer``).
* composite: (1 - mask) * static + mask * dynamic.

``low=True`` is the control: the step below each stated precision (GNT
products and sampled features in fp8 where the program states bf16; the
ResUNet and the dynamic layer's payloads and distances in bf16 where it
states float32). Geometry stays float32 on both.
"""

from __future__ import annotations

import torch

from perfbench.reference.nets import round_fp8


def cam_k(flat):
    return flat[..., 2:18].reshape(flat.shape[:-1] + (4, 4))


def cam_c2w(flat):
    return flat[..., 18:34].reshape(flat.shape[:-1] + (4, 4))


def projection(flat):
    """World -> pixel [..., 4, 4] (K @ inverse(c2w)), inverted in float64."""
    return (cam_k(flat).double() @ torch.linalg.inv(cam_c2w(flat).double())).float()


def pixel_rays(flat, idx, w):
    """Origins and (z-parameterised) directions [n, 3] of the rays through
    the pixels of flat indices ``idx`` in an image ``w`` wide."""
    u = (idx % w).double()
    v = torch.div(idx, w, rounding_mode="floor").double()
    pix = torch.stack([u, v, torch.ones_like(u)], 0)
    k3 = cam_k(flat).double()[:3, :3]
    c2w = cam_c2w(flat).double()
    d = (c2w[:3, :3] @ torch.linalg.inv(k3) @ pix).T
    return c2w[:3, 3].expand(d.shape).float(), d.float()


def project(proj, x):
    """uv [..., 2], in front [...] of points x [..., 3] under proj [..., 4, 4]."""
    cam = torch.einsum("...ij,...j->...i", proj[..., :3, :3], x) + proj[..., :3, 3]
    z = cam[..., 2]
    uv = cam[..., :2] / torch.clamp(z[..., None], min=1e-8)
    return uv.clamp(-1e6, 1e6), z > 0


def bilinear(img, x, y):
    """Zero-padded bilinear read of img [V, H, W, C] at x, y [V, ...]
    (pixel units, integer centres): taps outside the image read 0."""
    v, h, w, c = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = img.reshape(v * h * w, c)
    base = (torch.arange(v, device=img.device) * (h * w)).view((v,) + (1,) * (x.ndim - 1))
    out = torch.zeros(x.shape + (c,), dtype=torch.float32, device=img.device)
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1.0 - torch.abs(x - xi)) * (1.0 - torch.abs(y - yi))
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = base + (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            tap = flat[idx.reshape(-1)].reshape(x.shape + (c,)).float()
            out = out + tap * torch.where(inside, wgt, torch.zeros_like(wgt))[..., None]
    return out


def ray_diff(pts, tgt_centre, src_centres):
    """[V, R, S, 4]: the unit difference of the directions from each point
    to the target and to each source camera, and their dot product."""
    def unit(t):
        return t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-6)

    to_tgt = unit(tgt_centre - pts)[None]
    to_src = unit(src_centres[:, None, None, :] - pts[None])
    diff = to_tgt - to_src
    diff = diff / torch.clamp(torch.linalg.norm(diff, dim=-1, keepdim=True), min=1e-6)
    return torch.cat([diff, (to_tgt * to_src).sum(-1, keepdim=True)], dim=-1)


def features(resunet, rgbs, low=False):
    """ResUNet features [V, H/4, W/4, F] float32 of images [V, H, W, 3]:
    float32 without TF32, or bf16 (``low``)."""
    if low:
        with torch.autocast(rgbs.device.type, dtype=torch.bfloat16):
            return resunet(rgbs).float()
    with _no_tf32():
        return resunet(rgbs)


class _no_tf32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


@torch.no_grad()
def static_rays(gnt, feats, data, idx, sampler, n_samples, use_dyn_mask=True, low=False,
                chunk=512):
    """rgb [n, 3] and depth [n] of the static layer at the target pixels of
    flat indices ``idx``. feats: the spatial sources' features [V, Hf, Wf, F]
    (``features``)."""
    from perfbench.reference.samplers import sampler as sampler_module

    smp = sampler_module(sampler)
    src = data["rgb_src_spatial"].float()
    v, h, w, _ = src.shape
    prepared = smp.prepare(src, feats, data["dyn_mask_src_spatial"].float())
    tgt = data["flat_cam_tgt"].float()
    cams = data["flat_cam_src_spatial"].float()
    proj = projection(cams)
    centres = cam_c2w(cams)[:, :3, 3]
    near, far = data["depth_range"].double().reshape(-1)[:2]
    t = torch.arange(n_samples, dtype=torch.float64, device=src.device) / (n_samples - 1)
    z_all = (1.0 / (1.0 / near + (1.0 / far - 1.0 / near) * t)).float()
    rgbs, depths = [], []
    for c0 in range(0, idx.numel(), chunk):
        o, d = pixel_rays(tgt, idx[c0:c0 + chunk], w)
        z = z_all.expand(o.shape[0], n_samples)
        pts = o[:, None] + d[:, None] * z[..., None]
        uv, front = project(proj[:, None, None], pts[None])
        x, y = uv[..., 0], uv[..., 1]
        inbound = front & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        rgb_feat, lerped_mask = smp.sample(prepared, x, y)
        valid = inbound & ~(lerped_mask > 1e-3) if use_dyn_mask else inbound
        if low:
            rgb_feat = round_fp8(rgb_feat)
        rd = ray_diff(pts, cam_c2w(tgt)[:3, 3], centres)
        viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        rgb, wts = gnt(rgb_feat.permute(1, 2, 0, 3), rd.permute(1, 2, 0, 3),
                       valid.float()[..., None].permute(1, 2, 0, 3), pts, viewdirs, low=low)
        rgbs.append(rgb)
        depths.append((wts * z).sum(-1))
    return torch.cat(rgbs), torch.cat(depths)


def _bf16(t, low):
    return t.to(torch.bfloat16).float() if low else t


def knn_means(points, valid, k=50, low=False, block=512):
    """Each valid point's mean squared distance to its k nearest other valid
    points, from direct differences [N] (0 elsewhere)."""
    idx = torch.nonzero(valid, as_tuple=True)[0]
    p = _bf16(points[idx].float(), low)
    n = p.shape[0]
    if n <= k:
        raise ValueError(f"outlier removal needs more than k={k} valid points, got {n}")
    means = torch.empty(n, dtype=torch.float32, device=p.device)
    for q0 in range(0, n, block):
        q = p[q0:q0 + block]
        d2 = _bf16(((q[:, None, :] - p[None, :, :]) ** 2).sum(-1), low)
        rows = torch.arange(q.shape[0], device=p.device)
        d2[rows, q0 + rows] = float("inf")
        means[q0:q0 + block] = torch.topk(d2, k, dim=1, largest=False).values.mean(1)
    out = torch.zeros(valid.shape, dtype=torch.float32, device=p.device)
    out[idx] = means
    return out


def outlier_threshold(means, valid, std_thres=0.1):
    """median + std_thres * std of the valid points' means (the lower middle
    element for an even count; unbiased std), in float64."""
    m = means[valid].double()
    return torch.sort(m).values[(m.numel() - 1) // 2] + std_thres * torch.std(m, unbiased=True)


def splat_reach(data, points, which):
    """[H*W] bool: the pixels whose splatted value can change with the
    decision on the points ``which`` [H*W]: each point's own pixel (a
    dropped point stays there as noise) and the four pixels around its
    place in the target view (a kept point lands there)."""
    h, w = data["rgb_src_temporal"].shape[1:3]
    reach = which.clone()
    uv_t, _ = project(projection(data["flat_cam_tgt"].float()), points[which])
    x0, y0 = torch.floor(uv_t[:, 0]), torch.floor(uv_t[:, 1])
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            reach[(yi[inside] * w + xi[inside]).long()] = True
    return reach


def _splat(payload, flow):
    """Forward-splat payload [H, W, C] along flow [H, W, 2] onto the four
    pixels around each target, with bilinear weights; float32 sums."""
    h, w, c = payload.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=flow.device, dtype=torch.float32),
                            torch.arange(w, device=flow.device, dtype=torch.float32),
                            indexing="ij")
    fx, fy = gx + flow[..., 0], gy + flow[..., 1]
    x0, y0 = torch.floor(fx), torch.floor(fy)
    out = torch.zeros((h * w + 1, c), dtype=torch.float32, device=flow.device)
    flat = payload.reshape(h * w, c).float()
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1.0 - torch.abs(fx - xi)) * (1.0 - torch.abs(fy - yi))
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            tgt = torch.where(inside, yi * w + xi, torch.full_like(xi, h * w)).long()
            out.index_add_(0, tgt.reshape(-1), flat * torch.where(inside, wgt, 0.0).reshape(-1, 1))
    return out[:h * w].reshape(h, w, c)


@torch.no_grad()
def dynamic_cloud(data, flow_consistency=False):
    """The dynamic point cloud at the target time: points [H*W, 3] and the
    candidates [H*W] bool (dynamic, and advected inside the second frame)."""
    rgb = data["rgb_src_temporal"]
    h, w = rgb.shape[1:3]
    cams = data["flat_cam_src_temporal"].float()
    depth = data["depth_src_temporal"].float()
    idx = torch.arange(h * w, device=rgb.device)
    uv = torch.stack([(idx % w).float(), torch.div(idx, w, rounding_mode="floor").float()], -1)
    o1, d1 = pixel_rays(cams[0], idx, w)
    pcl1 = o1 + d1 * depth[0].reshape(-1, 1)
    dyn = data["dyn_mask_src_temporal"][0].reshape(-1) > 0
    if flow_consistency:
        dyn = dyn & ~(data["flow_fwd_occ_mask"].reshape(-1) > 0)
    uvf = uv + data["flow_fwd"].float().reshape(-1, 2)
    cand = dyn & (uvf[:, 0] >= 0) & (uvf[:, 0] <= w - 1) & (uvf[:, 1] >= 0) & (uvf[:, 1] <= h - 1)
    # the second frame's depth at the advected pixel, read with half-pixel
    # centres: nearest, ties to even, edge-clamped
    ix = torch.round(uvf[:, 0] - 0.5).clamp(0, w - 1).long()
    iy = torch.round(uvf[:, 1] - 0.5).clamp(0, h - 1).long()
    depth2 = depth[1].reshape(-1)[iy * w + ix]
    k2 = cam_k(cams[1]).double()[:3, :3]
    c2w2 = cam_c2w(cams[1]).double()
    dirs2 = (torch.cat([uvf.double(), torch.ones_like(uvf[:, :1]).double()], -1)
             @ (c2w2[:3, :3] @ torch.linalg.inv(k2)).T).float()
    pcl2 = c2w2[:3, 3].float() + dirs2 * depth2[:, None]
    t1, t2 = (float(t) for t in data["time_src_temporal"][:2])
    t_tgt = float(data["time_tgt"].reshape(-1)[0])
    if abs(t2 - t1) < 1e-9:
        return pcl1, cand
    return ((t2 - t_tgt) / (t2 - t1)) * pcl1 + ((t_tgt - t1) / (t2 - t1)) * pcl2, cand


@torch.no_grad()
def splat_layer(data, noise, points, keep, alpha=100.0, low=False):
    """rgb [H, W, 3] and mask [H, W, 1] of the dynamic layer: the kept points'
    pixels of the first temporal source (the rest clamped noise) splatted
    to their place in the target view. noise [H, W, 3] a standard normal."""
    rgb = data["rgb_src_temporal"].float()
    h, w = rgb.shape[1:3]
    flow = data["flow_fwd"].float()
    idx = torch.arange(h * w, device=rgb.device)
    uv = torch.stack([(idx % w).float(), torch.div(idx, w, rounding_mode="floor").float()], -1)
    uv_t, _ = project(projection(data["flat_cam_tgt"].float()), points)
    flow_t = torch.where(keep[:, None], uv_t - uv, torch.zeros_like(uv)).reshape(h, w, 2)
    m = keep.float().reshape(h, w, 1)
    rgb1 = _bf16(rgb[0] * m + torch.clamp(noise.float(), 0.0, 1.0) * (1.0 - m), low)
    bx, by = uv[:, 0].reshape(h, w) + flow[..., 0], uv[:, 1].reshape(h, w) + flow[..., 1]
    warped = bilinear(rgb[1:2], bx[None], by[None])[0]
    err = torch.mean(torch.abs(rgb1 - _bf16(warped, low)), dim=-1, keepdim=True)
    weight = _bf16(torch.exp(torch.clamp(-alpha * err, -alpha, alpha)), low)
    num = _bf16(_splat(torch.cat([rgb1 * weight, weight], -1), flow_t), low)
    num_m = _bf16(_splat(torch.cat([m * weight, weight], -1), flow_t), low)
    splat_rgb = num[..., :3] / (num[..., 3:] + 1e-7)
    mask = (num_m[..., :1] / (num_m[..., 1:] + 1e-7) > 1e-3).float()
    return splat_rgb * mask, mask
