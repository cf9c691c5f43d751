"""Plain reference of the NVIDIA protocol's scores (DynIBaR, as PGDVS runs it).

Images are quantised to uint8 and rescaled to [0, 1]; per region (full,
dynamic, static: the target's dynamic mask, its complement) the masked
PSNR (masked MSE, 10 log10(1 / mse)), the masked mean of the SSIM map
(7x7 uniform window with half-sample symmetric borders, K1 0.01, K2 0.03,
data range 2.0, unbiased covariances) in float64, and LPIPS v0.1 (AlexNet)
with the mask resized to each layer by floor-nearest indexing, in float32
without TF32. ``low`` computes one step down: float32 for the float64
scores, bf16 for LPIPS.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from perfbench.reference.render import _no_tf32


def quantize(img):
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8).astype(np.float64) / 255.0


def _box7(x):
    """Mean over 7x7 windows, borders mirrored about the edge (d c b a | a b
    c d), per channel."""
    p = np.pad(x, ((3, 3), (3, 3), (0, 0)), mode="symmetric")
    c = np.cumsum(np.cumsum(p, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    h, w = x.shape[:2]
    return (c[7:7 + h, 7:7 + w] - c[:h, 7:7 + w] - c[7:7 + h, :w] + c[:h, :w]) / 49.0


def ssim_map(a, b, data_range=2.0):
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    norm = 49.0 / 48.0
    ux, uy = _box7(a), _box7(b)
    vx = norm * (_box7(a * a) - ux * ux)
    vy = norm * (_box7(b * b) - uy * uy)
    vxy = norm * (_box7(a * b) - ux * uy)
    return ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))


def psnr(a, b, m):
    mse = np.sum((a - b) ** 2 * m) / (np.sum(m) + 1e-8)
    return 0.0 if mse == 0 else float(10.0 * np.log10(1.0 / mse))


def masked_mean(x, m):
    return float(np.sum(x * m) / (np.sum(m) + 1e-8))


@torch.no_grad()
def lpips(net, a, b, mask, low=False):
    """LPIPS of [H, W, 3] images in [0, 1] (float32 numpy) with an [H, W, 1]
    mask, on the net's device."""
    dev = next(net.parameters()).device
    dt = torch.bfloat16 if low else torch.float32

    def t(x):
        return (2.0 * torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev) - 1.0
                ).permute(2, 0, 1)[None].to(dt)

    m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(dev)
    if low:
        net = copy.deepcopy(net).to(dt)
    with _no_tf32():
        fa, fb = net.features(t(a)), net.features(t(b))
    total = 0.0
    for k in range(5):
        x = fa[k].float() / (torch.linalg.vector_norm(fa[k].float(), dim=1, keepdim=True) + 1e-10)
        y = fb[k].float() / (torch.linalg.vector_norm(fb[k].float(), dim=1, keepdim=True) + 1e-10)
        dmap = torch.sum((x - y) ** 2 * net.lins[k].float().view(1, -1, 1, 1), dim=1)[0]
        h, w = dmap.shape
        rows = torch.floor(torch.arange(h, dtype=torch.float32, device=dev)
                           * np.float32(m.shape[0] / h)).long()
        cols = torch.floor(torch.arange(w, dtype=torch.float32, device=dev)
                           * np.float32(m.shape[1] / w)).long()
        mk = m[rows][:, cols][..., 0]
        total = total + float(torch.sum(dmap * mk) / (torch.sum(mk) + 1e-8))
    return total


def nvidia_scores(pred, gt, dyn_mask, lpips_net=None, low=False):
    """{psnr|ssim|lpips}_{full|dyn|static} of a render against its target."""
    dt = np.float32 if low else np.float64
    p, g = quantize(pred).astype(dt), quantize(gt).astype(dt)
    dyn = np.repeat(np.asarray(dyn_mask, dt).reshape(p.shape[0], p.shape[1], 1), 3, axis=-1)
    smap = np.stack([ssim_map(p[..., c:c + 1], g[..., c:c + 1])[..., 0] for c in range(3)], -1)
    out = {}
    for region, m in (("full", np.ones_like(dyn)), ("dyn", dyn), ("static", 1.0 - dyn)):
        out[f"psnr_{region}"] = psnr(p, g, m)
        out[f"ssim_{region}"] = masked_mean(smap, m)
        if lpips_net is not None:
            out[f"lpips_{region}"] = lpips(lpips_net, p, g, m[..., :1], low)
    return out
