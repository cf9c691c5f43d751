"""Debug dumps: intermediate images, the dynamic point cloud, epipolar
overlays.

The counterpart of ``pgdvs_tpu.engines.debug`` (the reference's debug
flags): every image-shaped intermediate of a render as PNG (with the
forward flow and the first temporal source's depth colour-coded), the
dynamic point cloud as PLY, and one target pixel's epipolar samples drawn
onto each spatial source. PNGs are written by ``image_io.write_png``; the
arithmetic runs in torch on the data's device (numpy inputs: ``device``,
default the card), the drawing in numpy on the host.
"""

from __future__ import annotations

import logging
import pathlib

import numpy as np
import torch

from pgdvs_tpu_torch.core import cameras, sampling
from pgdvs_tpu_torch.data.image_io import write_png
from pgdvs_tpu_torch.data.loader import contract_to_device
from pgdvs_tpu_torch.utils.vis import colorize_depth, flow_to_color, save_ply_points

LOGGER = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _on_device(data, device):
    if any(isinstance(v, np.ndarray) for v in data.values()):
        return contract_to_device(data, device)
    return data


def dump_render_intermediates(out, data, out_dir, prefix: str = "debug"):
    """Every [H, W, 3] / [H, W, 1] array of the render dict ``out`` (and
    ``rgb_tgt``) as ``<prefix>_<key>.png``, clipped and truncated to uint8;
    the forward flow colour-coded and the first temporal depth colorized."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def save_img(name, arr):
        arr = _host(arr)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, -1)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            return
        write_png(out_dir / f"{prefix}_{name}.png", (np.clip(arr, 0, 1) * 255).astype(np.uint8))

    for k, val in out.items():
        if hasattr(val, "ndim"):
            save_img(k, val)
    if "rgb_tgt" in data:
        save_img("rgb_tgt", data["rgb_tgt"])
    if "flow_fwd" in data:
        write_png(out_dir / f"{prefix}_flow_fwd.png", flow_to_color(_host(data["flow_fwd"])))
    if "depth_src_temporal" in data:
        write_png(out_dir / f"{prefix}_depth_src0.png",
                  colorize_depth(_host(data["depth_src_temporal"])[0, ..., 0]))
    LOGGER.info("debug dumps written to %s", out_dir)


def dump_dynamic_pointclouds(data, cfg, out_dir, device="cuda"):
    """The dynamic point cloud's valid points as ``dyn_pcl_all.ply``;
    returns the cloud dict of ``compute_dyn_pointcloud``."""
    from pgdvs_tpu_torch.renderers.dynamic import compute_dyn_pointcloud

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = _on_device(data, device)
    pcl = compute_dyn_pointcloud(
        rgb_1=dev["rgb_src_temporal"][0],
        dyn_mask_1=dev["dyn_mask_src_temporal"][0],
        depth_1=dev["depth_src_temporal"][0],
        flow_12=dev["flow_fwd"],
        flow_12_occ_mask=dev["flow_fwd_occ_mask"],
        rgb_2=dev["rgb_src_temporal"][1],
        depth_2=dev["depth_src_temporal"][1],
        cam_1=dev["flat_cam_src_temporal"][0],
        cam_2=dev["flat_cam_src_temporal"][1],
        cam_tgt=dev["flat_cam_tgt"],
        time_1=dev["time_src_temporal"][0],
        time_2=dev["time_src_temporal"][1],
        time_tgt=dev["time_tgt"][0],
        cfg=cfg,
    )
    pts, cols = _host(pcl["points"]), _host(pcl["colors"])
    valid = _host(pcl["valid"]).astype(bool)
    save_ply_points(out_dir / "dyn_pcl_all.ply", pts[valid], np.clip(cols[valid], 0, 1))
    LOGGER.info("dynamic pcl: %d/%d valid points -> %s", valid.sum(), len(valid), out_dir)
    return pcl


def dump_epipolar_overlay(data, out_dir, pix_rc=(None, None), n_samples: int = 64,
                          device="cuda"):
    """``epi_src_<v>.png``: each spatial source with the projections of the
    ``n_samples`` inverse-depth samples along one target pixel's ray (the
    centre pixel by default) drawn as 3x3 dots, blue (near) to red (far)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = _on_device(data, device)
    h, w = dev["rgb_src_spatial"].shape[1:3]
    row = pix_rc[0] if pix_rc[0] is not None else h // 2
    col = pix_rc[1] if pix_rc[1] is not None else w // 2
    tgt = dev["flat_cam_tgt"]
    rays_o, rays_d, _, _ = cameras.get_rays(h, w, cameras.flat_cam_intrinsics(tgt),
                                            cameras.flat_cam_c2w(tgt))
    idx = row * w + col
    dr = dev["depth_range"].reshape(-1, 2)[0]
    pts, _ = sampling.sample_along_rays(rays_o[idx:idx + 1], rays_d[idx:idx + 1], dr[None],
                                        n_samples, inv_uniform=True)
    colors = np.linspace(0, 255, n_samples).astype(np.uint8)
    for v in range(dev["rgb_src_spatial"].shape[0]):
        uv, _z, _front = cameras.project_points(pts[0], dev["flat_cam_src_spatial"][v])
        img = (_host(dev["rgb_src_spatial"][v]) * 255).astype(np.uint8).copy()
        for i, (x, y) in enumerate(_host(uv)):
            xi, yi = int(round(x)), int(round(y))
            if 1 <= xi < w - 1 and 1 <= yi < h - 1:
                img[yi - 1:yi + 2, xi - 1:xi + 2] = [colors[i], 64, 255 - colors[i]]
        write_png(out_dir / f"epi_src_{v:02d}.png", img)
    LOGGER.info("epipolar overlays for pixel (%d, %d) -> %s", row, col, out_dir)
