"""Evaluation engine: renders novel views and scores them.

The port's counterpart of ``pgdvs_tpu.engines.evaluator`` (the reference's
``evaluator_pgdvs.py``): per view the render, a NaN guard, uint8
quantization, then masked PSNR / SSIM (/ LPIPS) over the full, dynamic and
static regions (the DynIBaR protocol), or the DyCheck covisible metrics;
per-image records and dataset means. Items are strided across processes
(the reference's DistributedSampler semantics).

Renders run on the data's device (the card unless the caller asks for the
CPU); the scores run on the host in numpy, LPIPS on its module's device.
With a ``mesh`` of N ranks (``parallel.mesh.make_mesh``) the process's
items are strided once more over the mesh's ranks, so each rank renders
one view of every N. Under an initialised process group the counts and
metric sums of every rank are summed, so every rank returns the dataset's.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import pathlib
import pickle
import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pgdvs_tpu_torch.data.image_io import write_png
from pgdvs_tpu_torch.data.loader import PrefetchLoader, contract_to_device, to_device_prefetch
from pgdvs_tpu_torch.metrics import dycheck as dm
from pgdvs_tpu_torch.metrics.lpips import lpips_distance, nearest_resize_floor
from pgdvs_tpu_torch.metrics.psnr_ssim import (
    masked_map_mean,
    masked_psnr,
    quantize_uint8,
    ssim_map,
)
from pgdvs_tpu_torch.parallel.mesh import all_reduce_sum, broadcast_object, world
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.config import RenderConfig, check_slice
from pgdvs_tpu_torch.utils import tracing

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalRecord:
    item_id: str
    metrics: dict
    wall_s: float


def _to_numpy_img(x):
    return np.clip(np.asarray(x, np.float64), 0.0, 1.0)


def _host(x) -> np.ndarray:
    if not torch.is_tensor(x):
        return np.asarray(x)
    with tracing.span("sync"):
        return x.detach().cpu().numpy()


def resize_gt_to_render(rgb_gt, eval_mask, render_hw):
    """Resize GT + eval mask to the render resolution (render_stride > 1).

    The protocol (evaluator_pgdvs.py:81-92): after uint8 quantization the GT
    is resized by torch's bicubic, antialiased, align_corners interpolate on
    the host in float32 (the call the JAX package makes), then cast to
    float64; the eval mask by torch's floor-nearest rule
    (``nearest_resize_floor``), then binarized with > 0.
    """
    rh, rw = render_hw
    if rgb_gt.shape[0] == rh and rgb_gt.shape[1] == rw:
        return rgb_gt, eval_mask
    t = torch.tensor(rgb_gt, dtype=torch.float32).permute(2, 0, 1)[None]
    rgb_out = (
        F.interpolate(t, size=(rh, rw), mode="bicubic", antialias=True, align_corners=True)[0]
        .permute(1, 2, 0)
        .numpy()
        .astype(np.float64)
    )
    if eval_mask is not None:
        m = torch.as_tensor(np.asarray(eval_mask), dtype=torch.float32)
        if m.ndim == 2:
            m = m[..., None]
        eval_mask = (nearest_resize_floor(m, rh, rw).numpy() > 0).astype(np.float64)
    return rgb_out, eval_mask


def compute_dycheck_metrics(pred, gt, covisible, lpips_net=None):
    """The DyCheck iPhone protocol: mPSNR / mSSIM (/ mLPIPS) over the
    covisible mask (evaluator_pgdvs.py:282-415), on the host in float32;
    mLPIPS on the LPIPS module's device."""
    pred_q = torch.from_numpy(quantize_uint8(_to_numpy_img(pred)).astype(np.float32))
    gt_q = torch.from_numpy(quantize_uint8(_to_numpy_img(gt)).astype(np.float32))
    m = torch.from_numpy(np.asarray(covisible, np.float32))
    if m.ndim == 2:
        m = m[..., None]
    out = {
        "mpsnr": float(dm.compute_psnr(pred_q, gt_q, m)),
        "mssim": float(dm.compute_ssim(pred_q, gt_q, m)),
    }
    if lpips_net is not None:
        dev = next(lpips_net.parameters()).device
        out["mlpips"] = float(dm.compute_lpips(lpips_net, pred_q.to(dev), gt_q.to(dev),
                                               m.to(dev)))
    return out


def compute_nvidia_metrics(pred, gt, dyn_mask, lpips_fn=None, quantize_gt: bool = True):
    """Full / dynamic / static metric triplets on uint8-quantized inputs
    (evaluator_pgdvs.py:73-77,190-280). quantize_gt=False when the caller
    already quantized, then resized, the GT (the reference does not
    quantize again after the render_stride resize). The SSIM map does not
    depend on the mask: it is computed once and its three masked means
    taken, equal bit for bit to three calls of ``masked_ssim``."""
    pred_q = quantize_uint8(_to_numpy_img(pred))
    gt_q = quantize_uint8(_to_numpy_img(gt)) if quantize_gt else np.asarray(gt, np.float64)
    dyn = np.asarray(dyn_mask, np.float64)
    if dyn.ndim == 2:
        dyn = dyn[..., None]
    dyn3 = np.repeat(dyn, 3, axis=-1) if dyn.shape[-1] == 1 else dyn
    ones = np.ones_like(dyn3)
    smap = ssim_map(pred_q, gt_q)
    out = {}
    for region, m in (("full", ones), ("dyn", dyn3), ("static", 1.0 - dyn3)):
        out[f"psnr_{region}"] = masked_psnr(pred_q, gt_q, m)
        out[f"ssim_{region}"] = masked_map_mean(smap, m)
        if lpips_fn is not None:
            out[f"lpips_{region}"] = float(
                lpips_fn(pred_q.astype(np.float32), gt_q.astype(np.float32), m[..., :1]))
    return out


def lpips_on_host_arrays(net, img0, img1, mask):
    """``lpips_distance`` of [H, W, 3] numpy images and an [H, W, 1] mask,
    moved to the net's device in float32; a float."""
    dev = next(net.parameters()).device

    def t(a):
        host = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        with tracing.span("sync"):
            return host.to(dev)

    d = lpips_distance(net, t(img0), t(img1), mask=t(mask))
    with tracing.span("sync"):
        return float(d)


class Evaluator:
    """Render + score a dataset of contract dicts.

    Args:
      models: (feature_net, gnt) on the device the renders run on; None
        for static_mode "geo", which renders no network.
      cfg: a RenderConfig inside the ported slice (else ValueError).
      static_mode: "gnt" or "geo".
      out_dir: optional directory for per-image pickles and PNGs (the
        reference's infos/ + vis/ layout).
      lpips_net: optional ``metrics.lpips.LPIPS`` module.
      save_vis: write ``{id}_combined.png`` per item.
      device: where the renders run when ``models`` is None (default cuda);
        else the models' device.
      tracker: optional point tracker (``configs.benchmarks.make_tracker``)
        on that device, passed to every render (the track bundles).
      mesh: optional ``parallel.mesh.Mesh``: its ranks share each
        process's items, one of every ``mesh.size`` each (every rank of the
        mesh runs ``run`` with the same arguments).
    """

    def __init__(self, models, cfg: RenderConfig, static_mode: str = "gnt",
                 out_dir: Optional[str] = None, lpips_net=None, save_vis: bool = False,
                 device="cuda", tracker=None, mesh=None):
        check_slice(cfg, static_mode)
        if models is None and static_mode != "geo":
            raise ValueError(f"static_mode {static_mode!r} renders the GNT: models needed")
        self.models = models
        self.cfg = cfg
        self.static_mode = static_mode
        self.device = (next(models[0].parameters()).device if models is not None
                       else torch.device(device))
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.save_vis = save_vis
        self.lpips_net = lpips_net
        self.tracker = tracker
        self._lpips = None
        if lpips_net is not None:
            self._lpips = lambda a, b, m: lpips_on_host_arrays(lpips_net, a, b, m)
        self.mesh = mesh

    def eval_item(self, data, item_id: str = "item", seed: int = 0) -> EvalRecord:
        """Render one contract (tensors on their device, or numpy arrays,
        moved to the models' device) with the noise of ``seed``, then score
        it."""
        if any(isinstance(v, np.ndarray) for v in data.values()):
            data = contract_to_device(data, self.device)
        device = data["flat_cam_tgt"].device
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed)
        out = render_novel_view(self.models, data, self.cfg, generator=gen,
                                static_mode=self.static_mode, tracker=self.tracker)
        if device.type == "cuda":
            with tracing.span("sync"):
                torch.cuda.synchronize(device)
        with tracing.span("sync"):
            pred = out["combined_rgb"].float().cpu().numpy()
        wall = time.perf_counter() - t0
        return self._score(pred, data, item_id, wall)

    def _score(self, pred, data, item_id: str, wall: float) -> EvalRecord:
        with tracing.span("eval.score"):
            # NaN guard (evaluator_pgdvs.py:56-68): log + zero-fill, never crash
            if not np.isfinite(pred).all():
                LOGGER.warning("non-finite render for %s; zero-filling", item_id)
                pred = np.nan_to_num(pred, nan=0.0, posinf=1.0, neginf=0.0)

            metrics = {}
            misc = data.get("misc") if isinstance(data.get("misc"), dict) else {}
            if "rgb_tgt" in data:
                gt = _host(data["rgb_tgt"])
                if misc.get("quant_type") == "dycheck":
                    covisible = (misc["covisible_mask"] if "covisible_mask" in misc
                                 else _host(data["eval_mask"])[..., :1])
                    metrics = compute_dycheck_metrics(pred, gt, covisible,
                                                      lpips_net=self.lpips_net)
                else:
                    dyn_mask = (misc["tgt_dyn_mask"] if "tgt_dyn_mask" in misc
                                else _host(data["eval_mask"])[..., :1])
                    quantize_gt = True
                    if gt.shape[:2] != pred.shape[:2]:
                        # render_stride > 1: quantize first, then resize GT and
                        # the mask (evaluator_pgdvs.py:73-92), no re-quantization
                        gt = quantize_uint8(_to_numpy_img(gt))
                        gt, dyn_mask = resize_gt_to_render(gt, dyn_mask, pred.shape[:2])
                        quantize_gt = False
                    metrics = compute_nvidia_metrics(pred, gt, dyn_mask, lpips_fn=self._lpips,
                                                     quantize_gt=quantize_gt)
            metrics["render_wall_s"] = wall
            if self.out_dir is not None:
                self._write_outputs(item_id, metrics, misc, pred)
            return EvalRecord(item_id, metrics, wall)

    def _write_outputs(self, item_id: str, metrics: dict, misc: dict, pred) -> None:
        """The item's pickle and, with save_vis, its PNG. The pickle carries
        the reference's join ids (scene / frame / cam, evaluator_pgdvs.py:
        120-129) so scripts/ref_parity_compare.py can match items; they stay
        out of ``metrics``, which the summary sums. The PNG's pixels are
        the render truncated to uint8, as the JAX package writes them."""
        self.out_dir.mkdir(parents=True, exist_ok=True)
        ids = {k: misc[k] for k in ("scene_id", "tgt_frame_id", "tgt_cam_id") if k in misc}
        with open(self.out_dir / f"{item_id}.pkl", "wb") as f:
            pickle.dump({**metrics, **ids}, f)
        if self.save_vis:
            write_png(self.out_dir / f"{item_id}_combined.png",
                      (np.clip(pred, 0.0, 1.0) * 255).astype(np.uint8))

    def run(self, dataset: Iterable, process_index: int = 0, process_count: int = 1,
            max_items: int = -1) -> dict:
        """Evaluate this process's items (every process_count-th from
        process_index), at most ``max_items`` of them (-1: all); with a
        mesh, the process is the mesh and its rank r takes the r-th of
        every ``mesh.size`` of those items.

        An indexable dataset is read through ``PrefetchLoader`` (item
        assembly overlaps the renders, the reference's DataLoader workers)
        and ``to_device_prefetch`` (the next item's copies started before the
        current one renders). Returns {count, sum, mean} over the metrics,
        or {count: 0}; under an initialised process group, those of every
        rank's items (the reference's ``torch.distributed.reduce``), on
        every rank.
        """
        rank, n = (self.mesh.rank, self.mesh.size) if self.mesh is not None else (0, 1)
        records = []
        if hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__"):
            idxs = [i for i in range(len(dataset))
                    if process_count <= 1 or i % process_count == process_index]
            if max_items >= 0:
                idxs = idxs[:max_items]
            idxs = idxs[rank::n]
            stream = zip(idxs, to_device_prefetch(PrefetchLoader(dataset, indices=idxs),
                                                  self.device))
        else:
            items = ((i, d) for i, d in enumerate(dataset)
                     if process_count <= 1 or i % process_count == process_index)
            if max_items >= 0:
                items = itertools.islice(items, max_items)
            stream = ((i, contract_to_device(d, self.device))
                      for k, (i, d) in enumerate(items) if k % n == rank)
        for i, data in stream:
            with tracing.span("eval.item", root_id=i):
                rec = self.eval_item(data, item_id=f"{i:06d}", seed=i)
                records.append(rec)
                LOGGER.info("eval %s: %s", rec.item_id, json.dumps(rec.metrics))
        keys = sorted(records[0].metrics) if records else []
        sums = {k: float(sum(r.metrics[k] for r in records)) for k in keys}
        count = len(records)
        if world()[1] > 1:
            # the cross-process sum. The key list must agree across ranks (a
            # rank whose shard is empty has none); rank 0 renders item 0
            # under the striding, so its list is broadcast and empty shards
            # add zeros
            keys = broadcast_object(keys, src=0)
            vec = torch.tensor([float(count)] + [sums.get(k, 0.0) for k in keys],
                               dtype=torch.float64)
            total = all_reduce_sum(vec).tolist()
            count = int(total[0])
            sums = {k: total[1 + i] for i, k in enumerate(keys)}
        if count == 0:
            return {"count": 0}
        return {"count": count, "sum": sums, "mean": {k: v / count for k, v in sums.items()}}
