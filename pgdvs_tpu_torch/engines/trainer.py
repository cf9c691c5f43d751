"""Training engine: per-scene GNT fine-tuning over a mesh of ranks (torch).

The port's counterpart of ``pgdvs_tpu.engines.trainer`` (the reference's
trainer is scaffolding only, ``trainer_pgdvs.py:246-247``): photometric
fine-tuning of the GNT and its ResUNet on a scene's source views, with

  * random ray batches drawn on the host with numpy, in the JAX package's
    order, so one seed gives its held-out views and pixels;
  * the (dp = views, rp = rays) train step of ``parallel.sharded``, the
    gradients summed over the mesh of ranks;
  * ``torch.optim.Adam`` (optax's defaults), checkpoints through
    ``engines.checkpoint`` with frozen-module exclusion and retention,
    written by rank 0.
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from pgdvs_tpu_torch.core import cameras
from pgdvs_tpu_torch.engines.checkpoint import restore_checkpoint, save_checkpoint
from pgdvs_tpu_torch.parallel.mesh import barrier, make_mesh, world
from pgdvs_tpu_torch.parallel.sharded import make_train_step
from pgdvs_tpu_torch.renderers.config import RenderConfig

LOGGER = logging.getLogger(__name__)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def sample_ray_batch(rng: np.random.Generator, data: dict, n_rays: int):
    """Ray batch supervised by the item's explicit target view.

    NOTE: on evaluation datasets ``rgb_tgt`` IS the held-out ground-truth
    view: training against it leaks the test signal into the weights and
    invalidates any later metric on the same scene. Use it only for
    debugging / overfit checks; ``sample_ray_batch_src`` is the honest
    fine-tuning objective.
    """
    tgt_cam = _np(data["flat_cam_tgt"])
    h, w = data["rgb_tgt"].shape[:2]
    idx = rng.integers(0, h * w, size=n_rays)
    dr = _ray_depth_range(data, idx, n_rays)
    rays_o, rays_d = _view_rays(tgt_cam, h, w, idx)
    return {
        "tgt_cam": tgt_cam,
        "src_cams": _np(data["flat_cam_src_spatial"]),
        "src_rgbs": _np(data["rgb_src_spatial"]),
        "rays_o": rays_o,
        "rays_d": rays_d,
        "depth_range": dr,
        "rgb_gt": _np(data["rgb_tgt"]).reshape(-1, 3)[idx],
    }


def sample_ray_batch_src(rng: np.random.Generator, data: dict, n_rays: int):
    """Self-supervised ray batch: one SOURCE view is held out as the target
    and rendered from the remaining sources.

    This never touches ``rgb_tgt`` (the held-out evaluation pixels), so
    fine-tuning with it keeps eval metrics honest. When a dynamic mask for
    the chosen source view is available, rays are drawn from static pixels
    only: the GNT branch being tuned is the static renderer, and dynamic
    content is inconsistent across the source frames.
    """
    src_cams = _np(data["flat_cam_src_spatial"])
    src_rgbs = _np(data["rgb_src_spatial"])
    n_views = src_cams.shape[0]
    if n_views < 2:
        raise ValueError("self-supervised fine-tuning needs >= 2 spatial source views")
    j = int(rng.integers(0, n_views))
    keep = [i for i in range(n_views) if i != j]
    h, w = src_rgbs.shape[1:3]

    p = None
    masks = data.get("dyn_mask_src_spatial")
    if masks is not None:
        static = (_np(masks[j]).reshape(-1) == 0).astype(np.float64)
        if static.sum() >= n_rays:  # else: fall back to uniform
            p = static / static.sum()
    idx = rng.choice(h * w, size=n_rays, replace=True, p=p)
    dr = _ray_depth_range(data, idx, n_rays, pixel_aligned=False)
    rays_o, rays_d = _view_rays(src_cams[j], h, w, idx)
    return {
        "tgt_cam": src_cams[j],
        "src_cams": src_cams[keep],
        "src_rgbs": src_rgbs[keep],
        "rays_o": rays_o,
        "rays_d": rays_d,
        "depth_range": dr,
        "rgb_gt": src_rgbs[j].reshape(-1, 3)[idx],
    }


def _view_rays(flat_cam, h, w, idx):
    cam = torch.from_numpy(np.asarray(flat_cam, np.float32))
    rays_o, rays_d, _uv, _ = cameras.get_rays(h, w, cam[2:18].reshape(4, 4),
                                              cam[18:34].reshape(4, 4))
    return rays_o.numpy()[idx], rays_d.numpy()[idx]


def _ray_depth_range(data, idx, n_rays, pixel_aligned=True):
    """Per-ray [near, far]. Scene-level ranges tile; per-pixel [H, W, 2]
    maps index by ray, but only when the rays live in the view the map was
    built for (``pixel_aligned``); source-view batches collapse them to the
    scene-wide [min, max]."""
    dr = _np(data["depth_range"]).astype(np.float32)
    if dr.ndim == 1:
        return np.tile(dr, (n_rays, 1))
    flat = dr.reshape(-1, 2)
    if pixel_aligned:
        return flat[idx]
    return np.tile(np.array([flat[:, 0].min(), flat[:, 1].max()], np.float32), (n_rays, 1))


class Trainer:
    """Fine-tune ``models`` = (feature_net, gnt) in place.

    Unlike the JAX package's ``Trainer(models, params, cfg, ...)`` the
    parameters are the modules' own. The optimizer is
    ``torch.optim.Adam(lr)`` with optax's defaults (b1 0.9, b2 0.999, eps
    1e-8) over both modules; ``mesh`` defaults to ``make_mesh(rp=1)`` on the
    models' device, every rank of the world a dp rank, and a given mesh must
    be on that device; ``dtype`` is the step's (``make_train_step``).
    Every rank of the mesh calls every method in the same order.
    """

    def __init__(self, models, cfg: RenderConfig, lr: float = 5e-4,
                 n_rays_per_view: int = 512, mesh=None, ckpt_dir: Optional[str] = None,
                 modules_not_to_save: Sequence[str] = (), n_ckpts_keep: int = -1,
                 train_on: str = "src", dtype=torch.float32):
        if train_on not in ("src", "tgt"):
            raise ValueError(f"train_on must be 'src' or 'tgt', got {train_on!r}")
        self.models = models
        self.params = {"feature_net": models[0], "gnt": models[1]}
        self.cfg = cfg
        self.n_rays = n_rays_per_view
        device = next(models[0].parameters()).device
        self.mesh = mesh if mesh is not None else make_mesh(rp=1, device=device)
        if self.mesh.device != device:
            raise ValueError(f"the mesh is on {self.mesh.device}, the models on {device}")
        self.optimizer = torch.optim.Adam([p for m in models for p in m.parameters()], lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.ckpt_dir = ckpt_dir
        # 'src': self-supervised held-out-source objective (honest).
        # 'tgt': supervise on the item's explicit target view; on eval
        # datasets that is the held-out ground truth (leaks the test
        # signal); debugging / overfit checks only.
        self.train_on = train_on
        self.modules_not_to_save = tuple(modules_not_to_save)
        self.n_ckpts_keep = n_ckpts_keep
        self.step = 0
        self.epoch = 0
        self._step_fn = make_train_step(self.mesh, models, cfg, self.optimizer,
                                        n_rays_per_view, dtype=dtype)

    def resume(self):
        """Load the newest checkpoint of ``ckpt_dir``, if any: the saved
        modules over the live ones (those of ``modules_not_to_save`` stay as
        they are), the optimizer's state, the epoch and step."""
        if self.ckpt_dir is None:
            raise ValueError("resume() needs a checkpoint directory (Trainer(ckpt_dir=...) / "
                             "run train --out-dir)")
        saved = {k: m for k, m in self.params.items() if k not in self.modules_not_to_save}
        payload, at = restore_checkpoint(self.ckpt_dir, template=saved,
                                         map_location=self.mesh.device)
        if payload is not None:
            self.optimizer.load_state_dict(payload["opt_state"])
            self.epoch, self.step = at
            LOGGER.info("resumed from epoch %d step %d", self.epoch, self.step)
        return self

    def train_epoch(self, dataset: Iterable, seed: int = 0, log_every: int = 10) -> float:
        """One pass over the dataset; each step takes dp views of
        ``n_rays_per_view`` rays. Every rank draws every view of a step, in
        the JAX package's order, and the step keeps its own. Returns the
        epoch's mean loss (NaN without a step)."""
        rng = np.random.default_rng(seed + self.epoch)
        dp = self.mesh.dp
        buf = []
        losses = []
        t0 = time.time()

        def flush():
            batch = {k: np.stack([b[k] for b in buf]) for k in buf[0]}
            buf.clear()
            loss = self._step_fn(batch)
            self.step += 1
            losses.append(loss)
            if self.step % log_every == 0:
                LOGGER.info("step %d loss %.5f (%.2f s/step)", self.step, loss,
                            (time.time() - t0) / max(len(losses), 1))

        sampler = sample_ray_batch_src if self.train_on == "src" else sample_ray_batch
        for data in dataset:
            if "rgb_src_spatial" not in data or (self.train_on == "tgt"
                                                 and "rgb_tgt" not in data):
                continue
            buf.append(sampler(rng, data, self.n_rays))
            if len(buf) == dp:
                flush()
        if buf:
            # epoch remainder (fewer views than dp, or a partial final
            # batch): cycle the buffered views up to dp so small scenes
            # still train on wide meshes (the repeats weight those views'
            # rays 2x in this one step)
            n = len(buf)
            buf.extend(buf[i % n] for i in range(dp - n))
            flush()
        self.epoch += 1
        if self.ckpt_dir is not None:
            if world()[0] == 0:
                save_checkpoint(self.ckpt_dir, self.params, self.optimizer, epoch=self.epoch,
                                step=self.step, modules_not_to_save=self.modules_not_to_save,
                                keep=self.n_ckpts_keep)
            barrier()
        return float(np.mean(losses)) if losses else float("nan")
