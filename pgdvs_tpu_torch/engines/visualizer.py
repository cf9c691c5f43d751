"""Visualization engine: renders a trajectory and assembles its video.

The counterpart of ``pgdvs_tpu.engines.visualizer``: each trajectory item
(``data.nvidia_vis``, ``data.mono_vis``) is rendered by
``render_novel_view`` on the models' device with the noise of its index,
and each of ``save_keys`` written as ``<i:06d>_<suffix>.png`` ("combined"
for ``combined_rgb``), truncated to uint8 as the JAX package writes it.
``images_to_video`` then assembles the mp4 with imageio-ffmpeg where that
is installed, and logs a warning and returns False where it is not, as the
JAX package's does. An indexable dataset is read through ``PrefetchLoader``
and ``to_device_prefetch``, as the evaluator reads it.
"""

from __future__ import annotations

import logging
import pathlib
import time
from typing import Iterable

import numpy as np
import torch

from pgdvs_tpu_torch.data.image_io import write_png
from pgdvs_tpu_torch.data.loader import PrefetchLoader, contract_to_device, to_device_prefetch
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.config import RenderConfig, check_slice

LOGGER = logging.getLogger(__name__)


def images_to_video(img_dir, pattern: str, out_f, fps: int = 10) -> bool:
    """Assemble the PNGs of ``img_dir`` matching ``pattern`` into an mp4;
    False when imageio-ffmpeg is missing or no file matches."""
    try:
        import imageio.v2 as imageio
        import imageio_ffmpeg  # noqa: F401
    except ImportError:
        LOGGER.warning("imageio-ffmpeg unavailable; skipping video export")
        return False
    files = sorted(pathlib.Path(img_dir).glob(pattern))
    if not files:
        return False
    writer = imageio.get_writer(str(out_f), fps=fps)
    for f in files:
        writer.append_data(imageio.imread(f))
    writer.close()
    return True


class Visualizer:
    """Render + write a trajectory.

    Args:
      models: (feature_net, gnt) on the device the renders run on; None
        for static_mode "geo".
      cfg: a RenderConfig inside the ported slice (else ValueError).
      out_dir: where the PNGs and the video go.
      static_mode: "gnt" or "geo".
      fps: the video's frame rate.
      device: where the renders run when ``models`` is None (default cuda);
        else the models' device.

    After ``run``: ``frame_seconds`` holds each frame's render wall time
    (synchronized on a card) and ``video_written`` whether the mp4 was.
    """

    def __init__(self, models, cfg: RenderConfig, out_dir, static_mode: str = "gnt",
                 fps: int = 10, device="cuda"):
        check_slice(cfg, static_mode)
        if models is None and static_mode != "geo":
            raise ValueError(f"static_mode {static_mode!r} renders the GNT: models needed")
        self.models = models
        self.cfg = cfg
        self.static_mode = static_mode
        self.out_dir = pathlib.Path(out_dir)
        self.fps = fps
        self.device = (next(models[0].parameters()).device if models is not None
                       else torch.device(device))
        self.frame_seconds = []
        self.video_written = False

    def render(self, data, seed: int):
        """The render dict of one item (tensors on the device)."""
        gen = torch.Generator(device=data["flat_cam_tgt"].device).manual_seed(seed)
        return render_novel_view(self.models, data, self.cfg, generator=gen,
                                 static_mode=self.static_mode)

    def run(self, dataset: Iterable, save_keys=("combined_rgb",)) -> pathlib.Path:
        self.out_dir.mkdir(parents=True, exist_ok=True)
        if hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__"):
            stream = to_device_prefetch(PrefetchLoader(dataset), self.device)
        else:
            stream = (contract_to_device(d, self.device) for d in dataset)
        self.frame_seconds = []
        for i, data in enumerate(stream):
            t0 = time.perf_counter()
            out = self.render(data, seed=i)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.frame_seconds.append(time.perf_counter() - t0)
            for key in save_keys:
                img = np.clip(out[key].float().cpu().numpy(), 0.0, 1.0)
                suffix = "combined" if key == "combined_rgb" else key
                write_png(self.out_dir / f"{i:06d}_{suffix}.png", (img * 255).astype(np.uint8))
            LOGGER.info("vis frame %d done", i)
        self.video_written = images_to_video(self.out_dir, "*_combined.png",
                                             self.out_dir / "video_combined.mp4", fps=self.fps)
        return self.out_dir
