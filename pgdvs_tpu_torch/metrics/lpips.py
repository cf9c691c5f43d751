"""LPIPS (AlexNet, v0.1), torch.

The port's counterpart of ``pgdvs_tpu.metrics.lpips_jax``, the NSFF
perceptual metric of the NVIDIA protocol: AlexNet conv1-5 relu features of
both images, each unit-normalized over its channels, the squared
difference weighted by the learned linear heads and summed over channels,
then per layer the mean, a masked mean (the mask resized to the layer with
torch's floor-nearest rule) or, with ``spatial``, the map bilinearly
resized to the image (the DyCheck variant); the layers are summed.

The learned heads are bundled (``weights/lpips_lin_alex_v0.1.pth``, the
same bytes as the JAX package's copy). The AlexNet backbone is torchvision's
``alexnet`` checkpoint, found by ``load_lpips_weights``; without it there is
no LPIPS and the evaluator reports PSNR / SSIM only, as in JAX.

On a card the convolutions run with TF32 off (a local
``torch.backends.cudnn.flags`` context): the JAX package runs them in
float32.
"""

from __future__ import annotations

import contextlib
import glob
import os
import pathlib
from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from pgdvs_tpu_torch.core.interpolate import resize

# ImageNet scaling constants of LPIPS's ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature config: (out_ch, kernel, stride, pad) per conv, with
# maxpool(3, 2) after convs 1 and 2 (and after 5, whose output is not used)
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}
# the convs' indices in torchvision's ``alexnet().features``
TORCHVISION_IDX = (0, 3, 6, 8, 10)

BUNDLED_HEADS = pathlib.Path(__file__).parent / "weights" / "lpips_lin_alex_v0.1.pth"


class LPIPS(nn.Module):
    """The AlexNet feature stack (``convs.{i}``) and the learned linear
    heads (``lins.{k}``, one weight per channel of layer k)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)
        convs, cin = [], 3
        for cout, k, s, p in _ALEX_CONVS:
            convs.append(nn.Conv2d(cin, cout, k, s, p))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(nn.Parameter(torch.zeros(c)) for c, *_ in _ALEX_CONVS)

    def features(self, x: torch.Tensor):
        """x [N, 3, H, W] in [-1, 1] -> the 5 relu feature maps."""
        x = (x - self.shift) / self.scale
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats


def no_tf32():
    """cuDNN with TF32 off and its other flags as they are, for this
    block only."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def nearest_resize_floor(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """torch ``F.interpolate(mode="nearest")`` source indexing on an
    [H, W, C] tensor: row i reads floor(i * (in_h / h)), the product taken
    in float32 as the JAX package's ``_nearest_resize_torch`` takes it."""
    in_h, in_w = m.shape[0], m.shape[1]

    def index(n_in, n_out):
        pos = torch.arange(n_out, dtype=torch.float32, device=m.device) * float(
            np.float32(n_in / n_out))
        return torch.floor(pos).long()

    return m[index(in_h, h)][:, index(in_w, w)]


@torch.no_grad()
def lpips_distance(net: LPIPS, img0, img1, mask=None, spatial: bool = False):
    """LPIPS distance between two [H, W, 3] images in [0, 1] on the net's
    device: a 0-d tensor, or with ``spatial`` the [H, W, 1] map.

    mask: optional [H, W, 1]; per layer the masked mean of the distance
    map, the mask resized to the layer by ``nearest_resize_floor``.
    """
    x0 = (2.0 * img0 - 1.0).permute(2, 0, 1)[None]
    x1 = (2.0 * img1 - 1.0).permute(2, 0, 1)[None]
    with no_tf32() if x0.is_cuda else contextlib.nullcontext():
        f0 = net.features(x0)
        f1 = net.features(x1)
    total = 0.0
    for k in range(5):
        a = f0[k] / (torch.linalg.vector_norm(f0[k], dim=1, keepdim=True) + 1e-10)
        b = f1[k] / (torch.linalg.vector_norm(f1[k], dim=1, keepdim=True) + 1e-10)
        diff = (a - b) ** 2
        dmap = torch.sum(diff * net.lins[k].view(1, -1, 1, 1), dim=1)[0, ..., None]  # [h, w, 1]
        if spatial:
            total = total + resize(dmap, img0.shape[0], img0.shape[1], "linear")
        elif mask is not None:
            m = nearest_resize_floor(mask, dmap.shape[0], dmap.shape[1])
            total = total + torch.sum(dmap * m) / (torch.sum(m) + 1e-8)
        else:
            total = total + torch.mean(dmap)
    return total


def _find(candidates):
    return next((str(c) for c in candidates if c and os.path.isfile(c)), None)


def load_lpips_weights(alexnet_path: Optional[str] = None,
                       lin_path: Optional[str] = None, device="cuda") -> Optional[LPIPS]:
    """The LPIPS module on ``device`` (default the card), in eval mode, from
    torch checkpoints, or None when the backbone or the heads are
    unavailable.

    lin_path: the LPIPS heads (``lin{k}.model.1.weight`` or
    ``lins.{k}.model.1.weight``, [1, C, 1, 1]); else
    ``$PGDVS_CKPT_DIR/lpips_alex_v0.1.pth``, else the bundled heads.
    alexnet_path: a torchvision ``alexnet`` state dict
    (``features.{0,3,6,8,10}``); else ``$PGDVS_CKPT_DIR/alexnet.pth``, else
    ``alexnet-*.pth`` in the torch hub cache (``~/.cache/torch/hub`` and
    ``torch.hub.get_dir()``, which is where torchvision keeps it). The JAX
    package's last step, torchvision's ``alexnet(weights="DEFAULT")``, reads
    that same file and downloads it when it is absent; the port never
    downloads, so the cache stands in for it.
    """
    ckpt_dir = os.environ.get("PGDVS_CKPT_DIR")
    if lin_path is None:
        lin_path = _find([ckpt_dir and os.path.join(ckpt_dir, "lpips_alex_v0.1.pth"),
                          BUNDLED_HEADS])
    if alexnet_path is None:
        caches = {os.path.expanduser("~/.cache/torch/hub"), torch.hub.get_dir()}
        alexnet_path = _find([ckpt_dir and os.path.join(ckpt_dir, "alexnet.pth")] + [
            f for d in sorted(caches)
            for f in sorted(glob.glob(os.path.join(d, "checkpoints", "alexnet-*.pth")))])
    if not (lin_path and alexnet_path and os.path.isfile(lin_path)
            and os.path.isfile(alexnet_path)):
        return None
    sd = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
    state = {}
    for i, ti in enumerate(TORCHVISION_IDX):
        state[f"convs.{i}.weight"] = sd[f"features.{ti}.weight"]
        state[f"convs.{i}.bias"] = sd[f"features.{ti}.bias"]
    for k in range(5):
        key = next((key for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight")
                    if key in lin_sd), None)
        if key is None:
            return None
        state[f"lins.{k}"] = lin_sd[key].reshape(-1)
    net = LPIPS()
    net.load_state_dict(state)
    return net.eval().to(device)


def lpips_params_from_jax(params) -> dict:
    """The JAX package's LPIPS param dict (``conv{i}_w`` HWIO, ``conv{i}_b``,
    ``lin{k}``), as numpy or JAX arrays -> the state dict of ``LPIPS``."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    state = {}
    for i in range(len(_ALEX_CONVS)):
        state[f"convs.{i}.weight"] = t(params[f"conv{i}_w"]).permute(3, 2, 0, 1).contiguous()
        state[f"convs.{i}.bias"] = t(params[f"conv{i}_b"])
    for k in range(len(_ALEX_CONVS)):
        state[f"lins.{k}"] = t(params[f"lin{k}"])
    return state
