"""Load the published ``ZoeD_M12_{N,K,NK}.pt`` into the port's ZoeDepth.

Counterpart of ``pgdvs_tpu.models.depth.zoe_port``. Zoe wraps MiDaS as
``core.core.*`` (timm's BEiT under ``pretrained.model.*``, the DPT
reassemble under ``pretrained.act_postprocess*``, the fusion and the head
under ``scratch.*``); everything else is the metric head. The port's
modules carry the checkpoint's names (``dpt_beit``, ``zoe_head``), so the
mapping is a selection by name, as strict as the JAX package's: every
weight the network reads must be there (KeyError), the known buffers and
unused modules (``_DROPPABLE``; ``refinenet4.resConfUnit1``, dead in
MiDaS's forward) are dropped, and any other key raises ValueError.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

# buffers / unused modules that may appear in released checkpoints
_DROPPABLE = re.compile(
    r"(relative_position_index$)"
    r"|(^model\.norm\.)"         # timm final norm (hooks are pre-norm)
    r"|(^model\.fc_norm\.)"
    r"|(^model\.head\.)"
    r"|(attn\.k_bias$)"          # zero buffer in some timm versions
)

_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "gamma_1", "gamma_2",
               "attn.qkv.weight", "attn.q_bias", "attn.v_bias",
               "attn.relative_position_bias_table", "attn.proj.weight", "attn.proj.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")
_WB = ("weight", "bias")


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def _backbone_keys(depth: int = 24) -> List[str]:
    """The names of ``dpt_beit.DPTBeitBackbone``'s parameters: the MiDaS
    core's checkpoint keys it reads."""
    pm = "pretrained.model."
    keys = [pm + "cls_token", pm + "patch_embed.proj.weight", pm + "patch_embed.proj.bias"]
    for i in range(depth):
        keys += [f"{pm}blocks.{i}.{k}" for k in _BLOCK_KEYS]
    for n in range(1, 5):
        ap = f"pretrained.act_postprocess{n}."
        keys += [ap + f"{m}.{p}" for m in (("0.project.0", "3") if n == 3
                                           else ("0.project.0", "3", "4")) for p in _WB]
    for n in range(1, 5):
        keys.append(f"scratch.layer{n}_rn.weight")
        rf = f"scratch.refinenet{n}."
        units = ("resConfUnit2",) if n == 4 else ("resConfUnit1", "resConfUnit2")
        keys += [rf + f"{u}.{c}.{p}" for u in units for c in ("conv1", "conv2") for p in _WB]
        keys += [rf + f"out_conv.{p}" for p in _WB]
    keys += [f"scratch.output_conv.{i}.{p}" for i in (0, 2, 4) for p in _WB]
    return keys


def _head_keys(variant: str) -> List[str]:
    """The names of ``ZoeMetricHeadSingle``'s ("single") or
    ``ZoeMetricHeadMulti``'s ("nk") parameters: the head's checkpoint
    keys."""
    def net(base):
        return [f"{base}._net.{i}.{p}" for i in (0, 2) for p in _WB]

    keys = [f"conv2.{p}" for p in _WB] + net("seed_projector")
    for i in range(4):
        keys += net(f"projectors.{i}")
    if variant == "single":
        keys += net("seed_bin_regressor")
        for i in range(4):
            keys += net(f"attractors.{i}")
        return keys + [f"conditional_log_binomial.mlp.{i}.{p}" for i in (0, 2) for p in _WB]
    keys += [f"patch_transformer.embedding_convPxP.{p}" for p in _WB]
    for i in range(4):
        b = f"patch_transformer.transformer_encoder.layers.{i}."
        keys += [b + "self_attn.in_proj_weight", b + "self_attn.in_proj_bias"]
        keys += [b + f"{m}.{p}" for m in ("self_attn.out_proj", "linear1", "linear2", "norm1",
                                          "norm2") for p in _WB]
    keys += [f"mlp_classifier.{i}.{p}" for i in (0, 2) for p in _WB]
    for name in ("nyu", "kitti"):
        keys += net(f"seed_bin_regressors.{name}")
        for i in range(4):
            keys += net(f"attractors.{name}.{i}")
        keys += [f"conditional_log_binomial.{name}.mlp.{i}.{p}" for i in (0, 2) for p in _WB]
    return keys


def _select(sd, keys):
    out = {}
    for k in keys:
        if k not in sd:
            raise KeyError(f"checkpoint missing {k}")
        out[k] = _tensor(sd[k]).float()
    return out


def port_dpt_beit(sd, depth: int = 24) -> Tuple[Dict[str, torch.Tensor], list]:
    """MiDaS-core state dict -> ``DPTBeitBackbone``'s state dict.

    Keys may carry ``core.core.``, ``core.`` or no prefix before
    ``pretrained.`` / ``scratch.``. Returns (state dict, dropped keys).
    Raises KeyError on a missing weight and ValueError on an unrecognized
    key."""
    norm = {}
    for k, v in sd.items():
        for pre in ("core.core.", "core.", ""):
            if k.startswith(pre + "pretrained.") or k.startswith(pre + "scratch."):
                norm[k[len(pre):]] = v
                break
    out = _select(norm, _backbone_keys(depth))
    dead = {f"scratch.refinenet4.resConfUnit1.{c}.{p}" for c in ("conv1", "conv2") for p in _WB}
    leftovers = [k for k in norm if k not in out and k not in dead]
    dropped = [k for k in leftovers if _DROPPABLE.search(
        k[len("pretrained."):] if k.startswith("pretrained.") else k)]
    unknown = [k for k in leftovers if k not in dropped]
    if unknown:
        raise ValueError(f"unrecognized checkpoint keys: {unknown[:8]}")
    return out, dropped


def port_zoe_head(sd) -> Tuple[Dict[str, torch.Tensor], str]:
    """Original isl-org metric-head state dict -> the head's state dict and
    its variant: ``patch_transformer.*`` present -> "nk"
    (``ZoeMetricHeadMulti``), else "single" (``ZoeMetricHeadSingle``).
    Strict: every head key is read; others raise ValueError."""
    variant = "nk" if any(k.startswith("patch_transformer.") for k in sd) else "single"
    out = _select(sd, _head_keys(variant))
    unknown = [k for k in sd if k not in out]
    if unknown:
        raise ValueError(f"unrecognized head keys: {unknown[:8]}")
    return out, variant


def load_zoe_checkpoint(path: str, depth: int = 24, device="cuda"):
    """Load a ZoeD_M12_*.pt: (backbone state dict, head state dict,
    variant), the tensors on ``device`` (default the card).

    The checkpoint splits into the MiDaS core (``core[.core]
    .pretrained/scratch.*``) and the metric head (everything else); both
    sides are strict, so a layout drift raises instead of running random
    weights. Raises FileNotFoundError when the file is not there."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"ZoeDepth checkpoint not found: {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    backbone_sd, head_sd = {}, {}
    for k, v in sd.items():
        body = k
        for pre in ("core.core.", "core."):
            if body.startswith(pre):
                body = body[len(pre):]
                break
        if body.startswith(("pretrained.", "scratch.")):
            backbone_sd[k] = v
        else:
            head_sd[body] = v
    backbone, _dropped = port_dpt_beit(backbone_sd, depth=depth)
    head, variant = port_zoe_head(head_sd)
    return ({k: v.to(device) for k, v in backbone.items()},
            {k: v.to(device) for k, v in head.items()}, variant)


def load_zoe_model(path: str, max_depth: float = 10.0, depth: int = 24, device="cuda"):
    """``dpt_beit.ZoeDepthDPT`` (the variant the checkpoint holds) with the
    checkpoint's weights, in eval mode on ``device``. Built on the meta
    device and filled by ``load_state_dict``: no random initialization."""
    from pgdvs_tpu_torch.models.depth.dpt_beit import ZoeDepthDPT

    backbone_sd, head_sd, variant = load_zoe_checkpoint(path, depth=depth, device=device)
    with torch.device("meta"):
        model = ZoeDepthDPT(max_depth=max_depth, variant=variant,
                            backbone_kwargs={"depth": depth})
    model = model.to_empty(device=device)
    model.midas.load_state_dict(backbone_sd)
    model.head.load_state_dict(head_sd)
    return model.eval()
