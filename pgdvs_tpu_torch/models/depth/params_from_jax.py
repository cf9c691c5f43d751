"""Carry the JAX package's flax ZoeDepth parameters into the port.

Input is a flax param tree given as nested dicts of numpy arrays
(``{"params": ...}`` or bare):

  * ``zoe_params_from_jax``: the tree of ``pgdvs_tpu.models.depth
    .dpt_beit.ZoeDepthDPT`` (``midas`` + ``head``, single or NK) -> the
    state dicts of the port's ``ZoeDepthDPT.midas`` and ``.head``, the
    inverse of the JAX package's ``zoe_port.port_dpt_beit`` /
    ``port_zoe_head`` (Conv kernels HWIO -> OIHW, Dense kernels transposed,
    the deconvolutions' [in, out, k, k] kept, LayerNorm scale -> weight,
    the flax scope names -> the checkpoint's names);
  * ``structural_state_dict``: the tree of a structural head
    (``ZoeDepthModel``, ``MetricBinsHead`` ...), whose port modules are
    named as the flax scopes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from pgdvs_tpu_torch.models.tracking.params_from_jax import flax_state_dict, kernel_to_torch


def _vec(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _pair(sd, name, p):
    """A Conv or Dense ``{kernel, bias}`` as ``name.weight`` / ``name.bias``."""
    sd[f"{name}.weight"] = kernel_to_torch(p["kernel"])
    sd[f"{name}.bias"] = _vec(p["bias"])


def _norm(sd, name, p):
    sd[f"{name}.weight"] = _vec(p["scale"])
    sd[f"{name}.bias"] = _vec(p["bias"])


def _net(sd, name, p):
    """``{conv1, conv2}`` -> ``_net.0`` / ``_net.2``."""
    _pair(sd, f"{name}._net.0", p["conv1"])
    _pair(sd, f"{name}._net.2", p["conv2"])


def backbone_state_dict(p) -> Dict[str, torch.Tensor]:
    """flax ``DPTBeitBackbone`` params -> the port's backbone state dict."""
    sd = {}
    pm = "pretrained.model."
    sd[pm + "cls_token"] = _vec(p["cls_token"]).reshape(1, 1, -1)
    _pair(sd, pm + "patch_embed.proj", p["patch_embed"])
    i = 0
    while f"block_{i}" in p:
        bp, b = p[f"block_{i}"], f"{pm}blocks.{i}."
        _norm(sd, b + "norm1", bp["norm1"])
        _norm(sd, b + "norm2", bp["norm2"])
        for g in ("gamma_1", "gamma_2"):
            sd[b + g] = _vec(bp[g])
        attn = bp["attn"]
        sd[b + "attn.qkv.weight"] = kernel_to_torch(attn["qkv_kernel"])
        for k in ("q_bias", "v_bias", "relative_position_bias_table"):
            sd[b + "attn." + k] = _vec(attn[k])
        _pair(sd, b + "attn.proj", attn["proj"])
        _pair(sd, b + "mlp.fc1", bp["mlp_fc1"])
        _pair(sd, b + "mlp.fc2", bp["mlp_fc2"])
        i += 1
    for n in range(1, 5):
        ap = f"pretrained.act_postprocess{n}."
        _pair(sd, ap + "0.project.0", p[f"readout_{n - 1}"])
        _pair(sd, ap + "3", p[f"proj_{n - 1}"])
    for n in (1, 2):  # ConvTranspose2d weight [in, out, k, k], as flax keeps it
        sd[f"pretrained.act_postprocess{n}.4.weight"] = _vec(p[f"deconv_{n - 1}"]["kernel"])
        sd[f"pretrained.act_postprocess{n}.4.bias"] = _vec(p[f"deconv_{n - 1}"]["bias"])
    _pair(sd, "pretrained.act_postprocess4.4", p["downconv_3"])
    for n in range(1, 5):
        sd[f"scratch.layer{n}_rn.weight"] = kernel_to_torch(p[f"layer{n}_rn"]["kernel"])
        rp, rf = p[f"refinenet{n}"], f"scratch.refinenet{n}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            if unit in rp:
                for conv in ("conv1", "conv2"):
                    _pair(sd, rf + f"{unit}.{conv}", rp[unit][conv])
        _pair(sd, rf + "out_conv", rp["out_conv"])
    for src, dst in (("0", "head_conv0"), ("2", "head_conv2"), ("4", "head_conv4")):
        _pair(sd, f"scratch.output_conv.{src}", p[dst])
    return sd


def head_state_dict(p) -> Dict[str, torch.Tensor]:
    """flax ``ZoeMetricHead{Single,Multi}`` params -> the port's head
    state dict (the variant read from the tree)."""
    sd = {}
    _pair(sd, "conv2", p["conv2"])
    _net(sd, "seed_projector", p["seed_projector"])
    for i in range(4):
        _net(sd, f"projectors.{i}", p[f"projector_{i}"])
    if "patch_transformer" not in p:
        _net(sd, "seed_bin_regressor", p["seed_bin_regressor"])
        for i in range(4):
            _net(sd, f"attractors.{i}", p[f"attractor_{i}"])
        clb = p["conditional_log_binomial"]
        _pair(sd, "conditional_log_binomial.mlp.0", clb["mlp0"])
        _pair(sd, "conditional_log_binomial.mlp.2", clb["mlp2"])
        return sd
    pt = p["patch_transformer"]
    _pair(sd, "patch_transformer.embedding_convPxP", pt["embedding_convPxP"])
    for i in range(4):
        lp, b = pt[f"layer_{i}"], f"patch_transformer.transformer_encoder.layers.{i}."
        sd[b + "self_attn.in_proj_weight"] = kernel_to_torch(lp["in_proj_kernel"])
        sd[b + "self_attn.in_proj_bias"] = _vec(lp["in_proj_bias"])
        _pair(sd, b + "self_attn.out_proj", lp["out_proj"])
        _pair(sd, b + "linear1", lp["linear1"])
        _pair(sd, b + "linear2", lp["linear2"])
        _norm(sd, b + "norm1", lp["norm1"])
        _norm(sd, b + "norm2", lp["norm2"])
    _pair(sd, "mlp_classifier.0", p["mlp_classifier_0"])
    _pair(sd, "mlp_classifier.2", p["mlp_classifier_2"])
    for name in ("nyu", "kitti"):
        _net(sd, f"seed_bin_regressors.{name}", p[f"seed_bin_regressor_{name}"])
        for i in range(4):
            _net(sd, f"attractors.{name}.{i}", p[f"attractor_{name}_{i}"])
        clb = p[f"conditional_log_binomial_{name}"]
        _pair(sd, f"conditional_log_binomial.{name}.mlp.0", clb["mlp0"])
        _pair(sd, f"conditional_log_binomial.{name}.mlp.2", clb["mlp2"])
    return sd


def zoe_params_from_jax(flax_params) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """flax ``ZoeDepthDPT`` params -> (the port's ``midas`` state dict, its
    ``head`` state dict)."""
    p = flax_params.get("params", flax_params)
    return backbone_state_dict(p["midas"]), head_state_dict(p["head"])


def structural_state_dict(flax_params) -> Dict[str, torch.Tensor]:
    """flax params of a structural head (``ZoeDepthModel``,
    ``MetricBinsHead``, ``SeedBinRegressor`` ...) -> the port module's
    state dict (the same scope names)."""
    return flax_state_dict(flax_params, lambda path: ".".join(path), "ZoeDepth")
