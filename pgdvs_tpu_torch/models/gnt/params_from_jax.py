"""Carry flax GNT / ResUNet parameters into the port's modules.

Input is a flax param tree given as nested dicts of numpy arrays (as
``pgdvs_tpu.renderers.static_gnt.init_gnt_params`` makes them, converted with
``np.asarray``); output is a torch state dict for
``pgdvs_tpu_torch.models.gnt.network.GNT`` or ``feature_net.ResUNet``. The
inverse of ``pgdvs_tpu.models.gnt.weight_port``:

  * Dense kernel [in, out] -> Linear weight [out, in];
  * Conv kernel HWIO -> Conv2d weight OIHW;
  * GroupNorm / LayerNorm scale -> weight;
  * ``block_pairs`` (nn.scan, axis 0 = pair p) unstacks into blocks: slot
    ``_a`` is block 2p and slot ``_b`` is block 2p+1; the pair's ``q_fc_*``
    belongs to block 2p.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _params(tree) -> dict:
    return tree["params"] if "params" in tree else tree


def _dense(sd: Dict, name: str, p: dict, idx=None):
    pick = (lambda a: a) if idx is None else (lambda a: np.asarray(a)[idx])
    sd[f"{name}.weight"] = _t(pick(p["kernel"])).T.contiguous()
    if "bias" in p:
        sd[f"{name}.bias"] = _t(pick(p["bias"]))


def _norm(sd: Dict, name: str, p: dict, idx=None):
    pick = (lambda a: a) if idx is None else (lambda a: np.asarray(a)[idx])
    sd[f"{name}.weight"] = _t(pick(p["scale"]))
    sd[f"{name}.bias"] = _t(pick(p["bias"]))


def gnt_state_dict(flax_gnt_params, depth: int = 8) -> Dict[str, torch.Tensor]:
    """flax GNT params (``{"params": ...}`` or bare) -> GNT state dict."""
    p = _params(flax_gnt_params)
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "rgbfeat_fc.0", p["rgbfeat_fc_0"])
    _dense(sd, "rgbfeat_fc.2", p["rgbfeat_fc_1"])
    bp = p["block_pairs"]
    for blk in range(depth):
        pair, slot = divmod(blk, 2)
        v = bp[f"view_trans_{'ab'[slot]}"]
        r = bp[f"ray_trans_{'ab'[slot]}"]
        vt, rt = f"view_crosstrans.{blk}", f"view_selftrans.{blk}"
        _norm(sd, f"{vt}.attn_norm", v["attn_norm"], pair)
        _norm(sd, f"{vt}.ff_norm", v["ff_norm"], pair)
        for name, flax_name in (
            ("q_fc", "q_fc"), ("k_fc", "k_fc"), ("v_fc", "v_fc"),
            ("pos_fc.0", "pos_fc_0"), ("pos_fc.2", "pos_fc_1"),
            ("attn_fc.0", "attn_fc_0"), ("attn_fc.2", "attn_fc_1"),
            ("out_fc", "out_fc"),
        ):
            _dense(sd, f"{vt}.attn.{name}", v["attn"][flax_name], pair)
        _dense(sd, f"{vt}.ff.fc1", v["ff"]["fc1"], pair)
        _dense(sd, f"{vt}.ff.fc2", v["ff"]["fc2"], pair)
        _norm(sd, f"{rt}.attn_norm", r["attn_norm"], pair)
        _norm(sd, f"{rt}.ff_norm", r["ff_norm"], pair)
        for name in ("q_fc", "k_fc", "v_fc", "out_fc"):
            _dense(sd, f"{rt}.attn.{name}", r["attn"][name], pair)
        _dense(sd, f"{rt}.ff.fc1", r["ff"]["fc1"], pair)
        _dense(sd, f"{rt}.ff.fc2", r["ff"]["fc2"], pair)
        if slot == 0:
            _dense(sd, f"q_fcs.{pair}.0", bp["q_fc_0"], pair)
            _dense(sd, f"q_fcs.{pair}.2", bp["q_fc_1"], pair)
    _norm(sd, "norm", p["norm"])
    _dense(sd, "rgb_fc", p["rgb_fc"])
    return sd


def _conv(sd: Dict, name: str, p: dict):
    sd[f"{name}.weight"] = _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def resunet_state_dict(flax_fnet_params,
                       layers=(3, 4, 6)) -> Dict[str, torch.Tensor]:
    """flax ResUNet params -> ResUNet state dict."""
    p = _params(flax_fnet_params)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv1", p["conv1"]["Conv_0"])
    _norm(sd, "bn1", p["bn1"]["GroupNorm_0"])
    for li, n in enumerate(layers):
        for i in range(n):
            src, dst = p[f"layer{li + 1}_{i}"], f"layer{li + 1}.{i}"
            _conv(sd, f"{dst}.conv1", src["conv1"]["Conv_0"])
            _norm(sd, f"{dst}.bn1", src["bn1"]["GroupNorm_0"])
            _conv(sd, f"{dst}.conv2", src["conv2"]["Conv_0"])
            _norm(sd, f"{dst}.bn2", src["bn2"]["GroupNorm_0"])
            if "down_conv" in src:
                _conv(sd, f"{dst}.downsample.0", src["down_conv"]["Conv_0"])
                _norm(sd, f"{dst}.downsample.1", src["down_bn"]["GroupNorm_0"])
    for name in ("iconv3", "iconv2"):
        _conv(sd, f"{name}.conv", p[name]["conv"]["Conv_0"])
        _norm(sd, f"{name}.bn", p[name]["bn"]["GroupNorm_0"])
    for name in ("upconv3", "upconv2"):
        _conv(sd, f"{name}.conv.conv", p[name]["conv"]["Conv_0"])
        _norm(sd, f"{name}.conv.bn", p[name]["bn"]["GroupNorm_0"])
    _conv(sd, "out_conv", p["out_conv"])
    return sd
