"""The port's ZoeDepth (DPT-BEiT + metric heads), its infer protocol, its
loaders and ``compute_zoedepth`` against the JAX package's, on the CPU.

One fake state dict in the published ``ZoeD_M12_*.pt`` layout at tiny
widths (BEiT width 32, 6 blocks, a 4x4 pretrained grid; the builders of
tests/test_dpt_beit.py, copied here, plus an NK head) is written as a
``.pt``: the JAX package loads it with its ``load_zoe_checkpoint``, the
port with its own; ``zoe_params_from_jax`` gives the port's state dicts
back from JAX's params, equal to the port's loader bit for bit.

  * the relative-position table resize against ``jax.image.resize``'s
    cubic at 1e-5 of the table's scale: larger, smaller and mixed grids;
  * the backbone (relative depth, the head activation, the bottleneck and
    the four fusion outputs) at a 4x6 token grid (the table resized) and
    at the pretrained 4x4; the single and NK heads (the NK head with each
    domain forced and as its classifier picks, two items in one batch);
    ``ZoeDepthDPT`` end to end for both variants; the structural
    ``ZoeDepthModel``: 1e-4 of each output's scale (float32, other
    convolution and summation orders);
  * ``zoe_infer`` at three odd frame sizes with a flip-sensitive network
    (1e-5), its resizes against JAX's numpy (1e-5);
  * ``compute_scene_zoe`` on three 40x56 PNG frames through the network
    (depth 1e-4 of its scale, the alignment's scalars 1e-4 relative) and
    through ``--pred-dir`` (bit for bit: the same numpy alignment); the
    CLI in-process with ``--device cpu`` and its refusals; the written
    npz files read back by the port's NVIDIA reader for every
    ``ZOE_PRINCIPLES`` key and "moe", equal to JAX's reader.

JAX's metric networks are compiled with XLA's algebraic simplifier off
(``_compiled``; the eager JAX program gives the same within 2e-8): with it,
XLA's CPU compiler rewrites the conditional log-binomial's
``log((n - 1 + 1e-7) - (k + 1e-7) + 1e-7)`` at the last bin into log(0),
and every depth comes out NaN. The port computes it as eager JAX (and
torch's original) does. The port runs on one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.data.nvidia_eval import NvidiaEvalDataset as JNvidiaEvalDataset
from pgdvs_tpu.models.depth import dpt_beit as jdpt
from pgdvs_tpu.models.depth import zoe_head as jhead
from pgdvs_tpu.models.depth import zoe_infer as jinfer
from pgdvs_tpu.models.depth.zoe_port import load_zoe_checkpoint as j_load_zoe_checkpoint
from pgdvs_tpu.preprocess.compute_zoedepth import compute_scene_zoe as j_compute_scene_zoe
from pgdvs_tpu.preprocess.depth_align import align_video as j_align_video
from pgdvs_tpu_torch.data.image_io import write_png
from pgdvs_tpu_torch.data.nvidia_eval import ZOE_PRINCIPLES, NvidiaEvalDataset
from pgdvs_tpu_torch.models.depth import dpt_beit, zoe_head, zoe_infer, zoe_port
from pgdvs_tpu_torch.models.depth.params_from_jax import (structural_state_dict,
                                                          zoe_params_from_jax)
from pgdvs_tpu_torch.preprocess import compute_zoedepth

# tiny config: dim 32, 6 blocks, hooks spread, pretrained grid 4x4
DIM, DEPTH, HEADS, GRID = 32, 6, 4, (4, 4)
HOOKS = (1, 2, 4, 5)
FEATS = 16
REASM = (16, 24, 32, 32)
HEAD_F = (8, 4)
N_BINS, EMB, PT_HIDDEN, PT_INTER = 16, 32, 32, 64
BACKBONE = dict(embed_dim=DIM, depth=DEPTH, n_heads=HEADS, mlp_ratio=2.0, patch=16,
                hooks=HOOKS, features=FEATS, reassemble_channels=REASM,
                pretrained_grid=GRID, head_features=HEAD_F)
BIN_CONFS = ({"name": "nyu", "n_bins": N_BINS, "min_depth": 1e-3, "max_depth": 10.0},
             {"name": "kitti", "n_bins": N_BINS, "min_depth": 1e-3, "max_depth": 80.0})
HEADS_KW = {
    "single": dict(bin_embedding_dim=EMB, num_relative_features=HEAD_F[1]),
    "nk": dict(bin_confs=BIN_CONFS, bin_embedding_dim=EMB, num_relative_features=HEAD_F[1],
               patch_transformer_hidden=PT_HIDDEN, patch_transformer_intermediate=PT_INTER),
}
REL = 1e-4
RESIZE_REL = 1e-5
NET_HW = (64, 96)          # the net size of a 40x56 frame at this target
FRAME_HW = (40, 56)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_midas_sd(rng):
    """Published ZoeD/MiDaS key layout at the tiny test dims."""
    sd = {}

    def add(name, *shape):
        sd["core.core." + name] = rng.normal(size=shape).astype(np.float32) * 0.05

    pm = "pretrained.model."
    add(pm + "cls_token", 1, 1, DIM)
    add(pm + "patch_embed.proj.weight", DIM, 3, 16, 16)
    add(pm + "patch_embed.proj.bias", DIM)
    n_rel = (2 * GRID[0] - 1) * (2 * GRID[1] - 1) + 3
    for i in range(DEPTH):
        b = f"{pm}blocks.{i}."
        add(b + "norm1.weight", DIM)
        add(b + "norm1.bias", DIM)
        add(b + "norm2.weight", DIM)
        add(b + "norm2.bias", DIM)
        add(b + "gamma_1", DIM)
        add(b + "gamma_2", DIM)
        add(b + "attn.qkv.weight", 3 * DIM, DIM)
        add(b + "attn.q_bias", DIM)
        add(b + "attn.v_bias", DIM)
        add(b + "attn.relative_position_bias_table", n_rel, HEADS)
        ntok = GRID[0] * GRID[1] + 1
        sd[f"core.core.{b}attn.relative_position_index"] = np.zeros(
            (ntok, ntok), np.int64
        )  # buffer: must be dropped by the port
        add(b + "attn.proj.weight", DIM, DIM)
        add(b + "attn.proj.bias", DIM)
        add(b + "mlp.fc1.weight", 2 * DIM, DIM)
        add(b + "mlp.fc1.bias", 2 * DIM)
        add(b + "mlp.fc2.weight", DIM, 2 * DIM)
        add(b + "mlp.fc2.bias", DIM)
    # timm final norm present in checkpoints, unused by DPT hooks
    add(pm + "norm.weight", DIM)
    add(pm + "norm.bias", DIM)

    for n in range(1, 5):
        ap = f"pretrained.act_postprocess{n}."
        add(ap + "0.project.0.weight", DIM, 2 * DIM)
        add(ap + "0.project.0.bias", DIM)
        add(ap + "3.weight", REASM[n - 1], DIM, 1, 1)
        add(ap + "3.bias", REASM[n - 1])
        if n == 1:
            add(ap + "4.weight", REASM[0], REASM[0], 4, 4)
            add(ap + "4.bias", REASM[0])
        elif n == 2:
            add(ap + "4.weight", REASM[1], REASM[1], 2, 2)
            add(ap + "4.bias", REASM[1])
        elif n == 4:
            add(ap + "4.weight", REASM[3], REASM[3], 3, 3)
            add(ap + "4.bias", REASM[3])

    for n in range(1, 5):
        add(f"scratch.layer{n}_rn.weight", FEATS, REASM[n - 1], 3, 3)
        rf = f"scratch.refinenet{n}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            for conv in ("conv1", "conv2"):
                add(rf + f"{unit}.{conv}.weight", FEATS, FEATS, 3, 3)
                add(rf + f"{unit}.{conv}.bias", FEATS)
        add(rf + "out_conv.weight", FEATS, FEATS, 1, 1)
        add(rf + "out_conv.bias", FEATS)

    add("scratch.output_conv.0.weight", HEAD_F[0], FEATS, 3, 3)
    add("scratch.output_conv.0.bias", HEAD_F[0])
    add("scratch.output_conv.2.weight", HEAD_F[1], HEAD_F[0], 3, 3)
    add("scratch.output_conv.2.bias", HEAD_F[1])
    add("scratch.output_conv.4.weight", 1, HEAD_F[1], 1, 1)
    add("scratch.output_conv.4.bias", 1)
    return sd


def _fake_zoe_head_sd(rng, n_bins=N_BINS, emb=EMB):
    """Original zoedepth.py single-head key layout at the tiny test dims."""
    sd = {}

    def add(name, *shape):
        sd[name] = rng.normal(size=shape).astype(np.float32) * 0.05

    def net(base, cin, mid, cout):
        add(base + "._net.0.weight", mid, cin, 1, 1)
        add(base + "._net.0.bias", mid)
        add(base + "._net.2.weight", cout, mid, 1, 1)
        add(base + "._net.2.bias", cout)

    add("conv2.weight", FEATS, FEATS, 1, 1)
    add("conv2.bias", FEATS)
    net("seed_bin_regressor", FEATS, 256, n_bins)
    net("seed_projector", FEATS, 128, emb)
    for i, n_attr in enumerate((16, 8, 4, 1)):
        net(f"projectors.{i}", FEATS, 128, emb)
        net(f"attractors.{i}", emb, emb, n_attr)
    clb_in = HEAD_F[1] + 1 + emb
    clb_mid = (HEAD_F[1] + 1 + emb) // 2
    add("conditional_log_binomial.mlp.0.weight", clb_mid, clb_in, 1, 1)
    add("conditional_log_binomial.mlp.0.bias", clb_mid)
    add("conditional_log_binomial.mlp.2.weight", 4, clb_mid, 1, 1)
    add("conditional_log_binomial.mlp.2.bias", 4)
    return sd


def _fake_zoe_nk_head_sd(rng, n_bins=N_BINS, emb=EMB):
    """Original zoedepth_nk.py two-domain key layout at the tiny dims."""
    sd = {}

    def add(name, *shape, scale=0.05):
        sd[name] = rng.normal(size=shape).astype(np.float32) * scale

    def net(base, cin, mid, cout):
        add(base + "._net.0.weight", mid, cin, 1, 1)
        add(base + "._net.0.bias", mid)
        add(base + "._net.2.weight", cout, mid, 1, 1)
        add(base + "._net.2.bias", cout)

    add("conv2.weight", FEATS, FEATS, 1, 1)
    add("conv2.bias", FEATS)
    add("patch_transformer.embedding_convPxP.weight", PT_HIDDEN, FEATS, 1, 1)
    add("patch_transformer.embedding_convPxP.bias", PT_HIDDEN)
    for i in range(4):
        b = f"patch_transformer.transformer_encoder.layers.{i}."
        add(b + "self_attn.in_proj_weight", 3 * PT_HIDDEN, PT_HIDDEN, scale=0.2)
        add(b + "self_attn.in_proj_bias", 3 * PT_HIDDEN)
        add(b + "self_attn.out_proj.weight", PT_HIDDEN, PT_HIDDEN, scale=0.2)
        add(b + "self_attn.out_proj.bias", PT_HIDDEN)
        add(b + "linear1.weight", PT_INTER, PT_HIDDEN, scale=0.2)
        add(b + "linear1.bias", PT_INTER)
        add(b + "linear2.weight", PT_HIDDEN, PT_INTER, scale=0.2)
        add(b + "linear2.bias", PT_HIDDEN)
        for nm in ("norm1", "norm2"):
            sd[b + nm + ".weight"] = (1.0 + rng.normal(size=PT_HIDDEN) * 0.1).astype(np.float32)
            add(b + nm + ".bias", PT_HIDDEN)
    add("mlp_classifier.0.weight", PT_HIDDEN, PT_HIDDEN, scale=0.3)
    add("mlp_classifier.0.bias", PT_HIDDEN)
    add("mlp_classifier.2.weight", 2, PT_HIDDEN, scale=0.3)
    add("mlp_classifier.2.bias", 2)
    net("seed_projector", FEATS, emb // 2, emb)
    for i in range(4):
        net(f"projectors.{i}", FEATS, emb // 2, emb)
    clb_in = HEAD_F[1] + emb
    clb_mid = (HEAD_F[1] + emb) // 4
    for name in ("nyu", "kitti"):
        net(f"seed_bin_regressors.{name}", FEATS, emb // 2, n_bins)
        for i in range(4):
            net(f"attractors.{name}.{i}", emb, emb, 16)
        add(f"conditional_log_binomial.{name}.mlp.0.weight", clb_mid, clb_in, 1, 1)
        add(f"conditional_log_binomial.{name}.mlp.0.bias", clb_mid)
        add(f"conditional_log_binomial.{name}.mlp.2.weight", 4, clb_mid, 1, 1)
        add(f"conditional_log_binomial.{name}.mlp.2.bias", 4)
    return sd


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{variant: (path of the .pt, the state dict as numpy)}; the single
    checkpoint also carries refinenet4's dead resConfUnit1."""
    root = tmp_path_factory.mktemp("zoe_ckpts")
    rng = np.random.default_rng(0)
    midas = _fake_midas_sd(rng)
    out = {}
    for variant, head in (("single", _fake_zoe_head_sd(rng)), ("nk", _fake_zoe_nk_head_sd(rng))):
        sd = {**midas, **head}
        path = root / f"ZoeD_tiny_{variant}.pt"
        torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
        out[variant] = (path, sd)
    return out


@pytest.fixture(scope="module")
def jparams(ckpts):
    """JAX's params of both variants, through its own loader."""
    out = {}
    for variant, (path, _) in ckpts.items():
        backbone, head, got = j_load_zoe_checkpoint(str(path), depth=DEPTH)
        assert got == variant
        out[variant] = {"params": {"midas": jax.tree_util.tree_map(jnp.asarray, backbone),
                                   "head": jax.tree_util.tree_map(jnp.asarray, head)}}
    return out


def _port_model(path, variant):
    backbone, head, got = zoe_port.load_zoe_checkpoint(str(path), depth=DEPTH, device="cpu")
    assert got == variant
    model = dpt_beit.ZoeDepthDPT(n_bins=N_BINS, variant=variant, backbone_kwargs=BACKBONE,
                                 head_kwargs=HEADS_KW[variant])
    model.midas.load_state_dict(backbone)
    model.head.load_state_dict(head)
    return model.eval()


@pytest.fixture(scope="module")
def models(ckpts):
    return {variant: _port_model(path, variant) for variant, (path, _) in ckpts.items()}


def _jax_model(variant):
    return jdpt.ZoeDepthDPT(n_bins=N_BINS, variant=variant, backbone_kwargs=BACKBONE,
                            head_kwargs=HEADS_KW[variant])


@pytest.fixture(scope="module")
def compiled():
    """The JAX programs compiled for this module's tests, by key."""
    return {}


def _compiled(cache, key, module, variables, *example):
    """``module.apply`` jitted for ``example``'s shapes with XLA's
    algebraic simplifier off (see the module docstring), compiled once per
    ``key`` into ``cache``."""
    if key not in cache:
        cache[key] = jax.jit(module.apply).lower(variables, *example).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return cache[key]


def _close(got, ref, rel=REL, err_msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape, err_msg)
    assert np.isfinite(ref).all() and np.isfinite(got).all(), err_msg
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1e-6),
                               err_msg=err_msg)


def _nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(2, 0, 1)[None]


def _hwc(t):
    return t[0].permute(1, 2, 0)


def _nhwc_to_nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("src,dst", [((4, 4), (4, 6)), ((4, 4), (2, 6)), ((6, 6), (3, 4)),
                                     ((24, 24), (24, 44)), ((4, 4), (4, 4))])
def test_rel_pos_table_resize_matches_jax(src, dst):
    """Up, down and mixed grids (24x24 -> 24x44 is the NVIDIA frame's);
    JAX's Keys cubic, not F.interpolate's bicubic."""
    rng = np.random.default_rng(sum(dst))
    n = (2 * src[0] - 1) * (2 * src[1] - 1) + 3
    table = rng.normal(size=(n, 3)).astype(np.float32)
    ref = np.asarray(jdpt.resize_rel_pos_table(jnp.asarray(table), src, dst))
    got = dpt_beit.resize_rel_pos_table(torch.from_numpy(table), src, dst)
    _close(got, ref, RESIZE_REL)
    np.testing.assert_array_equal(dpt_beit.gen_relative_position_index(*dst),
                                  jdpt.gen_relative_position_index(*dst))


@pytest.mark.parametrize("hw", [(64, 96), (64, 64)], ids=["grid4x6", "grid4x4"])
def test_backbone_matches_jax(models, jparams, hw):
    rng = np.random.default_rng(hw[1])
    x = rng.normal(size=hw + (3,)).astype(np.float32)
    ref = jax.jit(jdpt.DPTBeitBackbone(**BACKBONE).apply)(
        {"params": jparams["single"]["params"]["midas"]}, jnp.asarray(x))
    with torch.no_grad():
        got = models["single"].midas(_nchw(x))
    names = ("rel", "out_conv_feat", "l4_rn")
    for name, g, r in zip(names, got[:3], ref[:3]):
        _close(g[0] if name == "rel" else _hwc(g), r, err_msg=name)
    assert len(got[3]) == len(ref[3]) == 4
    for i, (g, r) in enumerate(zip(got[3], ref[3])):
        _close(_hwc(g), r, err_msg=f"r{4 - i}")


def _head_inputs(rng, b):
    """Head inputs of a NET_HW image (the shapes of the end-to-end tests,
    whose eager JAX ops they reuse): out_conv [64, 96, 4], the bottleneck
    at H/32, the fusion outputs at H/16 ... H/2, relative depth [64, 96]."""
    def arr(*shape):
        return rng.normal(size=(b,) + shape).astype(np.float32)
    feats = [arr(4 * 2 ** i, 6 * 2 ** i, FEATS) for i in range(4)]
    return (np.abs(arr(*NET_HW, HEAD_F[1])), arr(2, 3, FEATS), feats, np.abs(arr(*NET_HW)))


def test_single_head_matches_jax(models, jparams, compiled):
    rng = np.random.default_rng(7)
    outconv, btl, feats, rel = _head_inputs(rng, 2)
    head = jhead.ZoeMetricHeadSingle(N_BINS, **HEADS_KW["single"])
    p = {"params": jparams["single"]["params"]["head"]}
    with torch.no_grad():
        got = models["single"].head(
            _nhwc_to_nchw(outconv), _nhwc_to_nchw(btl), [_nhwc_to_nchw(f) for f in feats],
            torch.from_numpy(rel))
    apply = _compiled(compiled, "single_head", head, p, outconv[0], btl[0], [f[0] for f in feats],
                      rel[0])
    for i in range(2):
        ref = apply(p, outconv[i], btl[i], [f[i] for f in feats], rel[i])
        _close(got[i].permute(1, 2, 0), ref, err_msg=f"item {i}")


@pytest.mark.parametrize("force", [None, 0, 1], ids=["picked", "nyu", "kitti"])
def test_nk_head_matches_jax(ckpts, jparams, compiled, force):
    """Two items in one batch, each routed by its own logits; the domain
    forced by the classifier's last bias, or as the weights pick."""
    head_p = jax.tree_util.tree_map(np.asarray, jparams["nk"]["params"]["head"])
    model = _port_model(ckpts["nk"][0], "nk")
    if force is not None:
        bias = np.where(np.arange(2) == force, 50.0, -50.0).astype(np.float32)
        head_p["mlp_classifier_2"]["bias"] = bias
        with torch.no_grad():
            model.head.mlp_classifier[2].bias.copy_(torch.from_numpy(bias))
    rng = np.random.default_rng(8)
    outconv, btl, feats, rel = _head_inputs(rng, 2)
    head = jhead.ZoeMetricHeadMulti(**HEADS_KW["nk"])
    with torch.no_grad():
        depth, logits = model.head(
            _nhwc_to_nchw(outconv), _nhwc_to_nchw(btl), [_nhwc_to_nchw(f) for f in feats],
            torch.from_numpy(rel))
    apply = _compiled(compiled, "nk_head", head, {"params": head_p}, outconv[0], btl[0],
                      [f[0] for f in feats], rel[0])
    for i in range(2):
        ref_d, ref_l = apply({"params": head_p}, outconv[i], btl[i], [f[i] for f in feats],
                             rel[i])
        if force is not None:
            assert int(np.argmax(ref_l)) == force
        _close(logits[i], ref_l, err_msg=f"logits {i}")
        _close(depth[i].permute(1, 2, 0), ref_d, err_msg=f"depth {i}")


@pytest.mark.parametrize("variant", ["single", "nk"])
def test_zoe_dpt_matches_jax(models, jparams, compiled, variant):
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 1, NET_HW + (3,)).astype(np.float32)
    apply = _compiled(compiled, variant, _jax_model(variant), jparams[variant], img)
    ref = apply(jparams[variant], img)
    with torch.no_grad():
        got = models[variant](_nchw(img))[0]
    assert float(np.asarray(ref).min()) > 0
    _close(got, ref)


def test_structural_model_matches_jax():
    """ZoeDepthModel: the SAME-padded strided convolutions, the channel
    resize JAX applies between decoder scales, seed bins, attractors and
    the log-binomial."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    jm = jhead.ZoeDepthModel(n_bins=16, min_depth=0.3, max_depth=6.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(img))
    ref = jax.jit(jm.apply)(params, jnp.asarray(img))
    model = zoe_head.ZoeDepthModel(n_bins=16, min_depth=0.3, max_depth=6.0)
    model.load_state_dict(structural_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    _close(got, ref)
    d = np.asarray(rng.normal(size=(7,)), np.float32)
    _close(zoe_head.inverse_attractor(torch.from_numpy(d)), jhead.inverse_attractor(jnp.asarray(d)))


@pytest.mark.parametrize("in_hw,out_hw", [((676, 1240), (384, 512)), ((66, 86), (64, 96)),
                                          ((51, 77), (384, 512)), ((480, 640), (384, 512))])
def test_resize_output_size_matches_jax(in_hw, out_hw):
    assert zoe_infer.resize_output_size(*in_hw, *out_hw) == jinfer.resize_output_size(
        *in_hw, *out_hw)


@pytest.mark.parametrize("shape,out", [((7, 9, 3), (12, 20)), ((13, 11), (5, 6)),
                                       ((1, 4), (3, 8))])
def test_resizes_match_jax(shape, out):
    x = np.random.default_rng(len(shape)).uniform(0, 1, shape).astype(np.float32)
    _close(zoe_infer.resize_bilinear_ac(torch.from_numpy(x), *out),
           jinfer.resize_bilinear_ac(x, *out), RESIZE_REL)
    _close(zoe_infer.resize_bicubic(torch.from_numpy(x), *out).float(),
           jinfer.resize_bicubic(x, *out).astype(np.float32), RESIZE_REL)


def _toy_depth_np(x):
    """A flip-sensitive 'network' on [H, W, 3]."""
    ramp = np.linspace(1.0, 2.0, x.shape[1], dtype=np.float32)
    return x[..., 0] * ramp + x[..., 1] ** 2 + 0.5


def _toy_depth_torch(x):
    ramp = torch.linspace(1.0, 2.0, x.shape[-1])
    return x[:, 0] * ramp + x[:, 1] ** 2 + 0.5


@pytest.mark.parametrize("hw", [(37, 53), (41, 30), (23, 67)])
@pytest.mark.parametrize("flip", [True, False])
def test_zoe_infer_matches_jax(hw, flip):
    img = np.random.default_rng(hw[0]).uniform(0, 1, hw + (3,)).astype(np.float32)
    ref = jinfer.zoe_infer(_toy_depth_np, img, net_hw=(64, 96), with_flip_aug=flip)
    got = zoe_infer.zoe_infer(_toy_depth_torch, torch.from_numpy(img), net_hw=(64, 96),
                              with_flip_aug=flip)
    assert got.dtype == torch.float32
    _close(got, ref, RESIZE_REL)


def test_loaders_and_bridge(ckpts, jparams, tmp_path):
    """The port's loader equals zoe_params_from_jax of JAX's params bit for
    bit; the dropped buffers and refinenet4's dead unit are accepted; an
    unknown key raises ValueError as JAX's loader does, a missing weight
    KeyError, a missing file FileNotFoundError."""
    for variant, (path, sd) in ckpts.items():
        backbone, head, got = zoe_port.load_zoe_checkpoint(str(path), depth=DEPTH, device="cpu")
        assert got == variant
        b2, h2 = zoe_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams[variant]))
        for mine, theirs in ((backbone, b2), (head, h2)):
            assert set(mine) == set(theirs)
            for k in mine:
                assert torch.equal(mine[k], theirs[k]), k
    _, sd = ckpts["single"]
    backbone_sd = {k: v for k, v in sd.items() if k.startswith("core.core.")}
    _, dropped = zoe_port.port_dpt_beit(backbone_sd, depth=DEPTH)
    assert len(dropped) == DEPTH + 2 and all(
        "relative_position_index" in k or ".norm." in k for k in dropped)
    bad = dict(backbone_sd)
    bad["core.core.pretrained.model.blocks.0.attn.surprise"] = np.zeros(3)
    with pytest.raises(ValueError, match="unrecognized checkpoint keys"):
        zoe_port.port_dpt_beit(bad, depth=DEPTH)
    with pytest.raises(KeyError, match="checkpoint missing"):
        zoe_port.port_dpt_beit(backbone_sd, depth=DEPTH + 1)
    head_sd = {k: v for k, v in sd.items() if not k.startswith("core.")}
    with pytest.raises(ValueError, match="unrecognized head keys"):
        zoe_port.port_zoe_head({**head_sd, "mystery.module.weight": np.zeros(3)})
    del head_sd["attractors.2._net.0.bias"]
    with pytest.raises(KeyError, match="checkpoint missing"):
        zoe_port.port_zoe_head(head_sd)
    with pytest.raises(FileNotFoundError, match="ZoeDepth checkpoint not found"):
        zoe_port.load_zoe_checkpoint(str(tmp_path / "none.pt"), device="cpu")


def test_init_zoe_weights_stay_finite():
    """The seeded, damped weights chip_smoke.py runs at full width, here at
    the tiny one: finite, positive metric depth, the same for one seed."""
    outs = []
    for _ in range(2):
        model = dpt_beit.init_zoe_weights(dpt_beit.ZoeDepthDPT(
            n_bins=N_BINS, backbone_kwargs=BACKBONE, head_kwargs=HEADS_KW["single"]), seed=3)
        with torch.no_grad():
            img = torch.rand(1, 3, *NET_HW, generator=torch.Generator().manual_seed(0))
            outs.append(model(img))
    assert torch.isfinite(outs[0]).all() and (outs[0] > 0).all()
    assert torch.equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Three 40x56 PNG frames, seeded sparse MVS depth (half the pixels)."""
    root = tmp_path_factory.mktemp("zoe_scene")
    rng = np.random.default_rng(0)
    rgb_dir, mvs_dir = root / "rgbs", root / "mvs"
    rgb_dir.mkdir()
    mvs_dir.mkdir()
    true_depth = rng.uniform(2.0, 6.0, FRAME_HW).astype(np.float32)
    for i in range(3):
        write_png(rgb_dir / f"{i:05d}.png", rng.integers(0, 255, FRAME_HW + (3,)).astype(np.uint8))
        sparse = np.where(rng.uniform(size=FRAME_HW) > 0.5, true_depth, 0.0)
        np.savez(mvs_dir / f"{i:05d}.npz", depth=sparse)
    return root


def _jax_depth_fn(compiled, jparams, variant):
    model = _jax_model(variant)

    def net(x):
        apply = _compiled(compiled, variant, model, jparams[variant], x)
        return np.asarray(apply(jparams[variant], x))

    return lambda img: jinfer.zoe_infer(net, img, net_hw=NET_HW)


def _assert_npz_close(got_dir, ref_dir, exact=False):
    ref_files = sorted(p.name for p in ref_dir.glob("*.npz"))
    assert sorted(p.name for p in got_dir.glob("*.npz")) == ref_files and len(ref_files) == 3
    for name in ref_files:
        ref, got = np.load(ref_dir / name), np.load(got_dir / name)
        assert set(got.files) == set(ref.files), name
        for key in ref.files:
            assert got[key].shape == ref[key].shape and got[key].dtype == ref[key].dtype, key
            if exact:
                np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{name}:{key}")
        if not exact:
            _close(got["depth_pred"], ref["depth_pred"], err_msg=name)


def test_compute_scene_zoe_matches_jax(scene, jparams, models, compiled, tmp_path):
    """Through the network (depth_fn) on both packages, then through
    --pred-dir from the same predictions. With these random weights the
    predicted depth varies by ~0.1 % across a frame, so float32 noise of
    1e-7 moves the disparity scale (and which pixels the 80 % trim keeps)
    by far more than it moves the depth: the network run's scalars are
    held to JAX's ``align_video`` of the port's own predictions; the
    --pred-dir run's, to JAX's files bit for bit."""
    n_ref = j_compute_scene_zoe(scene / "rgbs", scene / "mvs", tmp_path / "jax", zoe_type="nk",
                                depth_fn=_jax_depth_fn(compiled, jparams, "nk"))

    def depth_fn(img):
        with torch.no_grad():
            return zoe_infer.zoe_infer(models["nk"], torch.from_numpy(img), net_hw=NET_HW)

    n = compute_zoedepth.compute_scene_zoe(scene / "rgbs", scene / "mvs", tmp_path / "port",
                                           zoe_type="nk", depth_fn=depth_fn)
    assert n == n_ref == 3
    got_dir = tmp_path / "port" / "zoe_depths_nk"
    _assert_npz_close(got_dir, tmp_path / "jax" / "zoe_depths_nk")
    preds = [np.load(got_dir / f"{i:05d}.npz")["depth_pred"] for i in range(3)]
    mvs = [np.load(scene / "mvs" / f"{i:05d}.npz")["depth"].astype(np.float32) for i in range(3)]
    infos = j_align_video([p[m > 0] for p, m in zip(preds, mvs)], [m[m > 0] for m in mvs])
    for i, info in enumerate(infos):
        got = np.load(got_dir / f"{i:05d}.npz")
        for key, val in info.items():
            np.testing.assert_allclose(got[key], val, rtol=1e-4, atol=0, err_msg=f"{i}:{key}")

    pred_dir = tmp_path / "pred"
    pred_dir.mkdir()
    for f in sorted((tmp_path / "jax" / "zoe_depths_nk").glob("*.npz")):
        np.savez(pred_dir / f.name, depth=np.load(f)["depth_pred"])
    j_compute_scene_zoe(scene / "rgbs", scene / "mvs", tmp_path / "jax_pred", pred_dir=pred_dir)
    compute_zoedepth.main(["--rgb-dir", str(scene / "rgbs"), "--mvs-depth-dir",
                           str(scene / "mvs"), "--save-dir", str(tmp_path / "port_pred"),
                           "--pred-dir", str(pred_dir)])
    _assert_npz_close(tmp_path / "port_pred" / "zoe_depths_n",
                      tmp_path / "jax_pred" / "zoe_depths_n", exact=True)


def test_cli_with_checkpoint_and_refusals(scene, ckpts, monkeypatch, tmp_path):
    """``--zoe-ckpt ... --device cpu`` writes what compute_scene_zoe writes
    with the same network under the reference protocol (net 384x512), bit
    for bit; without --pred-dir / --zoe-ckpt it refuses, with a missing
    checkpoint FileNotFoundError, and without --device on a machine with no
    card it fails instead of running on the CPU."""
    path = ckpts["single"][0]

    def tiny_model(ckpt, max_depth=10.0, device="cuda"):
        return _port_model(ckpt, "single").to(device)

    monkeypatch.setattr(zoe_port, "load_zoe_model", tiny_model)
    args = ["--rgb-dir", str(scene / "rgbs"), "--mvs-depth-dir", str(scene / "mvs")]
    compute_zoedepth.main(args + ["--save-dir", str(tmp_path / "cli"), "--zoe-ckpt", str(path),
                                  "--device", "cpu"])
    model = tiny_model(path, device="cpu")

    def depth_fn(img):
        with torch.no_grad():
            return zoe_infer.zoe_infer(model, torch.from_numpy(img), net_hw=(384, 512))

    compute_zoedepth.compute_scene_zoe(scene / "rgbs", scene / "mvs", tmp_path / "direct",
                                       depth_fn=depth_fn)
    _assert_npz_close(tmp_path / "cli" / "zoe_depths_n", tmp_path / "direct" / "zoe_depths_n",
                      exact=True)

    with pytest.raises(SystemExit):
        compute_zoedepth.main(args + ["--save-dir", str(tmp_path / "none")])
    with pytest.raises(FileNotFoundError, match="ZoeDepth checkpoint not found"):
        compute_zoedepth.main(args + ["--save-dir", str(tmp_path / "none"), "--zoe-ckpt",
                                      str(tmp_path / "missing.pt"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            compute_zoedepth.main(args + ["--save-dir", str(tmp_path / "nocard"), "--zoe-ckpt",
                                          str(path)])
        assert not (tmp_path / "nocard" / "zoe_depths_n").exists() or not any(
            (tmp_path / "nocard" / "zoe_depths_n").iterdir())


def test_written_npz_round_trip_through_the_readers(scene, tmp_path):
    """compute_scene_zoe's files under ``<root>/zoe/<scene>/dense`` for the
    three variants (precomputed predictions: the synthetic disparity
    transform of tests/test_preprocess.py), read by the port's NVIDIA reader
    for every ZOE_PRINCIPLES key and "moe": equal to JAX's reader, and the
    alignment recovers the true depth."""
    true_depth = np.random.default_rng(0).uniform(2.0, 6.0, FRAME_HW).astype(np.float32)
    pred_dir = tmp_path / "pred"
    pred_dir.mkdir()
    for i in range(3):
        np.savez(pred_dir / f"{i:05d}.npz", depth=1.0 / (2.0 * (1.0 / true_depth) + 0.01 * (i + 1)))
    dense = tmp_path / "zoe" / "Balloon1" / "dense"
    for zt in ("n", "k", "nk"):
        compute_zoedepth.main(["--rgb-dir", str(scene / "rgbs"), "--mvs-depth-dir",
                               str(scene / "mvs"), "--save-dir", str(dense), "--pred-dir",
                               str(pred_dir), "--zoe-type", zt])
    z = np.load(dense / "zoe_depths_n" / "00001.npz")
    for key, (scale_k, shift_k) in ZOE_PRINCIPLES.items():
        assert {key, scale_k, shift_k} <= set(z.files)
    for mode in [f"n_{zp}" for zp in ZOE_PRINCIPLES] + ["moe"]:
        port = NvidiaEvalDataset(tmp_path, use_zoe_depth=mode, zoe_depth_data_path="zoe")
        ref = JNvidiaEvalDataset(str(tmp_path), use_zoe_depth=mode, zoe_depth_data_path="zoe")
        for i in range(3):
            got = port._read_depth("Balloon1", i, *FRAME_HW)
            np.testing.assert_array_equal(got, ref._read_depth("Balloon1", i, *FRAME_HW))
            assert np.isfinite(got).all()
            if mode.endswith("indiv"):
                assert np.abs(got - true_depth).max() < 0.2, mode
