"""The port's reference GNT checkpoint loader
(``pgdvs_tpu_torch.models.gnt.weight_port``) against the JAX package's
``port_feature_net`` / ``port_gnt``.

A fake checkpoint in the reference layout (``{"feature_net",
"net_coarse", "net_fine", "optimizer"}``; the state dicts are made as
tests/test_weight_port.py makes them, the weights drawn at fan-in scale so that the
forwards stay in range) is saved to a temporary ``.pth`` and loaded by the
port; the ResUNet and GNT forwards then equal the JAX package's flax
forwards on its port of the same state dicts, at the bounds of
tests/test_torch_port_models.py (1e-4, float32 on both sides). A key the
modules hold and the checkpoint lacks raises, naming it; ``net_fine``,
optimizer state and extra keys are ignored; no file gives None.
"""

import jax
import numpy as np
import pytest
import torch

from pgdvs_tpu.models.gnt.feature_net import ResUNet as JResUNet
from pgdvs_tpu.models.gnt.network import GNT as JGNT
from pgdvs_tpu.models.gnt.weight_port import port_feature_net, port_gnt
from pgdvs_tpu_torch.models.gnt import weight_port as wp

ATOL = 1e-4


def _add_fn(sd, rng):
    def add(name, *shape):
        if name.endswith("bias"):
            v = rng.normal(0, 0.1, shape)
        elif len(shape) == 1:  # a norm's scale
            v = 1.0 + rng.normal(0, 0.1, shape)
        else:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        sd[name] = v.astype(np.float32)

    return add


def _fake_resunet_sd():
    sd = {}
    add = _add_fn(sd, np.random.default_rng(0))
    add("conv1.weight", 64, 3, 7, 7)
    add("bn1.weight", 64)
    add("bn1.bias", 64)
    specs = {"layer1": (64, 64, 3), "layer2": (128, 64, 4), "layer3": (256, 128, 6)}
    for layer, (planes, in_ch, n) in specs.items():
        for i in range(n):
            cin = in_ch if i == 0 else planes
            t = f"{layer}.{i}"
            add(f"{t}.conv1.weight", planes, cin, 3, 3)
            add(f"{t}.bn1.weight", planes)
            add(f"{t}.bn1.bias", planes)
            add(f"{t}.conv2.weight", planes, planes, 3, 3)
            add(f"{t}.bn2.weight", planes)
            add(f"{t}.bn2.bias", planes)
            if i == 0:
                add(f"{t}.downsample.0.weight", planes, cin, 1, 1)
                add(f"{t}.downsample.1.weight", planes)
                add(f"{t}.downsample.1.bias", planes)
    for name, cout, cin in (
        ("upconv3.conv", 128, 256),
        ("iconv3", 128, 256),
        ("upconv2.conv", 64, 128),
        ("iconv2", 32, 128),
    ):
        add(f"{name}.conv.weight", cout, cin, 3, 3)
        add(f"{name}.conv.bias", cout)
        add(f"{name}.bn.weight", cout)
        add(f"{name}.bn.bias", cout)
    add("out_conv.weight", 32, 32, 1, 1)
    add("out_conv.bias", 32)
    return sd


def _fake_gnt_sd(depth=8, w=64, feat=32, seed=1):
    sd = {}
    add = _add_fn(sd, np.random.default_rng(seed))
    add("rgbfeat_fc.0.weight", w, feat + 3)
    add("rgbfeat_fc.0.bias", w)
    add("rgbfeat_fc.2.weight", w, w)
    add("rgbfeat_fc.2.bias", w)
    for i in range(depth):
        vt = f"view_crosstrans.{i}"
        for nm in ("attn_norm", "ff_norm"):
            add(f"{vt}.{nm}.weight", w)
            add(f"{vt}.{nm}.bias", w)
        for nm in ("q_fc", "k_fc", "v_fc"):
            add(f"{vt}.attn.{nm}.weight", w, w)
        add(f"{vt}.attn.pos_fc.0.weight", w // 8, 4)
        add(f"{vt}.attn.pos_fc.0.bias", w // 8)
        add(f"{vt}.attn.pos_fc.2.weight", w, w // 8)
        add(f"{vt}.attn.pos_fc.2.bias", w)
        add(f"{vt}.attn.attn_fc.0.weight", w // 8, w)
        add(f"{vt}.attn.attn_fc.0.bias", w // 8)
        add(f"{vt}.attn.attn_fc.2.weight", w, w // 8)
        add(f"{vt}.attn.attn_fc.2.bias", w)
        add(f"{vt}.attn.out_fc.weight", w, w)
        add(f"{vt}.attn.out_fc.bias", w)
        add(f"{vt}.ff.fc1.weight", 4 * w, w)
        add(f"{vt}.ff.fc1.bias", 4 * w)
        add(f"{vt}.ff.fc2.weight", w, 4 * w)
        add(f"{vt}.ff.fc2.bias", w)
        rt = f"view_selftrans.{i}"
        for nm in ("attn_norm", "ff_norm"):
            add(f"{rt}.{nm}.weight", w)
            add(f"{rt}.{nm}.bias", w)
        for nm in ("q_fc", "k_fc", "v_fc"):
            add(f"{rt}.attn.{nm}.weight", w, w)
        add(f"{rt}.attn.out_fc.weight", w, w)
        add(f"{rt}.attn.out_fc.bias", w)
        add(f"{rt}.ff.fc1.weight", 4 * w, w)
        add(f"{rt}.ff.fc1.bias", 4 * w)
        add(f"{rt}.ff.fc2.weight", w, 4 * w)
        add(f"{rt}.ff.fc2.bias", w)
        if i % 2 == 0:
            posenc = 3 + 3 * 2 * 10
            add(f"q_fcs.{i}.0.weight", w, w + 2 * posenc)
            add(f"q_fcs.{i}.0.bias", w)
            add(f"q_fcs.{i}.2.weight", w, w)
            add(f"q_fcs.{i}.2.bias", w)
    add("norm.weight", w)
    add("norm.bias", w)
    add("rgb_fc.weight", 3, w)
    add("rgb_fc.bias", 3)
    return sd


def _torch_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference-layout checkpoint with what the loader must ignore, and
    the JAX package's port of it."""
    fsd, gsd = _fake_resunet_sd(), _fake_gnt_sd()
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    torch.save({"feature_net": _torch_sd(fsd),
                "net_coarse": {**_torch_sd(gsd), "extra.weight": torch.zeros(3)},
                "net_fine": _torch_sd(_fake_gnt_sd(seed=5)),
                "optimizer": {"state": {}, "param_groups": [{"lr": 5e-4, "betas": (0.9, 0.999)}]}},
               path)
    return path, {"params": port_feature_net(fsd)}, {"params": port_gnt(gsd)}


def test_resunet_forward_matches_jax_port(ckpt):
    path, fparams, _ = ckpt
    fnet, _gnt = wp.load_gnt_checkpoint(str(path), device="cpu")
    assert not fnet.training
    x = np.random.default_rng(1).uniform(size=(1, 64, 80, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JResUNet().apply(fparams, x))
    with torch.no_grad():
        got = fnet(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 16, 20, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_gnt_forward_matches_jax_port(ckpt):
    path, _, gparams = ckpt
    _fnet, gnt = wp.load_gnt_checkpoint(str(path), device="cpu")
    rng = np.random.default_rng(2)
    r, s, v, f = 6, 16, 4, 32
    rgb_feat = rng.normal(size=(r, s, v, 3 + f)).astype(np.float32)
    ray_diff = rng.normal(size=(r, s, v, 4)).astype(np.float32)
    mask = (rng.uniform(size=(r, s, v, 1)) > 0.3).astype(np.float32)
    mask[0] = 0.0
    pts = rng.normal(size=(r, s, 3)).astype(np.float32)
    ray_d = rng.normal(size=(r, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = JGNT(dtype="float32", ret_view_std=False).apply(
            gparams, rgb_feat, ray_diff, mask, pts, ray_d)
    with torch.no_grad():
        got = gnt(*(torch.from_numpy(a) for a in (rgb_feat, ray_diff, mask, pts, ray_d)))
    assert float(np.abs(np.asarray(ref["rgb"])).max()) > 0.01
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]), atol=ATOL)
    np.testing.assert_allclose(got["weights"].numpy(), np.asarray(ref["weights"]), atol=ATOL)


def test_net_fine_and_extra_keys_are_ignored(ckpt):
    path, _, _ = ckpt
    _fnet, gnt = wp.load_gnt_checkpoint(str(path), device="cpu")
    ref = _fake_gnt_sd()
    for key, v in gnt.state_dict().items():
        assert np.array_equal(v.numpy(), ref[wp.reference_key(key)]), key
    assert wp.reference_key("q_fcs.3.2.weight") == "q_fcs.6.2.weight"
    assert wp.reference_key("view_crosstrans.3.ff.fc1.bias") == "view_crosstrans.3.ff.fc1.bias"


@pytest.mark.parametrize("drop", ["q_fcs.2.0.weight", "layer2.0.downsample.1.bias"])
def test_missing_key_raises_naming_it(tmp_path, drop):
    fsd, gsd = _torch_sd(_fake_resunet_sd()), _torch_sd(_fake_gnt_sd())
    (gsd if drop.startswith("q_fcs") else fsd).pop(drop)
    path = tmp_path / "bad.pth"
    torch.save({"feature_net": fsd, "net_coarse": gsd}, path)
    with pytest.raises(KeyError, match=drop.replace(".", r"\.")):
        wp.load_gnt_checkpoint(str(path), device="cpu")


def test_absent_checkpoint_gives_none(tmp_path, monkeypatch):
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(tmp_path))
    assert wp.load_gnt_checkpoint(device="cpu") is None
    assert wp.load_gnt_checkpoint(str(tmp_path / "absent.pth"), device="cpu") is None


def test_default_location_under_the_checkpoint_dir(ckpt, tmp_path, monkeypatch):
    path, _, _ = ckpt
    (tmp_path / "gnt").mkdir()
    (tmp_path / "gnt" / "model_720000.pth").write_bytes(path.read_bytes())
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(tmp_path))
    models = wp.load_gnt_checkpoint(device="cpu")
    ref = wp.load_gnt_checkpoint(str(path), device="cpu")
    for a, b in zip(models, ref):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)


def test_loader_defaults_to_the_card(ckpt):
    """An entry point runs on the card unless the caller asks for the CPU."""
    import inspect

    assert inspect.signature(wp.load_gnt_checkpoint).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            wp.load_gnt_checkpoint(str(ckpt[0]))
