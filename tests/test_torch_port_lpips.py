"""The port's LPIPS (``pgdvs_tpu_torch.metrics.lpips``) against the JAX
package's ``lpips_distance``.

Random AlexNet weights from a numpy seed (He-scaled normal convolutions and
biases) with the bundled v0.1 heads, carried into the port by
``lpips_params_from_jax``. Unmasked, masked (the mask resized to each layer
by torch's floor-nearest rule) and ``spatial`` (the map bilinearly resized
to the image) distances at 64x96 and at an odd 50x70, held to JAX's at 1e-5
relative. Then the loader: a fake torchvision-layout AlexNet state dict
saved to a temporary ``.pth`` loads to the parameters JAX's
``load_torch_weights`` builds from it, along the same search order; the
port's heads are the same bytes as the JAX package's.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgdvs_tpu.metrics import lpips_jax
from pgdvs_tpu_torch.metrics import lpips as tl

RTOL = 1e-5
JAX_HEADS = pathlib.Path(lpips_jax.__file__).parent / "weights" / "lpips_lin_alex_v0.1.pth"


def jax_lpips_params(seed=0):
    """The JAX package's LPIPS param dict (numpy): random convolutions from
    ``seed``, the bundled heads."""
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for i, (cout, k, _s, _p) in enumerate(tl._ALEX_CONVS):
        params[f"conv{i}_w"] = (rng.normal(size=(k, k, cin, cout))
                                * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.05, cout).astype(np.float32)
        cin = cout
    heads = torch.load(JAX_HEADS, map_location="cpu", weights_only=True)
    for k in range(5):
        params[f"lin{k}"] = heads[f"lin{k}.model.1.weight"].numpy().reshape(-1)
    return params


@pytest.fixture(scope="module")
def nets():
    params = jax_lpips_params()
    net = tl.LPIPS()
    net.load_state_dict(tl.lpips_params_from_jax(params))
    return {k: jnp.asarray(v) for k, v in params.items()}, net.eval()


def _inputs(h, w, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.15, a.shape), 0, 1).astype(np.float32)
    m = (rng.uniform(size=(h, w, 1)) > 0.4).astype(np.float32)
    m[: h // 2, : w // 3] = 0.0
    return a, b, m


@pytest.mark.parametrize("hw", [(64, 96), (50, 70)])
@pytest.mark.parametrize("mode", ["plain", "masked", "spatial"])
def test_lpips_matches_jax(nets, hw, mode):
    jp, net = nets
    a, b, m = _inputs(*hw)
    kw = {"masked": dict(mask=m), "spatial": dict(spatial=True)}.get(mode, {})
    ref = np.asarray(lpips_jax.lpips_distance(
        jp, jnp.asarray(a), jnp.asarray(b),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}))
    got = tl.lpips_distance(net, torch.from_numpy(a), torch.from_numpy(b),
                            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                               for k, v in kw.items()}).numpy()
    assert got.shape == ref.shape == ((hw[0], hw[1], 1) if mode == "spatial" else ())
    assert float(np.min(ref)) > 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("hw,out", [((50, 70), (11, 16)), ((64, 96), (3, 5)),
                                    ((7, 9), (7, 9)), ((5, 6), (13, 17))])
def test_nearest_resize_floor_matches_jax(hw, out):
    rng = np.random.default_rng(2)
    m = rng.uniform(size=hw + (2,)).astype(np.float32)
    ref = np.asarray(lpips_jax._nearest_resize_torch(jnp.asarray(m)[None], *out))[0]
    got = tl.nearest_resize_floor(torch.from_numpy(m), *out).numpy()
    assert np.array_equal(got, ref)


def test_features_match_jax(nets):
    jp, net = nets
    a = _inputs(64, 96)[0]
    x = 2.0 * a - 1.0
    ref = lpips_jax.alexnet_features(jp, jnp.asarray(x)[None])
    with torch.no_grad():
        got = net.features(torch.from_numpy(x).permute(2, 0, 1)[None])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=RTOL, atol=1e-5 * float(np.abs(np.asarray(r)).max()))


def _fake_torchvision_alexnet(path, seed=7):
    """A torchvision ``alexnet`` state dict (features + classifier) of
    random weights from ``seed``, saved to ``path``."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for ti, (cout, k, _s, _p) in zip(tl.TORCHVISION_IDX, tl._ALEX_CONVS):
        sd[f"features.{ti}.weight"] = torch.from_numpy(
            rng.normal(0, 0.05, (cout, cin, k, k)).astype(np.float32))
        sd[f"features.{ti}.bias"] = torch.from_numpy(rng.normal(0, 0.05, cout).astype(np.float32))
        cin = cout
    sd["classifier.1.weight"] = torch.zeros(4, 9216)
    torch.save(sd, path)
    return path


def _same_params(net, params):
    state = tl.lpips_params_from_jax(params)
    got = net.state_dict()
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k


@pytest.fixture
def clean_env(monkeypatch, tmp_path):
    """No checkpoint directory and empty hub caches."""
    monkeypatch.delenv("PGDVS_CKPT_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    return tmp_path


def test_load_lpips_weights_explicit_path_matches_jax(clean_env):
    path = _fake_torchvision_alexnet(clean_env / "alex.pth")
    net = tl.load_lpips_weights(alexnet_path=str(path), device="cpu")
    params = lpips_jax.load_torch_weights(alexnet_path=str(path))
    assert net is not None and params is not None and not net.training
    _same_params(net, params)


def test_load_lpips_weights_search_order(clean_env, monkeypatch):
    """$PGDVS_CKPT_DIR/alexnet.pth, then the hub cache; heads from
    $PGDVS_CKPT_DIR before the bundled ones (lins.{k} keys accepted)."""
    ckpt = clean_env / "ckpts"
    ckpt.mkdir()
    _fake_torchvision_alexnet(ckpt / "alexnet.pth", seed=8)
    monkeypatch.setenv("PGDVS_CKPT_DIR", str(ckpt))
    _same_params(tl.load_lpips_weights(device="cpu"), lpips_jax.load_torch_weights())

    heads = torch.load(JAX_HEADS, map_location="cpu", weights_only=True)
    torch.save({k.replace("lin", "lins.", 1): 2.0 * v for k, v in heads.items()},
               ckpt / "lpips_alex_v0.1.pth")
    net, params = tl.load_lpips_weights(device="cpu"), lpips_jax.load_torch_weights()
    _same_params(net, params)
    assert torch.equal(net.lins[0], 2.0 * heads["lin0.model.1.weight"].reshape(-1))

    monkeypatch.delenv("PGDVS_CKPT_DIR")
    hub = clean_env / "home" / ".cache/torch/hub/checkpoints"
    hub.mkdir(parents=True)
    _fake_torchvision_alexnet(hub / "alexnet-owt-7be5be79.pth", seed=9)
    _same_params(tl.load_lpips_weights(device="cpu"), lpips_jax.load_torch_weights())


def test_load_lpips_weights_none_without_a_backbone(clean_env):
    assert tl.load_lpips_weights(device="cpu") is None
    assert lpips_jax.load_torch_weights() is None
    assert tl.load_lpips_weights(alexnet_path=str(clean_env / "absent.pth"), device="cpu") is None


def test_load_lpips_weights_none_with_incomplete_heads(clean_env):
    path = _fake_torchvision_alexnet(clean_env / "alex.pth")
    heads = torch.load(JAX_HEADS, map_location="cpu", weights_only=True)
    heads.pop("lin4.model.1.weight")
    torch.save(heads, clean_env / "heads.pth")
    assert tl.load_lpips_weights(str(path), str(clean_env / "heads.pth"), device="cpu") is None


def test_bundled_heads_are_the_jax_package_bytes():
    assert tl.BUNDLED_HEADS.read_bytes() == JAX_HEADS.read_bytes()
    assert tl.BUNDLED_HEADS.parent.parent.parent.name == "pgdvs_tpu_torch"
