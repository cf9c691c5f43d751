"""The port's trainer (``pgdvs_tpu_torch.engines.trainer``,
``parallel.sharded.make_train_step``) against the JAX package's, on the CPU.

The four cases of tests/test_trainer_sampling.py on the port's samplers,
then the samplers against JAX's for one seed: the same held-out view, pixel
indices and ground truth, rays within 1e-6, per-pixel depth ranges too.
One step of JAX's ``make_train_step`` (one CPU device, its gradients kept
as the optimizer's state) against the port's at 32x40, 3 sources, 8
samples, 64 rays: in float64 (``jax.enable_x64``) loss and every gradient
leaf within 1e-6; in float32 loss within 5e-5 relative and every gradient
leaf within 2e-2 of its largest entry, because the float32 step is
ill-conditioned: JAX's own float32 gradients lie up to 1.2e-2 of a leaf's
largest entry from their float64 value, and the port's float32 ones are
held nearer to that value than JAX's (``test_float32_step_is_nearer_float64
_than_jax_float32``); ``optax.sgd(1.0)`` against
``torch.optim.SGD(lr=1)``; two ``optax.adam`` steps against
``torch.optim.Adam``; the bf16 step (JAX's ``dtype="bfloat16"`` GNT, the
port's GNT under ``torch.autocast``) within 5e-2 relative loss. Then the
port alone: the loss falling over 6 epochs, checkpoint retention,
``modules_not_to_save`` and resume (as tests/test_engines.py:88-115 asks of
JAX), and ``run train --device cpu`` with ``--resume``.

The step batches come from ``sample_ray_batch_src`` with the rays whose
samples project within ``BORDER_PX`` of a source image's border replaced
by the view's next ray (``off_border``): the synthetic rig translates its
cameras along one axis, so a ray of the held-out view's first or last row
or column lands exactly on the border of every other view, where the
in-bounds test flips with the last bit of the projection (``ROADMAP.md``
F2: XLA and torch round K @ w2c @ x differently). ``test_border_flips_are
_f2`` shows that every mask disagreement of the unreplaced batch lies there.
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from pgdvs_tpu.data.synthetic import make_contract_data as j_make_contract_data
from pgdvs_tpu.engines import trainer as jtr
from pgdvs_tpu.models.gnt.projector import epipolar_sample as j_epipolar_sample
from pgdvs_tpu.parallel.mesh import make_mesh as j_make_mesh
from pgdvs_tpu.parallel.sharded import make_train_step as j_make_train_step
from pgdvs_tpu.renderers.config import RenderConfig as JRenderConfig
from pgdvs_tpu.renderers.static_gnt import init_gnt_params, make_gnt_models
from pgdvs_tpu_torch import run as trun
from pgdvs_tpu_torch.core import cameras, sampling
from pgdvs_tpu_torch.data.synthetic import make_contract_data
from pgdvs_tpu_torch.engines import trainer as ttr
from pgdvs_tpu_torch.engines.checkpoint import list_checkpoints, restore_checkpoint
from pgdvs_tpu_torch.models.gnt.params_from_jax import gnt_state_dict, resunet_state_dict
from pgdvs_tpu_torch.models.gnt.projector import epipolar_sample
from pgdvs_tpu_torch.parallel.mesh import make_mesh
from pgdvs_tpu_torch.parallel.sharded import make_train_step
from pgdvs_tpu_torch.renderers.config import RenderConfig
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models
from test_torch_port_lk import one_thread

H, W, N_SRC, S, N_RAYS = 32, 40, 3, 8, 64
RAY_TOL = 1e-6
X64_RTOL = 1e-6
# float32, port against JAX. Measured on the test's batch (train_batch()):
# loss 1.2e-5 relative apart, gradients up to 1.2e-2 of a leaf's largest
# entry apart, and on the batches of seeds 9 / 11 2.5e-5 / 2.0e-5 and
# 1.1e-2 / 0.28 (an InstanceNorm-fed ResUNet leaf of seed 11, whose JAX
# float32 gradient is that far from its float64 one)
LOSS_RTOL = 5e-5
GRAD_TOL = 2e-2           # of each leaf's largest entry
# float32 against float64, the test's batch. Measured: the port's loss
# 1.1e-5 relative and its gradients up to 4.6e-3 of a leaf's largest entry
# from JAX's float64 step; JAX's float32 loss 2.2e-5 and gradients up to
# 1.2e-2 from it
F64_LOSS_RTOL = 2e-5
F64_GRAD_TOL = 1e-2
BF16_LOSS_RTOL = 5e-2
BORDER_PX = 1e-3
ADAM_LR = 1e-5
ADAM_TOL = 0.05           # of the learning rate


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


# --- the samplers ---------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return make_contract_data(h=16, w=20, n_spatial=4, n_frames=6)


def test_port_contract_equals_jax(data):
    ref = j_make_contract_data(h=16, w=20, n_spatial=4, n_frames=6)
    assert sorted(data) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(data[k], v, err_msg=k)


def test_src_sampler_never_touches_target(data):
    """train_on='src' must not read the held-out eval pixels: its target is
    one of the source views and rgb_gt comes from that view's image."""
    rng = np.random.default_rng(0)
    poisoned = dict(data)
    poisoned["rgb_tgt"] = np.full_like(np.asarray(data["rgb_tgt"]), -7.0)
    b = ttr.sample_ray_batch_src(rng, poisoned, n_rays=64)
    assert (b["rgb_gt"] != -7.0).all()
    src = np.asarray(data["flat_cam_src_spatial"])
    matches = [i for i in range(src.shape[0]) if np.allclose(b["tgt_cam"], src[i])]
    assert len(matches) == 1
    assert b["src_cams"].shape[0] == src.shape[0] - 1
    assert not any(np.allclose(b["tgt_cam"], c) for c in b["src_cams"])
    view = np.asarray(data["rgb_src_spatial"])[matches[0]].reshape(-1, 3)
    assert all((view == px).all(1).any() for px in np.asarray(b["rgb_gt"]))


def test_src_sampler_prefers_static_pixels(data):
    """With a dyn mask present, rays are drawn from static pixels only."""
    rng = np.random.default_rng(1)
    masks = np.asarray(data["dyn_mask_src_spatial"])
    assert masks.max() > 0
    b = ttr.sample_ray_batch_src(rng, data, n_rays=32)
    src = np.asarray(data["flat_cam_src_spatial"])
    j = next(i for i in range(src.shape[0]) if np.allclose(b["tgt_cam"], src[i]))
    view = np.asarray(data["rgb_src_spatial"])[j].reshape(-1, 3)
    dyn_px, static_px = view[masks[j].reshape(-1) > 0], view[masks[j].reshape(-1) == 0]
    for px in np.asarray(b["rgb_gt"]):
        assert (not (np.abs(dyn_px - px) < 1e-6).all(1).any()
                or (np.abs(static_px - px) < 1e-6).all(1).any())


def test_tgt_sampler_layout(data):
    b = ttr.sample_ray_batch(np.random.default_rng(2), data, n_rays=48)
    assert b["rays_o"].shape == (48, 3) and b["rays_d"].shape == (48, 3)
    assert b["depth_range"].shape == (48, 2)
    assert (b["depth_range"][:, 1] > b["depth_range"][:, 0]).all()
    np.testing.assert_allclose(b["tgt_cam"], np.asarray(data["flat_cam_tgt"]))


def test_src_sampler_needs_two_views(data):
    one = dict(data)
    one["flat_cam_src_spatial"] = np.asarray(data["flat_cam_src_spatial"])[:1]
    one["rgb_src_spatial"] = np.asarray(data["rgb_src_spatial"])[:1]
    with pytest.raises(ValueError):
        ttr.sample_ray_batch_src(np.random.default_rng(0), one, n_rays=8)


@pytest.mark.parametrize("sampler", ["sample_ray_batch_src", "sample_ray_batch"])
@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_samplers_equal_jax(data, sampler, per_pixel, seed):
    d = dict(data)
    if per_pixel:  # a DyCheck-style [H, W, 2] range
        near = np.random.default_rng(3).uniform(0.5, 1.0, (16, 20, 1)).astype(np.float32)
        d["depth_range"] = np.concatenate([near, near + 3.0], -1)
    got = getattr(ttr, sampler)(np.random.default_rng(seed), d, 96)
    want = getattr(jtr, sampler)(np.random.default_rng(seed), d, 96)
    assert sorted(got) == sorted(want)
    for k in want:
        if k in ("rays_o", "rays_d"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=RAY_TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# --- one step against JAX's -------------------------------------------------------------

def _near_border(view: dict) -> np.ndarray:
    """[R] bool: a sample of the ray projects within BORDER_PX of a source
    image's border (x = 0 or W-1, y = 0 or H-1), in float64."""
    t = {k: torch.from_numpy(np.asarray(view[k])) for k in ("rays_o", "rays_d", "depth_range",
                                                            "src_cams")}
    pts, _ = sampling.sample_along_rays(t["rays_o"], t["rays_d"], t["depth_range"], S,
                                        inv_uniform=True)
    proj = cameras.flat_cam_projection(t["src_cams"].double())
    uv, _, _ = cameras.project_with(proj[:, None, None], pts.double()[None])
    h, w = np.asarray(view["src_rgbs"]).shape[1:3]
    d = torch.stack([uv[..., 0].abs(), (uv[..., 0] - (w - 1)).abs(), uv[..., 1].abs(),
                     (uv[..., 1] - (h - 1)).abs()]).amin(0)
    return (d < BORDER_PX).any(0).any(-1).numpy()


def off_border(view: dict) -> dict:
    """``view`` with each ray near a border (``_near_border``) replaced by
    the next ray of the view that is not."""
    near = _near_border(view)
    good = np.flatnonzero(~near)
    assert near.sum() <= len(near) // 4, near.sum()
    out = dict(view)
    for k in ("rays_o", "rays_d", "depth_range", "rgb_gt"):
        out[k] = np.array(view[k])
        out[k][near] = out[k][good[np.searchsorted(good, np.flatnonzero(near)) % len(good)]]
    return out


def train_batch(n_views=1, seed=5, border=False):
    """``n_views`` held-out source views of 64 rays from 32x40 scenes with 3
    sources (the port's sampler), stacked."""
    rng = np.random.default_rng(seed)
    items = [make_contract_data(h=H, w=W, n_spatial=N_SRC, n_frames=6, tgt_time=t)
             for t in (0.5, 0.35)[:n_views]]
    views = [ttr.sample_ray_batch_src(rng, d, N_RAYS) for d in items]
    if not border:
        views = [off_border(v) for v in views]
    return {k: np.stack([v[k] for v in views]) for k in views[0]}


def grad_catcher():
    """An optax transformation whose state is the last gradients (and whose
    update is zero), so JAX's step returns its gradients exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def state_dicts(tree) -> dict:
    """A flax {feature_net, gnt} tree as the port's {module.name: array}."""
    sd = {f"feature_net.{k}": v.numpy()
          for k, v in resunet_state_dict(tree["feature_net"]).items()}
    sd.update({f"gnt.{k}": v.numpy() for k, v in gnt_state_dict(tree["gnt"]).items()})
    return sd


def port_models(sd: dict):
    fnet, gnt = init_gnt_models(seed=0, device="cpu")
    for name, m in (("feature_net", fnet), ("gnt", gnt)):
        m.load_state_dict({k[len(name) + 1:]: torch.from_numpy(v) for k, v in sd.items()
                           if k.startswith(name + ".")})
    return fnet, gnt


def named(models) -> dict:
    return {f"{name}.{k}": p for name, m in zip(("feature_net", "gnt"), models)
            for k, p in m.named_parameters()}


def jax_cfg():
    return JRenderConfig(n_coarse_samples_per_ray=S, ray_tile=320, knn_tile=256)


def port_cfg():
    return RenderConfig(n_coarse_samples_per_ray=S, ray_tile=320)


def init_jax_params():
    """The JAX package's weights from PRNGKey(0) (its initialiser, jitted)."""
    models = make_gnt_models()
    return jax.jit(lambda k: init_gnt_params(k, *models, n_src=N_SRC))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_params():
    return init_jax_params()


def _jax_step(dtype, params):
    """JAX's step on one CPU device, its GNT in ``dtype`` (float64 with its
    parameters and batches under ``jax.enable_x64``): (params, fn(params,
    batch) -> (loss, gradients as a numpy tree))."""
    x64 = dtype == "float64"
    with jax.enable_x64(x64):
        models = make_gnt_models(dtype=dtype)
        if x64:
            params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
    catch = grad_catcher()
    mesh = j_make_mesh(n_devices=1)
    step, _ = j_make_train_step(mesh, models, jax_cfg(), catch, N_RAYS)

    def fn(p, batch):
        with jax.enable_x64(x64), mesh:
            _, g, loss = step(p, catch.init(p), {k: jnp.asarray(v.astype(np.float64) if x64
                                                                else v)
                                                  for k, v in batch.items()})
            return float(loss), jax.tree_util.tree_map(np.asarray, g)

    return params, fn


@pytest.fixture(scope="module")
def jax_step(jax_params):
    return _jax_step("float32", jax_params)


@pytest.fixture(scope="module")
def jax_step64(jax_params):
    return _jax_step("float64", jax_params)


@contextlib.contextmanager
def float64_port():
    """torch's default dtype float64 (the port's samplers make their
    sample depths and codes in it)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def port_step(params, batch, opt_cls=torch.optim.SGD, steps=1, dtype=torch.float32,
              record=False, **opt_kw):
    """The port's models from JAX's ``params`` after ``steps`` steps of
    ``make_train_step`` on ``batch`` (float64 models and batch where
    ``dtype`` is float64): (models, the last loss, or with ``record``
    every step's)."""
    models = port_models(state_dicts(jax.tree_util.tree_map(np.asarray, params)))
    if dtype == torch.float64:
        models = tuple(m.double() for m in models)
        batch = {k: v.astype(np.float64) for k, v in batch.items()}
    opt = opt_cls([p for m in models for p in m.parameters()], **({"lr": 1.0} | opt_kw))
    with float64_port() if dtype == torch.float64 else contextlib.nullcontext():
        step = make_train_step(make_mesh(device="cpu"), models, port_cfg(), opt, N_RAYS,
                               dtype=dtype)
        losses = [step(batch) for _ in range(steps)]
    return models, (losses if record else losses[-1])


def assert_grads(got: dict, want: dict, tol: float, floor: float, what=""):
    """Every leaf within ``tol`` of its largest entry, or of ``floor`` times
    the largest entry of every leaf where that is larger: the biases ahead
    of a softmax over views (``attn_fc.2``) and of an InstanceNorm have an
    exact gradient of 0 (both are shift-invariant), so their entries are
    rounding noise."""
    assert sorted(got) == sorted(want)
    top = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0, atol=tol * max(np.abs(g).max(), floor * top),
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def jax_steps(jax_step, jax_step64):
    """JAX's float32 and float64 steps on train_batch(): {dtype: (loss,
    gradients)}."""
    batch = train_batch()
    return {dt: fn(params, batch) for dt, (params, fn) in (("float32", jax_step),
                                                            ("float64", jax_step64))}


@pytest.fixture(scope="module")
def port_step32(jax_step):
    """The port's float32 SGD(lr=1) step from JAX's weights on
    train_batch(): (models, loss)."""
    return port_step(jax_step[0], train_batch())


def test_float64_step_equals_jax_x64(jax_step64, jax_steps):
    """The arithmetic: in float64 (JAX under jax.enable_x64) the port's
    step is JAX's to 1e-6."""
    params, _ = jax_step64
    loss, grads = jax_steps["float64"]
    models, got = port_step(params, train_batch(), dtype=torch.float64)
    assert got == pytest.approx(loss, rel=X64_RTOL)
    assert_grads({k: p.grad.numpy() for k, p in named(models).items()}, state_dicts(grads),
                 X64_RTOL, 1e-9, "grad")


def test_float32_step_equals_jax(jax_step, jax_steps, port_step32):
    params, _ = jax_step
    loss, grads = jax_steps["float32"]
    models, got = port_step32
    assert got == pytest.approx(loss, rel=LOSS_RTOL)
    assert_grads({k: p.grad.numpy() for k, p in named(models).items()}, state_dicts(grads),
                 GRAD_TOL, 1e-6, "grad")
    # torch.optim.SGD(lr=1) moved each parameter as optax.sgd(1.0) does
    upd, _ = optax.sgd(1.0).update(grads, optax.sgd(1.0).init(params), params)
    after = state_dicts(jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd)))
    sd = state_dicts(jax.tree_util.tree_map(np.asarray, params))
    assert_grads({k: sd[k] - p.detach().numpy() for k, p in named(models).items()},
                 {k: sd[k] - after[k] for k in sd}, GRAD_TOL, 1e-6, "sgd")


def test_float32_step_is_nearer_float64_than_jax_float32(jax_steps, port_step32):
    """The float32 step's conditioning, shown: JAX's float32 gradients lie
    more than 1e-3 of some leaf's largest entry from JAX's float64 ones (ten
    times the 1e-4 a port-to-JAX bound would need), and the port's float32
    step lies nearer to that float64 step than JAX's float32 step does, in
    the loss and in the worst leaf."""
    (loss32, g32), (loss64, g64) = jax_steps["float32"], jax_steps["float64"]
    models, got = port_step32
    g32, g64 = state_dicts(g32), state_dicts(g64)
    mine = {k: p.grad.numpy() for k, p in named(models).items()}
    assert got == pytest.approx(loss64, rel=F64_LOSS_RTOL)
    assert abs(got - loss64) < abs(loss32 - loss64)
    assert_grads(mine, g64, F64_GRAD_TOL, 1e-6, "port float32 against JAX float64")
    top = max(np.abs(g).max() for g in g64.values())

    def worst(g):
        return max(np.abs(g[k] - w).max() / max(np.abs(w).max(), 1e-6 * top)
                   for k, w in g64.items())

    assert worst(g32) > 1e-3
    assert worst(mine) < worst(g32)


def test_border_flips_are_f2():
    """With the border rays kept, the port's exact sampler and JAX's give
    the same masks except at samples within BORDER_PX of a border."""
    batch = train_batch(border=True)
    # the masks do not read the features
    feats = np.zeros((N_SRC - 1, H // 4, W // 4, 32), np.float32)
    t = {k: torch.from_numpy(np.array(batch[k][0])) for k in batch}
    pts, _ = sampling.sample_along_rays(t["rays_o"], t["rays_d"], t["depth_range"], S,
                                        inv_uniform=True)
    want = j_epipolar_sample(jnp.asarray(pts.numpy()), jnp.asarray(batch["tgt_cam"][0]),
                             jnp.asarray(batch["src_cams"][0]),
                             jnp.asarray(batch["src_rgbs"][0]), jnp.asarray(feats))["mask"]
    got = epipolar_sample(pts, t["tgt_cam"], t["src_cams"], t["src_rgbs"],
                          torch.from_numpy(np.array(feats)), out_dtype=torch.float32)["mask"]
    differ = got.movedim(0, 2).numpy() != (np.asarray(want)[..., 0] > 0)
    rays = np.flatnonzero(differ.any((1, 2)))
    assert len(rays) > 0  # the rig puts rays on the border
    assert _near_border({k: batch[k][0] for k in batch})[rays].all()


def test_adam_equals_optax_on_the_same_gradients():
    """``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999, eps
    1e-8), the Trainer's optimizer, moves every parameter as ``optax.adam``
    over two steps given the same two float64 gradients (seeded normals, a
    tenth of them near eps), on leaves of the GNT's and ResUNet's shapes."""
    rng = np.random.default_rng(4)
    shapes = {"dense": (64, 35), "conv": (3, 3, 32, 64), "bias": (64,), "scalar": (1,)}

    def draw(shape, scale):
        return rng.normal(size=shape) * np.where(rng.uniform(size=shape) < 0.1, 1e-8, scale)

    params = {k: draw(v, 0.1) for k, v in shapes.items()}
    grads = [{k: draw(v, 1e-2) for k, v in shapes.items()} for _ in range(2)]
    with jax.enable_x64(True):
        adam = optax.adam(1e-3)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = adam.init(p)
        for g in grads:
            upd, state = adam.update(jax.tree_util.tree_map(jnp.asarray, g), state, p)
            p = optax.apply_updates(p, upd)
    got = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = torch.optim.Adam(got.values(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        for k, v in g.items():
            got[k].grad = torch.from_numpy(v)
        opt.step()
    for k, v in p.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), rtol=0, atol=1e-12,
                                   err_msg=k)


def test_two_adam_steps_equal_optax(jax_step64):
    """Two train steps with ``optax.adam`` against ``torch.optim.Adam``, in
    float64, then the loss at the parameters they reach. The learning rate
    is 1e-5: Adam's first update moves every weight by about lr, and at
    1e-3 that throws the random network's loss from 0.35 to 4.7, where
    both steps' float32 parts decide the next gradient's signs. Each entry
    within ADAM_TOL lr (its first update is lr * sign(g) wherever |g| >>
    eps, so an entry whose gradient is rounding noise may land anywhere in
    it: measured 0.02 lr), the losses within 1e-6 relative."""
    params, fn = jax_step64
    batch = train_batch(seed=9)
    adam = optax.adam(ADAM_LR)
    losses = []
    with jax.enable_x64(True):
        state, p = adam.init(params), params
        for _ in range(2):
            loss, g = fn(p, batch)
            losses.append(loss)
            upd, state = adam.update(g, state, p)
            p = optax.apply_updates(p, upd)
        losses.append(fn(p, batch)[0])
        want = state_dicts(jax.tree_util.tree_map(np.asarray, p))
    models, _ = port_step(params, batch, torch.optim.Adam, steps=2, dtype=torch.float64,
                          lr=ADAM_LR, betas=(0.9, 0.999), eps=1e-8)
    for k, q in named(models).items():
        np.testing.assert_allclose(q.detach().numpy(), want[k], rtol=0, atol=ADAM_TOL * ADAM_LR,
                                   err_msg=k)
    got = port_step(params, batch, torch.optim.Adam, steps=3, dtype=torch.float64,
                    lr=ADAM_LR, betas=(0.9, 0.999), eps=1e-8, record=True)[1]
    assert got == pytest.approx(losses, rel=X64_RTOL)


def test_bf16_step_equals_jax_bf16(jax_step):
    params, _ = jax_step
    models = make_gnt_models(dtype="bfloat16")
    catch = grad_catcher()
    mesh = j_make_mesh(n_devices=1)
    step, _ = j_make_train_step(mesh, models, jax_cfg(), catch, N_RAYS)
    batch = train_batch(seed=11)
    with mesh:
        _, _, loss = step(params, catch.init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tm, got = port_step(params, batch, dtype=torch.bfloat16)
    assert got == pytest.approx(float(loss), rel=BF16_LOSS_RTOL)
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in named(tm).values())


# --- the trainer alone ------------------------------------------------------------------

def test_trainer_loss_falls_keeps_and_resumes(tmp_path):
    d = make_contract_data(h=H, w=W, n_spatial=N_SRC, n_frames=6)
    models = init_gnt_models(seed=0, device="cpu")
    tr = ttr.Trainer(models, port_cfg(), lr=1e-3, n_rays_per_view=N_RAYS,
                     ckpt_dir=str(tmp_path / "ckpts"), modules_not_to_save=("feature_net",),
                     n_ckpts_keep=3)
    losses = [tr.train_epoch([d, d], seed=i) for i in range(6)]
    assert np.isfinite(losses).all()
    # the photometric loss falls (averaged to damp step noise)
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    assert [(e, s) for e, s, _ in list_checkpoints(tmp_path / "ckpts")] == [(4, 8), (5, 10),
                                                                            (6, 12)]
    payload, _ = restore_checkpoint(tmp_path / "ckpts")
    assert sorted(payload["params"]) == ["gnt"]

    fresh = init_gnt_models(seed=1, device="cpu")
    before = {k: v.clone() for k, v in fresh[0].state_dict().items()}
    tr2 = ttr.Trainer(fresh, port_cfg(), lr=1e-3, n_rays_per_view=N_RAYS,
                      ckpt_dir=str(tmp_path / "ckpts"), modules_not_to_save=("feature_net",))
    tr2.resume()
    assert (tr2.epoch, tr2.step) == (6, 12)
    for k, v in models[1].state_dict().items():
        assert torch.equal(fresh[1].state_dict()[k], v), k
    # the unsaved module stays the live one
    for k, v in before.items():
        assert torch.equal(fresh[0].state_dict()[k], v), k
    st = tr2.optimizer.state_dict()["state"]
    assert st and all(int(s["step"]) == 12 for s in st.values())
    with pytest.raises(ValueError, match="checkpoint directory"):
        ttr.Trainer(fresh, port_cfg(), n_rays_per_view=N_RAYS).resume()
    with pytest.raises(ValueError, match="train_on"):
        ttr.Trainer(fresh, port_cfg(), train_on="both")


def _card_present(monkeypatch):
    """torch reporting one card, so that a mesh made without a device would
    land on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_trainer_mesh_follows_the_models_device(monkeypatch):
    """With a card present, a Trainer of CPU models lays its mesh on the
    CPU, and refuses a mesh on another device than its models'."""
    _card_present(monkeypatch)
    models = init_gnt_models(device="cpu")
    assert make_mesh().device == torch.device("cuda", 0)
    assert ttr.Trainer(models, port_cfg(), n_rays_per_view=8).mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="the mesh is on cuda:0, the models on cpu"):
        ttr.Trainer(models, port_cfg(), n_rays_per_view=8, mesh=make_mesh())


def test_trainer_cycles_the_dp_remainder(monkeypatch):
    """A step takes dp views; an epoch's remainder is cycled up to dp, in
    the JAX package's order (``trainer.py:238-245`` there)."""
    seen = []
    monkeypatch.setattr(ttr, "make_train_step", lambda *a, **k: (
        lambda batch: seen.append(batch["tgt_cam"].copy()) or 0.5))
    d = make_contract_data(h=16, w=20, n_spatial=3, n_frames=6)
    mesh = dataclasses.replace(make_mesh(device="cpu"), dp=2)
    tr = ttr.Trainer(init_gnt_models(device="cpu"), port_cfg(), n_rays_per_view=8, mesh=mesh)
    assert tr.train_epoch([d, d, d], seed=3) == 0.5 and tr.step == 2
    rng = np.random.default_rng(3)
    cams = [jtr.sample_ray_batch_src(rng, d, 8)["tgt_cam"] for _ in range(3)]
    np.testing.assert_array_equal(seen[0], np.stack(cams[:2]))
    np.testing.assert_array_equal(seen[1], np.stack([cams[2], cams[2]]))


# --- run train ------------------------------------------------------------------------

def test_run_train_and_resume(tmp_path, capsys):
    root = tmp_path / "scene"
    chip_smoke.write_reader_scene(root, raw_hw=(24, 32), eval_hw=(24, 32), n_frames=3,
                                  items=(), flow_frames=((0, 3),))
    out = tmp_path / "ft"
    argv = ["train", "--device", "cpu", "--data-root", str(root), "--scene-ids",
            chip_smoke.READER_SCENE, "--dataset-arg", "tgt_height=24", "n_src_views_spatial=2",
            "--out-dir", str(out), "--render-cfg", "n_coarse_samples_per_ray=8",
            "--n-rays", "32", "--gnt-dtype", "float32"]
    res = trun.main([*argv, "--epochs", "2"])
    assert res["epochs"] == 2 and res["steps"] == 6 and np.isfinite(res["final_epoch_loss"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    cfg = json.loads((out / "config.json").read_text())["render_cfg"]
    assert cfg["n_coarse_samples_per_ray"] == 8 and cfg["epipolar_mode"] == "exact"
    # resume: the saved config is the base, a new override wins
    res = trun.main([*argv[:-6], "--render-cfg", "ray_tile=64", "--n-rays", "32",
                     "--epochs", "2", "--resume", "--n-ckpts-keep", "3"])
    assert res["epochs"] == 4 and res["steps"] == 12
    cfg = json.loads((out / "config.json").read_text())["render_cfg"]
    assert (cfg["n_coarse_samples_per_ray"], cfg["ray_tile"]) == (8, 64)
    assert [(e, s) for e, s, _ in list_checkpoints(out)] == [(2, 6), (3, 9), (4, 12)]
    with pytest.raises(SystemExit, match="--resume needs --out-dir"):
        trun.main(["train", "--device", "cpu", "--resume"])


def test_run_train_device_cpu_with_a_card_present(tmp_path, monkeypatch):
    """``run train --device cpu`` keeps its batches on the CPU when a card
    is present."""
    _card_present(monkeypatch)
    root = tmp_path / "scene"
    chip_smoke.write_reader_scene(root, raw_hw=(24, 32), eval_hw=(24, 32), n_frames=3,
                                  items=(), flow_frames=((0, 3),))
    res = trun.main(["train", "--device", "cpu", "--data-root", str(root), "--scene-ids",
                     chip_smoke.READER_SCENE, "--dataset-arg", "tgt_height=24",
                     "n_src_views_spatial=2", "--render-cfg", "n_coarse_samples_per_ray=8",
                     "--n-rays", "16", "--max-items", "1"])
    assert res["steps"] == 1 and np.isfinite(res["final_epoch_loss"])
