"""Port parity: the differentiable rasterizer and the HAC training objective
(gauspcc_tpu_torch.render.raster.rasterize, models.hac.render.training_loss)
against jax.grad of the JAX package's, at the tiny sizes of
__graft_entry__ (_SMALL widths, 32x32, K 64), with blend_bf16=False on the
JAX side (the port blends in float32).

The noise of phases 1 and 2 is JAX's own: the test draws it from the same
key as model.py:364-368 does (split(key, 3), then uniform) and hands the
draws to the port.

Tolerances, stated per quantity: the loss rtol 1e-5; each gradient leaf
atol 2e-4 of the leaf's largest |gradient| plus rtol 1e-3. The gradients are
sums over every pixel of the image of float32 terms taken in another order
on each side (autodiff of the XLA blend against autograd of the port's, the
hash grid's scatter-add), and the MLP leaves sum them again over every
Gaussian."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.data.cameras import Camera as JCamera
from gauspcc_tpu.models.hac import model as jhac
from gauspcc_tpu.models.hac import render as jrender
from gauspcc_tpu.render import raster as jraster
from gauspcc_tpu.utils.checkpoint import _path_str

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak as tsoak
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import render as trender
from gauspcc_tpu_torch.models.hac import train as ttrain
from gauspcc_tpu_torch.render import raster as traster

HW = 32
SMALL = dict(feat_dim=16, n_offsets=4, voxel_size=0.05,
             resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
             log2_hashmap_size=13, log2_hashmap_size_2d=13)
JCFG = jhac.HACConfig(**SMALL)
TCFG = thac.HACConfig(**SMALL)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
LMBDA = 1e-3


def jax_state(seed=0, n_pts=300):
    """A JAX HAC state with non-trivial anchors (as __graft_entry__'s tiny
    scene, with features, offsets and masks drawn from a seed), and its
    flat numpy arrays."""
    rng = np.random.default_rng(seed)
    pts = jhac.voxelize_points(
        (rng.random((n_pts, 3)) * 1.2 - 0.6).astype(np.float32), JCFG.voxel_size)
    state = jhac.init_state(jax.random.PRNGKey(seed), JCFG, pts)
    cap, k = state["valid"].shape[0], JCFG.n_offsets
    anchors = dict(state["anchors"])
    anchors["anchor_feat"] = jnp.asarray(
        rng.normal(0, 0.5, (cap, JCFG.feat_dim)).astype(np.float32))
    anchors["offset"] = jnp.asarray(rng.normal(0, 0.3, (cap, k, 3)).astype(np.float32))
    anchors["mask"] = jnp.asarray(rng.normal(1, 2.0, (cap, k, 1)).astype(np.float32))
    state = jhac.update_anchor_bound(dict(state, anchors=anchors))
    flat = {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}
    return state, flat


def camera(seed=0):
    """A soak orbit camera at 32x32 with a seeded ground-truth image, as a
    JAX and a port CameraArrays (the port's with its image)."""
    c = tsoak._orbit_camera(0, 0.7, HW, radius=2.2)
    c.image = np.random.default_rng(seed).random((3, HW, HW)).astype(np.float32)
    jc = JCamera(uid=0, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy, width=HW,
                 height=HW, image=c.image)
    return (jrender.CameraArrays.from_camera(jc),
            trender.CameraArrays.from_camera(c, "cpu", with_image=True), c)


def raster_cfgs(cam):
    jr = jraster.RasterConfig(HW, HW, cam.tanfovx, cam.tanfovy,
                              max_gaussians_per_tile=64, blend_bf16=False)
    tr = traster.RasterConfig(HW, HW, cam.tanfovx, cam.tanfovy,
                              max_gaussians_per_tile=64)
    return jr, tr


def jax_noise(key, state, cfg):
    """The uniform draws generate_neural_gaussians makes from `key`."""
    k1, k2, k3 = jax.random.split(key, 3)
    cap = state["valid"].shape[0]
    return tuple(torch.from_numpy(np.array(jax.random.uniform(kk, shape, jnp.float32)))
                 for kk, shape in ((k1, (cap, cfg.feat_dim)), (k2, (cap, 6)),
                                   (k3, (cap, cfg.n_offsets, 3))))


def jax_leaf(tree, name):
    """The JAX leaf of a port leaf name, in the port's layout ([out, in]
    weights)."""
    keys = name.split("/")
    if keys[0] == "nets" and keys[1] != "tables":
        _, net, fc, which = keys
        arr = np.asarray(tree["nets"][net][fc]["w" if which == "weight" else "b"])
        return arr.T if which == "weight" else arr
    node = tree
    for k in keys:
        node = node[k]
    return np.asarray(node)


def assert_grads_close(got: dict, want_tree, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    for name, g in got.items():
        want = jax_leaf(want_tree, name)
        g = g.detach().numpy()
        assert g.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g, want, rtol=rtol, atol=atol * scale,
                                   err_msg=name)


def test_rasterize_gradients_match_jax():
    """Gradients of a weighted image sum with respect to means3d, colors,
    opacities, scales, rotations and means2d_extra."""
    rng = np.random.default_rng(0)
    n = 200
    means = (rng.random((n, 3)) * 1.4 - 0.7).astype(np.float32)
    means[:, 2] += 3.0
    arrays = dict(
        means3d=means, colors=rng.random((n, 3)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32),
        scales=rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        means2d_extra=np.zeros((n, 2), np.float32))
    weight = rng.normal(size=(3, HW, 48)).astype(np.float32)
    jr = jraster.RasterConfig(HW, 48, 0.45, 0.35, max_gaussians_per_tile=64,
                              blend_bf16=False)
    tr = traster.RasterConfig(HW, 48, 0.45, 0.35, max_gaussians_per_tile=64)
    vm = np.eye(4, dtype=np.float32)
    bg = np.array([1.0, 0.5, 0.0], np.float32)

    def jf(a):
        img, _ = jraster.rasterize(viewmatrix=jnp.asarray(vm),
                                   bg_color=jnp.asarray(bg), cfg=jr, **a)
        return jnp.sum(img * weight)

    want = jax.grad(jf)({k: jnp.asarray(v) for k, v in arrays.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in arrays.items()}
    img, _ = traster.rasterize(viewmatrix=torch.from_numpy(vm),
                               bg_color=torch.from_numpy(bg), cfg=tr, **leaves)
    got = torch.autograd.grad((img * torch.from_numpy(weight)).sum(),
                              list(leaves.values()))
    for (name, g) in zip(arrays, got):
        w = np.asarray(want[name])
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_training_loss_and_every_gradient_match_jax(phase):
    state, flat = jax_state(phase)
    jcam, tcam, cam = camera(phase)
    jr, tr = raster_cfgs(cam)
    key = jax.random.PRNGKey(10 + phase)
    bg = np.ones(3, np.float32)
    params, rest = jhac.split_state(state)
    m2d = jnp.zeros((rest["valid"].shape[0] * JCFG.n_offsets, 2))
    (want_loss, want_aux), (want_g, want_m2d) = jax.value_and_grad(
        jrender.training_loss, argnums=(0, 8), has_aux=True)(
        params, rest, JCFG, jcam, jr, jnp.asarray(bg), phase, key, m2d, LMBDA)

    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tm2d = torch.zeros(tuple(m2d.shape), requires_grad=True)
    loss, aux = trender.training_loss(
        tparams, trest, TCFG, tcam, tr, torch.from_numpy(bg), phase,
        jax_noise(key, state, JCFG), tm2d, LMBDA)
    got = torch.autograd.grad(loss, [*leaves.values(), tm2d], allow_unused=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for name in ("l1", "ssim", "psnr", "bit_per_param"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    if phase == 2:
        assert float(aux["bit_per_param"]) > 0
    grads = {n: g if g is not None else torch.zeros_like(t)
             for (n, t), g in zip(leaves.items(), got[:-1])}
    assert_grads_close(grads, want_g)
    scale = float(np.abs(np.asarray(want_m2d)).max())
    assert scale > 0
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want_m2d),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL * scale)
    for name in ("visible_anchor", "g_valid", "radii"):
        np.testing.assert_array_equal(aux[name].numpy(), np.asarray(want_aux[name]))
