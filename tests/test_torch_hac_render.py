"""Port parity: the HAC eval slice (weight carry, neural Gaussians, the
whole eval render, the image metrics and the soak scene) against the JAX
package, on small widths and 64x64 images.

Tolerances: elementwise float32 stages (context features, MLP heads,
neural Gaussians, metrics) rtol 1e-5, atol 1e-6; masks, bounds and the
scene's numpy arrays exact; a whole eval render against JAX's render_view
on its float32 XLA blend atol 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.cli import soak as jsoak
from gauspcc_tpu.data.cameras import Camera as JCamera
from gauspcc_tpu.models.hac import model as jhac
from gauspcc_tpu.models.hac import render as jrender
from gauspcc_tpu.render import raster as jraster
from gauspcc_tpu.utils import image as jimage
from gauspcc_tpu.utils.checkpoint import _path_str

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak as tsoak
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import pipeline as tpipeline
from gauspcc_tpu_torch.models.hac import render as trender
from gauspcc_tpu_torch.utils import image as timage

RTOL, ATOL = 1e-5, 1e-6
H = W = 64
SMALL = dict(feat_dim=16, n_offsets=4, voxel_size=0.05,
             resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
             log2_hashmap_size=13, log2_hashmap_size_2d=13)
JCFG = jhac.HACConfig(**SMALL)
TCFG = thac.HACConfig(**SMALL)


def _jax_state(seed=0):
    """A JAX HAC state with non-trivial anchors, as flat numpy arrays (the
    keys save_pytree writes) and as the JAX pytree."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((300, 3)) * 1.2 - 0.6).astype(np.float32)
    pts = jhac.voxelize_points(pts, JCFG.voxel_size, seed)
    state = jhac.init_state(jax.random.PRNGKey(seed), JCFG, pts)
    cap, k = state["valid"].shape[0], JCFG.n_offsets
    anchors = dict(state["anchors"])
    anchors["anchor_feat"] = jnp.asarray(
        rng.normal(0, 1.0, (cap, JCFG.feat_dim)).astype(np.float32))
    anchors["offset"] = jnp.asarray(
        rng.normal(0, 0.5, (cap, k, 3)).astype(np.float32))
    anchors["mask"] = jnp.asarray(
        rng.normal(0, 3.0, (cap, k, 1)).astype(np.float32))
    state = jhac.update_anchor_bound(dict(state, anchors=anchors))
    flat = {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}
    return state, flat


def _cameras(n=3):
    out = []
    for i in range(n):
        c = tsoak._orbit_camera(i, 0.7 + 2.0 * i, W, radius=2.5)
        jc = JCamera(uid=i, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy,
                     width=W, height=H)
        out.append((jc, c))
    return out


def test_state_from_numpy_carries_every_weight():
    state, flat = _jax_state()
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    assert set(convert.flatten(state)) == set(flat)
    nets = tstate["nets"]
    for name in convert.MLP_NAMES:
        for fc in ("fc0", "fc1"):
            np.testing.assert_array_equal(
                getattr(getattr(nets, name), fc).weight.detach().numpy(),
                flat[f"nets/{name}/{fc}/w"].T)
    np.testing.assert_array_equal(
        nets.tables.flat().detach().numpy(),
        np.asarray(jax.numpy.concatenate(
            [state["nets"]["tables"][k] for k in ("xyz", "xy", "xz", "yz")])))
    x = np.random.default_rng(1).normal(size=(20, TCFG.feat_dim + 4)).astype(np.float32)
    from gauspcc_tpu.core.nn import mlp2

    want = np.asarray(mlp2(state["nets"]["mlp_color"], jnp.asarray(x)))
    with torch.no_grad():
        got = nets.mlp_color(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # nested dicts are accepted as well as flat keys
    nested = jax.tree_util.tree_map(np.asarray, state)
    again = convert.state_from_numpy(nested, TCFG, device="cpu")
    np.testing.assert_array_equal(again["anchors"]["offset"].numpy(),
                                  tstate["anchors"]["offset"].numpy())
    with pytest.raises(KeyError):
        convert.state_from_numpy({k: v for k, v in flat.items()
                                  if k != "valid"}, TCFG, device="cpu")


def test_context_heads_match_jax():
    state, flat = _jax_state(1)
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    anchor = jhac.get_anchor(state, JCFG)
    want_feat = jhac.calc_interp_feat(state, JCFG, anchor)
    want = jhac.grid_mlp_split(state, JCFG, want_feat)
    with torch.no_grad():
        tanchor = thac.get_anchor(tstate, TCFG)
        np.testing.assert_array_equal(tanchor.numpy(), np.asarray(anchor))
        got_feat = thac.calc_interp_feat(tstate, TCFG, tanchor)
        got = thac.grid_mlp_split(tstate, TCFG, got_feat)
    np.testing.assert_allclose(got_feat.numpy(), np.asarray(want_feat),
                               rtol=RTOL, atol=ATOL)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("decoded", [False, True])
def test_neural_gaussians_match_jax(decoded):
    state, flat = _jax_state(2)
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    cap = flat["valid"].shape[0]
    vis = np.random.default_rng(3).random(cap) > 0.2
    center = np.array([0.3, -0.2, 2.5], np.float32)
    want, _ = jhac.generate_neural_gaussians(
        state, JCFG, jnp.asarray(center), jnp.asarray(vis), decoded=decoded)
    with torch.no_grad():
        got = thac.generate_neural_gaussians(
            tstate, TCFG, torch.from_numpy(center), torch.from_numpy(vis),
            decoded=decoded)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for name in ("xyz", "color", "opacity", "scaling", "rot"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_update_anchor_bound_matches_jax():
    state, flat = _jax_state(4)
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    got = thac.update_anchor_bound(tstate)
    np.testing.assert_array_equal(got["x_bound_min"].numpy(), flat["x_bound_min"])
    np.testing.assert_array_equal(got["x_bound_max"].numpy(), flat["x_bound_max"])


def test_init_state_has_the_jax_layout():
    pts = np.random.default_rng(5).random((700, 3)).astype(np.float32)
    jstate = jhac.init_state(jax.random.PRNGKey(0), JCFG, pts)
    tstate = thac.init_state(TCFG, pts, np.random.default_rng(0), device="cpu")
    jflat = {_path_str(kp): np.asarray(v) for kp, v in
             jax.tree_util.tree_flatten_with_path(jstate)[0]}
    tflat = convert.flatten({k: v for k, v in tstate.items() if k != "nets"})
    for key, arr in jflat.items():
        if not key.startswith("nets/"):  # nets: own seeded initialiser
            np.testing.assert_array_equal(tflat[key], arr, err_msg=key)
    carried = convert.state_from_numpy(jflat, TCFG, device="cpu")
    for (n1, p1), (n2, p2) in zip(tstate["nets"].named_parameters(),
                                  carried["nets"].named_parameters()):
        assert n1 == n2 and p1.shape == p2.shape


@pytest.mark.parametrize("decoded", [False, True])
def test_eval_render_matches_jax(decoded):
    state, flat = _jax_state(6)
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    bg = np.ones(3, np.float32)
    for jc, tc in _cameras(2):
        jr = jraster.RasterConfig(H, W, jc.tanfovx, jc.tanfovy,
                                  max_tiles_per_gaussian=16,
                                  max_gaussians_per_tile=128, blend_bf16=False)
        want = jrender.render_view(
            state, JCFG, jrender.CameraArrays.from_camera(jc), jr,
            jnp.asarray(bg), decoded=decoded)["render"]
        tr = tpipeline._raster_cfg(tc, 128, 16)
        got = trender.render_image(
            tstate, TCFG, trender.CameraArrays.from_camera(tc, "cpu"), tr,
            torch.from_numpy(bg), decoded=decoded)
        assert got.shape == (3, H, W)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(7)
    a = rng.random((3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(timage.psnr(ta, tb)),
                               float(jimage.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL)
    np.testing.assert_allclose(float(timage.ssim(ta, tb)),
                               float(jimage.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL, atol=ATOL)


def test_build_scene_matches_jax(monkeypatch):
    """Same seed -> the same cameras and seed points; ground truth rendered
    by the port against JAX's float32 blend (JAX's build_scene uses bf16
    blend operands by default, so that default is switched off here)."""
    jcfg_cls = jraster.RasterConfig
    monkeypatch.setattr(jraster, "RasterConfig",
                        lambda *a, **k: jcfg_cls(*a, blend_bf16=False, **k))
    want = jsoak.build_scene(np.random.default_rng(11), 48, 200, 8, 500,
                             kind="textured", white_background=True)
    got = tsoak.build_scene(np.random.default_rng(11), 48, 200, 8, 500,
                            white_background=True, device="cpu")
    np.testing.assert_array_equal(got.points, want.points)
    assert got.cameras_extent == want.cameras_extent
    assert len(got.test_cameras) == len(want.test_cameras) == 1
    for g, w in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        np.testing.assert_array_equal(g.world_view_transform,
                                      w.world_view_transform)
        np.testing.assert_allclose(g.image, w.image, rtol=0, atol=1e-4)


def test_evaluate_on_cpu_scores_the_held_out_views():
    scene = tsoak.build_scene(np.random.default_rng(0), 48, 200, 9, 800,
                              device="cpu")
    pts = thac.voxelize_points(scene.points, TCFG.voxel_size, 0)
    state = thac.update_anchor_bound(
        thac.init_state(TCFG, pts, np.random.default_rng(0), device="cpu"))
    res = tpipeline.evaluate(state, TCFG, scene.test_cameras, max_k=128,
                             white_background=True)
    assert len(res["renders"]) == len(scene.test_cameras) == 2
    assert res["eval_k"] == 128 and res["eval_d"] in (4, 8, 16, 32, 64, 128)
    for i, (cam, img) in enumerate(zip(scene.test_cameras, res["renders"])):
        assert img.shape == (3, 48, 48) and bool(torch.isfinite(img).all())
        want = float(jimage.psnr(jnp.asarray(img.numpy()), jnp.asarray(cam.image)))
        np.testing.assert_allclose(res["per_view"][f"{i:05d}"]["psnr"], want,
                                   rtol=RTOL)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Called without `device` on a machine with no GPU, an entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, flat = _jax_state()
    pts = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    cam = _cameras(1)[0][1]
    calls = [
        lambda: thac.init_state(TCFG, pts, np.random.default_rng(0)),
        lambda: convert.state_from_numpy(flat, TCFG),
        lambda: tsoak.build_scene(np.random.default_rng(0), 32, 50, 2, 50),
        lambda: trender.CameraArrays.from_camera(cam),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
