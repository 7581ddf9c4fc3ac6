"""Port parity on trained weights: the round-5 HAC soak's state
(runs/soak_hac_r5/model.npz, tracked by git, 30,000 steps at the full
HACConfig width) through the port and through the JAX package, on the CPU.

Cut to keep the lane fast: the capacity to the 14,294 valid anchors (the
buffers' valid prefix; the padding renders nothing), and the images to
96x96 (the render) and 48x48 (the loss) from the r5 scene's first held-out
camera. The JAX side blends in float32 (blend_bf16=False).

Tolerances: the render atol 1e-4, as the eval parity test
(tests/test_torch_hac_render.py); the phase-2 loss rtol 1e-5 and every
gradient leaf atol 2e-4 of its largest |gradient| plus rtol 1e-3, as
tests/test_torch_train.py (float32 sums in another order on each side)."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.data.cameras import Camera as JCamera
from gauspcc_tpu.models.hac import model as jhac
from gauspcc_tpu.models.hac import render as jrender
from gauspcc_tpu.render import raster as jraster

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak as tsoak
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import render as trender
from gauspcc_tpu_torch.models.hac import train as ttrain
from gauspcc_tpu_torch.render import raster as traster

from test_torch_train import GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, assert_grads_close

MODEL = Path(__file__).resolve().parents[1] / "runs" / "soak_hac_r5" / "model.npz"
JCFG = jhac.HACConfig(voxel_size=0.01)
TCFG = thac.HACConfig(voxel_size=0.01)


@pytest.fixture(scope="module")
def r5():
    """(JAX state, flat numpy arrays), cut to the valid anchors."""
    if not MODEL.exists():
        pytest.skip(f"{MODEL.name} of the r5 soak is not in this checkout")
    with np.load(MODEL) as z:
        flat = {k: z[k] for k in z.files}
    n = int(flat["valid"].sum())
    assert flat["valid"][:n].all()
    for k in list(flat):
        if k.startswith("anchors/") or k == "valid":
            flat[k] = flat[k][:n]
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree, flat


def _camera(hw):
    """The r5 scene's first held-out camera (orbit view 0 of 24) at hw."""
    c = tsoak._orbit_camera(0, 0.0, hw, radius=3.5, height=0.9)
    jc = JCamera(uid=0, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy, width=hw,
                 height=hw)
    return jc, c


def test_trained_render_matches_jax(r5):
    state, flat = r5
    jc, tc = _camera(96)
    bg = np.ones(3, np.float32)
    jr = jraster.RasterConfig(96, 96, jc.tanfovx, jc.tanfovy,
                              max_tiles_per_gaussian=32,
                              max_gaussians_per_tile=1024, tile_chunk=12,
                              blend_bf16=False)
    want = np.asarray(jrender.render_view(
        state, JCFG, jrender.CameraArrays.from_camera(jc), jr,
        jnp.asarray(bg))["render"])
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    tr = traster.RasterConfig(96, 96, tc.tanfovx, tc.tanfovy,
                              max_tiles_per_gaussian=32,
                              max_gaussians_per_tile=1024)
    got = trender.render_image(tstate, TCFG,
                               trender.CameraArrays.from_camera(tc, "cpu"), tr,
                               torch.from_numpy(bg)).numpy()
    assert got.shape == (3, 96, 96) and np.isfinite(got).all()
    assert want.std() > 0.05  # the trained scene, not the background
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_trained_phase2_loss_and_gradients_match_jax(r5):
    state, flat = r5
    jc, tc = _camera(48)
    jc.image = tc.image = np.random.default_rng(0).random((3, 48, 48)).astype(np.float32)
    jr = jraster.RasterConfig(48, 48, jc.tanfovx, jc.tanfovy,
                              max_gaussians_per_tile=256, tile_chunk=9,
                              blend_bf16=False)
    tr = traster.RasterConfig(48, 48, tc.tanfovx, tc.tanfovy,
                              max_gaussians_per_tile=256)
    key = jax.random.PRNGKey(5)
    bg = np.ones(3, np.float32)
    params, rest = jhac.split_state(state)
    n = rest["valid"].shape[0]
    m2d = jnp.zeros((n * JCFG.n_offsets, 2))
    (want_loss, want_aux), (want_g, want_m2d) = jax.value_and_grad(
        jrender.training_loss, argnums=(0, 8), has_aux=True)(
        params, rest, JCFG, jrender.CameraArrays.from_camera(jc), jr,
        jnp.asarray(bg), 2, key, m2d, 1e-3)

    k1, k2, k3 = jax.random.split(key, 3)
    noise = tuple(torch.from_numpy(np.array(jax.random.uniform(kk, s, jnp.float32)))
                  for kk, s in ((k1, (n, JCFG.feat_dim)), (k2, (n, 6)),
                                (k3, (n, JCFG.n_offsets, 3))))
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tm2d = torch.zeros(tuple(m2d.shape), requires_grad=True)
    loss, aux = trender.training_loss(
        tparams, trest, TCFG, trender.CameraArrays.from_camera(tc, "cpu", True),
        tr, torch.from_numpy(bg), 2, noise, tm2d, 1e-3)
    got = torch.autograd.grad(loss, [*leaves.values(), tm2d], allow_unused=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["bit_per_param"]),
                               float(want_aux["bit_per_param"]), rtol=LOSS_RTOL)
    assert float(aux["bit_per_param"]) > 0
    grads = {name: g if g is not None else torch.zeros_like(t)
             for (name, t), g in zip(leaves.items(), got[:-1])}
    assert_grads_close(grads, want_g)
    scale = float(np.abs(np.asarray(want_m2d)).max())
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want_m2d),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL * scale)
