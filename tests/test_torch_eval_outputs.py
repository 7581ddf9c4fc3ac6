"""The port's evaluation outputs (models/hac/pipeline.py: `evaluate` with
LPIPS and `out_dir`, `render_sets`, `_save_png`, train_scene's
test_renders/ and float_renders/) against the JAX package's
(gauspcc_tpu/models/hac/pipeline.py:414-503, :543) on the CPU, on one
converted state at 32x32.

The JAX package blends in bf16 by default (raster.py:51); the port blends
in float32, so the JAX side runs with blend_bf16=False (its `_raster_cfg`
patched, nothing in the package edited).

Tolerances, each with its reason:
- PSNR, SSIM and the LPIPS surrogate: abs 1e-4 (renders that agree to
  about 1e-5, scored in float32 by two libraries);
- the PNGs: at most 1 level of 255 (x 255 is truncated, so a render 1e-5
  away can fall on the other side of a level);
- the .npy renders: abs 1e-4, the renders' own agreement.
"""

import json
import os
import sys

import numpy as np
import jax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.data.cameras import Camera as JCamera
from gauspcc_tpu.models.hac import pipeline as jpipeline
from gauspcc_tpu.utils import checkpoint as jcheckpoint
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak as tsoak
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import pipeline as tpipeline
from gauspcc_tpu_torch.models.hac import train as ttrain

from test_torch_train import HW, JCFG, TCFG, jax_state

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny renders and convolutions on many threads oversubscribe the
    cores that parallel test workers share; on one thread they run as
    fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def float32_jax_blend(monkeypatch):
    """The JAX package's eval raster configs with blend_bf16=False, and no
    LPIPS weights file on either side (the surrogate)."""
    monkeypatch.delenv("GAUSPCC_LPIPS_WEIGHTS", raising=False)
    orig = jpipeline._raster_cfg
    monkeypatch.setattr(jpipeline, "_raster_cfg", lambda cam, max_k=256, max_d=32:
                        orig(cam, max_k, max_d)._replace(blend_bf16=False))


def _cameras(n=2):
    """n soak orbit cameras at 32x32 with seeded ground truth, as the port's
    and the JAX package's Camera."""
    port, jax_cams = [], []
    for i in range(n):
        c = tsoak._orbit_camera(i, 0.7 + 0.5 * i, HW, radius=2.2)
        c.image = np.random.default_rng(20 + i).random((3, HW, HW)).astype(np.float32)
        port.append(c)
        jax_cams.append(JCamera(uid=i, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy,
                                width=HW, height=HW, image=c.image))
    return port, jax_cams


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX package's and the port's evaluate of one state on two views,
    each writing its PNGs."""
    root = tmp_path_factory.mktemp("eval")
    state, flat = jax_state(9)
    cams, jcams = _cameras()
    orig = jpipeline._raster_cfg
    jpipeline._raster_cfg = lambda cam, max_k=256, max_d=32: orig(
        cam, max_k, max_d)._replace(blend_bf16=False)
    try:
        want = jpipeline.evaluate(state, JCFG, jcams, str(root / "jax"))
    finally:
        jpipeline._raster_cfg = orig
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    got = tpipeline.evaluate(tstate, TCFG, cams, out_dir=str(root / "port"))
    return want, got, root, tstate, cams


def test_evaluate_reports_jax_keys_and_values(both):
    want, got, _, _, _ = both
    assert set(got) - {"renders"} == set(want)
    assert got["lpips_variant"] == want["lpips_variant"] == "vgg_random_v1"
    assert "lpips" not in got
    assert (got["eval_k"], got["eval_d"]) == (want["eval_k"], want["eval_d"])
    for key in ("psnr", "ssim", "lpips_surrogate"):
        assert got[key] == pytest.approx(want[key], abs=ATOL), key
    assert set(got["per_view"]) == set(want["per_view"]) == {"00000", "00001"}
    for name, w in want["per_view"].items():
        g = got["per_view"][name]
        assert set(g) - {"ms"} == set(w)
        for key in w:
            assert g[key] == pytest.approx(w[key], abs=ATOL), (name, key)
        assert np.isfinite(g["lpips_surrogate"]) and g["lpips_surrogate"] > 0


def test_pngs_match_jax(both):
    from PIL import Image

    _, got, root, _, _ = both
    names = sorted(os.listdir(root / "port"))
    assert names == sorted(os.listdir(root / "jax")) == ["00000.png", "00001.png"]
    for i, name in enumerate(names):
        a = np.asarray(Image.open(root / "port" / name)).astype(np.int32)
        b = np.asarray(Image.open(root / "jax" / name)).astype(np.int32)
        assert a.shape == b.shape == (HW, HW, 3)
        assert np.abs(a - b).max() <= 1, name
        # the file is the port's own render, truncated
        want = np.clip(got["renders"][i].numpy().transpose(1, 2, 0) * 255.0,
                       0, 255).astype(np.uint8)
        np.testing.assert_array_equal(a, want)


def test_without_pil_the_renders_are_npy(both, tmp_path, monkeypatch):
    """Where PIL does not import (the card's machine) each render is the
    float [3, H, W] array in {i:05d}.npy, as the JAX package saves it."""
    _, got, _, tstate, cams = both
    state, _ = jax_state(9)
    _, jcams = _cameras()
    monkeypatch.setitem(sys.modules, "PIL", None)
    jpipeline.evaluate(state, JCFG, jcams, str(tmp_path / "jax"),
                       auto_k=False)
    res = tpipeline.evaluate(tstate, TCFG, cams, auto_k=False,
                             out_dir=str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["00000.npy", "00001.npy"]
    for i, name in enumerate(names):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert a.dtype == np.float32 and a.shape == b.shape == (3, HW, HW)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(a, res["renders"][i].numpy())


def test_train_scene_writes_renders_and_lpips(tmp_path):
    """train_scene's tail writes the decoded renders to test_renders/ and
    the float ones to float_renders/, and results.json carries the LPIPS
    surrogate's keys, as the JAX package's (pipeline.py:383, :392)."""
    codec_path = str(tmp_path / "pcc.npz")
    jcheckpoint.save_pytree(codec_path, jpcc.init_params(
        jax.random.PRNGKey(3), jpcc.NetConfig(8, 3)))
    scene = tsoak.build_scene(np.random.default_rng(1), 32, 300, 9, 600,
                              device="cpu")
    opt = ttrain.OptConfig(iterations=4, update_from=100, update_until=0)
    net = convert.load_codec_npz(codec_path, pcc.NetConfig(8, 3), device="cpu")
    model_dir = str(tmp_path / "run")
    _, res = tpipeline.train_scene(
        scene, thac.HACConfig(**TCFG._asdict()), opt, device="cpu",
        model_dir=model_dir, pcc_params=net, pcc_cfg=pcc.NetConfig(8, 3),
        log_every=0, white_background=True)
    n = len(scene.test_cameras)
    for sub in ("test_renders", "float_renders"):
        assert sorted(os.listdir(os.path.join(model_dir, sub))) == [
            f"{i:05d}.png" for i in range(n)]
    with open(os.path.join(model_dir, "results.json")) as f:
        saved = json.load(f)
    assert saved["lpips_variant"] == "vgg_random_v1" and "lpips" not in saved
    assert np.isfinite(saved["lpips_surrogate"]) and saved["lpips_surrogate"] > 0
    assert saved["lpips_surrogate"] == pytest.approx(res["lpips_surrogate"])
    assert all("lpips_surrogate" in v for v in saved["per_view"].values())
