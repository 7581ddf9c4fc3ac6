"""The port's tooling CLIs and the G-PCC shim against the JAX package's, on
the CPU: `cli/soak_eval.py`, `cli/sweep.py`, `cli/convert.py`,
`utils/gpcc.py` (counterparts of the same files in gauspcc_tpu/).

soak_eval and sweep run the port's pipeline (a JAX snapshot does not load
in the port), so they are held to the port's own `_code_and_evaluate` and
to the JAX package's layouts and keys. convert and the shim only run
programs: a fake `colmap` and a fake `tmc3` on PATH record their argument
lists, which must equal the JAX package's.

Tolerances: soak_eval's size exact and its PSNR within 1e-6 dB (the same
code on the same state); everything else exact (bytes, argument lists,
keys).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from gauspcc_tpu.cli import convert as jconvert
from gauspcc_tpu.cli import sweep as jsweep
from gauspcc_tpu.utils import gpcc as jgpcc
from gauspcc_tpu_torch import convert as tconvert
from gauspcc_tpu_torch.cli import convert, soak, soak_eval, sweep
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.models import registry
from gauspcc_tpu_torch.models.hac import pipeline
from gauspcc_tpu_torch.utils import gpcc
from gauspcc_tpu_torch.utils.heartbeat import NullHeartbeat

from tests.test_colmap import write_colmap_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_CODEC = os.path.join(REPO, "model", "gauspcgc", "best_model.npz")
# gauspcc_tpu/cli/soak_eval.py:84-93: JAX's evaluate keys
# (pipeline.py:487-499, the surrogate's LPIPS key) minus per_view, plus
# the size and the iteration
JAX_SUMMARY_KEYS = {"psnr", "ssim", "eval_k", "eval_d", "lpips_surrogate",
                    "lpips_variant", "fps", "size_bits", "size_mb", "iteration"}
SOAK = ["--hw", "64", "--gt_gaussians", "150", "--cams", "9",
        "--seed_points", "400", "--voxel_size", "0.05"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny trainings and renders on many threads oversubscribe the cores
    that parallel test workers share; on one thread they run as fast."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_soak_eval_codes_a_snapshot_as_train_scene_does(tmp_path):
    run = str(tmp_path / "run")
    scene = soak.build_scene(np.random.default_rng(0), 64, 150, 9, 400,
                             device="cpu")
    soak.train(scene, 4, voxel_size=0.05, device="cpu", model_dir=run,
               log_every=0, train_kw=dict(checkpoint_every=4))
    soak_eval.main(["--run", run, *SOAK, "--pcc_ckpt", SCENE_CODEC,
                    "--device", "cpu"])
    with open(os.path.join(run, "soak_summary.json")) as f:
        summary = json.load(f)
    assert set(summary) == JAX_SUMMARY_KEYS
    assert summary["iteration"] == 4
    assert summary["lpips_variant"] == "vgg_random_v1"
    assert sorted(os.listdir(os.path.join(run, "test_renders"))) == [
        "00000.png", "00001.png"]

    family = registry.get_family("hac")
    cfg = family.make_config(voxel_size=0.05)
    snap = pipeline.load_training_snapshot(
        os.path.join(run, "train_ckpt.pkl"), cfg, "cpu")
    net = tconvert.load_codec_npz(SCENE_CODEC, pcc.NetConfig(), device="cpu")
    want = pipeline._code_and_evaluate(
        snap["state"], cfg, family, scene, str(tmp_path / "again"), net,
        pcc.NetConfig(), False, lambda m: None, NullHeartbeat())
    assert summary["size_bits"] == want["size_bits"]
    assert summary["size_mb"] == want["size_mb"]
    assert summary["psnr"] == pytest.approx(want["psnr"], abs=1e-6)
    assert summary["lpips_surrogate"] == pytest.approx(want["lpips_surrogate"],
                                                       abs=1e-6)


@pytest.mark.parametrize("kind", ["smooth", "hard"])
def test_soak_scene_kinds_match_jax(kind, monkeypatch):
    """soak_eval's --scene kinds besides the soak's own "textured"
    (tests/test_torch_hac_render.py holds that one): the same cameras,
    seed points and ground truth for one seed, JAX's blend in float32."""
    from gauspcc_tpu.cli import soak as jsoak
    from gauspcc_tpu.render import raster as jraster

    jcfg_cls = jraster.RasterConfig
    monkeypatch.setattr(jraster, "RasterConfig",
                        lambda *a, **k: jcfg_cls(*a, blend_bf16=False, **k))
    want = jsoak.build_scene(np.random.default_rng(11), 32, 150, 8, 300,
                             kind=kind, white_background=True)
    got = soak.build_scene(np.random.default_rng(11), 32, 150, 8, 300,
                           white_background=True, device="cpu", kind=kind)
    np.testing.assert_array_equal(got.points, want.points)
    assert got.cameras_extent == want.cameras_extent
    for g, w in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        np.testing.assert_allclose(g.image, w.image, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="kind"):
        soak.build_scene(np.random.default_rng(0), 32, 150, 8, 300,
                         device="cpu", kind="flat")


def test_new_clis_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="no CUDA"):
        soak_eval.main(["--run", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA"):
        sweep.main(["--data_root", str(tmp_path), "--dataset", "tandt",
                    "--scenes", "none"])


def test_sweep_presets_equal_jax():
    assert sweep.DATASET_PRESETS == jsweep.DATASET_PRESETS


def test_sweep_trains_each_lambda_into_the_summary(tmp_path):
    """Two lambdas on the COLMAP fixture (4 images at 32 px) at HAC's full
    width, three steps each, with the codec the r5 soak coded its anchors
    with."""
    root = tmp_path / "data"
    write_colmap_fixture(str(root / "fix"), n_images=4, wh=32, n_points=200)
    out = tmp_path / "runs"
    sweep.main(["--data_root", str(root), "--dataset", "tandt", "--scenes",
                "fix", "--lmbdas", "0.004,0.0005", "--iterations", "3",
                "--out_root", str(out), "--pcc_ckpt", SCENE_CODEC,
                "--device", "cpu"])
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert list(summary) == ["fix/l0.004", "fix/l0.0005"]
    for name, entry in summary.items():
        assert set(entry) == {"psnr", "size_mb"}
        assert np.isfinite(entry["psnr"]) and entry["size_mb"] > 0, name
    for lmbda in ("0.004", "0.0005"):
        run = out / "tandt" / "fix" / f"hac_l{lmbda}"
        with open(run / "results.json") as f:
            assert json.load(f)["psnr"] == summary[f"fix/l{lmbda}"]["psnr"]
        assert os.listdir(run / "test_renders")


def test_convert_resizes_as_jax(tmp_path):
    """--skip_matching --resize on copies of one fixture: images_{2,4,8}
    byte for byte (PIL's LANCZOS on both sides); the input/ fallback of a
    scene without images/."""
    src = tmp_path / "src"
    write_colmap_fixture(str(src), n_images=3, wh=40, n_points=50)
    os.rename(src / "images", src / "input")
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    shutil.copytree(src, ours)
    shutil.copytree(src, theirs)
    convert.main(["-s", str(ours), "--skip_matching", "--resize"])
    jconvert.main(["-s", str(theirs), "--skip_matching", "--resize"])
    for sub in ("images", "images_2", "images_4", "images_8"):
        names = sorted(os.listdir(theirs / sub))
        assert names and sorted(os.listdir(ours / sub)) == names
        for n in names:
            assert (ours / sub / n).read_bytes() == (theirs / sub / n).read_bytes()


_FAKE = """#!{python}
import json, os, shutil, sys
with open(os.environ["FAKE_LOG"], "a") as f:
    f.write(json.dumps([os.path.basename(sys.argv[0])] + sys.argv[1:]) + "\\n")
args = sys.argv[1:]
def arg(prefix):
    for i, a in enumerate(args):
        if a == prefix:
            return args[i + 1]
        if a.startswith(prefix + "="):
            return a.split("=", 1)[1]
if args and args[0] == "image_undistorter":
    sparse = os.path.join(arg("--output_path"), "sparse")
    os.makedirs(sparse, exist_ok=True)
    for n in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(sparse, n), "w").close()
if arg("--mode") == "0":  # tmc3 encode: the "stream" is the PLY itself
    shutil.copy(arg("--uncompressedDataPath"), arg("--compressedStreamPath"))
if arg("--mode") == "1":
    shutil.copy(arg("--compressedStreamPath"), arg("--reconstructedDataPath"))
"""


def _fake_tools(tmp_path, monkeypatch) -> str:
    """`colmap` and `tmc3` on PATH that log their argument lists."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("colmap", "tmc3"):
        path = bin_dir / name
        path.write_text(_FAKE.format(python=sys.executable))
        path.chmod(0o755)
    log = str(tmp_path / "calls.jsonl")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_LOG", log)
    return log


def _calls(log: str, root) -> list:
    """The logged argument lists, with `root` written as <root>."""
    with open(log) as f:
        calls = [json.loads(line) for line in f]
    os.remove(log)
    return [[a.replace(str(root), "<root>") for a in c] for c in calls]


def test_convert_runs_colmap_as_jax(tmp_path, monkeypatch):
    log = _fake_tools(tmp_path, monkeypatch)
    layouts = []
    for i, main in enumerate((convert.main, jconvert.main)):
        root = tmp_path / f"s{i}"
        (root / "input").mkdir(parents=True)
        main(["-s", str(root), "--camera", "PINHOLE"])
        calls = _calls(log, root)
        layouts.append((calls, sorted(os.listdir(root / "sparse" / "0"))))
    assert layouts[0] == layouts[1]
    assert [c[1] for c in layouts[0][0]] == [
        "feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"]
    assert layouts[0][1] == ["cameras.bin", "images.bin", "points3D.bin"]
    # without the binary both refuse to reconstruct
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    for main in (convert.main, jconvert.main):
        with pytest.raises(SystemExit, match="colmap binary not found"):
            main(["-s", str(tmp_path / "s0")])


def test_gpcc_shim_runs_tmc3_as_jax(tmp_path, monkeypatch):
    log = _fake_tools(tmp_path, monkeypatch)
    xyz = np.random.default_rng(0).integers(0, 64, (100, 3)).astype(np.int32)
    assert gpcc.tmc3_available() and jgpcc.tmc3_available()
    runs = []
    for i, mod in enumerate((gpcc, jgpcc)):
        root = tmp_path / f"g{i}"
        root.mkdir()
        bits = mod.gpcc_encode(xyz, str(root / "a.bin"), posq_scale=2)
        pts = mod.gpcc_decode(str(root / "a.bin"))
        runs.append((bits, pts, _calls(log, root), sorted(os.listdir(root))))
    (bits, pts, calls, files), (jbits, jpts, jcalls, jfiles) = runs
    assert bits == jbits == (root / "a.bin").stat().st_size * 8
    assert calls == jcalls and [c[1] for c in calls] == ["--mode=0", "--mode=1"]
    assert files == jfiles == ["a.bin"]  # the temporary PLYs are gone
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(pts, xyz.astype(np.float32))
    for mod in (gpcc, jgpcc):
        assert not mod.tmc3_available("no-such-tmc3")
        with pytest.raises(RuntimeError, match="tmc3 binary not found"):
            mod.gpcc_encode(xyz, str(tmp_path / "x.bin"), binary="no-such-tmc3")
        with pytest.raises(RuntimeError, match="tmc3 binary not found"):
            mod.gpcc_decode(str(tmp_path / "x.bin"), binary="no-such-tmc3")

