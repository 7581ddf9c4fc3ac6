"""HAC's main path end to end in the port on the CPU: train_scene's codec
tail, the scene readers, the HAC CLI and `soak.main`, against the JAX
package where it has a counterpart.

Tolerances, each with its reason:
- codec_delta_db within 0 +- 0.01 dB, the JAX package's pin
  (tests/test_hac_pipeline.py:62): the decoded state renders what the float
  eval renders;
- the scene readers: exact (the same numpy on the same files).
"""

import json
import os

import numpy as np
import jax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.data.scene import Scene as JScene
from gauspcc_tpu.utils import checkpoint as jcheckpoint
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.data import cameras
from gauspcc_tpu_torch.data.scene import Scene
from gauspcc_tpu_torch.models.hac import cli, model as hac, pipeline
from gauspcc_tpu_torch.models.hac import train as hac_train

from tests.test_colmap import write_colmap_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_CODEC = os.path.join(REPO, "model", "gauspcgc", "best_model.npz")
DELTA_DB = 0.01
SMALL = dict(feat_dim=16, n_offsets=4, voxel_size=0.05, resolutions_3d=(6, 10, 16),
             resolutions_2d=(16, 32), log2_hashmap_size=13,
             log2_hashmap_size_2d=13)  # tests/test_hac_train.py:17


@pytest.fixture(scope="module")
def small_codec(tmp_path_factory):
    """A seeded NetConfig(8, 3) codec, saved as the JAX package saves it."""
    path = str(tmp_path_factory.mktemp("pcc") / "pcc.npz")
    jcheckpoint.save_pytree(path, jpcc.init_params(jax.random.PRNGKey(3),
                                                   jpcc.NetConfig(8, 3)))
    return path


def test_train_scene_encodes_decodes_and_evaluates(tmp_path, small_codec):
    """As tests/test_hac_pipeline.py:32 runs the JAX package: a short run,
    then model.npz, the bitstreams and results.json, and a codec that costs
    no PSNR."""
    scene = soak.build_scene(np.random.default_rng(1), 32, 300, 9, 600,
                             device="cpu")
    cfg = hac.HACConfig(**SMALL)
    opt = hac_train.OptConfig(iterations=25, update_from=5, update_interval=10,
                              update_until=20, lmbda=1e-3)
    pcc_cfg = pcc.NetConfig(8, 3)
    net = convert.load_codec_npz(small_codec, pcc_cfg, device="cpu")
    model_dir = str(tmp_path / "model")
    logs = []
    state, res = pipeline.train_scene(
        scene, cfg, opt, white_background=True, device="cpu", log_every=0,
        log=logs.append, model_dir=model_dir, pcc_params=net, pcc_cfg=pcc_cfg)
    assert any(m.startswith("Estimated sizes") for m in logs)
    assert any(m.startswith("Encoded sizes") for m in logs)
    saved = json.load(open(os.path.join(model_dir, "results.json")))
    # the seeded LPIPS surrogate reports under "lpips_surrogate", not "lpips"
    assert set(saved) == set(pipeline.RESULT_KEYS) - {"lpips"}
    assert np.isfinite(saved["psnr"]) and saved["size_mb"] > 0
    assert saved["size_bits"]["total"] == pytest.approx(saved["size_mb"] * 8 * 2**20)
    assert saved["codec_delta_db"] == pytest.approx(0.0, abs=DELTA_DB)
    assert res["codec_delta_db"] == saved["codec_delta_db"]
    assert os.path.exists(os.path.join(model_dir, "bitstreams", "xyz_pcc.bin"))
    # model.npz holds the trained state under the JAX package's keys
    with np.load(os.path.join(model_dir, "model.npz")) as data:
        assert torch.equal(torch.from_numpy(data["anchors/anchor_feat"]),
                           state["anchors"]["anchor_feat"])
        assert np.array_equal(data["nets/mlp_color/fc1/w"],
                              state["nets"].mlp_color.fc1.weight.detach().T.numpy())


def test_training_keeps_the_anchors_in_the_coded_order():
    """sort_anchors: the valid anchors first, in morton order of their
    voxels, with their moments and statistics moved along."""
    cfg = hac.HACConfig(**SMALL)
    rng = np.random.default_rng(2)
    pts = hac.voxelize_points((rng.random((300, 3)) * 2 - 1).astype(np.float32),
                              cfg.voxel_size)
    state = hac.init_state(cfg, pts, rng, device="cpu")
    n = pts.shape[0]
    perm = torch.from_numpy(rng.permutation(n))
    state["anchors"] = {k: torch.cat([v[:n][perm], v[n:]])
                        for k, v in state["anchors"].items()}
    state["anchors"]["anchor_feat"][:n] = torch.arange(n, dtype=torch.float32)[:, None]
    params, _ = hac.split_state(state)
    leaves = hac_train.param_leaves(params)
    opt_state = {"mu": {k: v.clone() for k, v in leaves.items()},
                 "nu": {k: v.clone() for k, v in leaves.items()}, "count": 3}
    stats = hac_train.zero_stats(state["valid"].shape[0], cfg.n_offsets)
    stats["anchor_demon"][:n, 0] = torch.arange(n, dtype=torch.float32)
    stats["offset_denom"][: n * cfg.n_offsets, 0] = torch.arange(
        n, dtype=torch.float32).repeat_interleave(cfg.n_offsets)
    s2, st2, o2 = hac_train.sort_anchors(state, stats, opt_state, cfg)
    key = torch.round(s2["anchors"]["anchor"][:n] / cfg.voxel_size).long().numpy()
    np.testing.assert_array_equal(
        np.lexsort((key[:, 0], key[:, 1], key[:, 2])), np.arange(n))
    assert bool(s2["valid"][:n].all()) and not bool(s2["valid"][n:].any())
    moved = s2["anchors"]["anchor_feat"][:n, 0]
    assert torch.equal(o2["mu"]["anchors/anchor_feat"][:n, 0], moved)
    assert torch.equal(st2["anchor_demon"][:n, 0], moved)
    assert torch.equal(st2["offset_denom"][: n * cfg.n_offsets, 0],
                       moved.repeat_interleave(cfg.n_offsets))
    assert o2["count"] == 3 and torch.equal(o2["mu"]["nets/mlp_grid/fc0/weight"],
                                            opt_state["mu"]["nets/mlp_grid/fc0/weight"])


def test_scene_readers_match_jax(tmp_path):
    root = str(tmp_path / "scene")
    write_colmap_fixture(root)
    got, want = Scene(root, eval_split=True), JScene(root, eval_split=True)
    assert got.cameras_extent == want.cameras_extent
    np.testing.assert_array_equal(got.points, want.points)
    for a, b in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        assert (a.uid, a.width, a.height, a.fovx, a.fovy, a.image_name) == \
            (b.uid, b.width, b.height, b.fovx, b.fovy, b.image_name)
        np.testing.assert_array_equal(a.world_view_transform, b.world_view_transform)
        np.testing.assert_array_equal(a.image, b.image)
    assert cameras.fov2focal(cameras.focal2fov(40.0, 32), 32) == pytest.approx(40.0)


def test_hac_cli_trains_and_evaluates_a_colmap_scene_on_cpu(tmp_path, small_codec):
    """The port's CLI on the fixture of tests/test_colmap.py:150, as the JAX
    package's CLI runs there (at feat_dim 16 and 4 offsets, to keep it
    short): train -> encode -> decode -> eval, then eval again from the
    model directory, which reads cfg.json."""
    root = str(tmp_path / "scene")
    write_colmap_fixture(root, n_images=6, wh=32, n_points=150)
    model_dir = str(tmp_path / "out")
    codec_args = ["--pcc_ckpt", small_codec, "--pcc_channels", "8",
                  "--pcc_kernel_size", "3", "--device", "cpu"]
    cli.main(["train", "-s", root, "-m", model_dir, "--voxel_size", "0.05",
              "--iterations", "30", "--log2", "13", "--log2_2D", "11",
              "--feat_dim", "16", "--n_offsets", "4", *codec_args])
    results = json.load(open(os.path.join(model_dir, "results.json")))
    assert results["psnr"] is not None and results["size_mb"] > 0
    assert results["codec_delta_db"] == pytest.approx(0.0, abs=DELTA_DB)
    cli.main(["eval", "-m", model_dir, *codec_args])
    again = json.load(open(os.path.join(model_dir, "results.json")))
    assert again["size_bits"] == results["size_bits"]
    assert again["psnr"] == pytest.approx(results["psnr"], abs=1e-6)


def test_cli_refuses_what_is_not_ported(tmp_path, small_codec):
    """A missing codec checkpoint is refused, with --gui as without it; the
    viewer itself is ported (--gui reaching train_scene:
    tests/test_torch_gui.py), as is every family (--model cat3dgs:
    tests/test_torch_cat3dgs_pipeline.py), and --start_checkpoint /
    --checkpoint_every are (tests/test_torch_resume.py)."""
    with pytest.raises(SystemExit, match="no such file"):
        cli.main(["train", "-s", str(tmp_path), "-m", str(tmp_path), "--gui",
                  "--port", "0", "--pcc_ckpt", str(tmp_path / "none.npz"),
                  "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["train", "-s", str(tmp_path), "-m", str(tmp_path),
                  "--pcc_ckpt", str(tmp_path / "none.npz"), "--device", "cpu"])


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["eval", "-m", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA"):
        soak.main(["--out", str(tmp_path / "soak")])


def jsonl_scalars_only(monkeypatch):
    """soak.main's ScalarLogger without its TensorBoard writer: importing
    torch.utils.tensorboard loads TensorFlow where it is installed, which
    takes seconds a test process, and no test reads the TensorBoard
    files."""
    from gauspcc_tpu_torch.utils import scalars

    real = scalars.ScalarLogger
    monkeypatch.setattr(scalars, "ScalarLogger", lambda log_dir: real(
        log_dir, use_tensorboard=False))


def test_soak_main_writes_the_summary_on_cpu(tmp_path, monkeypatch):
    """soak.main at a smoke size, with the codec the r5 soak coded
    its anchors with (model/gauspcgc, the default --pcc_ckpt)."""
    jsonl_scalars_only(monkeypatch)
    out = str(tmp_path / "soak")
    soak.main(["--iters", "20", "--hw", "32", "--gt_gaussians", "150",
               "--cams", "9", "--seed_points", "400", "--voxel_size", "0.05",
               "--out", out, "--pcc_ckpt", SCENE_CODEC, "--device", "cpu",
               "--log_every", "0"])
    summary = json.load(open(os.path.join(out, "soak_summary.json")))
    assert summary["iteration"] == 20 and summary["size_mb"] > 0
    assert summary["codec_delta_db"] == pytest.approx(0.0, abs=DELTA_DB)
    assert summary["size_bits"]["mlps"] == 1_165_920
    assert "per_view" not in summary
    assert os.path.exists(os.path.join(out, "model.npz"))
