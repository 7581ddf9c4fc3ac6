"""The port's family registry (gauspcc_tpu_torch/models/registry.py) and
HAC++ through every entry point of the pipeline on the CPU: train_scene
with the family and its codec tail, the CLI and `soak.main`, at the size of
the `hac_plus` case of tests/test_registry_pipeline.py (feat_dim 10, 3
offsets, resolutions (6, 10, 16) / (16, 32), 2^13 rows).

Tolerances: the decoded values exact (the decoder recomputes every model
bit for bit); a second encode of the trained state writes the sizes the
first wrote; the anchors' order exactly the codec's. codec_delta_db is
not pinned: the float eval of a HAC++ state renders its unquantised
attributes, as the JAX package's does.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.models import registry as jregistry
from gauspcc_tpu.utils import checkpoint as jcheckpoint
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.models import registry
from gauspcc_tpu_torch.models.hac import cli, pipeline
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.models.hac_plus import codec as hacp_codec
from gauspcc_tpu_torch.models.hac_plus import model as hacp

from tests.test_colmap import write_colmap_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_CODEC = os.path.join(REPO, "model", "gauspcgc", "best_model.npz")
SMALL = dict(feat_dim=10, n_offsets=3, voxel_size=0.05,
             resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
             log2_hashmap_size=13, log2_hashmap_size_2d=13)


@pytest.fixture(scope="module")
def small_codec(tmp_path_factory):
    """A seeded NetConfig(8, 3) codec, saved as the JAX package saves it."""
    path = str(tmp_path_factory.mktemp("pcc") / "pcc.npz")
    jcheckpoint.save_pytree(path, jpcc.init_params(jax.random.PRNGKey(3),
                                                   jpcc.NetConfig(8, 3)))
    return path


def test_registry_families_resolve():
    """As tests/test_registry_pipeline.py:18 for the ported families, with
    the JAX registry's names and config fields."""
    assert registry.FAMILIES == jregistry.FAMILIES
    for name in ("hac", "hac_plus"):
        fam = registry.get_family(name)
        assert fam.name == name and callable(fam.training_loss)
        assert fam.extra_init is None and fam.grad_mask is None
        assert (fam.make_config._fields
                == jregistry.get_family(name).make_config._fields)
    assert registry.get_family("hac_plus").make_config is hacp.HACPlusConfig
    with pytest.raises(ValueError):
        registry.get_family("nope")


@pytest.mark.parametrize("name,item", [("tcgs", "item 7b"),
                                       ("cat3dgs", "item 7c")])
def test_unported_families_name_their_roadmap_item(name, item):
    """The families of ROADMAP.md Queue 1 items 7b (TC-GS) and 7c
    (CAT-3DGS) are ported: each resolves, with the JAX registry's config
    fields and defaults and its phase schedule at the JAX boundaries;
    TC-GS without hooks, CAT-3DGS with its PCA fit and its freezes."""
    fam, jfam = registry.get_family(name), jregistry.get_family(name)
    assert fam.name == name and callable(fam.training_loss)
    assert fam.make_config._fields == jfam.make_config._fields
    assert fam.make_config()._asdict() == jfam.make_config()._asdict()
    cfg = fam.make_config()
    if name == "tcgs":
        assert fam.extra_init is None and fam.grad_mask is None
        assert [fam.phase_of_step(s) for s in (3000, 3001, 10001, 15001)] == [
            jfam.phase_of_step(s) for s in (3000, 3001, 10001, 15001)] == [0, 1, 2, 3]
        assert (cfg.ctx_dim, cfg.grid_out_dim) == (195, 175)
        return
    from gauspcc_tpu_torch.models.cat3dgs import model as cat
    from gauspcc_tpu_torch.models.cat3dgs import render as cat_render

    assert fam.extra_init is cat.set_pca_frame
    assert fam.grad_mask is cat_render.grad_mask
    edges = (3000, 3001, 10000, 10001, 15000, 15001, 16000, 16001, 19000, 19001)
    assert [fam.phase_of_step(s) for s in edges] == [
        jfam.phase_of_step(s) for s in edges] == [0, 1, 1, 2, 2, 3, 3, 4, 4, 5]
    assert (cfg.ctx_dim, cfg.grid_out_dim, cfg.chcm_slices) == (9, 125, (25, 25))


def test_train_scene_hac_plus_codes_decodes_and_evaluates(tmp_path, small_codec):
    """train_scene(family=hac_plus) on the CPU through phases 0-2 with two
    densifications (the family's extra_init once, on entering phase 2),
    then its codec tail: results.json, a stream whose decode gives back
    exactly what the encoder coded, the anchors in the codec's order."""
    scene = soak.build_scene(np.random.default_rng(1), 32, 300, 9, 600,
                             device="cpu")
    entered = []

    def extra_init(state, cfg):  # the family's hook on entering phase 2
        entered.append(int(state["valid"].sum()))
        return state

    fam = dataclasses.replace(registry.get_family("hac_plus"),
                              extra_init=extra_init)
    cfg = fam.make_config(**SMALL)
    opt = hac_train.OptConfig(iterations=25, start_stat=2, update_from=5,
                              update_interval=10, update_until=25, lmbda=1e-3)
    pcc_cfg = pcc.NetConfig(8, 3)
    net = convert.load_codec_npz(small_codec, pcc_cfg, device="cpu")
    model_dir = str(tmp_path / "model")
    logs = []
    state, res = pipeline.train_scene(
        scene, cfg, opt, white_background=True, device="cpu", log_every=0,
        log=logs.append, model_dir=model_dir, pcc_params=net, pcc_cfg=pcc_cfg,
        phase_of_step=soak.compressed_phase_schedule(25), family=fam)
    h = res["history"]
    assert list(np.unique(h["phase"])) == [0, 1, 2]
    assert np.isfinite(h["loss"]).all() and (h["bit_per_param"][h["phase"] == 2] > 0).all()
    assert [it for it, _ in res["densify"]] == [10, 20]
    assert entered == [res["densify"][0][1]["n_anchors"]]  # phase 2 from 17
    assert not any(m.startswith("Estimated sizes") for m in logs)  # HAC only
    assert any(m.startswith("Encoded sizes") for m in logs)
    saved = json.load(open(os.path.join(model_dir, "results.json")))
    # the seeded LPIPS surrogate reports under "lpips_surrogate", not "lpips"
    assert set(saved) == set(pipeline.RESULT_KEYS) - {"lpips"}
    assert np.isfinite(saved["psnr"]) and np.isfinite(saved["psnr_float"])
    assert saved["size_mb"] > 0 and saved["eval_k"] >= 256
    # the anchors stay in the codec's order
    n = int(state["valid"].sum())
    assert bool(state["valid"][:n].all())
    key = torch.round(state["anchors"]["anchor"][:n] / cfg.voxel_size).long().numpy()
    np.testing.assert_array_equal(
        np.lexsort((key[:, 0], key[:, 1], key[:, 2])), np.arange(n))
    # the stream decodes exactly to what the encoder codes
    values = {}
    sizes, _ = hacp_codec.conduct_encoding(state, cfg, str(tmp_path / "again"),
                                           net, pcc_cfg, values=values)
    assert sizes == saved["size_bits"]
    dec, _ = hacp_codec.conduct_decoding(
        state, cfg, os.path.join(model_dir, "bitstreams"), net, pcc_cfg)
    m = values["feat"].shape[0]
    assert int(dec["valid"].sum()) == m > 0
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(dec["anchors"][key][:m], values[name]), name
    # model.npz loads back as a HAC++ state
    with np.load(os.path.join(model_dir, "model.npz")) as data:
        again = convert.state_from_numpy({k: data[k] for k in data.files}, cfg,
                                          device="cpu")
    assert torch.equal(again["nets"].channel_ctx.mlp_d4.fc1.weight,
                       state["nets"].channel_ctx.mlp_d4.fc1.weight)


def test_cli_trains_and_evaluates_hac_plus_on_cpu(tmp_path, small_codec):
    """The CLI with --model hac_plus on the COLMAP fixture (not a Blender
    scene, so the full channel context), then eval, which reads the family
    from cfg.json."""
    root = str(tmp_path / "scene")
    write_colmap_fixture(root, n_images=6, wh=32, n_points=150)
    model_dir = str(tmp_path / "out")
    codec_args = ["--pcc_ckpt", small_codec, "--pcc_channels", "8",
                  "--pcc_kernel_size", "3", "--device", "cpu"]
    cli.main(["train", "-s", root, "-m", model_dir, "--model", "hac_plus",
              "--voxel_size", "0.05", "--iterations", "20", "--log2", "13",
              "--log2_2D", "11", "--feat_dim", "10", "--n_offsets", "3",
              *codec_args])
    meta = json.load(open(os.path.join(model_dir, "cfg.json")))
    assert meta["model"] == "hac_plus" and meta["hac"]["tiny_ctx"] is False
    results = json.load(open(os.path.join(model_dir, "results.json")))
    assert results["psnr"] is not None and results["size_mb"] > 0
    assert "feat_0_4.b" in os.listdir(os.path.join(model_dir, "bitstreams"))
    cli.main(["eval", "-m", model_dir, *codec_args])
    again = json.load(open(os.path.join(model_dir, "results.json")))
    assert again["size_bits"] == results["size_bits"]
    assert again["psnr"] == pytest.approx(results["psnr"], abs=1e-6)


def test_soak_main_trains_hac_plus_on_cpu(tmp_path):
    """soak.main --model hac_plus at a smoke size, at the full HACPlusConfig
    width, with the codec the r5 soak coded its anchors with."""
    out = str(tmp_path / "soak")
    soak.main(["--model", "hac_plus", "--iters", "12", "--hw", "32",
               "--gt_gaussians", "150", "--cams", "9", "--seed_points", "400",
               "--voxel_size", "0.05", "--out", out, "--pcc_ckpt", SCENE_CODEC,
               "--device", "cpu", "--log_every", "0"])
    summary = json.load(open(os.path.join(out, "soak_summary.json")))
    assert summary["iteration"] == 12 and summary["size_mb"] > 0
    cfg = hacp.HACPlusConfig()
    in_dim, fd, k = cfg.feat_dim + 4, cfg.feat_dim, cfg.n_offsets
    params = sum(i * o + o for i, o in (
        (in_dim, fd), (fd, k), (in_dim, fd), (fd, 7 * k), (in_dim, fd),
        (fd, 3 * k), (cfg.grid_spec.output_dim, 2 * fd), (2 * fd, 225)))
    assert summary["size_bits"]["mlps"] == 32 * params  # no channel_ctx
    with np.load(os.path.join(out, "model.npz")) as data:
        assert data["nets/mlp_grid/fc1/w"].shape == (2 * fd, 225)
        assert "nets/channel_ctx/mlp_d4/fc0/w" in data.files
        assert not any(f.startswith("nets/mlp_deform") for f in data.files)
    assert os.path.exists(os.path.join(out, "bitstreams", "feat_0_4.b"))
    assert hac_codec.BATCH == hacp_codec.BATCH
