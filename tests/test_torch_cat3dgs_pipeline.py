"""CAT-3DGS through every entry point of the port's pipeline on the CPU:
`train_scene(family=registry.get_family("cat3dgs"))` with its codec tail,
the CLI with `--model cat3dgs` and `soak.main --model cat3dgs`, at the size
of the `cat3dgs` case of tests/test_registry_pipeline.py:36-38 (feat_dim 8
in slices (4, 4), 3 offsets, one-channel planes at 16 and 32), the CLI's
planes and the soak at CATConfig's full plane sizes (64, 128, 256), the
soak at its full width.

Tolerances: the decoded values exact (the decoder recomputes every model
bit for bit); a second encode of the trained state writes the sizes the
first wrote; the networks' bits exactly the parameter count and the
integer ARMs' bytes exactly the record's. codec_delta_db is not pinned:
the float eval of a CAT-3DGS state renders its unquantised attributes, as
the JAX package's does.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.utils import checkpoint as jcheckpoint
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.models import registry
from gauspcc_tpu_torch.models.cat3dgs import codec as cat_codec
from gauspcc_tpu_torch.models.cat3dgs import field as cfield
from gauspcc_tpu_torch.models.cat3dgs import model as cat
from gauspcc_tpu_torch.models.hac import cli, pipeline
from gauspcc_tpu_torch.models.hac import train as hac_train

from tests.test_colmap import write_colmap_fixture
from test_torch_tcgs import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_CODEC = os.path.join(REPO, "model", "gauspcgc", "best_model.npz")
SMALL = dict(feat_dim=8, n_offsets=3, voxel_size=0.05, chcm_slices=(4, 4),
             tri_feat=1, base_resolution=16, multiscale=(1, 2))


@pytest.fixture(scope="module")
def small_codec(tmp_path_factory):
    """A seeded NetConfig(8, 3) codec, saved as the JAX package saves it."""
    path = str(tmp_path_factory.mktemp("pcc") / "pcc.npz")
    jcheckpoint.save_pytree(path, jpcc.init_params(jax.random.PRNGKey(3),
                                                   jpcc.NetConfig(8, 3)))
    return path


def test_train_scene_cat3dgs_codes_decodes_and_evaluates(tmp_path, small_codec):
    """train_scene(family=cat3dgs) on the CPU through phases 0-2 (a
    compressed version of the family's schedule) with two densifications,
    set_pca_frame once on entering phase 2, the ARMs frozen there; then
    its codec tail: results.json, a stream whose decode gives back exactly
    what the encoder coded, and model.npz."""
    scene = soak.build_scene(np.random.default_rng(1), 32, 300, 9, 600,
                             device="cpu")
    base = registry.get_family("cat3dgs")
    fitted = []

    def extra_init(state, cfg):  # the family's hook, counted
        fitted.append(int(state["valid"].sum()))
        return base.extra_init(state, cfg)

    fam = dataclasses.replace(base, extra_init=extra_init)
    cfg = fam.make_config(**SMALL)
    opt = hac_train.OptConfig(iterations=25, start_stat=2, update_from=5,
                              update_interval=10, update_until=25, lmbda=1e-3)
    pcc_cfg = pcc.NetConfig(8, 3)
    net = convert.load_codec_npz(small_codec, pcc_cfg, device="cpu")
    init = cat.CATNets(cfg).init_seeded(np.random.default_rng(0))
    model_dir = str(tmp_path / "model")
    logs = []
    state, res = pipeline.train_scene(
        scene, cfg, opt, white_background=True, device="cpu", log_every=0,
        log=logs.append, model_dir=model_dir, pcc_params=net, pcc_cfg=pcc_cfg,
        phase_of_step=lambda it: fam.phase_of_step(it * 600), family=fam)
    h = res["history"]
    assert list(np.unique(h["phase"])) == [0, 1, 2]
    assert np.isfinite(h["loss"]).all()
    assert (h["bit_per_param"][h["phase"] == 2] > 0).all()
    assert (h["bit_per_param"][h["phase"] < 2] == 0).all()
    assert [it for it, _ in res["densify"]] == [10, 20]
    assert len(fitted) == 1 and fitted[0] > 0
    field = state["nets"].field
    assert not torch.equal(field.rotation.detach(), torch.eye(3))
    for got, seeded in zip(field.arms.parameters(), init.field.arms.parameters()):
        assert torch.equal(got.detach(), seeded)  # phase 2 freezes the ARMs
    assert not torch.equal(field.scales[0].detach(), init.field.scales[0])
    saved = json.load(open(os.path.join(model_dir, "results.json")))
    # the seeded LPIPS surrogate reports under "lpips_surrogate", not "lpips"
    assert set(saved) == set(pipeline.RESULT_KEYS) - {"lpips"}
    assert np.isfinite(saved["psnr"]) and np.isfinite(saved["psnr_float"])
    assert saved["size_bits"]["triplane"] > 3 * 4560 * 8
    # a second encode writes the same sizes; the stream decodes exactly
    values = {}
    sizes, _ = cat_codec.conduct_encoding(state, cfg, str(tmp_path / "again"),
                                          net, pcc_cfg, values=values)
    assert sizes == saved["size_bits"]
    dec, _ = cat_codec.conduct_decoding(
        state, cfg, os.path.join(model_dir, "bitstreams"), net, pcc_cfg)
    m = values["feat"].shape[0]
    assert int(dec["valid"].sum()) == m > 0
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(dec["anchors"][key][:m], values[name]), name
    for got, want in zip(cfield.quantized_planes(dec["nets"].field),
                         values["planes"]):
        assert torch.equal(got, want)
    # model.npz loads back as a CAT-3DGS state, with JAX's keys
    with np.load(os.path.join(model_dir, "model.npz")) as data:
        files = set(data.files)
        again = convert.state_from_numpy({k: data[k] for k in data.files}, cfg,
                                         device="cpu")
    assert {"nets/field/scales/1", "nets/field/arms/xz/layers/2/res_lin/w",
            "nets/field/pca_mean", "nets/mlp_chcm/0/fc1/w"} <= files
    assert not any(f.startswith(("nets/tables", "nets/mlp_grid")) for f in files)
    assert torch.equal(again["nets"].field.rotation, field.rotation)


def test_cli_trains_and_evaluates_cat3dgs_on_cpu(tmp_path, small_codec):
    """The CLI with --model cat3dgs on the COLMAP fixture (feat_dim 8 in two
    slices of 4, the config's 64-, 128- and 256-wide planes), then eval,
    which reads the family from cfg.json."""
    root = str(tmp_path / "scene")
    write_colmap_fixture(root, n_images=6, wh=32, n_points=150)
    model_dir = str(tmp_path / "out")
    codec_args = ["--pcc_ckpt", small_codec, "--pcc_channels", "8",
                  "--pcc_kernel_size", "3", "--device", "cpu"]
    cli.main(["train", "-s", root, "-m", model_dir, "--model", "cat3dgs",
              "--voxel_size", "0.05", "--iterations", "10", "--feat_dim", "8",
              "--n_offsets", "3", *codec_args])
    meta = json.load(open(os.path.join(model_dir, "cfg.json")))
    assert meta["model"] == "cat3dgs" and meta["hac"]["chcm_slices"] == [4, 4]
    assert meta["hac"]["multiscale"] == [1, 2, 4]
    assert "log2_hashmap_size" not in meta["hac"]
    results = json.load(open(os.path.join(model_dir, "results.json")))
    assert results["psnr"] is not None and results["size_mb"] > 0
    files = os.listdir(os.path.join(model_dir, "bitstreams"))
    assert "arm_q.bin" in files and "tri_2_yz_0.b" in files
    assert "hash.b" not in files
    cli.main(["eval", "-m", model_dir, *codec_args])
    again = json.load(open(os.path.join(model_dir, "results.json")))
    assert again["size_bits"] == results["size_bits"]
    assert again["psnr"] == pytest.approx(results["psnr"], abs=1e-6)


def test_cli_takes_the_published_chcm_slices(tmp_path, small_codec):
    """`--chcm_slices` gives CAT-3DGS the published run's split (here its
    form at feat_dim 8: four slices, three chcm heads, each from the slices
    before it); a split that does not sum to --feat_dim, or one given to
    another family, stops the command before it reads anything."""
    root = str(tmp_path / "scene")
    write_colmap_fixture(root, n_images=6, wh=32, n_points=150)
    model_dir = str(tmp_path / "out")
    args = ["train", "-s", root, "-m", model_dir, "--voxel_size", "0.05",
            "--iterations", "5", "--feat_dim", "8", "--n_offsets", "3",
            "--pcc_ckpt", small_codec, "--pcc_channels", "8",
            "--pcc_kernel_size", "3", "--device", "cpu"]
    with pytest.raises(SystemExit, match="do not sum"):
        cli.main(args + ["--model", "cat3dgs", "--chcm_slices", "5", "10"])
    with pytest.raises(SystemExit, match="cat3dgs"):
        cli.main(args + ["--model", "hac", "--chcm_slices", "4", "4"])
    assert not os.path.exists(model_dir)
    cli.main(args + ["--model", "cat3dgs", "--chcm_slices", "1", "2", "2", "3"])
    meta = json.load(open(os.path.join(model_dir, "cfg.json")))
    assert meta["hac"]["chcm_slices"] == [1, 2, 2, 3]
    with np.load(os.path.join(model_dir, "model.npz")) as data:
        heads = sorted(k for k in data.files
                       if k.startswith("nets/mlp_chcm/") and k.endswith("fc0/w"))
        assert [data[k].shape for k in heads] == [(1, 16), (3, 16), (5, 16)]


def test_soak_main_trains_cat3dgs_on_cpu(tmp_path):
    """soak.main --model cat3dgs at a smoke size, at the full CATConfig
    width, with the codec the r5 soak coded its anchors with: the networks
    1,124,320 bits and the integer ARMs 13,680 bytes, as the JAX r5 record.
    The soak's compressed schedule stops at phase 2, as the JAX package's
    does, so the ARMs keep their seeded weights."""
    out = str(tmp_path / "soak")
    soak.main(["--model", "cat3dgs", "--iters", "10", "--hw", "32",
               "--gt_gaussians", "150", "--cams", "9", "--seed_points", "400",
               "--voxel_size", "0.05", "--out", out, "--pcc_ckpt", SCENE_CODEC,
               "--device", "cpu", "--log_every", "0"])
    summary = json.load(open(os.path.join(out, "soak_summary.json")))
    assert summary["iteration"] == 10 and summary["size_mb"] > 0
    assert summary["size_bits"]["mlps"] == 1_124_320
    assert os.path.getsize(os.path.join(out, "bitstreams", "arm_q.bin")) == 13_680
    assert soak.compressed_phase_schedule(10)(10) == 2
    init = cat.CATNets(cat.CATConfig()).init_seeded(np.random.default_rng(0))
    with np.load(os.path.join(out, "model.npz")) as data:
        assert data["nets/field/scales/2"].shape == (3, 1, 256, 256)
        assert data["nets/mlp_attr/fc0/w"].shape == (cat.CATConfig().ctx_dim, 100)
        np.testing.assert_array_equal(
            data["nets/field/arms/yz/layers/4/lin/w"],
            init.field.arms["yz"].layers[4].lin.weight.detach().numpy().T)
        assert not np.array_equal(data["nets/field/rotation"], np.eye(3))
