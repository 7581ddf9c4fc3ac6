"""TC-GS through every entry point of the port's pipeline on the CPU:
`train_scene(family=registry.get_family("tcgs"))` with its codec tail, the
CLI with `--model tcgs` and `soak.main --model tcgs`, at the size of the
`tcgs` case of tests/test_registry_pipeline.py:31-40 (feat_dim 8, 3
offsets, 4 plane channels at 16x16, 2 samples, a 4-channel latent), the
soak at TCGSConfig's full width.

Tolerances: the decoded values exact (the decoder recomputes every model
bit for bit); a second encode of the trained state writes the sizes the
first wrote; the networks' and the latent's bits exactly the parameter
and latent counts. codec_delta_db is not pinned: the float eval of a
TC-GS state renders its unquantised attributes, as the JAX package's
does.
"""

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
from gauspcc_tpu_torch.models.hac import cli, pipeline
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.models.tcgs import codec as tcgs_codec
from gauspcc_tpu_torch.models.tcgs import model as tcgs

from tests.test_colmap import write_colmap_fixture
from test_torch_tcgs import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_CODEC = os.path.join(REPO, "model", "gauspcgc", "best_model.npz")
SMALL = dict(feat_dim=8, n_offsets=3, voxel_size=0.05, tri_feat=4,
             tri_res=16, tri_samples=2, ae_compressed=4)


@pytest.fixture(scope="module")
def small_codec(tmp_path_factory):
    """A seeded NetConfig(8, 3) codec, saved as the JAX package saves it."""
    path = str(tmp_path_factory.mktemp("pcc") / "pcc.npz")
    jcheckpoint.save_pytree(path, jpcc.init_params(jax.random.PRNGKey(3),
                                                   jpcc.NetConfig(8, 3)))
    return path


def test_train_scene_tcgs_codes_decodes_and_evaluates(tmp_path, small_codec):
    """train_scene(family=tcgs) on the CPU through phases 0-3 (a
    compressed version of the family's schedule) with two
    densifications, then its codec tail: results.json, a stream whose
    decode gives back exactly what the encoder coded, and model.npz."""
    scene = soak.build_scene(np.random.default_rng(1), 32, 300, 9, 600,
                             device="cpu")
    fam = registry.get_family("tcgs")
    cfg = fam.make_config(**SMALL)
    opt = hac_train.OptConfig(iterations=28, start_stat=2, update_from=5,
                              update_interval=10, update_until=25, lmbda=1e-3)
    pcc_cfg = pcc.NetConfig(8, 3)
    net = convert.load_codec_npz(small_codec, pcc_cfg, device="cpu")
    model_dir = str(tmp_path / "model")
    logs = []
    state, res = pipeline.train_scene(
        scene, cfg, opt, white_background=True, device="cpu", log_every=0,
        log=logs.append, model_dir=model_dir, pcc_params=net, pcc_cfg=pcc_cfg,
        phase_of_step=lambda it: fam.phase_of_step(it * 600), family=fam)
    h = res["history"]
    assert list(np.unique(h["phase"])) == [0, 1, 2, 3]
    assert np.isfinite(h["loss"]).all()
    assert (h["bit_per_param"][h["phase"] >= 2] > 0).all()
    assert (h["bit_per_param"][h["phase"] < 2] == 0).all()
    assert [it for it, _ in res["densify"]] == [10, 20]
    assert not any(m.startswith("Estimated sizes") for m in logs)  # HAC only
    saved = json.load(open(os.path.join(model_dir, "results.json")))
    # the seeded LPIPS surrogate reports under "lpips_surrogate", not "lpips"
    assert set(saved) == set(pipeline.RESULT_KEYS) - {"lpips"}
    assert np.isfinite(saved["psnr"]) and np.isfinite(saved["psnr_float"])
    assert saved["size_bits"]["triplane"] == 3 * 4 * 2 * 2 * 16
    # a second encode writes the same sizes; the stream decodes exactly
    values = {}
    sizes, _ = tcgs_codec.conduct_encoding(state, cfg, str(tmp_path / "again"),
                                           net, pcc_cfg, values=values)
    assert sizes == saved["size_bits"]
    dec, _ = tcgs_codec.conduct_decoding(
        state, cfg, os.path.join(model_dir, "bitstreams"), net, pcc_cfg)
    m = values["feat"].shape[0]
    assert int(dec["valid"].sum()) == m > 0
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(dec["anchors"][key][:m], values[name]), name
    assert torch.equal(dec["nets"].planes, values["planes"])
    # model.npz loads back as a TC-GS state, with JAX's keys
    with np.load(os.path.join(model_dir, "model.npz")) as data:
        files = set(data.files)
        again = convert.state_from_numpy({k: data[k] for k in data.files}, cfg,
                                          device="cpu")
    assert {"nets/planes", "nets/autoencoder/enc0/w",
            "nets/mlp_triplane/fc1/w"} <= files
    assert not any(f.startswith(("nets/tables", "nets/mlp_grid")) for f in files)
    assert torch.equal(again["nets"].autoencoder.dec2.w,
                       state["nets"].autoencoder.dec2.w)


def test_cli_trains_and_evaluates_tcgs_on_cpu(tmp_path, small_codec):
    """The CLI with --model tcgs on the COLMAP fixture, then eval, which
    reads the family from cfg.json."""
    root = str(tmp_path / "scene")
    write_colmap_fixture(root, n_images=6, wh=32, n_points=150)
    model_dir = str(tmp_path / "out")
    codec_args = ["--pcc_ckpt", small_codec, "--pcc_channels", "8",
                  "--pcc_kernel_size", "3", "--device", "cpu"]
    cli.main(["train", "-s", root, "-m", model_dir, "--model", "tcgs",
              "--voxel_size", "0.05", "--iterations", "20", "--feat_dim", "8",
              "--n_offsets", "3", *codec_args])
    meta = json.load(open(os.path.join(model_dir, "cfg.json")))
    assert meta["model"] == "tcgs" and meta["hac"]["tri_res"] == 32
    assert "log2_hashmap_size" not in meta["hac"]
    results = json.load(open(os.path.join(model_dir, "results.json")))
    assert results["psnr"] is not None and results["size_mb"] > 0
    files = os.listdir(os.path.join(model_dir, "bitstreams"))
    assert tcgs_codec.LATENT_FILE in files and "hash.b" not in files
    cli.main(["eval", "-m", model_dir, *codec_args])
    again = json.load(open(os.path.join(model_dir, "results.json")))
    assert again["size_bits"] == results["size_bits"]
    assert again["psnr"] == pytest.approx(results["psnr"], abs=1e-6)


def test_soak_main_trains_tcgs_on_cpu(tmp_path):
    """soak.main --model tcgs at a smoke size, at the full TCGSConfig
    width, with the codec the r5 soak coded its anchors with: the networks
    1,636,320 bits and the latent 6,144, as the JAX r5 record. The soak's
    compressed schedule stops at phase 2, as the JAX package's does."""
    out = str(tmp_path / "soak")
    soak.main(["--model", "tcgs", "--iters", "12", "--hw", "32",
               "--gt_gaussians", "150", "--cams", "9", "--seed_points", "400",
               "--voxel_size", "0.05", "--out", out, "--pcc_ckpt", SCENE_CODEC,
               "--device", "cpu", "--log_every", "0"])
    summary = json.load(open(os.path.join(out, "soak_summary.json")))
    assert summary["iteration"] == 12 and summary["size_mb"] > 0
    assert summary["size_bits"]["mlps"] == 1_636_320
    assert summary["size_bits"]["triplane"] == 6_144
    with np.load(os.path.join(out, "model.npz")) as data:
        assert data["nets/planes"].shape == (3, 16, 32, 32)
        assert data["nets/mlp_triplane/fc0/w"].shape == (tcgs.TCGSConfig().ctx_dim,
                                                         100)
    scene = soak.build_scene(np.random.default_rng(0), 32, 150, 9, 400,
                             device="cpu")
    _, cfg, _, res = soak.train(scene, 12, model="tcgs", voxel_size=0.05,
                                device="cpu", log_every=0, log=lambda m: None)
    assert isinstance(cfg, tcgs.TCGSConfig)
    assert res["history"]["phase"].max() == 2
