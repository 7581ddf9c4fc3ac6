"""The port's codec-training data, corpus, checkpoints, logging and CLI
(gauspcc_tpu_torch/codecs/gauspcgc/data.py and cli.py, utils/checkpoint.py,
utils/heartbeat.py, utils/scalars.py) against the JAX package's, on the
CPU, at NetConfig(8, 3) on clouds of at most 3,000 points.

Tolerances: none. Every comparison is exact (points read, partitions,
epoch orders, corpus bytes, weights through either package's `.npz`),
except the PLY text round trip, which keeps 6 significant digits (rtol
1e-5, as tests/test_train_gauspcgc.py test_ply_roundtrip), and the
coded clouds, which must decode to the same point set.
"""

import json
import os
import struct
import time

import numpy as np
import jax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import data as jdata, model as jmodel
from gauspcc_tpu.utils import checkpoint as jcheckpoint
from gauspcc_tpu.utils.scalars import ScalarLogger as JScalarLogger
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import cli, data, model, train
from gauspcc_tpu_torch.utils import checkpoint
from gauspcc_tpu_torch.utils.heartbeat import Heartbeat
from gauspcc_tpu_torch.utils.scalars import ScalarLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "pcc_corpus_r4")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module: the lane runs 6 workers
    on a few cores, where torch's thread pool oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_cloud(rng, n=1200, extent=64):
    """tests/test_train_gauspcgc.py:15."""
    base = rng.integers(0, extent, size=(n, 3))
    base[:, 2] = (base[:, 0] // 4 + base[:, 1] // 4) % (extent // 2)
    return np.unique(base, axis=0).astype(np.float32)


def _write_binary_ply(path, pts, endian="<"):
    """A binary PLY with an extra property between the coordinates."""
    fmt = "binary_little_endian" if endian == "<" else "binary_big_endian"
    with open(path, "wb") as f:
        f.write((f"ply\nformat {fmt} 1.0\nelement vertex {len(pts)}\n"
                 "property float x\nproperty uchar red\nproperty float y\n"
                 "property double z\nend_header\n").encode())
        for x, y, z in pts:
            f.write(struct.pack(f"{endian}fBfd", x, 7, y, z))


# ---------------------------------------------------------------------------
# readers, writers, partitions, datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["bin", "npy", "npz", "ply_ascii",
                                 "ply_binary_le", "ply_binary_be"])
def test_read_points_equals_jax(tmp_path, fmt):
    rng = np.random.default_rng(1)
    pts = (rng.standard_normal((257, 3)) * 100).astype(np.float32)
    path = str(tmp_path / f"c.{fmt.split('_')[0]}")
    if fmt == "bin":
        np.concatenate([pts, np.ones((257, 1), np.float32)], 1).tofile(path)
    elif fmt == "npy":
        np.save(path, pts)
    elif fmt == "npz":
        np.savez(path, points=pts)
    elif fmt == "ply_ascii":
        jdata.save_ply_ascii_geo(pts, path)
    else:
        _write_binary_ply(path, pts, "<" if fmt.endswith("le") else ">")
    got, want = data.read_points(path), jdata.read_points(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if fmt != "ply_ascii":
        np.testing.assert_array_equal(got, pts)
    with pytest.raises(ValueError, match="unsupported"):
        data.read_points(str(tmp_path / "c.xyz"))


def test_ply_roundtrip_and_same_file_as_jax(tmp_path):
    pts = np.array([[0.5, -1.25, 3.0], [2, 2, 2], [1e5, -3e-3, 7]], np.float32)
    data.save_ply_ascii_geo(pts, str(tmp_path / "port.ply"))
    jdata.save_ply_ascii_geo(pts, str(tmp_path / "jax.ply"))
    assert (open(tmp_path / "port.ply", "rb").read()
            == open(tmp_path / "jax.ply", "rb").read())
    back = data.read_points(str(tmp_path / "port.ply"))
    np.testing.assert_allclose(back, pts, rtol=1e-5)
    clouds = data.read_point_clouds([str(tmp_path / "port.ply")] * 3, workers=2)
    assert len(clouds) == 3 and all(np.array_equal(c, back) for c in clouds)


def test_kdtree_partition_equals_jax():
    rng = np.random.default_rng(7)
    pts = (rng.standard_normal((10_000, 3)) * [1, 5, 2]).astype(np.float32)
    got = data.kdtree_partition(pts, max_num=1500)
    want = jdata.kdtree_partition(pts, max_num=1500)
    assert len(got) == len(want) > 4
    assert all(len(p) <= 1500 for p in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_patch_dataset_order_and_patches_equal_jax(tmp_path):
    """Epoch orders, KD-part picks, patch coords and the geometry keys of
    one seed, over three epochs, equal JAX's; WholeCloudDataset too."""
    rng = np.random.default_rng(2)
    paths = []
    for i, n in enumerate((2900, 800, 2500)):
        paths.append(str(tmp_path / f"c{i}.npy"))
        np.save(paths[-1], (rng.standard_normal((n, 3)) * 40).astype(np.float32))
    got = data.PatchDataset(paths, max_num=1000, seed=3)
    want = jdata.PatchDataset(paths, max_num=1000, seed=3)
    for _ in range(3):
        order = got.epoch_order()
        assert order == want.epoch_order()
        for idx in order:
            (gk, gx), (wk, wx) = got.sample_with_key(idx), want.sample_with_key(idx)
            assert gk == wk and gx.dtype == wx.dtype == np.int64
            np.testing.assert_array_equal(gx, wx)
    whole, jwhole = data.WholeCloudDataset(paths), jdata.WholeCloudDataset(paths)
    assert len(whole) == len(jwhole) == 3
    for i in range(3):
        np.testing.assert_array_equal(whole.get(i), jwhole.get(i))
    np.testing.assert_array_equal(
        data.quantize_cloud(whole.clouds[0], 2.0, pre_quantized=False),
        jdata.quantize_cloud(whole.clouds[0], 2.0, pre_quantized=False))


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split,seed", [("train", 7), ("val", 1234)])
def test_synth_writes_the_tracked_corpus_byte_for_byte(tmp_path, split, seed):
    """`cli synth --seed 7` (train) and `--seed 1234` (val) write the first
    file of data/pcc_corpus_r4/<split> byte for byte."""
    cli.main(["synth", "--output_dir", str(tmp_path), "--seed", str(seed),
              "--count", "1", "--kind", "mixed"])
    got = open(tmp_path / "synth_0000.npy", "rb").read()
    want = open(os.path.join(CORPUS, split, "synth_0000.npy"), "rb").read()
    assert got == want


def test_synth_kinds():
    for kind in ("surface", "clustered"):
        (pts, desc), = cli.synth_clouds(3, 1, kind)
        assert desc.startswith(kind) and pts.dtype == np.float32
        assert len(np.unique(pts, axis=0)) == len(pts) > 1000


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_best_model_npz_loads_in_either_package(tmp_path):
    """A port-trained best_model.npz loads in JAX's
    load_pytree(template=init_params(...)) with equal values, and a JAX
    one loads in the port's load_codec_npz."""
    rng = np.random.default_rng(4)
    p = str(tmp_path / "c.npy")
    np.save(p, _make_cloud(rng, 2000))
    cfg = train.TrainConfig(channels=8, kernel_size=3, max_steps=2,
                            val_interval=2, model_dir=str(tmp_path / "m"))
    net = train.train(cfg, data.PatchDataset([p], seed=0), data.WholeCloudDataset([p]),
                      device="cpu")
    template = jmodel.init_params(jax.random.PRNGKey(0), jmodel.NetConfig(8, 3))
    loaded = jcheckpoint.load_pytree(str(tmp_path / "m" / "best_model.npz"), template)
    flat = checkpoint.flatten(jax.tree_util.tree_map(np.asarray, loaded))
    assert flat.keys() == checkpoint.flatten(net).keys()
    for k, v in checkpoint.flatten(net).items():
        np.testing.assert_array_equal(flat[k], v)

    jparams = jmodel.init_params(jax.random.PRNGKey(5), jmodel.NetConfig(8, 3))
    jcheckpoint.save_pytree(str(tmp_path / "jax.npz"), jparams)
    port = convert.load_codec_npz(str(tmp_path / "jax.npz"), cfg.net, "cpu")
    want = checkpoint.flatten(jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in checkpoint.flatten(port).items():
        np.testing.assert_array_equal(v, want[k])


def test_training_checkpoint_holds_numpy_only(tmp_path):
    """The snapshot pickles a module as its flat keys and tensors as
    arrays, atomically (no .tmp left), and loads back equal."""
    net = model.init_net(model.NetConfig(8, 3), 0)
    opt = train.make_optimizer(train.TrainConfig())
    state = opt.init(dict(net.named_parameters()))
    path = str(tmp_path / "train_state.pkl")
    checkpoint.save_training_checkpoint(path, {
        "params": net, "opt_state": state, "iteration": 7, "best_val": 1.5})
    assert not os.path.exists(path + ".tmp")
    snap = checkpoint.load_training_checkpoint(path)
    assert snap["iteration"] == 7 and snap["best_val"] == 1.5
    assert snap["opt_state"]["count"] == 0
    assert all(isinstance(v, np.ndarray) for v in snap["params"].values())
    assert all(isinstance(v, np.ndarray) for v in snap["opt_state"]["mu"].values())
    back = convert.codec_params_from_numpy(snap["params"], model.NetConfig(8, 3), "cpu")
    for a, b in zip(back.parameters(), net.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

def test_scalar_logger_writes_jax_lines(tmp_path):
    """The port's ScalarLogger writes the JSONL lines JAX's writes (but
    the time)."""
    lines = {}
    for name, cls in (("port", ScalarLogger), ("jax", JScalarLogger)):
        log = cls(str(tmp_path / name), use_tensorboard=False)
        log.log(10, {"train/bpp": 9.5, "skip": None, "n": np.float32(2)})
        log.log(20, {"val/bpp": 8.25})
        assert log.sinks == ["jsonl"]
        log.close()
        rows = [json.loads(line) for line in open(tmp_path / name / "scalars.jsonl")]
        lines[name] = [{k: v for k, v in r.items() if k != "time"} for r in rows]
    assert lines["port"] == lines["jax"]
    assert lines["port"][0] == {"step": 10, "train/bpp": 9.5, "n": 2.0}


def test_heartbeat_guard_keeps_the_file_warm(tmp_path):
    path = str(tmp_path / "hb" / "heartbeat")
    hb = Heartbeat(path, interval=0.05, max_s=10.0)
    assert os.path.exists(path)
    os.utime(path, (0, 0))
    with hb.guard("block"):
        deadline = time.monotonic() + 10.0
        while os.path.getmtime(path) == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert os.path.getmtime(path) > 0  # touched inside the section


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_cli_train_then_compress_and_decompress(tmp_path, capsys):
    """`train` 2 steps on the CPU with
    validation, then code two clouds with the trained best_model.npz and
    decode them to the same points; batch and engine flags refuse."""
    rng = np.random.default_rng(6)
    clouds = tmp_path / "clouds"
    os.makedirs(clouds)
    for i in range(2):
        data.save_ply_ascii_geo(_make_cloud(rng, n=600), str(clouds / f"c{i}.ply"))
    model_dir = str(tmp_path / "model")
    cli.main(["train", "--channels", "8", "--kernel_size", "3", "--device", "cpu",
              "--training_data", str(clouds / "*.ply"), "--val_data",
              str(clouds / "c0.ply"), "--model_save_folder", model_dir,
              "--max_steps", "2", "--val_interval", "2", "--max_patch_points", "400"])
    ckpt = os.path.join(model_dir, "best_model.npz")
    assert os.path.exists(ckpt)
    assert os.path.exists(os.path.join(model_dir, "scalars.jsonl"))
    out_dir, dec_dir = str(tmp_path / "bins"), str(tmp_path / "dec")
    small = ["--channels", "8", "--kernel_size", "3", "--device", "cpu", "--ckpt", ckpt]
    cli.main(["compress", *small, "--input", str(clouds / "*.ply"),
              "--output_dir", out_dir])
    assert os.path.exists(os.path.join(out_dir, "compress_results.csv"))
    cli.main(["decompress", *small, "--input", os.path.join(out_dir, "*.bin"),
              "--output_dir", dec_dir])
    assert os.path.exists(os.path.join(dec_dir, "decompress_results.csv"))
    for i in range(2):
        orig = data.read_points(str(clouds / f"c{i}.ply"))
        dec = data.read_points(os.path.join(dec_dir, f"c{i}.ply"))
        assert (set(map(tuple, dec.astype(np.int64).tolist()))
                == set(map(tuple, orig.astype(np.int64).tolist())))
    for extra in (["--batch", "2"], ["--geom", "host"], ["--geom", "device"]):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7e"):
            cli.main(["compress", *small, "--input", str(clouds / "*.ply"),
                      "--output_dir", out_dir, *extra])
    open(os.path.join(out_dir, "x.binb"), "wb").close()
    with pytest.raises(NotImplementedError, match="Queue 1 item 7e"):
        cli.main(["decompress", *small, "--input", os.path.join(out_dir, "*.binb"),
                  "--output_dir", dec_dir])
