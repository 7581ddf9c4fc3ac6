"""Resume and the divergence canary in the port's `pipeline.train_scene`
(gauspcc_tpu_torch.models.hac.pipeline, utils.heartbeat), the HAC CLI and
`soak.main`, against the JAX package's oracles.

- Resume is held to tests/test_resume_gui.py:46's determinism oracle: N
  steps straight equal N/2, a snapshot and a resume, with a densification
  on each side of the snapshot and the phase-1 and phase-2 noise after it.
  The anchors, `valid`, the moments and the statistics are exact (the same
  CPU arithmetic in the same order), and so is the final logged line but
  for its timing; both runs' last snapshots hold the same torch
  generator's and numpy rng's states, camera order and caps. A snapshot
  reloads exactly: every tensor as the cut run left it, and the generator
  and rng states, the order and the caps as the uncut run's snapshot at the
  same step.
- `DivergenceMonitor` gives JAX's decisions on tests/test_heartbeat.py:
  64-74's sequences and on seeded random ones (exact: the same float
  comparisons).
- A forced canary drop (a negative `divergence_drop_db`) writes
  DIVERGED.json and skips the codec evaluation; `soak.main` then exits
  with code 3.
- `--checkpoint_every` and `--start_checkpoint` through the HAC CLI, and
  `--checkpoint_every` and `--resume` through `soak.main` (at the soak's
  full width, so its codec tail is recorded, not run): the resumed run's
  model.npz equals the uncut run's, array for array.
"""

import json
import os

import numpy as np
import pytest
import torch

from gauspcc_tpu.utils import heartbeat as jheartbeat

from gauspcc_tpu_torch.cli import soak
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.models.hac import cli, model as hac, pipeline
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.utils import heartbeat

from test_torch_hac_pipeline import (SCENE_CODEC, SMALL, jsonl_scalars_only,
                                     small_codec)  # noqa: F401
from tests.test_colmap import write_colmap_fixture

CFG = hac.HACConfig(**SMALL)
ITERS = 24
# densification at 8 and 16, the snapshot at 12; the compressed schedule
# enters phase 1 at 13 and phase 2 at 17
OPT = hac_train.OptConfig(iterations=ITERS, start_stat=2, update_from=5,
                          update_interval=8, update_until=22)
PHASES = soak.compressed_phase_schedule(ITERS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tiny CPU trainings launch many small ops: on one thread each
    they run as fast as on many, and they do not oversubscribe the cores
    that parallel test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _train(scene, model_dir, logs=None, **kw):
    return pipeline.train_scene(
        scene, CFG, OPT, white_background=True, device="cpu", log_every=4,
        phase_of_step=PHASES, model_dir=model_dir,
        log=(logs.append if logs is not None else lambda m: None), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The straight run, the run cut at 12 with its snapshot, and the run
    resumed from that snapshot, with their logs; each snapshots every 12
    steps."""
    root = tmp_path_factory.mktemp("resume")
    scene = soak.build_scene(np.random.default_rng(0), 32, 150, 9, 400,
                             device="cpu")
    out = {}
    for name, kw in (("straight", {}),
                     ("cut", dict(stop_at=12)),
                     ("resumed", dict(start_checkpoint=str(
                         root / "cut" / "train_ckpt.pkl")))):
        logs = []
        state, res = _train(scene, str(root / name), logs, checkpoint_every=12,
                            **kw)
        out[name] = (state, res, logs)
    return root, out


def _snapshot(root, name, suffix=""):
    return pipeline.load_training_snapshot(
        str(root / name / f"train_ckpt.pkl{suffix}"), CFG, device="cpu")


def _same_host_states(a, b):
    assert a["iteration"] == b["iteration"]
    assert torch.equal(a["generator"].get_state(), b["generator"].get_state())
    assert a["rng"].bit_generator.state == b["rng"].bit_generator.state
    assert a["order"] == b["order"] and a["caps"] == b["caps"]


def test_resume_is_deterministic_across_a_densification(runs):
    root, out = runs
    (sa, ra, la), (sb, rb, lb) = out["straight"], out["resumed"]
    assert [it for it, _ in ra["densify"]] == [8, 16]
    assert [it for it, _ in rb["densify"]] == [16]
    assert ra["densify"][1] == rb["densify"][0]
    assert list(rb["history"]["step"]) == list(range(13, ITERS + 1))
    assert any("canary" in m for m in out["cut"][2])
    for name in sa["anchors"]:
        assert torch.equal(sa["anchors"][name], sb["anchors"][name]), name
    assert torch.equal(sa["valid"], sb["valid"])
    for moment in ("mu", "nu"):
        for name, t in ra["opt_state"][moment].items():
            assert torch.equal(t, rb["opt_state"][moment][name]), name
    assert ra["opt_state"]["count"] == rb["opt_state"]["count"] == ITERS
    for name, t in ra["stats"].items():
        assert torch.equal(t, rb["stats"][name]), name
    assert ra["rcfg"] == rb["rcfg"]
    _same_host_states(_snapshot(root, "straight"), _snapshot(root, "resumed"))
    tail_a = [m for m in la if m.startswith(f"iter {ITERS} (")]
    tail_b = [m for m in lb if m.startswith(f"iter {ITERS} (")]
    assert tail_a and tail_a[0].rsplit("(", 1)[0] == tail_b[0].rsplit("(", 1)[0]


def test_snapshot_reloads_exactly(runs):
    root, out = runs
    state, res, _ = out["cut"]
    snap = _snapshot(root, "cut")
    assert snap["iteration"] == 12
    for name, t in state["anchors"].items():
        assert torch.equal(snap["state"]["anchors"][name], t), name
    for key in ("valid", "x_bound_min", "x_bound_max"):
        assert torch.equal(snap["state"][key], state[key]), key
    for (n, p), (m, q) in zip(state["nets"].named_parameters(),
                              snap["state"]["nets"].named_parameters()):
        assert n == m and torch.equal(p, q), n
    for moment in ("mu", "nu"):
        for name, t in res["opt_state"][moment].items():
            assert torch.equal(snap["opt_state"][moment][name], t), name
    assert snap["opt_state"]["count"] == res["opt_state"]["count"] == 12
    for name, t in res["stats"].items():
        assert torch.equal(snap["stats"][name], t), name
    assert snap["caps"] == (res["rcfg"].max_tiles_per_gaussian,
                            res["rcfg"].max_gaussians_per_tile)
    # the uncut run's snapshot at 12, kept as the previous generation
    _same_host_states(snap, _snapshot(root, "straight", ".prev"))


@pytest.mark.parametrize("drop_db,warmup,values", [
    (3.0, 1, [10.0, 22.0, 25.0, 22.5, 21.9]),  # tests/test_heartbeat.py:64
    (3.0, 2, [30.0, 5.0, 5.0]),  # tests/test_heartbeat.py:74
    (1.5, 1, list(np.random.default_rng(0).normal(30, 1.5, 40))),
    (0.5, 3, list(np.random.default_rng(1).normal(25, 0.4, 40))),
])
def test_divergence_monitor_matches_jax(drop_db, warmup, values):
    want = jheartbeat.DivergenceMonitor(drop_db=drop_db, warmup=warmup)
    got = heartbeat.DivergenceMonitor(drop_db=drop_db, warmup=warmup)
    decisions = [got.update(v) for v in values]
    assert decisions == [want.update(v) for v in values]
    assert (got.best, got.last, got.n) == (want.best, want.last, want.n)
    if drop_db == 3.0 and warmup == 1:
        assert decisions == [False] * 4 + [True] and got.best == 25.0


def test_null_heartbeat_is_inert():
    hb = heartbeat.NullHeartbeat()
    hb.beat()
    with hb.guard("x"):
        pass


def test_forced_canary_drop_aborts_and_skips_the_codec(tmp_path):
    scene = soak.build_scene(np.random.default_rng(0), 32, 150, 9, 400,
                             device="cpu")
    model_dir = str(tmp_path / "run")
    net = pcc.init_net(pcc.NetConfig(8, 3), 0)
    logs = []
    state, res = _train(scene, model_dir, logs, checkpoint_every=4,
                        divergence_drop_db=-1.0, pcc_params=net,
                        pcc_cfg=pcc.NetConfig(8, 3))
    abort = res["aborted_divergence"]
    assert abort["iteration"] == 8 and abort["drop_db"] == pytest.approx(
        abort["canary_best_db"] - abort["canary_db"])
    with open(os.path.join(model_dir, "DIVERGED.json")) as f:
        assert json.load(f) == abort
    assert any("DIVERGENCE ABORT" in m for m in logs)
    assert "psnr" not in res and "size_mb" not in res
    assert not os.path.exists(os.path.join(model_dir, "bitstreams"))
    assert not os.path.exists(os.path.join(model_dir, "results.json"))
    assert os.path.exists(os.path.join(model_dir, "model.npz"))
    assert res["history"]["step"][-1] == 8


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_same_npz(a, b):
    a, b = _npz(a), _npz(b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_hac_cli_checkpoints_and_resumes(tmp_path, small_codec):  # noqa: F811
    root = str(tmp_path / "scene")
    write_colmap_fixture(root, n_images=6, wh=32, n_points=150)
    args = ["-s", root, "--voxel_size", "0.05", "--iterations", "8",
            "--log2", "13", "--log2_2D", "11", "--feat_dim", "16",
            "--n_offsets", "4", "--pcc_ckpt", small_codec, "--pcc_channels",
            "8", "--pcc_kernel_size", "3", "--device", "cpu"]
    uncut = str(tmp_path / "uncut")
    cli.main(["train", "-m", uncut, "--checkpoint_every", "4", *args])
    assert os.path.exists(os.path.join(uncut, "train_ckpt.pkl"))
    resumed = str(tmp_path / "resumed")
    cli.main(["train", "-m", resumed, "--start_checkpoint",
              os.path.join(uncut, "train_ckpt.pkl.prev"), *args])
    _assert_same_npz(os.path.join(uncut, "model.npz"),
                     os.path.join(resumed, "model.npz"))
    for d in (uncut, resumed):
        with open(os.path.join(d, "results.json")) as f:
            assert json.load(f)["size_mb"] > 0


def test_soak_main_checkpoints_aborts_and_resumes(tmp_path, monkeypatch,
                                                  capsys):
    """A soak cut by a forced canary drop at its second snapshot (exit code
    3, the JAX package's abort line), then resumed from its first snapshot
    by `--resume`: the same model at the same step, then the codec tail
    (recorded here, not run: tests/test_torch_hac_pipeline.py runs
    soak.main's codec on the CPU)."""
    small = ["--hw", "32", "--gt_gaussians", "150", "--cams", "9",
             "--seed_points", "400", "--voxel_size", "0.05", "--iters", "4",
             "--pcc_ckpt", SCENE_CODEC, "--device", "cpu", "--log_every", "0"]
    cut = str(tmp_path / "cut")
    jsonl_scalars_only(monkeypatch)

    class AlwaysDrops(heartbeat.DivergenceMonitor):
        def __init__(self, drop_db=3.0, warmup=1):
            super().__init__(drop_db=-1.0, warmup=warmup)

    with monkeypatch.context() as m:
        m.setattr(pipeline, "DivergenceMonitor", AlwaysDrops)
        with pytest.raises(SystemExit) as exit_:
            soak.main([*small, "--out", cut, "--checkpoint_every", "2"])
    assert exit_.value.code == 3
    assert "soak ABORTED (divergence at iter 4)" in capsys.readouterr().out
    with open(os.path.join(cut, "soak_summary.json")) as f:
        assert json.load(f)["aborted_divergence"]["iteration"] == 4
    with open(os.path.join(cut, "scalars.jsonl")) as f:
        canary = [json.loads(ln) for ln in f if "eval/psnr_clean" in ln]
    assert [c["step"] for c in canary] == [2, 4]
    assert os.path.exists(os.path.join(cut, "heartbeat"))
    resumed = str(tmp_path / "resumed")
    tails = []
    with monkeypatch.context() as m:
        m.setattr(pipeline, "_code_and_evaluate",
                  lambda state, cfg, family, scene, model_dir, *a: tails.append(
                      (family.name, model_dir)) or {"size_mb": 1.0})
        soak.main([*small, "--out", resumed,
                   "--resume", os.path.join(cut, "train_ckpt.pkl.prev")])
    assert tails == [("hac", resumed)]
    _assert_same_npz(os.path.join(cut, "model.npz"),
                     os.path.join(resumed, "model.npz"))
    with open(os.path.join(resumed, "soak_summary.json")) as f:
        assert json.load(f)["iteration"] == 4
