"""Whole runs of every cell at a tiny size on the CPU (the harness's look
for a card skipped): the result's shape, `correct` against the plain
reference, and `correct` false when the timed path is broken underneath."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests import tiny

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    torch.set_num_threads(2)
    tiny.patch_sizes(monkeypatch)


def run(name, trace=False, seconds=0.3):
    return harness.run_cell(tiny.cell(name), seed=tiny.SEED, seconds=seconds,
                            trace=trace, t_start=time.perf_counter(),
                            device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_shaped(name):
    r = run(name)
    assert r.pop("_stderr_lines")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    spec = tiny.cell(name)
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    json.dumps(r)


def test_a_traced_run_reports_per_layer_metrics_only():
    r = run("hac.train_rd", trace=True)
    spec = tiny.cell("hac.train_rd")
    assert set(r["metrics"]) <= {m["name"] for m in spec.per_layer}
    assert "idle.train" in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in faults.CELL_FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = run(name)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("gauspcgc")])
def test_the_float8_control_is_not_correct(name):
    """The control (the reference with float8 conv operands in the
    program's place) fails a number of the cell; the hac cells' control,
    TF32, acts only on the card (test_portbench_card.py)."""
    spec = tiny.cell(name)
    session = harness.driver(spec.driver).setup(spec, tiny.SEED, "cpu")
    session.window(0.2, trace=False)
    session.release()
    checks = session.control()
    assert not all(c.ok for c in checks), [(c.name, c.value) for c in checks]


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the entry exits non-zero and prints no
    result; in a directory holding only the benchmark's files it fails
    too."""
    cmd = [sys.executable, "-m", "portbench.run", "--workload", "hac.view",
           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
