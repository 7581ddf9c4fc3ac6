"""The port's tracing and profiling (gauspcc_tpu_torch.utils.profiling)
against the JAX package's gauspcc_tpu/utils/profiling.py on the CPU.

Exact: PhaseTimer's counts and its summary() text for the same totals,
device_memory_stats() on the CPU ({} on both). The times themselves are
host clocks and are not compared. `trace` writes a Chrome
trace whose events name the profiled operations."""

import json
import os
import time

import pytest
import torch

from gauspcc_tpu.utils import profiling as jprofiling

from gauspcc_tpu_torch.utils import profiling


def _drive(timer):
    for name, n in (("feat", 3), ("blend", 1), ("adam", 2)):
        for _ in range(n):
            with timer.phase(name):
                time.sleep(0.001)


def test_phase_timer_counts_and_summary_match_jax():
    got, want = profiling.PhaseTimer(device="cpu"), jprofiling.PhaseTimer()
    _drive(got)
    _drive(want)
    assert dict(got.counts) == dict(want.counts) == {"feat": 3, "blend": 1,
                                                      "adam": 2}
    assert all(got.totals[k] >= 0.001 * n for k, n in got.counts.items())
    # the same totals give the same text
    for t in (got, want):
        t.totals.update({"feat": 1.23456, "blend": 0.0004, "adam": 12.5})
    assert got.summary() == want.summary() == (
        "adam 12.500s/2x, blend 0.000s/1x, feat 1.235s/3x")
    got.reset()
    want.reset()
    assert got.summary() == want.summary() == ""


def test_phase_timer_counts_a_phase_that_raises():
    timer = profiling.PhaseTimer(device="cpu")
    with pytest.raises(ValueError):
        with timer.phase("bad"):
            raise ValueError("inside")
    assert timer.counts["bad"] == 1


def test_phase_timer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA"):
        profiling.PhaseTimer()


def test_device_memory_stats_is_empty_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: its stats are not empty")
    assert profiling.device_memory_stats() == jprofiling.device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, device="cpu") as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names
    assert any(e.key in ("aten::mm", "aten::matmul") for e in prof.key_averages())
