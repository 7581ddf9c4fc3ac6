"""What the benchmark imports: nothing of JAX or the JAX package in the
process that measures, and nothing of the program in the reference."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "gauspcc_tpu"}


def test_a_run_process_loads_no_jax():
    """Importing the entry, the harness, every driver, every metric and the
    program modules the drivers reach leaves no module whose whole
    top-level name is JAX's or the JAX package's."""
    bench = harness.benchmark()
    drivers = sorted({json.loads((HERE / "workloads" / f"{w['name']}.json")
                                 .read_text())["driver"]
                      for w in bench["workloads"]})
    metrics = [m["name"] for m in bench["per_layer"]]
    code = f"""
import sys, json
import portbench.run, portbench.calibrate
from portbench import harness
for d in {drivers!r}:
    harness.driver(d)
for m in {metrics!r}:
    harness.metric_reader(m)
import gauspcc_tpu_torch.convert
import gauspcc_tpu_torch.models.registry
import gauspcc_tpu_torch.models.hac.pipeline
import gauspcc_tpu_torch.codecs.gauspcgc.codec
import gauspcc_tpu_torch.codecs.gauspcgc.train
import gauspcc_tpu_torch.utils.network_gui
print(json.dumps(sorted({{m.split('.')[0] for m in list(sys.modules)}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gauspcc_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = _imports(path)
    assert not tops & (FORBIDDEN | {"gauspcc_tpu_torch"}), tops


def test_no_benchmark_file_imports_jax():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path
