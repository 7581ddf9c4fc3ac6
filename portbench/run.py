"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in portbench/workloads/<name>.json,
its configuration in portbench/configs/<config>.json, its driver in
portbench/drivers/<driver>.py, and each per-layer metric that
BENCHMARK.json lists for the cell in portbench/layer_metrics/<metric>.py.
The system under test is the PyTorch and CUDA package gauspcc_tpu_torch;
nothing here imports JAX or the JAX package.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, the traced run's breakdown, and last the numbers
that decided `correct`, each beside its limit (also the last lines of
standard error). A run without a CUDA device, or with fewer than the cell
asks for, exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gauspcc_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (gauspcc_tpu_torch is not gauspcc_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _environment() -> None:
    """No JAX through a library, and few threads. The port's only build
    cache is its own gauspcc_tpu_torch/build/ inside the checkout (nvcc and
    g++, keyed by the sources' hash); it has no Triton and no
    torch.utils.cpp_extension."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process with few threads: the host's share of a run (numpy, the
    # launches) is single-threaded, and idle worker pools only contend
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from portbench import harness

    spec = harness.load_cell(args.workload)
    import torch

    harness.mark("imports")
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.chips:
        print(f"{spec.name} needs {spec.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.empty(1, device="cuda")
    harness.mark("cuda_init")
    result = harness.run_cell(spec, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), t_start=T_START,
                              device="cuda")
    found = forbidden_modules()
    if found:
        print("forbidden modules loaded in the measuring process: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in result.pop("_stderr_lines"):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
