"""Readings that the limits of `correct` are set from: for each seed, the
numbers a cell's check compares, for the program (a short window at the
cell's own load, then the plain reference) and, on the control seeds, for
the control (the reference in the next lower precision, in the program's
place). The benchmark's own runs do not run this.

    python3 -m portbench.calibrate --workload hac.train_rd --seeds 11 12 13 \
        --control-seeds 11 --seconds 2

One JSON line per seed and side on standard output.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[],
                    help="seeds on which the reference also meets itself "
                    "with its gradients jittered (training cells)")
    ap.add_argument("--jitter", type=float, nargs="*", default=[1e-3])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", help="plant this fault (portbench/faults.py) "
                    "in the program: the readings it gives")
    args = ap.parse_args(argv)
    import torch

    from portbench import faults, harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    spec = harness.load_cell(args.workload)
    drv = harness.driver(spec.driver)
    keep = ("readings", "caps", "k", "d")
    for seed in args.seeds:
        t0 = time.perf_counter()
        session = drv.setup(spec, seed, args.device)
        t1 = time.perf_counter()
        win = session.window(args.seconds, trace=False)
        session.release()
        t2 = time.perf_counter()
        checks = session.check()
        t3 = time.perf_counter()
        print(json.dumps({
            "workload": spec.name, "seed": seed,
            "side": args.fault or "program",
            "values": win.values, "setup_s": t1 - t0, "reference_s": t3 - t2,
            "checks": {c.name: c.value for c in checks},
            "extra": {k: v for k, v in vars(session).items() if k in keep}},
            default=str), flush=True)
        others = ([("control", session.control)]
                  if seed in args.control_seeds else [])
        if seed in args.witness_seeds:
            others += [(f"witness_{j:g}", lambda j=j: session.witness(j))
                       for j in args.jitter]
        for side, fn in others:
            t4 = time.perf_counter()
            checks = fn()
            print(json.dumps({
                "workload": spec.name, "seed": seed, "side": side,
                "seconds": time.perf_counter() - t4,
                "checks": {c.name: c.value for c in checks},
                "extra": {k: v for k, v in vars(session).items() if k in keep}},
                default=str), flush=True)
        del session
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
