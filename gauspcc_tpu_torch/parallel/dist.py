"""Process groups for the port's data parallelism: the counterpart of the
JAX package's `jax.sharding.Mesh` with one "dp" axis and `shard_map`
(gauspcc_tpu/parallel/dp.py, dp_scene.py), on `torch.distributed`.

`launch` starts `world` rank processes with torch.multiprocessing's
"spawn" method. They meet through a file (`init_method="file://<dir>/
rdzv"`, a fresh directory a launch), so launches that run at the same
time never race for a TCP port. Each rank pins its device: `cuda:(rank %
device_count)`, or the CPU when the caller asks, where it runs torch on
one thread (several ranks, and several test workers, share the cores).
A rank runs functions of this package, which read their inputs from an
`.npz` file (`write_inputs` / `read_inputs`) and write their outputs
beside it, so a rank process imports torch and the port only (a rank
that finds JAX loaded raises).

The backend is the caller's: "nccl" for one rank per card, "gloo" for
the CPU or for several ranks on one card (NCCL refuses two ranks on one
device). Nothing switches it: a failed NCCL init or collective raises.
Gloo reduces CUDA tensors as they are: this module stages nothing
through host memory.

`all_reduce_mean_` is JAX's `pmean` over a dict of tensors: one float32
bucket, one summing `all_reduce`, a division by the world size, copied
back in place; `all_reduce_sum_` is `psum`; `broadcast_` replicates
rank 0's tensors.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import sys
import tempfile
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gauspcc_tpu_torch.device import resolve

BACKENDS = ("nccl", "gloo")
# a collective or an init that waits longer than this raises
TIMEOUT = datetime.timedelta(minutes=5)


def rank_device(rank: int, device: str) -> torch.device:
    """The device of rank `rank`: the CPU when `device` is "cpu", else
    cuda:(rank % device_count)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init(rank: int, world: int, backend: str, device: str,
         rdzv_file: str) -> torch.device:
    """Join the default process group as `rank` of `world`, meeting through
    `rdzv_file`; returns the rank's device. NCCL is initialised eagerly
    on that device, so a failing NCCL raises here."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose one of {BACKENDS}")
    dev = rank_device(rank, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; use gloo on "
                         "the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{rdzv_file}", rank=rank,
        world_size=world, timeout=TIMEOUT,
        device_id=dev if backend == "nccl" else None)
    return dev


def _rank_main(rank, targets, world, backend, device, rdzv_file, in_path,
               out_dir):
    dev = init(rank, world, backend, device, rdzv_file)
    try:
        for target in targets:
            target(rank, world, dev, in_path, out_dir)
        if "jax" in sys.modules:
            raise RuntimeError(f"rank {rank} has imported JAX: a rank process "
                               f"imports torch and the port only")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(targets: Sequence[Callable], world: int, backend: str,
           device: str, in_path: str, out_dir: str) -> None:
    """Run `target(rank, world, device, in_path, out_dir)` for each of
    `targets`, in order, on `world` spawned ranks of one process group.
    The targets are functions of this package (a rank imports them, and
    nothing else, by name). Raises if any rank fails; the other ranks are
    then stopped."""
    rdzv_dir = tempfile.mkdtemp(prefix="rdzv-")
    try:
        mp.start_processes(
            _rank_main, args=(tuple(targets), world, backend, device,
                              os.path.join(rdzv_dir, "rdzv"), in_path, out_dir),
            nprocs=world, join=True, start_method="spawn")
    finally:
        shutil.rmtree(rdzv_dir, ignore_errors=True)


def _through_bucket_(tensors: dict[str, torch.Tensor], collective):
    """Pack the tensors into one float32 bucket, run `collective(bucket)`
    on it, and copy the result back into them."""
    items = list(tensors.values())
    if not items:
        return tensors
    with torch.no_grad():
        bucket = torch.cat([t.detach().reshape(-1).to(torch.float32)
                            for t in items])
        collective(bucket)
        off = 0
        for t in items:
            n = t.numel()
            t.copy_(bucket[off:off + n].view(t.shape))
            off += n
    return tensors


def all_reduce_mean_(tensors: dict[str, torch.Tensor]):
    """Replace every tensor by its mean over the default group (JAX's
    pmean), in place, through one float32 bucket; returns the dict."""
    def mean(bucket):
        dist.all_reduce(bucket, op=dist.ReduceOp.SUM)
        bucket /= dist.get_world_size()

    return _through_bucket_(tensors, mean)


def all_reduce_sum_(tensors: dict[str, torch.Tensor]):
    """Replace every tensor by its sum over the default group (JAX's
    psum)."""
    return _through_bucket_(tensors, lambda bucket: dist.all_reduce(
        bucket, op=dist.ReduceOp.SUM))


def broadcast_(tensors: dict[str, torch.Tensor]):
    """Replace every tensor by rank 0's, in place, through one float32
    bucket (every tensor this package replicates is float32)."""
    return _through_bucket_(tensors, lambda bucket: dist.broadcast(bucket,
                                                                   src=0))


def bucket_bytes(tensors: dict[str, torch.Tensor]) -> int:
    """The bytes of the float32 bucket that `all_reduce_mean_` reduces."""
    return 4 * sum(t.numel() for t in tensors.values())


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """Rank `rank`'s own generator, seeded from (seed, rank): the
    counterpart of the JAX step's per-device key (dp_scene.py:51)."""
    s = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


# ---------------------------------------------------------------------------
# rank inputs and outputs
# ---------------------------------------------------------------------------

def write_inputs(path: str, **sections) -> None:
    """One `.npz` of named sections, each (arrays, meta): the arrays under
    "<section>/<key>", the meta (JSON) under "<section>/__meta__"."""
    out = {}
    for name, (arrays, meta) in sections.items():
        for k, v in arrays.items():
            out[f"{name}/{k}"] = np.asarray(v)
        out[f"{name}/__meta__"] = np.asarray(json.dumps(meta))
    np.savez(path, **out)


def read_inputs(path: str, section: str) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, meta) of one section of a `write_inputs` file."""
    prefix = f"{section}/"
    with np.load(path) as data:
        arrays = {k[len(prefix):]: data[k] for k in data.files
                  if k.startswith(prefix)}
    meta = json.loads(str(arrays.pop("__meta__")))
    return arrays, meta


def output_path(out_dir: str, section: str, rank: int) -> str:
    return os.path.join(out_dir, f"{section}_rank{rank}.npz")


def to_numpy(tensors: dict[str, torch.Tensor], prefix: str) -> dict:
    return {f"{prefix}{k}": v.detach().cpu().numpy() for k, v in tensors.items()}
