"""Data-parallel GausPcgc codec training, a KD patch per rank a step
(counterpart of gauspcc_tpu/parallel/dp.py: `default_capacity_schedule`
:25, `pack_patch` :36, `stack_patches` :77, `make_dp_train_step` :89).

Each rank sums the teacher-forced bits of its own patch's levels
(`codecs/gauspcgc/model.py` `level_bits`: the geometry built on the
device from static shapes), one forward and one backward per level into
`.grad` as the single-process trainer does, so no graph spans the
levels; the gradients and the bpp are scaled by 1 / max(n_points, 1) and
mean-reduced over the group, and one Adam update, identical on every rank,
follows. A patch is packed into fixed per-level capacities (`pack_patch`),
so every rank runs the same shapes.

The capacity schedule of `default_capacity_schedule` divides by 8 a
level, the dyadic pyramid's shrinkage; a real KD patch is a surface whose
pyramid shrinks by about 4 a level, so at full width its coarser levels
overflow that schedule and `pack_patch` raises. Callers pass `caps` that
fit their patches.

`rank_main` is the rank program `dist.launch` runs: one DP step on the
inputs of a `dist.write_inputs` file's "codec" section, with Adam at
rate LR (1e-3, JAX's tests/test_parallel.py rate).
"""

from __future__ import annotations

import numpy as np
import torch

from gauspcc_tpu_torch.codecs.gauspcgc import model
from gauspcc_tpu_torch.ops import sparse
from gauspcc_tpu_torch.parallel import dist as pdist
from gauspcc_tpu_torch.utils.optim import GroupAdam

LR = 1e-3  # the rank program's Adam rate


def default_capacity_schedule(finest_cap: int = 4096, n_levels: int = 4):
    """Per-level parent capacities, coarse to fine: the finest divided by
    8 a level, floored at 64 (JAX's schedule)."""
    caps = []
    c = finest_cap
    for _ in range(n_levels):
        caps.append(max(c, 64))
        c //= 8
    return caps[::-1]


def pack_patch(xyz_int: np.ndarray, caps: list[int]) -> dict:
    """One patch's finest len(caps) coded levels in fixed capacities, as
    JAX's: per level pc int32 [cap, 3], po int32 [cap], pm bool [cap] and
    gt int32 [cap * 8] (the parents, their occupancy, their mask, the
    children's occupancy in sorted order), plus n_points (int32). A patch
    with fewer levels has empty (masked) coarse levels. Raises if a level
    has more parents than its capacity."""
    xyz0 = sparse.dedupe_lex(xyz_int - xyz_int.min(axis=0))
    levels = sparse.build_occupancy_pyramid(xyz0, min_points=64,
                                            sorted_unique=True)
    n_levels = len(caps)
    trans = [(levels[d], levels[d + 1]) for d in range(len(levels) - 1)]
    trans = trans[-n_levels:]
    out = {"pc": [], "po": [], "pm": [], "gt": []}
    for i, cap in enumerate(caps):
        j = i - (n_levels - len(trans))
        pc = np.zeros((cap, 3), np.int32)
        po = np.zeros(cap, np.int32)
        pm = np.zeros(cap, bool)
        gt = np.zeros(cap * 8, np.int32)
        if j >= 0:
            (c, o), (_, go) = trans[j]
            if c.shape[0] > cap:
                raise ValueError(f"level {i}: {c.shape[0]} parents > cap {cap}")
            pc[: c.shape[0]] = c
            po[: c.shape[0]] = o
            pm[: c.shape[0]] = True
            gt[: go.shape[0]] = go
        for key, v in zip(("pc", "po", "pm", "gt"), (pc, po, pm, gt)):
            out[key].append(v)
    out["n_points"] = np.int32(xyz0.shape[0])
    return out


def stack_patches(patches: list[dict], device) -> dict:
    """Per-rank patches stacked on a leading rank axis, on `device`; rank r
    takes row r. n_points stays a host array."""
    n_levels = len(patches[0]["pc"])
    batch = {key: [torch.as_tensor(np.stack([p[key][i] for p in patches]),
                                   device=device)
                   for i in range(n_levels)]
             for key in ("pc", "po", "pm", "gt")}
    batch["n_points"] = np.stack([p["n_points"] for p in patches])
    return batch


def patch_gradients(net: model.GausPcgcNet, net_cfg: model.NetConfig,
                    levels, n_points: int):
    """One patch's gradients and bpp: per level (pc, po, pm, gt) a forward
    and a backward into `.grad`, then the gradients and the summed bits
    divided by max(n_points, 1). -> (grads by parameter name, bpp)."""
    leaves = dict(net.named_parameters())
    for p in leaves.values():
        p.grad = None
    total = None
    for pc, po, pm, gt in levels:
        bits, _ = model.level_bits(net, net_cfg, pc, po, pm, gt)
        bits.backward()
        total = bits.detach() if total is None else total + bits.detach()
    n = float(max(int(n_points), 1))
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) / n
             for k, p in leaves.items()}
    for p in leaves.values():
        p.grad = None
    return grads, total / n


def make_dp_train_step(optimizer: GroupAdam, net_cfg: model.NetConfig):
    """step(net, opt_state, batch) -> (opt_state, mean bpp, grads), on every
    rank of the default process group.

    `batch`: stack_patches of one packed patch a rank. The first call
    broadcasts the network's parameters from rank 0. The parameters and
    moments are updated in place; `grads` are the mean-reduced gradients by
    parameter name."""
    replicated = [False]

    def step(net, opt_state, batch):
        rank = torch.distributed.get_rank()
        leaves = dict(net.named_parameters())
        if not replicated[0]:
            pdist.broadcast_(leaves)
            replicated[0] = True
        levels = [tuple(batch[k][i][rank] for k in ("pc", "po", "pm", "gt"))
                  for i in range(len(batch["pc"]))]
        grads, bpp = patch_gradients(net, net_cfg, levels,
                                     batch["n_points"][rank])
        pdist.all_reduce_mean_({**grads, "__bpp__": bpp})
        opt_state = optimizer.update(grads, opt_state, leaves)
        return opt_state, float(bpp), grads

    return step


def adam(lr: float) -> GroupAdam:
    """optax.adam(lr) (eps 1e-8) as a one-group GroupAdam."""
    return GroupAdam({"net": lambda count: lr}, lambda name: "net", eps=1e-8)


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------

def codec_inputs(net: model.GausPcgcNet, net_cfg: model.NetConfig,
                 patches: list[dict]):
    """The "codec" section for `dist.write_inputs`: the network (JAX's
    keys) and one packed patch a rank."""
    from gauspcc_tpu_torch.utils.checkpoint import flatten

    arrays = {f"net/{k}": v for k, v in flatten(net).items()}
    for i in range(len(patches[0]["pc"])):
        for key in ("pc", "po", "pm", "gt"):
            arrays[f"{key}{i}"] = np.stack([p[key][i] for p in patches])
    arrays["n_points"] = np.stack([p["n_points"] for p in patches])
    meta = {"net_cfg": list(net_cfg), "n_levels": len(patches[0]["pc"])}
    return arrays, meta


def rank_main(rank: int, world: int, device, in_path: str, out_dir: str):
    """Take one DP step at Adam's rate LR on the "codec" section on this
    rank and write its parameters, the reduced gradients and the bpp to
    `dist.output_path(out_dir, "codec", rank)`."""
    from gauspcc_tpu_torch import convert

    arrays, meta = pdist.read_inputs(in_path, "codec")
    net_cfg = model.NetConfig(*meta["net_cfg"])
    net = convert.codec_params_from_numpy(
        {k[len("net/"):]: v for k, v in arrays.items() if k.startswith("net/")},
        net_cfg, device)
    optimizer = adam(LR)
    opt_state = optimizer.init(dict(net.named_parameters()))
    batch = {key: [torch.as_tensor(arrays[f"{key}{i}"], device=device)
                   for i in range(meta["n_levels"])]
             for key in ("pc", "po", "pm", "gt")}
    batch["n_points"] = arrays["n_points"]
    _, bpp, grads = make_dp_train_step(optimizer, net_cfg)(net, opt_state,
                                                           batch)
    np.savez(pdist.output_path(out_dir, "codec", rank),
             **pdist.to_numpy(dict(net.named_parameters()), "param/"),
             **pdist.to_numpy(grads, "grad/"), bpp=np.float64(bpp))
