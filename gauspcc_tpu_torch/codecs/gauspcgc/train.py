"""GausPcgc codec trainer: the port's counterpart of
gauspcc_tpu/codecs/gauspcgc/train.py (`TrainConfig` :37, `make_optimizer`
:54, `SibLevel` :102, `_bucket_train` :120, `pyramid_batches_sib` :143,
`pyramid_batches` :242, `_batch_bits` :261, `cloud_bits` :283,
`train_step` :296, `setup_logger` :322, `_prepared_nbytes` :339, `train`
:364).

Parity with the reference single-GPU loop (GausPcgc/train.py:144-256):
Adam lr 5e-4 decayed x0.1 at [40k, 90k], 110k steps, a KD patch a step,
loss = the network's bpp, periodic validation with best-checkpoint
tracking, rotating-file and console logging, a crash dump.

A step builds (or takes from the geometry cache) the patch's
sibling-packed pyramid on the training device, then runs one forward and
one backward per level, so no graph spans the levels: the gradients
accumulate in `.grad`, are scaled by 1/n_points and applied by one Adam
update, and the step reads its bits from the device once. The trainer
builds the sib engine's levels (`pyramid_batches_sib`); `cloud_bits` and
`train_step` also take JAX's legacy levels of the general sparse conv
(`pyramid_batches`: codec engine 6's geometry), whose gradients come from
the general conv's scatter-free backward (ops/sparse.py).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from logging.handlers import RotatingFileHandler

import numpy as np
import torch

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import model
from gauspcc_tpu_torch.codecs.gauspcgc.codec import (
    MIN_BASE_POINTS, _gmap, _level_geometries)
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.ops import hostmap, sibconv, sparse
from gauspcc_tpu_torch.utils import checkpoint
from gauspcc_tpu_torch.utils.heartbeat import Heartbeat
from gauspcc_tpu_torch.utils.optim import GroupAdam

@dataclass
class TrainConfig:
    channels: int = 32
    kernel_size: int = 5
    learning_rate: float = 5e-4
    lr_decay: float = 0.1
    lr_decay_steps: tuple[int, ...] = (40_000, 90_000)
    max_steps: int = 110_000
    val_interval: int = 500
    log_interval: int = 100
    seed: int = 11
    model_dir: str = "./model/gauspcgc"

    @property
    def net(self) -> model.NetConfig:
        return model.NetConfig(self.channels, self.kernel_size)


def lr_schedule(cfg: TrainConfig):
    """optax's piecewise_constant_schedule(lr, {b: lr_decay}) in float32:
    the rate for an update whose count BEFORE the update is `count` (optax
    scales by the schedule at the state's count, then increments it), so a
    decay applies from the update with count >= b."""
    f32 = np.float32

    def sched(count: int) -> float:
        v = f32(cfg.learning_rate)
        for b in sorted(int(s) for s in cfg.lr_decay_steps):
            if count >= b:
                v = f32(f32(cfg.lr_decay) * v)
        return float(v)

    return sched


def make_optimizer(cfg: TrainConfig) -> GroupAdam:
    """optax.adam(piecewise schedule, eps=1e-8) as a one-group GroupAdam,
    which hands its rate function the count after the increment."""
    sched = lr_schedule(cfg)
    return GroupAdam({"net": lambda count: sched(count - 1)},
                     lambda name: "net", eps=1e-8)


class SibLevel:
    """Device tensors for one coded level in sibling-packed layout; the
    group maps are `sibconv.GroupMap`s, shared between a level's children
    and the next level's parents."""

    __slots__ = ("pocc", "pmask", "p_maps", "ppos", "c_maps", "cmask", "gt")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _bucket_train(n: int, minimum: int = 256) -> int:
    """Pure power-of-two capacity for training shapes (not the codec's
    `_bucket`, which steps by 16384 above 16384): JAX chose it to halve
    its per-shape compiles, and the port keeps its shapes, whose padding
    leaves the bits unchanged."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pyramid_batches_sib(xyz_int: np.ndarray, device):
    """The sibling-packed training levels of a cloud, built on `device`.

    One k=3 group map per pyramid level (`codec._gmap`), converted to its
    gather rows and their flip once and shared between that level's
    children and the next level's parents, plus the packed occupancy, masks
    and targets. The maps are k=3 whatever the conv's kernel size, as
    JAX's. Returns ([SibLevel] per coded level, n_points)."""
    dev = torch.device(device)
    xyz_int = np.asarray(xyz_int, np.int64)
    xyz0 = sparse.dedupe_lex(xyz_int - xyz_int.min(axis=0))
    levels = sparse.build_occupancy_pyramid(xyz0, min_points=MIN_BASE_POINTS,
                                            sorted_unique=True)
    coords = [torch.as_tensor(c, device=dev) for c, _ in levels]
    occs = [torch.as_tensor(o.astype(np.int64), device=dev) for _, o in levels]
    caps = [_bucket_train(c.shape[0]) for c in coords]
    # the finest level needs no map of its own
    maps = [sibconv.GroupMap(_gmap(coords[d], caps[d]))
            for d in range(len(levels) - 1)]
    groups0 = hostmap.dedupe(coords[0].to(torch.int64) >> 1)
    g0cap = _bucket_train(groups0.shape[0])
    map0 = sibconv.GroupMap(_gmap(groups0, g0cap))
    for m in [map0, *maps]:
        m.flipped  # built now, so the geometry cache holds and counts it

    out = []
    octs = torch.arange(8, device=dev)
    for d in range(len(levels) - 1):
        pcoords, pocc, cap = coords[d], occs[d], caps[d]
        nd = pcoords.shape[0]
        if d == 0:
            gp_coords, gp_cap, gp_map = groups0, g0cap, map0
        else:
            gp_coords, gp_cap, gp_map = coords[d - 1], caps[d - 1], maps[d - 1]
        pos = sibconv.sib_pos(pcoords, gp_coords)
        pocc_packed = torch.zeros(gp_cap * 8, dtype=torch.int64, device=dev)
        pocc_packed[pos] = pocc
        pmask = torch.zeros(gp_cap * 8, dtype=torch.bool, device=dev)
        pmask[pos] = True
        cmask = torch.zeros(cap * 8, dtype=torch.bool, device=dev)
        cmask[: nd * 8] = ((pocc[:, None] >> octs) & 1).bool().reshape(-1)
        cpos = sibconv.sib_pos(coords[d + 1], pcoords)
        gt = torch.zeros(cap * 8, dtype=torch.int32, device=dev)
        gt[cpos] = occs[d + 1].to(torch.int32)
        ppos = torch.zeros(cap, dtype=torch.int64, device=dev)
        ppos[:nd] = pos
        out.append(SibLevel(pocc=pocc_packed, pmask=pmask, p_maps=gp_map,
                            ppos=ppos, c_maps=maps[d], cmask=cmask, gt=gt))
    return out, xyz0.shape[0]


def pyramid_batches(xyz_int: np.ndarray, kernel_size: int, device):
    """JAX's legacy training levels over the general sparse conv: codec
    engine 6's geometry (`codec._LevelGeometry`: host-built children and
    packed window maps, shipped to `device`, adjacent levels sharing a map
    where their capacities agree). Returns ([(geometry, gt int32 [ccap])]
    per coded level, n_points)."""
    dev = torch.device(device)
    xyz_int = np.asarray(xyz_int, np.int64)
    xyz0 = sparse.dedupe_lex(xyz_int - xyz_int.min(axis=0))
    levels = sparse.build_occupancy_pyramid(xyz0, min_points=MIN_BASE_POINTS,
                                            sorted_unique=True)
    out = []
    for d, g in enumerate(_level_geometries(levels, kernel_size, dev)):
        gt = np.zeros(g.ccap, np.int32)
        gt[: g.n_child] = levels[d + 1][1]
        out.append((g, torch.as_tensor(gt, device=dev)))
    return out, xyz0.shape[0]


def _batch_bits(net, net_cfg: model.NetConfig, b):
    """(bits, valid children) of one level: a SibLevel, or a legacy
    (geometry, gt) tuple from `pyramid_batches`."""
    if isinstance(b, tuple):
        g, gt = b
        return model.level_bits_packed(net, net_cfg, g.po, g.pm, g.p_map,
                                       g.octant, g.parent_idx, g.child_mask,
                                       g.c_map, gt)
    return model.level_bits_sib(net, net_cfg, b.pocc, b.pmask, b.p_maps,
                                b.ppos, b.c_maps, b.cmask, b.gt)


def _device_of(net) -> torch.device:
    return next(net.parameters()).device


def cloud_bits(net, net_cfg: model.NetConfig, xyz_int: np.ndarray,
               prepared=None) -> tuple[float, int]:
    """Teacher-forced total bits for a whole cloud (the validation metric),
    on the network's device; one read from the device."""
    with torch.no_grad():
        batches, n_points = (prepared if prepared is not None
                             else pyramid_batches_sib(xyz_int, _device_of(net)))
        total = None
        for b in batches:
            bits, _ = _batch_bits(net, net_cfg, b)
            total = bits if total is None else total + bits
    return float(total), n_points


def train_step(net, optimizer: GroupAdam, opt_state: dict,
               net_cfg: model.NetConfig, xyz_int: np.ndarray | None,
               prepared=None) -> tuple[dict, float]:
    """One step on one patch: per level a forward and a backward into
    `.grad`, then one Adam update of the gradients times 1/n_points, in
    place. `prepared`: (batches, n_points) from `pyramid_batches_sib`, which
    the trainer caches per patch, or from `pyramid_batches`. Returns
    (opt_state, bpp)."""
    batches, n_points = (prepared if prepared is not None
                         else pyramid_batches_sib(xyz_int, _device_of(net)))
    leaves = dict(net.named_parameters())
    for p in leaves.values():
        p.grad = None
    total = None
    for b in batches:
        bits, _ = _batch_bits(net, net_cfg, b)
        bits.backward()
        bits = bits.detach()
        total = bits if total is None else total + bits
    inv_n = float(np.float32(1.0 / n_points))
    grads = {k: p.grad * inv_n for k, p in leaves.items()}
    for p in leaves.values():
        p.grad = None
    opt_state = optimizer.update(grads, opt_state, leaves)
    return opt_state, float(total) / n_points


def setup_logger(log_dir: str, name: str = "gauspcgc") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fh = RotatingFileHandler(
        os.path.join(log_dir, "train.log"), maxBytes=10 * 1024 * 1024, backupCount=5
    )
    ch = logging.StreamHandler()
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    fh.setFormatter(fmt)
    ch.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger


def _prepared_nbytes(prepared) -> int:
    """Device bytes held by one prepared cloud (geometry-cache accounting).
    Counts each tensor once: adjacent levels share their maps."""
    batches, _ = prepared
    seen: set = set()
    total = 0
    for b in batches:
        if isinstance(b, tuple):
            g, gt = b
            parts = [g.po, g.pm, g.octant, g.parent_idx, g.child_mask,
                     *g.p_map, *g.c_map, gt]
        else:
            parts = [getattr(b, name) for name in b.__slots__]
        for a in parts:
            if id(a) not in seen:
                seen.add(id(a))
                total += (a.nbytes if isinstance(a, sibconv.GroupMap)
                          else a.numel() * a.element_size())
    return total


def _opt_state_from_host(snap: dict, device) -> dict:
    return {"mu": {k: torch.as_tensor(v, device=device) for k, v in snap["mu"].items()},
            "nu": {k: torch.as_tensor(v, device=device) for k, v in snap["nu"].items()},
            "count": int(snap["count"])}


def train(cfg: TrainConfig, dataset, val_dataset=None, max_steps=None,
          scalar_logger=None, start_params=None, geo_cache_size: int = 64,
          resume_state: str | None = None, state_every: int = 1000,
          geo_cache_bytes: int = 3_000_000_000, device="cuda"):
    """Full training loop over a PatchDataset; returns the trained network.

    dataset: `data.PatchDataset`; val_dataset: `data.WholeCloudDataset`.
    scalar_logger: an optional `utils.scalars.ScalarLogger`.
    start_params: a `GausPcgcNet` to start from instead of `model.init_net`
    (seeded with cfg.seed).
    geo_cache_size / geo_cache_bytes: patches whose device geometry (maps,
    masks, targets) stays resident between epochs, and their byte budget;
    the KD partition is deterministic, so a revisited patch costs no host
    work. A patch that does not fit is rebuilt each visit.
    resume_state: a train_state.pkl of an earlier run: the network, Adam's
    moments and count, the step and the best val bpp, so an interrupted
    run continues where it stopped; state_every: steps between snapshots.
    device: "cuda" by default; the CPU only when named."""
    dev = resolve(device)
    logger = setup_logger(cfg.model_dir)
    logger.info(f"config: {cfg}")
    # liveness file for an external stall watchdog, kept warm through the
    # first step and validation sweeps
    hb = Heartbeat(os.path.join(cfg.model_dir, "heartbeat"))
    net_cfg = cfg.net
    net = (start_params if start_params is not None
           else model.init_net(net_cfg, cfg.seed)).to(dev)
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(dict(net.named_parameters()))

    steps = max_steps or cfg.max_steps
    best_val = float("inf")
    step = 0
    state_path = os.path.join(cfg.model_dir, "train_state.pkl")
    if resume_state and os.path.exists(resume_state):
        snap = checkpoint.load_training_checkpoint(resume_state)
        net = convert.codec_params_from_numpy(snap["params"], net_cfg, dev)
        opt_state = _opt_state_from_host(snap["opt_state"], dev)
        step = int(snap["iteration"])
        best_val = float(snap.get("best_val", best_val))
        logger.info(f"resumed full state from {resume_state} at step {step}")
    step0 = step
    t0 = time.time()
    ema_bpp = None
    geo_cache: dict = {}
    geo_cache_used = 0
    try:
        while step < steps:
            for idx in dataset.epoch_order():
                if step >= steps:
                    break
                ckey, xyz = dataset.sample_with_key(idx)
                prepared = geo_cache.get(ckey)
                if prepared is None:
                    prepared = pyramid_batches_sib(xyz, dev)
                    nb = _prepared_nbytes(prepared)
                    if (len(geo_cache) < geo_cache_size
                            and geo_cache_used + nb <= geo_cache_bytes):
                        geo_cache[ckey] = prepared
                        geo_cache_used += nb
                with hb.guard("step"):
                    opt_state, bpp = train_step(net, optimizer, opt_state,
                                                net_cfg, None, prepared=prepared)
                hb.beat()
                step += 1
                if step == step0 + 1:
                    logger.info(
                        f"step {step} first step done "
                        f"({time.time() - t0:.1f}s incl. set-up)")
                ema_bpp = bpp if ema_bpp is None else 0.95 * ema_bpp + 0.05 * bpp
                if step % cfg.log_interval == 0 or (
                        step - step0 <= 100 and step % 10 == 0):
                    logger.info(
                        f"step {step} bpp {bpp:.4f} ema {ema_bpp:.4f} "
                        f"({(time.time()-t0)/max(step - step0, 1):.3f} s/step)"
                    )
                    if scalar_logger is not None:
                        scalar_logger.log(step, {
                            "train/bpp": bpp, "train/ema_bpp": ema_bpp,
                            "train/step_time":
                                (time.time() - t0) / max(step - step0, 1),
                        })
                if val_dataset is not None and step % cfg.val_interval == 0:
                    with hb.guard("val"):
                        # one val cloud's geometry on the device at a time
                        vb, vn = None, 0
                        with torch.no_grad():
                            for vi in range(len(val_dataset)):
                                batches, n = pyramid_batches_sib(
                                    val_dataset.get(vi), dev)
                                for lv in batches:
                                    b, _ = _batch_bits(net, net_cfg, lv)
                                    vb = b if vb is None else vb + b
                                vn += n
                        vb = float(vb)  # one read for the whole val set
                    val_bpp = vb / max(vn, 1)
                    logger.info(f"step {step} val_bpp {val_bpp:.4f}")
                    if scalar_logger is not None:
                        scalar_logger.log(step, {"val/bpp": val_bpp})
                    if val_bpp < best_val:
                        best_val = val_bpp
                        checkpoint.save_pytree(
                            os.path.join(cfg.model_dir, "best_model.npz"), net)
                if step % 10_000 == 0:
                    checkpoint.save_pytree(
                        os.path.join(cfg.model_dir, f"ckpt_{step}.npz"), net)
                if state_every and step % state_every == 0:
                    if os.path.exists(state_path):
                        os.replace(state_path, state_path + ".prev")
                    checkpoint.save_training_checkpoint(state_path, {
                        "params": net, "opt_state": opt_state,
                        "iteration": step, "best_val": best_val,
                    })
    except Exception:
        # crash dump, as GausPcgc/train.py:237-240
        checkpoint.save_pytree(
            os.path.join(cfg.model_dir, f"error_model_{step}.npz"), net)
        raise
    checkpoint.save_pytree(os.path.join(cfg.model_dir, "final_model.npz"), net)
    return net
