"""GausPcgc codec training, closed loop of cached steps (cell
gauspcgc.train).

Set-up makes 4 clouds with the r5 corpus's generator (traffic/clouds.py
`synth_clouds`, "mixed") from the corpus's own seed 7 (`corpus_seed`: the
first 4 clouds of the regenerated r4 training corpus), the same for every
run so that every seed trains on patches of the same sizes, and cuts each
into KD patches of at most 150,000 points (`kdtree_partition`, data.py's
MAX_PATCH_POINTS), builds every patch's sibling-packed levels with the
program's `pyramid_batches_sib`, as its trainer caches them, makes the
weights from the seed (traffic/codec_weights.py) and hands them to the
program (`convert.codec_params_from_numpy`), with the trainer's optimizer
(`make_optimizer(TrainConfig())`: Adam, eps 1e-8, lr 5e-4). Patches are
visited in an order drawn from the seed, a new permutation after each
pass. The first three steps go through the window's own call
(`train_step(..., prepared=)`) on three different patches; the plain
reference follows them after the window. The window takes steps until
`seconds` have passed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness
from portbench.reference import gauspcgc as ref
from portbench.traffic import clouds as traffic
from portbench.traffic import codec_weights

LIMITS = {"loss_gap": 1e-6, "grad_gap": 5e-3, "change_gap": 1e-3,
          "step1_change_gap": 0.05}
CHECK_STEPS = 3


def _key(param_name: str) -> str:
    """The program's parameter name -> the JAX tree's key."""
    key = param_name.replace(".", "/")
    if key.endswith("/weight"):
        return key[: -len("weight")] + "w"
    if key.endswith("/bias"):
        return key[: -len("bias")] + "b"
    return key


def _dense_oriented(name: str, t: torch.Tensor) -> torch.Tensor:
    """A program leaf in the JAX key's orientation (nn.Linear is [out, in])."""
    return t.T if name.endswith(".weight") else t


class Session:
    def __init__(self, cell, seed: int, device):
        from gauspcc_tpu_torch import convert
        from gauspcc_tpu_torch.codecs.gauspcgc import model as net
        from gauspcc_tpu_torch.codecs.gauspcgc import train as pcc_train

        self.limits = {**LIMITS, **cell.limits}
        tr, conf = cell.traffic, cell.config
        self.device = dev = torch.device(device)
        self.train_mod = pcc_train
        self.k = conf["model"]["kernel_size"]
        self.cfg = pcc_train.TrainConfig(channels=conf["model"]["channels"],
                                         kernel_size=self.k)
        self.net_cfg = net.NetConfig(conf["model"]["channels"], self.k,
                                     conf["model"]["dtype"])
        self.patches = []
        for pts, _ in traffic.synth_clouds(tr["corpus_seed"], tr["clouds"],
                                           tr["kind"]):
            for part in traffic.kdtree_partition(pts, tr["max_patch_points"]):
                self.patches.append(np.round(part).astype(np.int64))
        harness.mark("patches")
        self.prepared = [pcc_train.pyramid_batches_sib(p, dev)
                         for p in self.patches]
        harness.mark("pyramids")
        self.w0 = codec_weights.seeded_weights(
            seed, conf["model"]["channels"], self.k, dev)
        self.net = convert.codec_params_from_numpy(
            {k: v.cpu().numpy() for k, v in self.w0.items()}, self.net_cfg,
            device=dev)
        self.optimizer = pcc_train.make_optimizer(self.cfg)
        self.opt_state = self.optimizer.init(dict(self.net.named_parameters()))
        harness.mark("weights")
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.order: list = []
        self.check_idx, self.losses = [], []
        for i in range(CHECK_STEPS):
            idx, loss = self._step()
            self.check_idx.append(idx)
            self.losses.append(loss)
            if i == 0:
                self.mu1 = {_key(k): _dense_oriented(k, v).clone()
                            for k, v in self.opt_state["mu"].items()}
                self.after1 = self._leaves()
        self.after = self._leaves()

    def _leaves(self) -> dict:
        return {_key(k): _dense_oriented(k, v.detach()).clone()
                for k, v in self.net.named_parameters()}

    def _step(self):
        if not self.order:
            self.order = self.rng.permutation(len(self.patches)).tolist()
        idx = self.order.pop()
        self.opt_state, bpp = self.train_mod.train_step(
            self.net, self.optimizer, self.opt_state, self.net_cfg, None,
            prepared=self.prepared[idx])
        return idx, bpp

    def window(self, seconds: float, trace: bool) -> harness.Window:
        steps, failed = 0, 0
        harness.sync(self.device)
        t0 = time.perf_counter()
        while True:
            _, bpp = self._step()
            failed += int(not np.isfinite(bpp))
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        harness.sync(self.device)
        window_s = time.perf_counter() - t0
        return harness.Window(attempted=steps, failed=failed,
                              values={"codec_step_ms": window_s / steps * 1e3},
                              seconds=window_s)

    def trace_info(self) -> dict:
        from portbench.counts import codec_ops

        ops = []
        for p in self.patches:
            levels = ref.build_pyramid(p - p.min(axis=0))
            # a training step runs the network forward once and backward
            # (two products per conv) once: 3 / 2 of a round trip's count
            ops.append(codec_ops.round_trip_ops(levels, self.k,
                                                self.net_cfg.channels,
                                                self.device) * 3 // 2)
        return {"ops_per_unit": float(np.mean(ops)),
                "peak_flops": codec_ops.PEAK_BF16_FLOPS}

    def release(self) -> None:
        del self.net, self.opt_state, self.prepared
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, operand=torch.bfloat16, jitter: float = 0.0):
        patches = []
        for i in self.check_idx:
            p = self.patches[i]
            shifted = p - p.min(axis=0)
            patches.append((ref.build_pyramid(shifted),
                            ref.dedupe_lex(shifted).shape[0]))
        return ref.train_steps(self.w0, patches, kernel_size=self.k,
                               lr=self.cfg.learning_rate, decay=self.cfg.lr_decay,
                               decay_steps=self.cfg.lr_decay_steps,
                               operand=operand, jitter=jitter,
                               jitter_seed=self.seed)

    def compare(self, got, want) -> list:
        losses, g1, after1, after = want
        gaps = [abs(a - b) / abs(b) for a, b in zip(got[0], losses)]
        # the first step's loss: the later steps' read Adam's sign-like
        # first updates of near-zero gradient components, which float-order
        # noise flips (PERF.md: the reference against itself with its
        # gradients jittered reads as far; the worst step is kept among
        # the readings)
        loss_gap = gaps[0]
        keep = harness.moved_leaves(g1)
        grad_gap, grad_leaf, grad_median = harness.leaf_norm_gaps(got[1], g1, keep)
        # the change: the worst leaf after the first step (its rate, leaf
        # by leaf) and the median leaf after three (the later steps' update;
        # its worst leaf swings with the same noise)
        ch = harness.change_gaps(self.w0, got[2], after1, got[3], after, g1,
                                 keep, lambda k: k.split("/")[0])
        # the componentwise gap of the first gradients, median leaf: the
        # size of noise that the jittered witness gives the reference
        rel = [float(torch.linalg.norm((got[1][k] - g1[k]).double())
                     / torch.linalg.norm(g1[k].double())) for k in keep]
        self.readings = {"grad_leaf": grad_leaf, "grad_median": grad_median,
                         "grad_rel_median": float(np.median(rel)),
                         "loss_gap_worst_step": max(gaps), "loss_gaps": gaps,
                         **{f"change_{k}": v for k, v in ch.items()}}
        return [harness.Check("loss_gap", loss_gap, self.limits["loss_gap"]),
                harness.Check("grad_gap", grad_gap, self.limits["grad_gap"]),
                harness.Check("change_gap", ch["median"], self.limits["change_gap"]),
                harness.Check("step1_change_gap", ch["step1"],
                              self.limits["step1_change_gap"])]

    def plain(self):
        """The reference in the configuration's precision (kept: the
        control and the witness compare against it too)."""
        if not hasattr(self, "_plain"):
            self._plain = self.reference()
        return self._plain

    def check(self) -> list:
        g_prog = {k: v / (1 - ref.ADAM_B1) for k, v in self.mu1.items()}
        return self.compare((self.losses, g_prog, self.after1, self.after),
                            self.plain())

    def control(self) -> list:
        """The reference with float8 (e4m3) conv operands in the program's
        place."""
        return self.compare(self.reference(torch.float8_e4m3fn), self.plain())

    def witness(self, jitter: float) -> list:
        """The reference against itself with jitter * N(0, 1) times each
        leaf's root mean square added to its gradient components: how far
        Adam's first steps carry noise of that size (calibrate.py; never a
        benchmark run)."""
        return self.compare(self.reference(jitter=jitter), self.plain())


def setup(cell, seed: int, device):
    return Session(cell, seed, device)
