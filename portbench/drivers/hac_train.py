"""HAC's phase-2 training steps, closed loop (cell hac.train_rd).

Set-up does what the port's `train_scene` (models/hac/pipeline.py:196-362)
does up to a step after `update_until`: the seeded state fitted to its
context box (`update_anchor_bound`, the family's `extra_init`), the
family's step function (`make_train_step` with HAC's `training_loss`), the
per-group Adam at the step count of the window's first step, the raster
caps grown by `adapt_caps` until they hold (as the checks every 500 steps
have left them by then), cameras in `rng.permutation` order. It then takes
the first three steps through the window's own call, on three different
cameras, which the plain reference follows after the window. The window
takes steps until `seconds` have passed, the caps checked at every step
that is a multiple of CAP_ADAPT_EVERY, as train_scene does; no
densification (steps after 15,000 have none). Each step's quantisation
noise is drawn by the benchmark from the seed and handed to the step.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import harness
from portbench.counts import blend as blend_counts
from portbench.counts import hac_ops
from portbench.drivers import _hac
from portbench.reference import hac as ref
from portbench.traffic import hac_scene

# limits of the checks (PERF.md gives the readings they were set from)
LIMITS = {"loss_gap": 4e-3, "grad_gap": 0.06, "change_gap": 1.5e-3,
          "step1_change_gap": 0.15}
CHECK_STEPS = 3
TRACE_FRAMES = 6  # steps whose blends the traced run counts


class Session:
    def __init__(self, cell, seed: int, device):
        from gauspcc_tpu_torch.models import registry
        from gauspcc_tpu_torch.models.hac import model as hac
        from gauspcc_tpu_torch.models.hac import pipeline
        from gauspcc_tpu_torch.models.hac import train as hac_train

        self.limits = {**LIMITS, **cell.limits}
        self.pipeline, self.hac_train, self.hac = pipeline, hac_train, hac
        inp = self.inp = _hac.Inputs(cell, seed, device, with_frames=True)
        harness.mark("inputs")
        dev = inp.device
        state, self.cfg = _hac.program_state(inp, cell.config)
        harness.mark("state")
        self.family = family = registry.get_family("hac")
        if family.extra_init is not None:
            state = family.extra_init(state, self.cfg)
        self.opt = hac_train.OptConfig(lmbda=cell.config["train"]["lmbda"])
        self.optimizer = hac_train.make_optimizer(self.opt, inp.geo.extent)
        self.params, self.rest = hac.split_state(state)
        self.opt_state = self.optimizer.init(hac_train.param_leaves(self.params))
        self.first_step = int(cell.traffic["first_step"])
        self.opt_state["count"] = self.first_step - 1
        self.stats = hac_train.zero_stats(inp.cap, self.cfg.n_offsets, dev)
        self.cams = [_hac.program_camera(inp.geo.cameras[i], dev, inp.frames[i])
                     for i in inp.geo.train_idx]
        cam0 = inp.geo.cameras[inp.geo.train_idx[0]]
        rcfg = _hac.program_raster(cam0)
        for _ in range(16):  # the checks before step 15,001 have grown them
            rcfg, grew = pipeline.adapt_caps(hac.merge_state(self.params, self.rest),
                                             self.cfg, rcfg, self.cams[0],
                                             log=lambda *_: None)
            if not grew:
                break
        self.caps = (rcfg.max_tiles_per_gaussian, rcfg.max_gaussians_per_tile)
        harness.mark("caps")
        self.rcfg = rcfg
        self.step_fn = self._make_step(rcfg)
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(len(self.cams)).tolist()
        self.gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
        self.it = self.first_step
        # the first steps, which the reference follows
        leaves = hac_train.param_leaves(self.params)
        self.check_cams, self.check_noise, self.losses = [], [], []
        for i in range(CHECK_STEPS):
            cam_i, noise, metrics = self._step()
            self.check_cams.append(cam_i)
            self.check_noise.append(noise)
            self.losses.append(metrics["loss"])
            if i == 0:
                self.mu1 = {k: v.clone() for k, v in self.opt_state["mu"].items()}
                self.after1 = {k: v.detach().clone() for k, v in leaves.items()}
        self.after = {k: v.detach().clone() for k, v in leaves.items()}

    def _make_step(self, rcfg):
        return self.hac_train.make_train_step(
            self.cfg, rcfg, self.optimizer, self.opt,
            loss_fn=self.family.training_loss, grad_mask=self.family.grad_mask,
            white_background=self.inp.white)

    def _step(self):
        it = self.it
        if it % self.pipeline.CAP_ADAPT_EVERY == 0:
            rcfg, grew = self.pipeline.adapt_caps(
                self.hac.merge_state(self.params, self.rest), self.cfg,
                self.rcfg, self.cams[0], log=lambda *_: None)
            if grew:
                self.rcfg, self.step_fn = rcfg, self._make_step(rcfg)
        if not self.order:
            self.order = self.rng.permutation(len(self.cams)).tolist()
        cam_i = self.order.pop()
        noise = hac_scene.noise_draw(self.inp.shape, self.inp.cap, self.gen,
                                     self.inp.device)
        self.params, self.opt_state, self.stats, metrics = self.step_fn(
            self.params, self.rest, self.opt_state, self.stats,
            self.cams[cam_i], phase=2, noise=noise)
        self.it += 1
        return cam_i, noise, metrics

    def window(self, seconds: float, trace: bool) -> harness.Window:
        records: dict = {}
        losses = []
        steps = 0
        rec = (_hac.record_blends(TRACE_FRAMES, records) if trace
               else contextlib.nullcontext())
        with rec:
            harness.sync(self.inp.device)
            t0 = time.perf_counter()
            while True:
                _, _, metrics = self._step()
                losses.append(metrics["loss"])
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            harness.sync(self.inp.device)
            t1 = time.perf_counter()
        window_s = t1 - t0
        loss = torch.stack(losses).cpu().numpy()
        failed = int((~np.isfinite(loss)).sum())
        self.records = records
        return harness.Window(attempted=steps, failed=failed,
                              values={"train_step_ms": window_s / steps * 1e3},
                              seconds=window_s)

    def trace_info(self) -> dict:
        """The counts behind the traced window's rooflines and mfu, from
        the blends it kept (worked out after the window)."""
        records = self.records
        fwd = [blend_counts.blend_bound(*r[:5], **r[5]) for r in records["forward"]]
        bwd = [blend_counts.backward_bound(*r[:5], **r[5]) for r in records["backward"]]
        n = min(len(fwd), len(bwd), len(records["visible"]))
        shape = self.inp.shape
        hw = self.inp.geo.cameras[0].hw
        ops = [hac_ops.train_step_ops(shape, int(records["visible"][i].sum()),
                                      hw, hw, fwd[i]["ops"], bwd[i]["ops"])
               for i in range(n)]
        self.records = {}
        return {"blend_fwd_bound_ms": [b["bound_ms"] for b in fwd],
                "blend_bwd_bound_ms": [b["bound_ms"] for b in bwd],
                "blend_fwd": fwd, "blend_bwd": bwd,
                "anchors": self.inp.points.shape[0], "rows": self.inp.cap,
                "caps_d_k": list(self.caps),
                "ops_per_unit": float(np.mean(ops)) if ops else None,
                "peak_flops": hac_ops.PEAK_FP32_FLOPS}

    def release(self) -> None:
        self.prog_losses = [float(x) for x in self.losses]
        del self.params, self.rest, self.opt_state, self.stats, self.step_fn
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False):
        """The plain reference's caps, first three losses, first gradient
        and leaves after three steps, from the same leaves, cameras and
        noise; in TF32 for the control."""
        inp = self.inp
        cam0 = inp.geo.cameras[inp.geo.train_idx[0]]
        ref_cams = [inp.ref_camera(inp.geo.cameras[i], inp.frames[i])
                    for i in inp.geo.train_idx]
        with ref.precision(tf32=tf32):
            P, rest = inp.leaves, inp.rest
            rcfg = cam0.raster_config()
            for _ in range(16):
                rcfg, grew = ref.adapt_caps(P, rest, inp.shape, rcfg, ref_cams[0])
                if not grew:
                    break
            losses, g1, after1, after = ref.train_steps(
                P, rest, inp.shape, [ref_cams[i] for i in self.check_cams],
                self.check_noise, rcfg, count0=self.first_step - 1,
                extent=inp.geo.extent, iterations=self.opt.iterations,
                lmbda=self.opt.lmbda, lambda_dssim=self.opt.lambda_dssim,
                white_background=inp.white)
        caps = (rcfg.max_tiles_per_gaussian, rcfg.max_gaussians_per_tile)
        return caps, losses, g1, after1, after

    def compare(self, got, want) -> list:
        """The checks of `got` (caps, losses, first gradient, leaves after
        the first and the third step) against the reference's `want`.
        Leaves whose reference gradient is under a thousandth of the median
        leaf's are left out (the deform MLP, which no loss term reaches)."""
        inp = self.inp
        caps, losses, g1, after1, after = want
        caps_gap = float(tuple(got[0]) != tuple(caps))
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got[1], losses))
        keep = harness.moved_leaves(g1)
        grad_gap, grad_leaf, grad_median = harness.leaf_norm_gaps(got[2], g1, keep)
        # the change: the worst leaf after the first step (Adam's first
        # update is about lr * sign(g), so it reads each leaf's rate), and
        # the median leaf after three: a leaf whose gradient components sit
        # near 0 turns float-order noise into whole steps, and the worst
        # leaf after three swings from seed to seed (PERF.md)
        ch = harness.change_gaps(inp.leaves, got[3], after1, got[4], after, g1,
                                 keep, lambda k: "/".join(k.split("/")[:2]))
        self.readings = {"grad_leaf": grad_leaf, "grad_median": grad_median,
                         **{f"change_{k}": v for k, v in ch.items()}}
        return [harness.Check("caps_differ", caps_gap, 0.0),
                harness.Check("loss_gap", loss_gap, self.limits["loss_gap"]),
                harness.Check("grad_gap", grad_gap, self.limits["grad_gap"]),
                harness.Check("change_gap", ch["median"], self.limits["change_gap"]),
                harness.Check("step1_change_gap", ch["step1"],
                              self.limits["step1_change_gap"])]

    def program_readings(self):
        g_prog = {k: v / (1 - ref.ADAM_B1) for k, v in self.mu1.items()}
        return self.caps, self.prog_losses, g_prog, self.after1, self.after

    def check(self) -> list:
        return self.compare(self.program_readings(), self.reference())

    def control(self) -> list:
        """The control's checks: the reference in TF32 in the program's
        place (run by portbench/calibrate.py, never by a benchmark run)."""
        want = self.reference()
        return self.compare(self.reference(tf32=True), want)


def setup(cell, seed: int, device):
    return Session(cell, seed, device)
