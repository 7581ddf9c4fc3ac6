"""CAT-3DGS's phase-5 training steps, closed loop (cell cat3dgs.train_rd).

Set-up does what the port's `train_scene` does up to a phase-5 step, with
the published run's settings (configs/cat3dgs.json): the family
(`registry.get_family("cat3dgs")`) builds the state's shapes
(`init_state`) and the seeded leaves are copied in; its `extra_init` fits
the PCA frame (the port's LOF over the anchors); the per-group Adam at the
count before the window's first step; the raster caps grown by
`adapt_caps` until they hold; the view-frequency weights of the mask
(`--cam_mask 1`: `update_view_frequency` of every training camera's
prefilter mask, then `view_frequency_weights`), computed once and held
fixed through the window; cameras in `rng.permutation` order. Every step
goes through the family step (`make_train_step` with CAT's
`training_loss` and `grad_mask`) at the phase `phase_of_step` gives, with
the weights. The first three steps, on three different cameras, are
followed by the plain reference after the window, which fits the frame
and the weights of its own. Each step's noise (the attributes' and the
planes') is drawn by the benchmark from the seed.

In the cell's scene an anchor is seen by 16 to 21 of the 21 training
cameras, so its weight lies between about 0.76 and 1.0001, and fewer than
0.2% of the anchors fall below 0.99: the weights scale the mask's gradient
through the rate, and seldom its forward. `mask_weights_gap` reads that
gradient where the image leaves it alone.

A program whose step takes no `mask_weights` cannot run the published
configuration: set-up stops at once with an error.
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import NamedTuple

import numpy as np
import torch

from portbench import harness
from portbench.counts import arm_rate as arm_counts
from portbench.counts import blend as blend_counts
from portbench.counts import cat_ops
from portbench.drivers import _hac
from portbench.reference import cat3dgs as ref
from portbench.reference import hac as ref_hac
from portbench.traffic import cat_scene, hac_scene

# limits of the checks (PERF.md gives the readings they were set from)
LIMITS = {"loss_gap": 1.5e-3, "grad_gap": 0.06, "change_gap": 4e-4,
          "step1_change_gap": 0.15, "arm_bits_gap": 1e-3, "arm_grad_gap": 0.01,
          "frame_gap": 3e-3, "mask_weights_gap": 1e-3}
CHECK_STEPS = 3
TRACE_FRAMES = 6  # steps whose blends the traced run counts
FRAME = ("nets/field/rotation", "nets/field/pca_mean", "nets/field/pca_std")
ARM_LEAVES = ("nets/field/arms/", "nets/field/scales/")


class Readings(NamedTuple):
    """What a side gives for the checks: the caps, the first three losses,
    the first planes' bits a parameter, the first gradient, the leaves
    after the first and the third step, and the PCA frame (rotation, mean,
    std) the steps start from."""

    caps: tuple
    losses: list
    arm1: float
    g1: dict
    after1: dict
    after: dict
    frame: tuple


def frame_gaps(got: tuple, want: tuple) -> dict:
    """The gaps of a PCA frame from another: the rotations' columns up to
    their signs (|R_got^T R_want| against the identity, largest entry), the
    means' distance over the least std, the stds' largest relative gap."""
    rg, mg, sg = (t.detach().double().cpu() for t in got)
    rw, mw, sw = (t.detach().double().cpu() for t in want)
    eye = torch.eye(3, dtype=torch.float64)
    return {"rotation": float(((rg.T @ rw).abs() - eye).abs().max()),
            "mean": float(torch.linalg.norm(mg - mw) / sw.min()),
            "std": float((sg / sw - 1.0).abs().max())}


def along_gap(err: torch.Tensor, move: torch.Tensor) -> float:
    """|<err, move>| / <move, move>: how much of `move` an error repeats
    or undoes (0 where there is no move)."""
    err, move = err.double(), move.double()
    mm = float((move * move).sum())
    return abs(float((err * move).sum())) / mm if mm > 0 else 0.0


class Inputs(_hac.Inputs):
    """The `hac` cells' scene and anchors with CAT-3DGS's leaves."""

    def __init__(self, cell, seed: int, device):
        conf = cell.config
        self.shape = ref.CATShape.from_config(conf)
        sc = conf["scene"]
        self.white = bool(cell.traffic.get("white_background", True))
        self.geo = hac_scene.scene_geometry(seed, sc["resolution"], sc["n_gt"],
                                            sc["n_cams"], sc["n_seed_points"],
                                            sc["structure_seed"])
        self.device = torch.device(device)
        self.frames = hac_scene.gt_frames(self.geo, self.device, self.white)
        self.points = hac_scene.anchors(self.geo, self.shape.voxel_size, seed)
        self.leaves, self.rest = cat_scene.make_leaves(
            self.shape, self.points, seed, self.device)
        self.cap = self.rest["valid"].shape[0]


def program_config(conf: dict, family):
    m = conf["model"]
    cfg = family.make_config(
        feat_dim=m["feat_dim"], n_offsets=m["n_offsets"],
        voxel_size=m["voxel_size"], chcm_slices=tuple(m["chcm_slices"]),
        chcm_for_offsets=m["chcm_for_offsets"],
        chcm_for_scaling=m["chcm_for_scaling"], tri_feat=m["tri_feat"],
        base_resolution=m["base_resolution"],
        multiscale=tuple(m["multiscale"]), contract=m["contract"],
        q_feat=m["q_feat"], q_scaling=m["q_scaling"], q_offsets=m["q_offsets"])
    if tuple(cfg.field.layers_arm) != tuple(m["arm_layers"]):
        raise SystemExit(f"the program's ARMs are {cfg.field.layers_arm}, the "
                         f"configuration's {m['arm_layers']}")
    return cfg


class Session:
    def __init__(self, cell, seed: int, device):
        from gauspcc_tpu_torch.models import registry
        from gauspcc_tpu_torch.models.cat3dgs import render as cat_render
        from gauspcc_tpu_torch.models.hac import model as hac
        from gauspcc_tpu_torch.models.hac import pipeline
        from gauspcc_tpu_torch.models.hac import render as hac_render
        from gauspcc_tpu_torch.models.hac import train as hac_train

        if "mask_weights" not in inspect.signature(
                hac_train.step_gradients).parameters:
            raise SystemExit("the program's train step takes no mask_weights: "
                             "it cannot run CAT-3DGS's published --cam_mask 1")
        self.limits = {**LIMITS, **cell.limits}
        self.pipeline, self.hac_train, self.hac = pipeline, hac_train, hac
        self.family = family = registry.get_family("cat3dgs")
        self.cfg = cfg = program_config(cell.config, family)
        train = cell.config["train"]
        if train["cam_mask"] != 1:
            raise SystemExit("the cell runs the published --cam_mask 1")
        inp = self.inp = Inputs(cell, seed, device)
        harness.mark("inputs")
        dev = inp.device
        state = family.init_state(cfg, inp.points, np.random.default_rng(seed),
                                  device=dev)
        self.params, self.rest = hac.split_state(state)
        leaves = hac_train.param_leaves(self.params)
        if leaves.keys() != inp.leaves.keys():
            raise SystemExit("the program's leaves are not the benchmark's: "
                             f"{sorted(leaves.keys() ^ inp.leaves.keys())}")
        with torch.no_grad():
            for name, p in leaves.items():
                p.copy_(inp.leaves[name])
            for name in ("anchor", "rotation", "opacity"):
                self.rest["anchors"][name].copy_(inp.rest[name])
            self.rest["valid"].copy_(inp.rest["valid"])
        harness.mark("state")
        state = family.extra_init(hac.merge_state(self.params, self.rest), cfg)
        self.params, self.rest = hac.split_state(state)
        leaves = hac_train.param_leaves(self.params)
        for name in FRAME:  # the steps on both sides start from it
            inp.leaves[name] = leaves[name].detach().clone()
        self.frame = tuple(inp.leaves[name] for name in FRAME)
        harness.mark("pca_frame")
        self.opt = hac_train.OptConfig(iterations=train["iterations"],
                                       lmbda=train["lmbda"])
        self.optimizer = hac_train.make_optimizer(self.opt, inp.geo.extent)
        self.opt_state = self.optimizer.init(leaves)
        self.first_step = int(cell.traffic["first_step"])
        self.opt_state["count"] = self.first_step - 1
        self.stats = hac_train.zero_stats(inp.cap, cfg.n_offsets, dev)
        self.cams = [_hac.program_camera(inp.geo.cameras[i], dev, inp.frames[i])
                     for i in inp.geo.train_idx]
        rcfg = _hac.program_raster(inp.geo.cameras[inp.geo.train_idx[0]])
        for _ in range(16):
            rcfg, grew = pipeline.adapt_caps(hac.merge_state(self.params, self.rest),
                                             cfg, rcfg, self.cams[0],
                                             log=lambda *_: None)
            if not grew:
                break
        self.caps = (rcfg.max_tiles_per_gaussian, rcfg.max_gaussians_per_tile)
        self.rcfg = rcfg
        harness.mark("caps")
        with torch.no_grad():
            state = hac.merge_state(self.params, self.rest)
            counts = torch.zeros(inp.cap, device=dev)
            for cam in self.cams:
                counts = cat_render.update_view_frequency(
                    counts, hac_render.prefilter_voxel(state, cfg.as_hac(), cam,
                                                       rcfg))
            self.weights = cat_render.view_frequency_weights(
                counts, self.rest["valid"])
            w = self.weights[self.rest["valid"]]
            self.weight_stats = {
                "min": float(w.min()), "max": float(w.max()),
                "share_not_1": float((w != 1.0).float().mean()),
                "share_below_0.99": float((w < 0.99).float().mean())}
        harness.mark("mask_weights")
        self.step_fn = self._make_step(rcfg)
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(len(self.cams)).tolist()
        self.gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
        self.it = self.first_step
        if family.phase_of_step(self.it) != 5:
            raise SystemExit(f"step {self.it} is not in phase 5")
        leaves = hac_train.param_leaves(self.params)
        self.check_cams, self.check_noise, self.losses = [], [], []
        for i in range(CHECK_STEPS):
            cam_i, noise, metrics = self._step()
            self.check_cams.append(cam_i)
            self.check_noise.append(noise)
            self.losses.append(metrics["loss"])
            if i == 0:
                self.arm1 = metrics["arm_bit_per_param"]
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
        noise = cat_scene.noise_draw(self.inp.shape, self.inp.cap, self.gen,
                                     self.inp.device)
        self.params, self.opt_state, self.stats, metrics = self.step_fn(
            self.params, self.rest, self.opt_state, self.stats,
            self.cams[cam_i], phase=self.family.phase_of_step(it), noise=noise,
            mask_weights=self.weights)
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
        """The counts behind the traced window's shares, from the blends it
        kept and the configuration's shapes (worked out after the window)."""
        from gauspcc_tpu_torch.models.cat3dgs import field as cat_field

        records = self.records
        fwd = [blend_counts.blend_bound(*r[:5], **r[5]) for r in records["forward"]]
        bwd = [blend_counts.backward_bound(*r[:5], **r[5]) for r in records["backward"]]
        n = min(len(fwd), len(bwd), len(records["visible"]))
        shape = self.inp.shape
        hw = self.inp.geo.cameras[0].hw
        ops = [cat_ops.train_step_ops(shape, int(records["visible"][i].sum()),
                                      hw, hw, fwd[i]["ops"], bwd[i]["ops"])
               for i in range(n)]
        self.records = {}
        arm = arm_counts.arm_rate_bound(shape)
        return {"anchors": self.inp.points.shape[0], "rows": self.inp.cap,
                "base_resolution_rule": cat_field.adapt_resolution(
                    self.inp.points.shape[0]),
                "caps_d_k": list(self.caps), "mask_weights": self.weight_stats,
                "blend_fwd_bound_ms": [b["bound_ms"] for b in fwd],
                "blend_bwd_bound_ms": [b["bound_ms"] for b in bwd],
                "arm_rate_bound_ms": arm["bound_ms"], "arm_rate": arm,
                "ops_per_unit": float(np.mean(ops)) if ops else None,
                "peak_flops": cat_ops.PEAK_FP32_FLOPS}

    def release(self) -> None:
        self.prog_losses = [float(x) for x in self.losses]
        self.prog_arm1 = float(self.arm1)
        del self.params, self.rest, self.opt_state, self.stats, self.step_fn
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False):
        """The plain reference's Readings, from the same leaves, cameras and
        noise, with the weights and the frame of its own fit (its steps
        start from the program's frame, since each axis's sign is free),
        and its StepReadings; in TF32 for the control."""
        inp = self.inp
        frame = ref.fit_frame(torch.from_numpy(inp.points).to(inp.device))
        cam0 = inp.geo.cameras[inp.geo.train_idx[0]]
        ref_cams = [inp.ref_camera(inp.geo.cameras[i], inp.frames[i])
                    for i in inp.geo.train_idx]
        with ref_hac.precision(tf32=tf32):
            P, rest = inp.leaves, inp.rest
            rcfg = cam0.raster_config()
            for _ in range(16):
                rcfg, grew = ref.adapt_caps(P, rest, inp.shape, rcfg, ref_cams[0])
                if not grew:
                    break
            weights = ref.view_weights(P, rest, inp.shape, ref_cams, rcfg)
            steps = ref.train_steps(
                P, rest, inp.shape, [ref_cams[i] for i in self.check_cams],
                self.check_noise, weights, rcfg, count0=self.first_step - 1,
                extent=inp.geo.extent, iterations=self.opt.iterations,
                lmbda=self.opt.lmbda, lambda_dssim=self.opt.lambda_dssim,
                white_background=inp.white)
        caps = (rcfg.max_tiles_per_gaussian, rcfg.max_gaussians_per_tile)
        return Readings(caps, steps.losses, steps.arm1, steps.first,
                        steps.after1, steps.after, frame), steps

    def compare(self, got: Readings, want: Readings, steps) -> list:
        """The checks of `got` against the reference's `want`: hac.train_rd's
        five; the planes' bits at step 1 (`arm_bits_gap`, relative); the
        worst gap of the ARMs' and the planes' gradient norms at step 1
        (`arm_grad_gap`: lmbda and the rate's denominator make those
        gradients small, so `grad_gap`'s median-relative leaves may pass them
        by); the frame against the reference's own fit (`frame_gap`, the
        worst of `frame_gaps`); and the first mask gradient's error along the
        move the weights make in the reference's (with the weights against
        with weights of 1), as a share of that move, over the mask entries of
        the Gaussians the first view did not draw, which the image leaves
        alone (`mask_weights_gap`: a step that ignores the weights reads 1)."""
        inp = self.inp
        g1 = want.g1
        caps_gap = float(tuple(got.caps) != tuple(want.caps))
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses))
        arm_bits_gap = abs(got.arm1 - want.arm1) / abs(want.arm1)
        keep = harness.moved_leaves(g1)
        grad_gap, grad_leaf, grad_median = harness.leaf_norm_gaps(got.g1, g1, keep)
        arm_keys = [k for k in g1 if k.startswith(ARM_LEAVES)]
        arm_gap, arm_leaf, _ = harness.leaf_norm_gaps(got.g1, g1, arm_keys)
        ch = harness.change_gaps(inp.leaves, got.after1, want.after1, got.after,
                                 want.after, g1, keep, ref.group_of)
        frame = frame_gaps(got.frame, want.frame)
        free = ~steps.drawn
        move = (g1["anchors/mask"] - steps.mask_grad_unit)[free]
        mask_gap = along_gap((got.g1["anchors/mask"] - g1["anchors/mask"])[free],
                             move)
        self.readings = {"grad_leaf": grad_leaf, "grad_median": grad_median,
                         "arm_grad_leaf": arm_leaf, "moved_leaves": len(keep),
                         "leaves": len(g1),
                         **{f"change_{k}": v for k, v in ch.items()},
                         **{f"frame_{k}": v for k, v in frame.items()},
                         "arm_bits_f64_gap": abs(got.arm1 - steps.arm1_f64)
                         / abs(steps.arm1_f64),
                         "mask_free_entries": int(free.sum()),
                         "mask_move_share": float(torch.linalg.norm(move.double()))
                         / max(float(torch.linalg.norm(
                             g1["anchors/mask"][free].double())), 1e-300),
                         "weights": self.weight_stats}
        return [harness.Check("caps_differ", caps_gap, 0.0),
                harness.Check("loss_gap", loss_gap, self.limits["loss_gap"]),
                harness.Check("grad_gap", grad_gap, self.limits["grad_gap"]),
                harness.Check("change_gap", ch["median"], self.limits["change_gap"]),
                harness.Check("step1_change_gap", ch["step1"],
                              self.limits["step1_change_gap"]),
                harness.Check("arm_bits_gap", arm_bits_gap,
                              self.limits["arm_bits_gap"]),
                harness.Check("arm_grad_gap", arm_gap, self.limits["arm_grad_gap"]),
                harness.Check("frame_gap", max(frame.values()),
                              self.limits["frame_gap"]),
                harness.Check("mask_weights_gap", mask_gap,
                              self.limits["mask_weights_gap"])]

    def program_readings(self) -> Readings:
        g_prog = {k: v / (1 - ref_hac.ADAM_B1) for k, v in self.mu1.items()}
        return Readings(self.caps, self.prog_losses, self.prog_arm1, g_prog,
                        self.after1, self.after, self.frame)

    def check(self) -> list:
        return self.compare(self.program_readings(), *self.reference())

    def control(self) -> list:
        """The control's checks: the reference in TF32 in the program's
        place (run by portbench/calibrate.py, never by a benchmark run)."""
        want, steps = self.reference()
        return self.compare(self.reference(tf32=True)[0], want, steps)


def setup(cell, seed: int, device):
    return Session(cell, seed, device)
