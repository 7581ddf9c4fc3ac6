"""The scene pipeline of every family: train a scene, then estimate (HAC
only), encode, decode and evaluate it, rendering the held-out views and
scoring them against ground truth (counterpart of
gauspcc_tpu/models/hac/pipeline.py: _raster_cfg :34, select_eval_d :75,
select_eval_k :94, adapt_caps :121, train_scene :150 with its resume
snapshot, heartbeat, scalar logging and divergence canary :150-362 and
its codec tail :365-405, render_sets :414, evaluate :447). The family
(`models/registry.py`) gives the state, the objective, the schedule and
the codec; every render goes through HAC's scaffold (`cfg.as_hac()`).

`evaluate` scores every view with PSNR, SSIM and LPIPS (`utils/lpips.py`:
the pretrained VGG16 weights when a weights file is present, else the
seeded surrogate, reported as "lpips_surrogate") and, given `out_dir`,
writes each render there as a PNG (`.npy` where PIL is missing), as the
JAX package's evaluate does (:447-503, _save_png :543). `train_scene`
serves the SIBR remote viewer between steps when given a
`utils.network_gui.NetworkGUI` (`_poll_gui`, JAX :505).
"""

from __future__ import annotations

import functools
import json
import os
import time
import traceback
from typing import Callable

import numpy as np
import torch

from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc_model
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.render import raster
from gauspcc_tpu_torch.utils import checkpoint, image as img_lib
from gauspcc_tpu_torch.utils.heartbeat import DivergenceMonitor, NullHeartbeat


def _raster_cfg(cam, max_k: int = 256, max_d: int = 32) -> raster.RasterConfig:
    return raster.RasterConfig(
        height=cam.height, width=cam.width,
        tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        max_gaussians_per_tile=max_k, max_tiles_per_gaussian=max_d)


def _device(state) -> torch.device:
    return state["anchors"]["anchor"].device


def _base(cfg) -> hac.HACConfig:
    """A family's config as HAC's, for the renders of the shared scaffold."""
    return cfg.as_hac() if hasattr(cfg, "as_hac") else cfg


@torch.no_grad()
def select_eval_d(state, cfg: hac.HACConfig, cameras, decoded: bool = False,
                  cap: int = 128) -> int:
    """Smallest power-of-two D (from 4, at most `cap`) that covers the
    largest tile footprint over all views: below the cap it renders exactly
    as an unbounded D, and it only shrinks the binning sort."""
    cfg = _base(cfg)
    worst = 0
    for cam in cameras:
        rcfg = _raster_cfg(cam)
        ca = hac_render.CameraArrays.from_camera(cam, _device(state))
        visible = hac_render.prefilter_voxel(state, cfg, ca, rcfg, decoded)
        ng, _ = hac.generate_neural_gaussians(state, cfg, ca.camera_center,
                                              visible, decoded=decoded)
        fp = raster.max_tile_footprint(ng.xyz, ng.scaling, ng.rot,
                                       ca.viewmatrix, rcfg, valid=ng.valid)
        worst = max(worst, int(fp))
    d = 4
    while d < min(worst, cap):
        d *= 2
    return d


@torch.no_grad()
def select_eval_k(state, cfg: hac.HACConfig, cam, decoded: bool = False,
                  start_k: int = 256, max_k: int = 4096,
                  tol_db: float = 45.0) -> int:
    """Smallest per-tile cap K whose render matches the 2K render to at
    least tol_db PSNR, doubling from start_k (the reference blends
    unbounded lists; the far tail sits behind ever smaller transmittance)."""
    cfg = _base(cfg)
    dev = _device(state)
    ca = hac_render.CameraArrays.from_camera(cam, dev)
    bg = torch.zeros(3, device=dev)
    k = start_k
    img_k = hac_render.render_image(state, cfg, ca, _raster_cfg(cam, k), bg,
                                    decoded=decoded)
    while k < max_k:
        img_2k = hac_render.render_image(state, cfg, ca, _raster_cfg(cam, 2 * k),
                                         bg, decoded=decoded)
        if float(img_lib.psnr(img_k, img_2k)) >= tol_db:
            return k
        k *= 2
        img_k = img_2k
    return k


@torch.no_grad()
def adapt_caps(state, cfg: hac.HACConfig, rc: raster.RasterConfig, cam,
               log=print, max_d: int = 256, max_k: int = 1024):
    """Grow the bounded-work raster caps when the scene outgrows them:
    double D when over 5% of the visible Gaussians overflow it, K when over
    2% of the occupied tiles do (training against an over-truncated forward
    collapsed earlier soaks). `cam`: CameraArrays. Returns (rc, grew)."""
    cfg = _base(cfg)
    visible = hac_render.prefilter_voxel(state, cfg, cam, rc)
    ng, _ = hac.generate_neural_gaussians(state, cfg, cam.camera_center, visible)
    sat = raster.tile_saturation(ng.xyz, ng.scaling, ng.rot, cam.viewmatrix,
                                 rc, valid=ng.valid)
    over_d, over_k, max_cnt = (float(sat[k]) for k in (
        "frac_gauss_over_d", "frac_tiles_over_k", "max_tile_count"))
    grew = False
    if over_d > 0.05 and rc.max_tiles_per_gaussian < max_d:
        rc = rc._replace(max_tiles_per_gaussian=rc.max_tiles_per_gaussian * 2)
        grew = True
    if over_k > 0.02 and rc.max_gaussians_per_tile < max_k:
        rc = rc._replace(max_gaussians_per_tile=rc.max_gaussians_per_tile * 2)
        grew = True
    if grew:
        log(f"raster caps -> D={rc.max_tiles_per_gaussian} "
            f"K={rc.max_gaussians_per_tile} (over_d {over_d:.3f}, "
            f"over_k {over_k:.3f}, max_tile {max_cnt:.0f})")
    return rc, grew


CAP_ADAPT_EVERY = 500  # steps between checks of the raster caps
CANARY_VIEWS, CANARY_K, CANARY_D = 2, 1024, 256  # the clean-render canary


def _snapshot(params, rest, opt_state, stats, it, gen, rng, order, rcfg):
    """What a resume needs, as `checkpoint.save_training_checkpoint` pickles
    it (numpy arrays and Python values)."""
    return {"params": params, "rest": rest, "opt_state": opt_state,
            "stats": stats, "iteration": it,
            "generator": gen.get_state(), "rng": rng.bit_generator.state,
            "order": list(order),
            "caps": (rcfg.max_tiles_per_gaussian, rcfg.max_gaussians_per_tile)}


def load_training_snapshot(path, cfg, device="cuda") -> dict:
    """A `train_ckpt.pkl` back on `device`: "state", "opt_state", "stats",
    "iteration", "generator" (a torch.Generator on the device), "rng"
    (numpy's), "order" (the cameras still to visit) and "caps" (D, K)."""
    from gauspcc_tpu_torch import convert

    dev = resolve(device)
    snap = checkpoint.load_training_checkpoint(path)
    params, rest = snap["params"], snap["rest"]
    state = convert.state_from_numpy({
        "anchors": {**params["anchors"], **rest["anchors"]},
        "nets": params["nets"], "valid": rest["valid"],
        "x_bound_min": rest["x_bound_min"],
        "x_bound_max": rest["x_bound_max"]}, cfg, dev)

    def tensors(tree):
        return {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}

    opt = snap["opt_state"]
    gen = torch.Generator(device=dev)
    gen.set_state(torch.from_numpy(snap["generator"]))
    rng = np.random.default_rng()
    rng.bit_generator.state = snap["rng"]
    return {"state": state, "opt_state": dict(opt, mu=tensors(opt["mu"]),
                                              nu=tensors(opt["nu"])),
            "stats": tensors(snap["stats"]), "iteration": snap["iteration"],
            "generator": gen, "rng": rng, "order": list(snap["order"]),
            "caps": tuple(snap["caps"])}


@torch.no_grad()
def canary_psnr(state, cfg, cameras, white_background: bool = False):
    """The clean-render canary: the mean PSNR of the first CANARY_VIEWS
    held-out views rendered at K CANARY_K and D CANARY_D (the training
    PSNR renders through quantization noise and the training caps, so it
    can look healthy while the true render rots). -> (mean, per view)."""
    cfg = _base(cfg)
    dev = _device(state)
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    ps = []
    for cam in cameras[:CANARY_VIEWS]:
        img = hac_render.render_image(
            state, cfg, hac_render.CameraArrays.from_camera(cam, dev),
            _raster_cfg(cam, CANARY_K, CANARY_D), bg)
        ps.append(float(img_lib.psnr(img, torch.from_numpy(cam.image).to(dev))))
    return float(np.mean(ps)), ps


def train_scene(scene, cfg, opt: hac_train.OptConfig, *,
                seed: int = 0, log_every: int = 200,
                white_background: bool = False,
                phase_of_step: Callable[[int], int] | None = None,
                log=print, device="cuda", model_dir: str | None = None,
                pcc_params=None, pcc_cfg=None, eval_at_end: bool = True,
                family=None, start_checkpoint: str | None = None,
                checkpoint_every: int = 0, stop_at: int | None = None,
                scalar_logger=None, heartbeat=None,
                divergence_drop_db: float = 3.0, gui=None):
    """Train one scene of `family` (a `registry.Family`, HAC's by default;
    `cfg` is its config type); returns (state, results).

    The loop of the JAX package's train_scene: cameras in the order of
    rng.permutation, the raster caps adapted at step 1 and every
    CAP_ADAPT_EVERY steps, the anchor bound refitted on entering phase 2, densification every `update_interval` steps between
    update_from and update_until. Unlike the JAX package's, the anchors
    are kept in the codec's order from the start and after each
    densification (`train.sort_anchors`), so the decoded scene renders as
    the trained one did.
    `phase_of_step` maps a step to its schedule stage, the family's unless
    given (a compressed one for short runs, cli/soak.py); on entering phase
    2 the family's `extra_init` runs, and its `grad_mask` on every step's
    gradients.

    Resume (JAX :150-170, :303-306): with `checkpoint_every` > 0 a snapshot
    goes to model_dir/train_ckpt.pkl every that many steps (the previous
    one kept as train_ckpt.pkl.prev): the leaves, the rest of the state,
    the moments and their count, the statistics, the iteration, the
    torch.Generator's and numpy rng's states, the cameras still to visit
    and the raster caps. `start_checkpoint` resumes from such a file;
    `stop_at` ends the run after that step (a cut run). A resumed run takes
    the same steps as one that was never cut. JAX's snapshot lacks the
    caps, so its resume starts from the default caps and adapts them at
    its first step (pipeline.py:241), where the uncut run does not adapt:
    that step differs whenever the check would grow a cap there. The port
    restores the caps and adapts them where the uncut run does.

    The canary (JAX :307-362): at each snapshot the first two test views
    are rendered at K 1024 and D 256 (`canary_psnr`), logged to
    `scalar_logger` as eval/psnr_clean, and once the PSNR falls more than
    `divergence_drop_db` below its running max (`DivergenceMonitor`) the
    run writes model_dir/DIVERGED.json and stops, returning results with
    "aborted_divergence" and no codec evaluation. `heartbeat` (a
    `utils.heartbeat.Heartbeat`) beats every step and guards the blocking
    sections; `scalar_logger` (`utils.scalars.ScalarLogger`) gets the
    train/* scalars every `log_every` steps and the eval/* ones at the end.
    `gui` (a `utils.network_gui.NetworkGUI`) is polled before every step
    (`_poll_gui`), the model directory as the viewer's verify string.

    results: "history" (per step: step, phase, loss, l1, psnr,
    bit_per_param, non-finite gradients, copied to the host once at the
    end), "densify" (per densification: step and adjust_anchor's info),
    "caps" (per cap change: step, D, K), "rcfg", "opt_state", "stats".

    With `model_dir` the trained state is saved there as model.npz (the
    JAX package's keys); with `pcc_params` (a GausPcgc network, `pcc_cfg`
    its NetConfig) and `eval_at_end` the scene is then estimated (HAC
    only), encoded into model_dir/bitstreams by the family's codec,
    decoded, and both the decoded and the float state are evaluated on the
    test views (the first two training views when there are none), their
    renders written to model_dir/test_renders and model_dir/float_renders.
    results then also has the decoded state's evaluation ("psnr", "ssim",
    the LPIPS key and "lpips_variant", "eval_k", "eval_d", "fps",
    "per_view"), "psnr_float", "codec_delta_db" (float minus decoded),
    "size_bits" and "size_mb", which results.json in model_dir holds."""
    dev = resolve(device)
    if family is None:
        from gauspcc_tpu_torch.models import registry

        family = registry.get_family("hac")
    if phase_of_step is None:
        phase_of_step = family.phase_of_step
    if checkpoint_every and model_dir is None:
        raise ValueError("checkpoint_every needs a model_dir to write to")
    if model_dir is not None:
        os.makedirs(model_dir, exist_ok=True)
    hb = heartbeat if heartbeat is not None else NullHeartbeat()
    canary_mon = DivergenceMonitor(drop_db=divergence_drop_db, warmup=1)
    optimizer = hac_train.make_optimizer(opt, scene.cameras_extent)
    cams = scene.train_cameras
    rcfg = _raster_cfg(cams[0])
    cam_arrays = [hac_render.CameraArrays.from_camera(c, dev, with_image=True)
                  for c in cams]

    if start_checkpoint:
        snap = load_training_snapshot(start_checkpoint, cfg, dev)
        state, opt_state, stats = (snap["state"], snap["opt_state"],
                                   snap["stats"])
        gen, rng, order = snap["generator"], snap["rng"], snap["order"]
        rcfg = rcfg._replace(max_tiles_per_gaussian=snap["caps"][0],
                             max_gaussians_per_tile=snap["caps"][1])
        first_it = snap["iteration"] + 1
        log(f"resumed from {start_checkpoint} at iteration {snap['iteration']}")
    else:
        points = hac.voxelize_points(scene.points, cfg.voxel_size, seed)
        state = hac.update_anchor_bound(family.init_state(
            cfg, points, np.random.default_rng(seed), device=dev))
        log(f"anchors at init: {points.shape[0]}")
        params, rest = hac.split_state(state)
        opt_state = optimizer.init(hac_train.param_leaves(params))
        stats = hac_train.zero_stats(rest["valid"].shape[0], cfg.n_offsets, dev)
        # train in the order the codec ships the anchors (sort_anchors)
        state, stats, opt_state = hac_train.sort_anchors(state, stats,
                                                         opt_state, cfg)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(cam_arrays)).tolist()
        first_it = 1
    params, rest = hac.split_state(state)

    def mk_step(rc):
        return hac_train.make_train_step(
            cfg, rc, optimizer, opt, loss_fn=family.training_loss,
            grad_mask=family.grad_mask, white_background=white_background)

    step_fn = mk_step(rcfg)
    ckpt_path = (os.path.join(model_dir, "train_ckpt.pkl")
                 if model_dir is not None else None)
    last_it = min(opt.iterations, stop_at) if stop_at else opt.iterations
    history, densify, caps = [], [], []
    diverged = None
    t0 = time.perf_counter()
    for it in range(first_it, last_it + 1):
        if it == 1 or it % CAP_ADAPT_EVERY == 0:
            with hb.guard("adapt_caps"):
                rcfg, grew = adapt_caps(hac.merge_state(params, rest), cfg,
                                        rcfg, cam_arrays[0], log=log)
            if grew:
                step_fn = mk_step(rcfg)
                caps.append((it, rcfg.max_tiles_per_gaussian,
                             rcfg.max_gaussians_per_tile))
        if gui is not None:
            _poll_gui(gui, hac.merge_state(params, rest), cfg, model_dir or "",
                      log=log)
        if not order:
            order = rng.permutation(len(cam_arrays)).tolist()
        cam = cam_arrays[order.pop()]
        phase = phase_of_step(it)
        if phase >= 2 and phase_of_step(it - 1) < 2:
            # refit the context's bounding box to the densified anchors
            # before the rate phase, and the family's own set-up
            state = hac.update_anchor_bound(hac.merge_state(params, rest))
            if family.extra_init is not None:
                state = family.extra_init(state, cfg)
            params, rest = hac.split_state(state)
        with hb.guard("step"):
            params, opt_state, stats, metrics = step_fn(
                params, rest, opt_state, stats, cam, phase=phase,
                generator=gen)
        hb.beat()
        history.append(torch.stack([
            metrics["loss"], metrics["l1"], metrics["psnr"],
            metrics["bit_per_param"],
            metrics["nonfinite_grads"].to(torch.float32)]))
        if log_every and it % log_every == 0:
            per_it = (time.perf_counter() - t0) / (it - first_it + 1)
            log(f"iter {it} (phase {phase}): loss {float(metrics['loss']):.4f} "
                f"psnr {float(metrics['psnr']):.2f} "
                f"bit/param {float(metrics['bit_per_param']):.4f} "
                f"({per_it * 1e3:.1f} ms/it)")
            if scalar_logger is not None:
                scalar_logger.log(it, {
                    "train/loss": metrics["loss"], "train/l1": metrics["l1"],
                    "train/psnr": metrics["psnr"],
                    "train/bit_per_param": metrics["bit_per_param"],
                    "train/iter_time": per_it})
        if (opt.start_stat < it < opt.update_until and it > opt.update_from
                and it % opt.update_interval == 0 and not 3000 <= it < 4000):
            state, stats, opt_state, info = hac_train.adjust_anchor(
                hac.merge_state(params, rest), stats, opt_state, cfg, opt, rng)
            state, stats, opt_state = hac_train.sort_anchors(
                state, stats, opt_state, cfg)
            params, rest = hac.split_state(state)
            densify.append((it, info))
            log(f"iter {it}: anchors {info['n_anchors']} "
                f"(+{info['n_added']}/-{info['n_pruned']})")
        if checkpoint_every and it % checkpoint_every == 0:
            if os.path.exists(ckpt_path):  # keep one generation of history
                os.replace(ckpt_path, ckpt_path + ".prev")
            checkpoint.save_training_checkpoint(ckpt_path, _snapshot(
                params, rest, opt_state, stats, it, gen, rng, order, rcfg))
            log(f"iter {it}: checkpoint -> {ckpt_path}")
            if scene.test_cameras:
                with hb.guard("canary"):
                    canary, ps = canary_psnr(hac.merge_state(params, rest),
                                             cfg, scene.test_cameras,
                                             white_background)
                log(f"iter {it}: clean-render canary PSNR {canary:.2f} "
                    f"{['%.1f' % p for p in ps]}")
                if scalar_logger is not None:
                    scalar_logger.log(it, {"eval/psnr_clean": canary})
                if canary_mon.update(canary):
                    # the model has collapsed while the training metrics
                    # may still look alive: keep the evidence and stop
                    diverged = {"iteration": it, "canary_db": canary,
                                "canary_best_db": canary_mon.best,
                                "drop_db": canary_mon.best - canary}
                    with open(os.path.join(model_dir, "DIVERGED.json"), "w") as f:
                        json.dump(diverged, f, indent=2)
                    log(f"iter {it}: DIVERGENCE ABORT: canary {canary:.2f} dB "
                        f"is {canary_mon.best - canary:.2f} dB below the "
                        f"running max {canary_mon.best:.2f}; stopping "
                        f"(checkpoint at {ckpt_path})")
                    break
    per_step = torch.stack(history).cpu().numpy() if history else np.zeros((0, 5))
    steps = np.arange(first_it, first_it + len(history))
    results = {
        "history": {
            "step": steps,
            "phase": np.array([phase_of_step(int(i)) for i in steps]),
            "loss": per_step[:, 0], "l1": per_step[:, 1], "psnr": per_step[:, 2],
            "bit_per_param": per_step[:, 3], "nonfinite_grads": per_step[:, 4],
        },
        "densify": densify, "caps": caps, "rcfg": rcfg,
        "opt_state": opt_state, "stats": stats,
    }
    state = hac.merge_state(params, rest)
    if model_dir is not None:
        checkpoint.save_pytree(os.path.join(model_dir, "model.npz"), state)
        if diverged is not None:
            results["aborted_divergence"] = diverged
        elif eval_at_end and pcc_params is not None:
            results.update(_code_and_evaluate(
                state, cfg, family, scene, model_dir, pcc_params, pcc_cfg,
                white_background, log, hb))
            if scalar_logger is not None:
                scalar_logger.log(last_it, {
                    f"eval/{k}": results.get(k)
                    for k in ("psnr", "ssim", "fps", "size_mb")})
    return state, results


RESULT_KEYS = ("psnr", "ssim", "lpips", "lpips_surrogate", "lpips_variant",
               "eval_k", "eval_d", "fps", "per_view", "psnr_float",
               "codec_delta_db", "size_bits", "size_mb")


def _code_and_evaluate(state, cfg, family, scene, model_dir, pcc_params,
                       pcc_cfg, white_background, log, hb) -> dict:
    """train_scene's tail: estimate (HAC only), encode, decode, evaluate the
    decoded and the float state (renders into model_dir/test_renders and
    model_dir/float_renders), write results.json."""
    pcc_cfg = pcc_cfg if pcc_cfg is not None else pcc_model.NetConfig()
    if family.name == "hac":
        _, est_log = hac_codec.estimate_final_bits(state, cfg)
        log(est_log)
    bs_dir = os.path.join(model_dir, "bitstreams")
    with hb.guard("encode"):
        sizes, enc_log = family.conduct_encoding(state, cfg, bs_dir,
                                                 pcc_params, pcc_cfg)
    log(enc_log)
    with hb.guard("decode"):
        dec_state, dec_log = family.conduct_decoding(state, cfg, bs_dir,
                                                     pcc_params, pcc_cfg)
    log(dec_log)
    cams = scene.test_cameras or scene.train_cameras[:2]
    with hb.guard("eval_decoded"):
        results = evaluate(dec_state, cfg, cams,
                           white_background=white_background, decoded=True,
                           out_dir=os.path.join(model_dir, "test_renders"))
    with hb.guard("eval_float"):
        float_res = evaluate(state, cfg, cams,
                             white_background=white_background,
                             out_dir=os.path.join(model_dir, "float_renders"))
    results["psnr_float"] = float_res["psnr"]
    if results["psnr"] is not None and float_res["psnr"] is not None:
        results["codec_delta_db"] = float_res["psnr"] - results["psnr"]
    results["size_bits"] = sizes
    results["size_mb"] = sizes["total"] / hac_codec.BIT2MB
    out = {k: results[k] for k in RESULT_KEYS if k in results}
    with open(os.path.join(model_dir, "results.json"), "w") as f:
        json.dump(out, f, indent=2, default=float)
    log(f"eval: PSNR {results['psnr']}, size {results['size_mb']:.4f} MB, "
        f"codec delta {results.get('codec_delta_db')} dB")
    return out


class _ViewTimer:
    """Milliseconds of one render: CUDA events on the GPU, the host clock
    on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.e1.record()
            self.e1.synchronize()
            self.ms = self.e0.elapsed_time(self.e1)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


@torch.no_grad()
def render_sets(state, cfg: hac.HACConfig, cameras,
                white_background: bool = False, decoded: bool = False,
                max_k: int = 256, max_d: int = 32, out_dir: str | None = None):
    """Render all views. Returns (renders [3, H, W] each, ms per view).

    Each shape bucket gets one untimed warm-up render first, so the times
    are steady-state renders. With `out_dir` each render is copied to the
    host after its timer stops and written there as {i:05d}.png
    (`_save_png`)."""
    cfg = _base(cfg)
    dev = _device(state)
    bg = torch.ones(3, device=dev) if white_background else torch.zeros(3, device=dev)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
    renders, ms = [], []
    warmed: set = set()
    for i, cam in enumerate(cameras):
        rcfg = _raster_cfg(cam, max_k, max_d)
        ca = hac_render.CameraArrays.from_camera(cam, dev)
        if rcfg not in warmed:
            hac_render.render_image(state, cfg, ca, rcfg, bg, decoded=decoded)
            warmed.add(rcfg)
        with _ViewTimer(dev) as t:
            img = hac_render.render_image(state, cfg, ca, rcfg, bg,
                                          decoded=decoded)
        renders.append(img)
        ms.append(t.ms)
        if out_dir is not None:
            _save_png(img.cpu().numpy(), os.path.join(out_dir, f"{i:05d}.png"))
    return renders, ms


@functools.lru_cache(maxsize=None)
def _lpips_module(path: str, exists: bool, device: str):
    from gauspcc_tpu_torch.utils import lpips

    return lpips.load_default_lpips(path, device=device)


def _lpips_for(device: torch.device):
    """The LPIPS module of the weights `utils.lpips.weights_path()` names
    (the seeded surrogate without them), built once a process and device.
    Unlike the JAX package's _try_lpips (:553), which returns None on any
    error, a failure to build it raises."""
    from gauspcc_tpu_torch.utils import lpips

    path = lpips.weights_path()
    return _lpips_module(path, os.path.exists(path), str(device))


@torch.no_grad()
def evaluate(state, cfg, cameras, white_background: bool = False,
             decoded: bool = False, auto_k: bool = True,
             max_k: int | None = None, max_d: int | None = None,
             out_dir: str | None = None) -> dict:
    """PSNR, SSIM and LPIPS of the eval renders (STE-quantised for HAC's
    float state, the decoded state's attributes as they are with `decoded`)
    against the cameras' ground-truth images, for every family.

    The caps follow the JAX package's rule: with `auto_k` (the default) K
    is the smallest visually lossless one on the first camera
    (`select_eval_k`) and D covers every footprint (`select_eval_d`,
    capped at 128); without it K 256 and D 32. `max_k` / `max_d` fix a cap
    instead (the r5 soak evaluated at K 1024). With `out_dir` the renders
    are written there (`render_sets`).

    LPIPS is reported as "lpips" only for the pretrained VGG16 weights; the
    seeded surrogate's value goes under "lpips_surrogate", so that no one
    compares it with published LPIPS. "lpips_variant" names the weights."""
    cfg = _base(cfg)
    if max_k is None:
        max_k = (select_eval_k(state, cfg, cameras[0], decoded=decoded)
                 if auto_k and cameras else 256)
    if max_d is None:
        max_d = (select_eval_d(state, cfg, cameras, decoded=decoded)
                 if auto_k and cameras else 32)
    renders, ms = render_sets(state, cfg, cameras, white_background, decoded,
                              max_k=max_k, max_d=max_d, out_dir=out_dir)
    lpips_fn = _lpips_for(_device(state))
    variant = lpips_fn.variant
    lpips_key = "lpips" if variant == "vgg16_pretrained" else "lpips_surrogate"
    per_view = {}
    for i, (cam, img) in enumerate(zip(cameras, renders)):
        entry = {"ms": ms[i]}
        if cam.image is not None:
            gt = torch.from_numpy(cam.image).to(img.device)
            entry["psnr"] = float(img_lib.psnr(img, gt))
            entry["ssim"] = float(img_lib.ssim(img, gt))
            entry[lpips_key] = float(lpips_fn(img, gt))
        per_view[f"{i:05d}"] = entry
    scored = [v for v in per_view.values() if "psnr" in v]

    def mean(key):
        return float(np.mean([v[key] for v in scored])) if scored else None

    return {
        "psnr": mean("psnr"),
        "ssim": mean("ssim"),
        "eval_k": max_k,
        "eval_d": max_d,
        lpips_key: mean(lpips_key),
        "lpips_variant": variant,
        "fps": len(ms) / max(sum(ms) / 1e3, 1e-9),
        "per_view": per_view,
        "renders": renders,
    }


@torch.no_grad()
def _poll_gui(gui, state, cfg, verify: str, log=print) -> None:
    """Serve the SIBR remote viewer between training steps: render the
    camera it asks for (K 256) on the state's device and send the frame,
    and keep serving while the viewer has training paused. An error inside
    the exchange is logged and disconnects the viewer; training goes on (the
    viewer's protocol, as the JAX package's :505-541)."""
    from gauspcc_tpu_torch.utils import network_gui

    cfg = _base(cfg)
    dev = _device(state)
    while gui.try_connect():
        try:
            cam_dict, do_training, keep_alive, _scale = gui.receive()
            img_bytes = None
            if cam_dict is not None:
                wvt = cam_dict["world_view_transform"]
                center = np.linalg.inv(wvt)[3, :3].astype(np.float32)
                cam = hac_render.CameraArrays(
                    viewmatrix=torch.from_numpy(wvt).to(dev),
                    camera_center=torch.from_numpy(center).to(dev))
                rcfg = raster.RasterConfig(
                    height=cam_dict["height"], width=cam_dict["width"],
                    tanfovx=float(np.tan(cam_dict["fovx"] * 0.5)),
                    tanfovy=float(np.tan(cam_dict["fovy"] * 0.5)),
                    max_gaussians_per_tile=256)
                out = hac_render.render_view(state, cfg, cam, rcfg,
                                             torch.zeros(3, device=dev))
                img_bytes = network_gui.image_to_bytes(
                    out["render"].cpu().numpy())
            gui.send(img_bytes, verify)
            if do_training or not keep_alive:
                break
        except Exception:
            log("viewer disconnected after an error:\n"
                + traceback.format_exc())
            gui.disconnect()
            break


def _save_png(img_chw: np.ndarray, path: str) -> None:
    """[3, H, W] float in [0, 1] as an 8-bit PNG (x 255 clipped and
    truncated, as the JAX package writes it); without PIL the float array
    as .npy beside where the PNG would be."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path.replace(".png", ".npy"), img_chw)
        return
    arr = np.clip(img_chw.transpose(1, 2, 0) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
