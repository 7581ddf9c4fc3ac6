"""Scene-scale soak (own copy of gauspcc_tpu/cli/soak.py:37-130, with its
"textured", "smooth" and "hard" kinds, and :139-246): clustered coloured
Gaussians rendered from orbit cameras with the port's rasterizer as ground
truth, plus seed points for the anchors; `train` trains a family (HAC,
HAC++, TC-GS or CAT-3DGS) on it, and `main` runs the whole pipeline, train
-> estimate -> encode -> decode -> evaluate, and writes soak_summary.json.

The numpy RNG calls run in the same order as the JAX package's
build_scene, so one seed gives the same Gaussians, cameras and seed points
in both. `main` keeps a heartbeat file (out/heartbeat) and the scalar
streams (out/scalars.jsonl), writes a resume snapshot every
`--checkpoint_every` steps (out/train_ckpt.pkl), resumes from one with
`--resume`, and exits with code 3 when the clean-render canary aborts a
diverged run (out/DIVERGED.json): a wrapper must not retry that run.

    python -m gauspcc_tpu_torch.cli.soak --iters 30000 --out runs/soak_torch \
        [--model hac|hac_plus|tcgs|cat3dgs] [--pcc_ckpt model/gauspcgc/best_model.npz] \
        [--checkpoint_every 2000] [--resume runs/soak_torch/train_ckpt.pkl] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from gauspcc_tpu_torch.data.cameras import Camera
from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.render import raster


class SyntheticScene:
    """train_cameras / test_cameras / points / cameras_extent."""

    def __init__(self, cams_train, cams_test, points, extent):
        self.train_cameras = cams_train
        self.test_cameras = cams_test
        self.points = points
        self.cameras_extent = extent


def _orbit_camera(uid, angle, hw, radius=4.0, height=0.6, fov=0.9):
    pos = np.array([radius * np.cos(angle), height, radius * np.sin(angle)])
    fwd = -pos / np.linalg.norm(pos)
    up0 = np.array([0.0, 1.0, 0.0])
    right = np.cross(up0, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    r_w2v = np.stack([right, up, fwd])
    t = -r_w2v @ pos
    return Camera(uid=uid, R=r_w2v.T, T=t, fovx=fov, fovy=fov,
                  width=hw, height=hw)


@torch.no_grad()
def build_scene(rng: np.random.Generator, hw: int, n_gt: int, n_cams: int,
                n_seed: int, white_background: bool = True,
                device="cuda", kind: str = "textured") -> SyntheticScene:
    """The soak scene of `kind`: "textured" (smooth colour plus
    mid-frequency texture that only per-anchor features can carry, the
    soak's), "smooth" (low-frequency colour only) or "hard" (random colours,
    for stress runs)."""
    dev = resolve(device)
    if kind not in ("textured", "smooth", "hard"):
        raise ValueError(f"unknown soak scene kind {kind!r}")
    # clustered coloured Gaussian field
    n_clusters = max(8, n_gt // 150)
    centers = rng.random((n_clusters, 3)) * 1.6 - 0.8
    idx = rng.integers(0, n_clusters, n_gt)
    means = (centers[idx] + rng.normal(0, 0.12, (n_gt, 3))).astype(np.float32)
    lo_f = np.array([[2.1, 0.7, 1.3], [0.9, 2.4, 1.7], [1.5, 1.1, 2.6]])
    phases = np.array([0.0, 2.1, 4.2])
    if kind == "hard":
        colors = rng.random((n_gt, 3)).astype(np.float32)
        scales = (rng.random((n_gt, 3)) * 0.05 + 0.015).astype(np.float32)
        opac = (rng.random((n_gt, 1)) * 0.6 + 0.3).astype(np.float32)
    else:
        if kind == "smooth":
            colors = (0.5 + 0.45 * np.sin(means @ lo_f.T + phases)).astype(
                np.float32)
        else:
            hi_f = np.array([[5.3, 7.1, 4.2], [6.7, 3.9, 5.8],
                             [4.4, 6.1, 7.3]])
            colors = (0.5 + 0.27 * np.sin(means @ lo_f.T + phases)
                      + 0.18 * np.sin(means @ hi_f.T + 1.3 * phases + 0.7))
            colors = np.clip(colors, 0.0, 1.0).astype(np.float32)
        scales = (rng.random((n_gt, 3)) * 0.06 + 0.03).astype(np.float32)
        opac = (rng.random((n_gt, 1)) * 0.45 + 0.5).astype(np.float32)
    rots = np.tile([1.0, 0, 0, 0], (n_gt, 1)).astype(np.float32)

    gt = {name: torch.from_numpy(v).to(dev) for name, v in (
        ("means3d", means), ("colors", colors), ("opacities", opac),
        ("scales", scales), ("rotations", rots))}
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    cams = []
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, n_cams, endpoint=False)):
        c = _orbit_camera(i, ang, hw, radius=3.5 + 0.6 * np.sin(3 * ang),
                          height=0.4 + 0.5 * np.cos(2 * ang))
        rcfg = raster.RasterConfig(hw, hw, c.tanfovx, c.tanfovy,
                                   max_gaussians_per_tile=256)
        img, _ = raster.rasterize(
            viewmatrix=torch.from_numpy(c.world_view_transform).to(dev),
            bg_color=bg, cfg=rcfg, **gt)
        c.image = img.cpu().numpy()
        cams.append(c)

    sel = rng.integers(0, n_gt, n_seed)
    seed_pts = means[sel] + rng.normal(0, 0.02, (n_seed, 3)).astype(np.float32)
    extent = float(np.linalg.norm(
        np.ptp(np.stack([c.camera_center for c in cams]), axis=0)) * 0.5)
    # interleaved holdout (llffhold = 8): every 8th orbit view is a test view
    hold = 8
    test = [c for i, c in enumerate(cams) if i % hold == 0]
    train = [c for i, c in enumerate(cams) if i % hold != 0]
    return SyntheticScene(train, test, seed_pts.astype(np.float32), extent)


def compressed_phase_schedule(iters: int) -> Callable[[int], int]:
    """The phase schedule of a soak shorter than 30,000 steps, so that it
    still reaches the rate phase: the clean phase floored at the reference's
    own absolute gate (3,000 steps, or half the run), then phase 1 to a third
    of the run (at least a third of what is left), then phase 2."""
    b0 = max(iters // 10, min(3000, iters // 2))
    b1 = max(iters // 3, b0 + (iters - b0) // 3)
    return lambda it: 0 if it <= b0 else (1 if it <= b1 else 2)


def train(scene: SyntheticScene, iters: int, *, model: str = "hac",
          voxel_size: float = 0.01, lmbda: float = 1e-3,
          white_background: bool = True, seed: int = 0, log=print,
          log_every: int = 200, device="cuda", model_dir=None,
          pcc_params=None, pcc_cfg=None, train_kw=None, **opt_overrides):
    """Train the family `model` at its config's full width on a soak scene,
    with the soak's OptConfig (update_until at half the run, at most
    15,000) and, below 30,000 steps, its compressed phase schedule in place
    of the family's. `opt_overrides` replace OptConfig fields; `model_dir`,
    `pcc_params` and `pcc_cfg` go to train_scene (save, encode, decode,
    evaluate); `train_kw` goes to train_scene as it is (resume, snapshots,
    stop_at, heartbeat, scalar_logger, divergence_drop_db). Returns (state,
    cfg, opt, results), results as train_scene's."""
    from gauspcc_tpu_torch.models import registry
    from gauspcc_tpu_torch.models.hac import pipeline
    from gauspcc_tpu_torch.models.hac import train as hac_train

    dev = resolve(device)
    family = registry.get_family(model)
    if iters < 30_000:
        family = dataclasses.replace(
            family, phase_of_step=compressed_phase_schedule(iters))
    cfg = family.make_config(voxel_size=voxel_size)
    opt = dataclasses.replace(hac_train.OptConfig(
        iterations=iters, lmbda=lmbda, update_until=min(15_000, iters // 2)),
        **opt_overrides)
    state, results = pipeline.train_scene(
        scene, cfg, opt, seed=seed, log_every=log_every,
        white_background=white_background, log=log, device=dev,
        model_dir=model_dir, pcc_params=pcc_params, pcc_cfg=pcc_cfg,
        family=family, **(train_kw or {}))
    return state, cfg, opt, results


def main(argv=None):
    p = argparse.ArgumentParser(prog="gauspcc-torch-soak")
    p.add_argument("--model", default="hac",
                   choices=("hac", "hac_plus", "tcgs", "cat3dgs"))
    p.add_argument("--iters", type=int, default=30_000)
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--gt_gaussians", type=int, default=6000)
    p.add_argument("--cams", type=int, default=24)
    p.add_argument("--seed_points", type=int, default=30_000)
    p.add_argument("--bg", default="white", choices=("white", "black"))
    p.add_argument("--voxel_size", type=float, default=0.01)
    p.add_argument("--lmbda", type=float, default=1e-3)
    p.add_argument("--out", default="runs/soak_torch")
    p.add_argument("--pcc_ckpt", default="model/gauspcgc/best_model.npz")
    p.add_argument("--checkpoint_every", type=int, default=2000)
    p.add_argument("--resume", default="",
                   help="a train_ckpt.pkl to resume from")
    p.add_argument("--log_every", type=int, default=200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from gauspcc_tpu_torch import convert
    from gauspcc_tpu_torch.utils.heartbeat import Heartbeat
    from gauspcc_tpu_torch.utils.scalars import ScalarLogger

    dev = resolve(args.device)
    if not os.path.exists(args.pcc_ckpt):
        raise SystemExit(f"--pcc_ckpt {args.pcc_ckpt!r}: no such file")
    pcc_params = convert.load_codec_npz(args.pcc_ckpt, device=dev)
    white_bg = args.bg == "white"
    os.makedirs(args.out, exist_ok=True)
    hb = Heartbeat(os.path.join(args.out, "heartbeat"))
    t0 = time.time()
    with hb.guard("build_scene"):
        scene = build_scene(np.random.default_rng(0), args.hw,
                            args.gt_gaussians, args.cams, args.seed_points,
                            white_background=white_bg, device=dev)
    print(f"scene built in {time.time() - t0:.1f}s: "
          f"{len(scene.train_cameras)} train / {len(scene.test_cameras)} "
          f"test cams @ {args.hw}x{args.hw}, {scene.points.shape[0]} seeds")
    t0 = time.time()
    scalars = ScalarLogger(args.out)
    try:
        _, _, _, results = train(
            scene, args.iters, model=args.model, voxel_size=args.voxel_size,
            lmbda=args.lmbda, white_background=white_bg,
            log_every=args.log_every, device=dev, model_dir=args.out,
            pcc_params=pcc_params, train_kw=dict(
                checkpoint_every=args.checkpoint_every,
                start_checkpoint=args.resume or None,
                scalar_logger=scalars, heartbeat=hb))
    finally:
        scalars.close()
    wall = time.time() - t0
    from gauspcc_tpu_torch.models.hac.pipeline import RESULT_KEYS

    summary = {k: results[k] for k in RESULT_KEYS
               if k in results and k != "per_view"}
    summary.update(iteration=args.iters, train_wall_s=wall,
                   ms_per_iter=wall / max(args.iters, 1) * 1e3)
    if "aborted_divergence" in results:
        summary["aborted_divergence"] = results["aborted_divergence"]
    with open(os.path.join(args.out, "soak_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    if "aborted_divergence" in results:
        # a distinct exit code: resuming a collapsed run would collapse
        # again, so a wrapper loop must not retry it
        abort = results["aborted_divergence"]
        print(f"soak ABORTED (divergence at iter {abort['iteration']}): "
              f"canary {abort['canary_db']:.2f} dB")
        raise SystemExit(3)
    print(f"soak done in {wall / 60:.1f} min ({summary['ms_per_iter']:.1f} "
          f"ms/iter): PSNR {summary.get('psnr')}, size "
          f"{summary.get('size_mb')} MB")


if __name__ == "__main__":
    main()
