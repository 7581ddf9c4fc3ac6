"""Encode, decode and evaluate a soak run from its training snapshot
(counterpart of gauspcc_tpu/cli/soak_eval.py): loads the port's
train_ckpt.pkl that `--checkpoint_every` writes, rebuilds the soak's seeded
scene, and runs the path train_scene's tail runs (estimate for HAC,
conduct_encoding, conduct_decoding, evaluate), writing the renders to
<run>/test_renders and soak_summary.json. It reads the port's snapshots,
not the JAX package's pickles. As the JAX package's does, it evaluates on
a black background whatever the soak trained on.

    python -m gauspcc_tpu_torch.cli.soak_eval --run runs/soak_torch \
        [--model hac] [--pcc_ckpt model/gauspcgc/best_model.npz] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="gauspcc-torch-soak-eval")
    p.add_argument("--run", required=True)
    p.add_argument("--model", default="hac")
    p.add_argument("--hw", type=int, default=512)
    p.add_argument("--gt_gaussians", type=int, default=6000)
    p.add_argument("--cams", type=int, default=24)
    p.add_argument("--seed_points", type=int, default=30_000)
    p.add_argument("--voxel_size", type=float, default=0.01)
    p.add_argument("--scene", default="textured",
                   choices=("textured", "smooth", "hard"))
    p.add_argument("--pcc_ckpt", default="model/gauspcgc/best_model.npz")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from gauspcc_tpu_torch import convert
    from gauspcc_tpu_torch.cli import soak
    from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc_model
    from gauspcc_tpu_torch.device import resolve
    from gauspcc_tpu_torch.models import registry
    from gauspcc_tpu_torch.models.hac import codec as hac_codec
    from gauspcc_tpu_torch.models.hac import pipeline

    dev = resolve(args.device)
    fam = registry.get_family(args.model)
    cfg = fam.make_config(voxel_size=args.voxel_size)
    ckpt = os.path.join(args.run, "train_ckpt.pkl")
    snap = pipeline.load_training_snapshot(ckpt, cfg, dev)
    state, it = snap["state"], snap["iteration"]
    print(f"loaded {ckpt} at iteration {it}, "
          f"{int(state['valid'].sum())} anchors")
    if not os.path.exists(args.pcc_ckpt):
        raise SystemExit(f"--pcc_ckpt {args.pcc_ckpt!r}: no such file")
    pcc_cfg = pcc_model.NetConfig()
    pcc_params = convert.load_codec_npz(args.pcc_ckpt, pcc_cfg, device=dev)

    # the soak's seed, so the same scene
    scene = soak.build_scene(np.random.default_rng(0), args.hw,
                             args.gt_gaussians, args.cams, args.seed_points,
                             device=dev, kind=args.scene)
    bs_dir = os.path.join(args.run, "bitstreams")
    if fam.name == "hac":
        _, est_log = hac_codec.estimate_final_bits(state, cfg)
        print(est_log)
    sizes, enc_log = fam.conduct_encoding(state, cfg, bs_dir, pcc_params,
                                          pcc_cfg)
    print(enc_log)
    dec_state, dec_log = fam.conduct_decoding(state, cfg, bs_dir, pcc_params,
                                              pcc_cfg)
    print(dec_log)
    results = pipeline.evaluate(
        dec_state, cfg, scene.test_cameras, decoded=True,
        out_dir=os.path.join(args.run, "test_renders"))
    results["size_bits"] = sizes
    results["size_mb"] = sizes["total"] / hac_codec.BIT2MB
    results["iteration"] = it
    with open(os.path.join(args.run, "soak_summary.json"), "w") as f:
        json.dump({k: v for k, v in results.items()
                   if k not in ("per_view", "renders")}, f, indent=2,
                  default=float)
    print(f"eval @ iter {it}: PSNR {results['psnr']:.3f}, "
          f"SSIM {results['ssim']:.4f}, size {results['size_mb']:.3f} MB, "
          f"FPS {results['fps']:.2f}")


if __name__ == "__main__":
    main()
