"""A dataset x scene x lambda sweep (counterpart of gauspcc_tpu/cli/sweep.py):
the reference's per-dataset runs (voxel sizes 0.001 / 0.005 / 0.01 and
lambda grids) from one entry point, each run trained, coded, decoded and
evaluated by `pipeline.train_scene` into
<out_root>/<dataset>/<scene>/<model>_l<lambda>, the PSNRs and sizes
gathered in <out_root>/summary.json (rewritten after each run).

    python -m gauspcc_tpu_torch.cli.sweep --model hac --data_root /data \
        --dataset mipnerf360 --scenes bicycle,garden --lmbdas 0.004,0.0005 \
        --out_root runs/ [--pcc_ckpt model/gauspcgc/best_model.npz] \
        [--device cuda]

Without `--pcc_ckpt` the anchors' codec is `model.init_net(seed=0)`, whose
weights differ from the JAX package's seeded ones.
"""

from __future__ import annotations

import argparse
import json
import os

DATASET_PRESETS = {
    # voxel_size per run_ours_*.sh:4-27
    "mipnerf360": {"voxel_size": 0.001, "images": "images_4"},
    "deepblending": {"voxel_size": 0.005, "images": "images"},
    "tandt": {"voxel_size": 0.01, "images": "images"},
    "nerf_synthetic": {"voxel_size": 0.001, "images": "", "white_background": True},
    # BungeeNeRF city scenes (CAT-3DGS/arguments/bungee.py): lr schedules
    # capped at 30k steps regardless of total iterations
    "bungee": {"voxel_size": 0.005, "images": "images", "lr_max_steps": 30_000},
}


def main(argv=None):
    p = argparse.ArgumentParser(prog="gauspcc-torch-sweep")
    p.add_argument("--model", default="hac",
                   choices=("hac", "hac_plus", "tcgs", "cat3dgs"))
    p.add_argument("--data_root", required=True)
    p.add_argument("--dataset", required=True, choices=sorted(DATASET_PRESETS))
    p.add_argument("--scenes", required=True, help="comma-separated scene dirs")
    p.add_argument("--lmbdas", default="0.004,0.0005")
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--out_root", default="runs")
    p.add_argument("--pcc_ckpt", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from gauspcc_tpu_torch import convert
    from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc_model
    from gauspcc_tpu_torch.data.scene import Scene
    from gauspcc_tpu_torch.device import resolve
    from gauspcc_tpu_torch.models import registry
    from gauspcc_tpu_torch.models.hac import pipeline
    from gauspcc_tpu_torch.models.hac import train as hac_train

    dev = resolve(args.device)
    preset = DATASET_PRESETS[args.dataset]
    fam = registry.get_family(args.model)
    pcc_cfg = pcc_model.NetConfig()
    if args.pcc_ckpt:
        pcc_params = convert.load_codec_npz(args.pcc_ckpt, pcc_cfg, device=dev)
    else:
        pcc_params = pcc_model.init_net(pcc_cfg, seed=0).to(dev)
    white_bg = preset.get("white_background", False)

    summary = {}
    for scene_name in args.scenes.split(","):
        scene = Scene(os.path.join(args.data_root, scene_name),
                      images_dir=preset.get("images") or "images",
                      white_background=white_bg)
        for lmbda in (float(x) for x in args.lmbdas.split(",")):
            run_dir = os.path.join(args.out_root, args.dataset, scene_name,
                                   f"{args.model}_l{lmbda}")
            cfg = fam.make_config(voxel_size=preset["voxel_size"])
            opt = hac_train.OptConfig(
                iterations=args.iterations, lmbda=lmbda,
                lr_max_steps=preset.get("lr_max_steps"))
            _, results = pipeline.train_scene(
                scene, cfg, opt, white_background=white_bg, device=dev,
                model_dir=run_dir, pcc_params=pcc_params, pcc_cfg=pcc_cfg,
                family=fam)
            summary[f"{scene_name}/l{lmbda}"] = {
                "psnr": results.get("psnr"),
                "size_mb": results.get("size_mb"),
            }
            with open(os.path.join(args.out_root, "summary.json"), "w") as f:
                json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
