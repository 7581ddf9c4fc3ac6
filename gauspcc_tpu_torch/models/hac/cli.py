"""The scene command line (counterpart of gauspcc_tpu/models/hac/cli.py):
train a scene of a family (`--model hac`, `hac_plus`, `tcgs` or `cat3dgs`)
end to end, then encode, decode and evaluate it; or encode, decode and
evaluate a trained model directory again.

  python -m gauspcc_tpu_torch.models.hac.cli train -s <scene_dir> \
      -m <model_dir> [--model hac_plus --voxel_size 0.001 --lmbda 0.004 \
      --iterations 30000 --pcc_ckpt model/gauspcgc/best_model.npz \
      --device cuda]
  python -m gauspcc_tpu_torch.models.hac.cli eval -m <model_dir> \
      [-s <scene_dir>] [--device cuda]

The anchors' codec comes from `--pcc_ckpt`, a GausPcgc `.npz` of the JAX
package's keys (`convert.load_codec_npz`). cfg.json in the model directory
records the family and its configuration for `eval`. `--checkpoint_every N`
writes a resume snapshot every N steps, `--start_checkpoint` resumes from
one (`pipeline.train_scene`). `--gui` serves the SIBR remote viewer on
`--ip`:`--port` while training. Both commands write the decoded renders to
<model_dir>/test_renders (train also the float ones to float_renders) and
results.json with PSNR, SSIM and LPIPS. HAC++ takes the tiny
channel context on a Blender scene, as the JAX CLI does; CAT-3DGS splits
the features into the chcm slices `--chcm_slices` gives (the published
run's `5 10 15 20`), by default two halves of `--feat_dim` (the JAX
config's (25, 25) at its default 50). Runs on the card unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

def _load_pcc(args, device):
    from gauspcc_tpu_torch import convert
    from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc_model

    if not os.path.exists(args.pcc_ckpt):
        raise SystemExit(f"--pcc_ckpt {args.pcc_ckpt!r}: no such file (the "
                         f"anchors' GausPcgc weights, e.g. "
                         f"model/gauspcgc/best_model.npz)")
    cfg = pcc_model.NetConfig(args.pcc_channels, args.pcc_kernel_size)
    return convert.load_codec_npz(args.pcc_ckpt, cfg, device=device), cfg


def cmd_train(args):
    from gauspcc_tpu_torch.data.scene import Scene
    from gauspcc_tpu_torch.device import resolve
    from gauspcc_tpu_torch.models import registry
    from gauspcc_tpu_torch.models.hac import pipeline
    from gauspcc_tpu_torch.models.hac import train as hac_train

    half = args.feat_dim // 2
    slices = (tuple(args.chcm_slices) if args.chcm_slices
              else (half, args.feat_dim - half))
    if args.chcm_slices is not None and args.model != "cat3dgs":
        raise SystemExit("--chcm_slices is CAT-3DGS's (--model cat3dgs)")
    if sum(slices) != args.feat_dim:
        raise SystemExit(f"--chcm_slices {list(slices)} do not sum to "
                         f"--feat_dim {args.feat_dim}")
    family = registry.get_family(args.model)
    dev = resolve(args.device)
    pcc_params, pcc_cfg = _load_pcc(args, dev)
    kw = dict(
        feat_dim=args.feat_dim, n_offsets=args.n_offsets,
        voxel_size=args.voxel_size, update_depth=args.update_depth,
        update_init_factor=args.update_init_factor,
        update_hierachy_factor=args.update_hierachy_factor)
    if args.model in ("hac", "hac_plus"):  # the hash grids' families
        kw.update(log2_hashmap_size=args.log2, log2_hashmap_size_2d=args.log2_2D,
                  n_features_per_level=args.n_features)
    scene = Scene(args.source_path, eval_split=args.eval, images_dir=args.images,
                  white_background=args.white_background)
    if args.model == "hac_plus":
        kw["tiny_ctx"] = scene.is_blender
    if args.model == "cat3dgs":
        kw["chcm_slices"] = slices
    cfg = family.make_config(**kw)
    opt = hac_train.OptConfig(iterations=args.iterations, lmbda=args.lmbda)
    os.makedirs(args.model_path, exist_ok=True)
    with open(os.path.join(args.model_path, "cfg.json"), "w") as f:
        json.dump({"model": args.model, "hac": cfg._asdict(),
                   "opt": dataclasses.asdict(opt),
                   "source_path": args.source_path}, f, indent=2)
    gui = None
    if args.gui:
        from gauspcc_tpu_torch.utils.network_gui import NetworkGUI

        gui = NetworkGUI(args.ip, args.port)
    try:
        pipeline.train_scene(
            scene, cfg, opt, white_background=args.white_background,
            device=dev, model_dir=args.model_path, pcc_params=pcc_params,
            pcc_cfg=pcc_cfg, family=family,
            start_checkpoint=args.start_checkpoint,
            checkpoint_every=args.checkpoint_every, gui=gui)
    finally:
        if gui is not None:
            gui.close()


def cmd_eval(args):
    from gauspcc_tpu_torch import convert
    from gauspcc_tpu_torch.data.scene import Scene
    from gauspcc_tpu_torch.device import resolve
    from gauspcc_tpu_torch.models import registry
    from gauspcc_tpu_torch.models.hac import codec as hac_codec
    from gauspcc_tpu_torch.models.hac import pipeline
    from gauspcc_tpu_torch.utils import checkpoint

    dev = resolve(args.device)
    pcc_params, pcc_cfg = _load_pcc(args, dev)
    with open(os.path.join(args.model_path, "cfg.json")) as f:
        meta = json.load(f)
    # the family is the one the model was trained as, whatever --model says
    family = registry.get_family(meta.get("model", "hac"))
    cfg = family.make_config(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in meta["hac"].items()})
    scene = Scene(args.source_path or meta["source_path"], eval_split=True,
                  images_dir=args.images)
    state = convert.state_from_numpy(checkpoint.load_pytree(
        os.path.join(args.model_path, "model.npz")), cfg, device=dev)
    bs_dir = os.path.join(args.model_path, "bitstreams")
    sizes, enc_log = family.conduct_encoding(state, cfg, bs_dir, pcc_params,
                                             pcc_cfg)
    print(enc_log)
    dec_state, dec_log = family.conduct_decoding(state, cfg, bs_dir,
                                                 pcc_params, pcc_cfg)
    print(dec_log)
    results = pipeline.evaluate(
        dec_state, cfg, scene.test_cameras, decoded=True,
        out_dir=os.path.join(args.model_path, "test_renders"))
    results = {k: results[k] for k in pipeline.RESULT_KEYS if k in results}
    results["size_bits"] = sizes
    results["size_mb"] = sizes["total"] / hac_codec.BIT2MB
    with open(os.path.join(args.model_path, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(f"PSNR {results['psnr']}, size {results['size_mb']:.3f} MB")


def main(argv=None):
    p = argparse.ArgumentParser(prog="hac")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--model", default="hac",
                        choices=("hac", "hac_plus", "tcgs", "cat3dgs"))
        sp.add_argument("-s", "--source_path", default="")
        sp.add_argument("-m", "--model_path", required=True)
        sp.add_argument("--images", default="images")
        sp.add_argument("--pcc_ckpt", default="model/gauspcgc/best_model.npz")
        sp.add_argument("--pcc_channels", type=int, default=32)
        sp.add_argument("--pcc_kernel_size", type=int, default=5)
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--feat_dim", type=int, default=50)
    t.add_argument("--n_offsets", type=int, default=10)
    t.add_argument("--voxel_size", type=float, default=0.001)
    t.add_argument("--update_depth", type=int, default=3)
    t.add_argument("--update_init_factor", type=int, default=16)
    t.add_argument("--update_hierachy_factor", type=int, default=4)
    t.add_argument("--log2", type=int, default=19)
    t.add_argument("--log2_2D", type=int, default=17)
    t.add_argument("--n_features", type=int, default=2)
    t.add_argument("--chcm_slices", type=int, nargs="+", default=None,
                   help="CAT-3DGS's feature slices, summing to --feat_dim "
                   "(the published run: 5 10 15 20); by default two halves")
    t.add_argument("--iterations", type=int, default=30_000)
    t.add_argument("--lmbda", type=float, default=1e-3)
    t.add_argument("--eval", action="store_true", default=True)
    t.add_argument("--white_background", action="store_true")
    t.add_argument("--start_checkpoint", default=None,
                   help="resume from a training snapshot (train_ckpt.pkl)")
    t.add_argument("--checkpoint_every", type=int, default=0,
                   help="write a training snapshot to <model_path>/"
                   "train_ckpt.pkl every N steps (0: none)")
    t.add_argument("--gui", action="store_true",
                   help="serve the SIBR remote viewer while training")
    t.add_argument("--ip", default="127.0.0.1")
    t.add_argument("--port", type=int, default=6009)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    common(e)
    e.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
