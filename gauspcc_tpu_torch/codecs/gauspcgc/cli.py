"""Command-line drivers for the GausPcgc codec: the port's counterpart of
gauspcc_tpu/codecs/gauspcgc/cli.py (`cmd_compress` :38, `_compress_batched`
:68, `cmd_decompress` :105, `cmd_train` :137, `_synth_clustered` :173, `_rand_rot` :186,
`_synth_surface` :197, `cmd_synth` :243).

Parity with the reference CLIs (GausPcgc/compress_ue_4stage_conv.py,
decompress_ue_4stage_conv.py, train.py): compress a glob of point clouds
to .bin files with a per-file CSV of bpp and encode time, decompress them
to .ply, train the context model, or write the seeded synthetic corpus.
The generators are numpy-exact copies of JAX's, so `synth --seed 7
--kind mixed --count 48` writes data/pcc_corpus_r4/train byte for byte,
and `--seed 1234 --count 8` its val.

Usage:
  python -m gauspcc_tpu_torch.codecs.gauspcgc.cli synth --output_dir train/ \
      --seed 7 --count 48
  python -m gauspcc_tpu_torch.codecs.gauspcgc.cli train \
      --training_data 'train/*.npy' --val_data 'val/*.npy' \
      --model_save_folder my_model/ [--device cpu]
  python -m gauspcc_tpu_torch.codecs.gauspcgc.cli compress --input 'clouds/*.ply' \
      --ckpt my_model/best_model.npz --output_dir out/ [--geom host|device] \
      [--batch 8]
  python -m gauspcc_tpu_torch.codecs.gauspcgc.cli decompress --input 'out/*.bin*' \
      --ckpt my_model/best_model.npz --output_dir dec/

`train` has no default folder: it writes best_model.npz, train_state.pkl,
scalars.jsonl and train.log into the folder it is given, so it never
overwrites weights the caller did not name.

A checkpoint is an .npz of the JAX package's keys (`convert.load_codec_npz`),
so weights either package trained code here. `--geom` picks the engine (the
sib engine by default; `host` and `device` the general conv over host- or
device-built geometry); `--batch N` codes N clouds a stream into
batch_<first>.binb files, which `decompress` splits back into
<name>_<i>.ply. Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from glob import glob

import numpy as np

from gauspcc_tpu_torch.codecs.gauspcgc import data

def _load_params(ckpt: str, cfg, device):
    from gauspcc_tpu_torch import convert

    return convert.load_codec_npz(ckpt, cfg, device=device)


def _net_config(args):
    from gauspcc_tpu_torch.codecs.gauspcgc import model

    return model.NetConfig(args.channels, args.kernel_size)


def _write_csv(path: str, rows: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def cmd_compress(args):
    from gauspcc_tpu_torch.codecs.gauspcgc import codec

    cfg = _net_config(args)
    params = _load_params(args.ckpt, cfg, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.batch > 1:
        return _compress_batched(args, cfg, params)
    rows = []
    for path in sorted(glob(args.input)):
        xyz = data.quantize_cloud(data.read_points(path), args.posQ)
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.output_dir, name + ".bin")
        res = codec.compress_point_cloud(xyz, params, out_path, posQ=1.0,
                                         config=cfg, geom=args.geom,
                                         device=args.device)
        rows.append(
            dict(file=name, bpp=res["bpp"], enc_time=res["enc_time"],
                 bits=res["file_size_bits"], num_points=res["num_points"])
        )
        print(f"{name}: {res['bpp']:.4f} bpp, {res['enc_time']:.2f}s")
    if not rows:
        sys.exit(f"no files match {args.input}")
    csv_path = os.path.join(args.output_dir, "compress_results.csv")
    _write_csv(csv_path, rows)
    mean_bpp = float(np.mean([r["bpp"] for r in rows]))
    print(f"mean bpp: {mean_bpp:.4f} over {len(rows)} files -> {csv_path}")


def _compress_batched(args, cfg, params):
    """Groups of --batch clouds, each group one merged stream
    (`codec.compress_point_cloud_batch`) named batch_<first index>.binb."""
    from gauspcc_tpu_torch.codecs.gauspcgc import codec

    paths = sorted(glob(args.input))
    if not paths:
        sys.exit(f"no files match {args.input}")
    rows = []
    t0 = time.time()
    total_pts = 0
    for gi in range(0, len(paths), args.batch):
        clouds = [data.quantize_cloud(data.read_points(p), args.posQ)
                  for p in paths[gi : gi + args.batch]]
        out_path = os.path.join(args.output_dir, f"batch_{gi:04d}.binb")
        res = codec.compress_point_cloud_batch(
            clouds, params, out_path, posQ=1.0, config=cfg, geom=args.geom,
            device=args.device)
        total_pts += res["num_points"]
        rows.append(dict(
            file=os.path.basename(out_path), bpp=res["bpp"],
            enc_time=res["enc_time"], bits=res["file_size_bits"],
            num_points=res["num_points"], num_clouds=res["num_clouds"]))
        print(f"{out_path}: {res['num_clouds']} clouds, "
              f"{res['bpp']:.4f} bpp, {res['enc_time']:.2f}s")
    wall = time.time() - t0
    csv_path = os.path.join(args.output_dir, "compress_results.csv")
    _write_csv(csv_path, rows)
    print(f"aggregate: {total_pts / max(wall, 1e-9):.0f} pts/s over "
          f"{len(paths)} files -> {csv_path}")


def cmd_decompress(args):
    from gauspcc_tpu_torch.codecs.gauspcgc import codec

    cfg = _net_config(args)
    params = _load_params(args.ckpt, cfg, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    rows = []
    for path in sorted(glob(args.input)):
        name = os.path.splitext(os.path.basename(path))[0]
        if path.endswith(".binb"):
            res = codec.decompress_point_cloud_batch(path, params, config=cfg,
                                                     device=args.device)
            for i, pc in enumerate(res["point_clouds"]):
                out_path = os.path.join(args.output_dir, f"{name}_{i:03d}.ply")
                data.save_ply_ascii_geo(pc, out_path)
            print(f"{name}: {res['num_points']} pts in "
                  f"{len(res['point_clouds'])} clouds, {res['dec_time']:.2f}s")
        else:
            res = codec.decompress_point_cloud(path, params, config=cfg,
                                               device=args.device)
            out_path = os.path.join(args.output_dir, name + ".ply")
            data.save_ply_ascii_geo(res["point_cloud"], out_path)
            print(f"{name}: {res['num_points']} pts, "
                  f"{res['dec_time']:.2f}s -> {out_path}")
        rows.append(dict(file=name, dec_time=res["dec_time"],
                         num_points=res["num_points"]))
    if not rows:
        sys.exit(f"no files match {args.input}")
    # per-file decode CSV, as the reference's decompress driver writes
    # (decompress_ue_4stage_conv.py:188-192)
    csv_path = os.path.join(args.output_dir, "decompress_results.csv")
    _write_csv(csv_path, rows)
    print(f"decoded {len(rows)} files -> {csv_path}")


def cmd_train(args):
    from gauspcc_tpu_torch.codecs.gauspcgc import train as train_lib
    from gauspcc_tpu_torch.utils.scalars import ScalarLogger

    cfg = train_lib.TrainConfig(
        channels=args.channels,
        kernel_size=args.kernel_size,
        learning_rate=args.learning_rate,
        max_steps=args.max_steps,
        val_interval=args.val_interval,
        model_dir=args.model_save_folder,
        lr_decay_steps=tuple(
            int(s) for s in args.lr_decay_steps.split(",") if s),
    )
    train_paths = sorted(glob(args.training_data))
    if not train_paths:
        sys.exit(f"no training files match {args.training_data}")
    ds = data.PatchDataset(train_paths, seed=cfg.seed,
                           max_num=args.max_patch_points)
    val = None
    if args.val_data:
        val = data.WholeCloudDataset(sorted(glob(args.val_data)))
    start = None
    if args.resume:
        start = _load_params(args.resume, cfg.net, args.device)
    scalars = ScalarLogger(cfg.model_dir)
    try:
        train_lib.train(cfg, ds, val, scalar_logger=scalars,
                        start_params=start, geo_cache_size=args.geo_cache,
                        geo_cache_bytes=args.geo_cache_mb * 1_000_000,
                        resume_state=args.resume_state or None,
                        device=args.device)
    finally:
        scalars.close()


def _synth_clustered(rng):
    """Gaussian blobs on random centers (round-1 family; near its entropy
    floor for a context model — kept for distribution diversity)."""
    n_centers = int(rng.integers(40, 400))
    span = int(rng.integers(1500, 6000))
    sigma = float(rng.uniform(5.0, 40.0))
    n_pts = int(rng.integers(60_000, 220_000))
    centers = rng.integers(0, span, size=(n_centers, 3))
    pts = centers[rng.integers(0, n_centers, n_pts)] + rng.normal(
        0, sigma, (n_pts, 3))
    return pts, f"clustered centers={n_centers} span={span} sigma={sigma:.1f}"


def _rand_rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _synth_surface(rng):
    """Dense 2-D manifolds in 3-D: random smooth heightfields, ellipsoid
    shells, and boxes at varying sampling density -- the structure family
    of real Gaussian-splat anchor clouds (anchors sit on scene surfaces).
    Parent occupancy strongly predicts child occupancy on a surface, so
    this corpus actually exercises the context model (the clustered family
    is near its entropy floor)."""
    span = int(rng.integers(1500, 6000))
    n_obj = int(rng.integers(3, 10))
    budget = int(rng.integers(80_000, 260_000))
    parts = []
    for _ in range(n_obj):
        n = max(2000, int(budget * rng.dirichlet(np.ones(n_obj))[0]))
        kind = rng.choice(["height", "shell", "box"])
        size = span * rng.uniform(0.15, 0.6)
        if kind == "height":
            uv = rng.random((n, 2)) - 0.5
            k = int(rng.integers(2, 6))
            fr = rng.uniform(2.0, 9.0, (k, 2))
            ph = rng.uniform(0, 2 * np.pi, k)
            amp = rng.uniform(0.02, 0.12, k) * size
            z = sum(a * np.sin(uv @ f + p) for a, f, p in zip(amp, fr, ph))
            p = np.stack([uv[:, 0] * size, uv[:, 1] * size, z], 1)
        elif kind == "shell":
            d = rng.normal(size=(n, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            axes = size * rng.uniform(0.3, 0.8, 3) * 0.5
            p = d * axes
        else:  # box: sample its 6 faces
            face = rng.integers(0, 6, n)
            uv = rng.random((n, 2)) - 0.5
            half = size * rng.uniform(0.3, 0.7, 3) * 0.5
            p = np.zeros((n, 3))
            ax = face % 3
            sgn = np.where(face < 3, 1.0, -1.0)
            for a in range(3):
                m = ax == a
                o = [(a + 1) % 3, (a + 2) % 3]
                p[np.ix_(m, o)] = uv[m] * 2 * half[o]
                p[m, a] = sgn[m] * half[a]
        p = p @ _rand_rot(rng).T + rng.uniform(0.2, 0.8, 3) * span
        p += rng.normal(0, rng.uniform(0.3, 1.5), p.shape)  # surface jitter
        parts.append(p)
    return np.concatenate(parts), f"surface objs={n_obj} span={span}"


def synth_clouds(seed: int, count: int, kind: str = "mixed"):
    """The synthetic training clouds, one (points float32 [N, 3], what
    they are) at a time, from one numpy generator seeded with `seed`:
    kind "mixed" draws 70% surface family, 30% clustered. They stand in
    for the GausPcc-1K corpus (GausPcgc/README.md:73-77) where it is
    absent."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        if kind == "clustered":
            pts, desc = _synth_clustered(rng)
        elif kind == "surface":
            pts, desc = _synth_surface(rng)
        else:
            pts, desc = (_synth_surface(rng) if rng.random() < 0.7
                         else _synth_clustered(rng))
        yield np.unique(np.round(pts), axis=0).astype(np.float32), desc


def cmd_synth(args):
    """Write `synth_clouds` as output_dir/synth_<i>.npy."""
    os.makedirs(args.output_dir, exist_ok=True)
    for i, (pts, desc) in enumerate(synth_clouds(args.seed, args.count,
                                                 args.kind)):
        path = os.path.join(args.output_dir, f"synth_{i:04d}.npy")
        np.save(path, pts)
        print(f"{path}: {pts.shape[0]} pts ({desc})")


def main(argv=None):
    p = argparse.ArgumentParser(prog="gauspcgc")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--channels", type=int, default=32)
        sp.add_argument("--kernel_size", type=int, default=5)
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")

    c = sub.add_parser("compress")
    common(c)
    c.add_argument("--input", required=True, help="glob of point cloud files")
    c.add_argument("--ckpt", required=True)
    c.add_argument("--output_dir", required=True)
    c.add_argument("--posQ", type=float, default=1.0)
    c.add_argument("--geom", default=None, choices=("host", "device"),
                   help="the general conv over host-built (version 6) or "
                        "device-built (version 7) geometry; the sib engine "
                        "(version 5) by default")
    c.add_argument("--batch", type=int, default=1,
                   help=">1: that many clouds a merged .binb stream")
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress")
    common(d)
    d.add_argument("--input", required=True,
                   help="glob of .bin and .binb (batch) files")
    d.add_argument("--ckpt", required=True)
    d.add_argument("--output_dir", required=True)
    d.set_defaults(fn=cmd_decompress)

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--training_data", required=True)
    t.add_argument("--val_data", default="")
    t.add_argument("--model_save_folder", required=True,
                   help="where checkpoints, logs and the heartbeat go")
    t.add_argument("--learning_rate", type=float, default=5e-4)
    t.add_argument("--max_steps", type=int, default=110_000)
    t.add_argument("--max_patch_points", type=int, default=data.MAX_PATCH_POINTS)
    t.add_argument("--geo_cache", type=int, default=64,
                   help="patches whose device geometry stays resident")
    t.add_argument("--geo_cache_mb", type=int, default=3000,
                   help="byte budget (MB) of the device geometry cache")
    t.add_argument("--lr_decay_steps", default="40000,90000",
                   help="comma-separated decay milestones (x0.1 each)")
    t.add_argument("--val_interval", type=int, default=500)
    t.add_argument("--resume", default="", help="params .npz to resume from")
    t.add_argument("--resume_state", default="",
                   help="train_state.pkl for a full resume (params, "
                        "optimizer moments, step)")
    t.set_defaults(fn=cmd_train)

    s = sub.add_parser("synth")
    s.add_argument("--output_dir", required=True)
    s.add_argument("--count", type=int, default=40)
    s.add_argument("--seed", type=int, default=7)
    s.add_argument("--kind", default="mixed",
                   choices=("mixed", "surface", "clustered"))
    s.set_defaults(fn=cmd_synth)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
