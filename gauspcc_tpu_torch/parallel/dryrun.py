"""A data-parallel dry run on tiny shapes: one DP scene step at phase 2 and
one DP codec step at NetConfig(8, 3) across `--ranks` processes, both
finite (counterpart of __graft_entry__.py:58-137 `dryrun_multichip`,
which prints the same line).

    python -m gauspcc_tpu_torch.parallel.dryrun --ranks 2 --backend gloo --device cpu
    python -m gauspcc_tpu_torch.parallel.dryrun --ranks 1 --backend nccl --device cuda

The scene is __graft_entry__.py's `_tiny_scene` (300 seed points, a 32x32
camera at z = -3, K 64) at its `_SMALL` widths; the codec's patches are
400 random points in a 32^3 cube a rank, packed at
default_capacity_schedule(512, 3).
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc_model
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.parallel import dist as pdist
from gauspcc_tpu_torch.parallel import dp, dp_scene
from gauspcc_tpu_torch.render import raster

SMALL = dict(feat_dim=16, n_offsets=4, voxel_size=0.05,
             resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
             log2_hashmap_size=13, log2_hashmap_size_2d=13)


def tiny_inputs(n_ranks: int) -> dict:
    """The dry run's "scene" and "codec" sections, built on the CPU."""
    rng = np.random.default_rng(0)
    cfg = hac.HACConfig(**SMALL)
    pts = hac.voxelize_points(
        (rng.random((300, 3)) * 1.2 - 0.6).astype(np.float32), cfg.voxel_size)
    state = hac.update_anchor_bound(hac.init_state(
        cfg, pts, np.random.default_rng(0), device="cpu"))
    view = torch.eye(4)
    view[3, 2] = 3.0
    cam = hac_render.CameraArrays(view, torch.tensor([0.0, 0.0, -3.0]),
                                  torch.zeros((3, 32, 32)))
    rcfg = raster.RasterConfig(32, 32, 0.5, 0.5, max_gaussians_per_tile=64)
    scene = dp_scene.scene_inputs(
        state, cfg, "hac", [cam] * n_ranks, rcfg,
        hac_train.OptConfig(iterations=100, lmbda=1e-3), 4.0, phase=2,
        seed=2)
    net_cfg = pcc_model.NetConfig(channels=8, kernel_size=3)
    caps = dp.default_capacity_schedule(finest_cap=512, n_levels=3)
    patches = [dp.pack_patch(np.unique(rng.integers(0, 32, size=(400, 3)),
                                       axis=0).astype(np.int64), caps)
               for _ in range(n_ranks)]
    codec = dp.codec_inputs(pcc_model.init_net(net_cfg, 0), net_cfg, patches)
    return {"scene": scene, "codec": codec}


def run(n_ranks: int, backend: str, device: str) -> tuple[float, float]:
    """The dry run; returns (rank 0's scene loss, codec bpp), both finite."""
    with tempfile.TemporaryDirectory() as tmp:
        in_path = f"{tmp}/inputs.npz"
        pdist.write_inputs(in_path, **tiny_inputs(n_ranks))
        pdist.launch((dp_scene.rank_main, dp.rank_main), n_ranks, backend,
                     device, in_path, tmp)
        with np.load(pdist.output_path(tmp, "scene", 0)) as s:
            loss = float(s["loss"])
        with np.load(pdist.output_path(tmp, "codec", 0)) as c:
            bpp = float(c["bpp"])
    if not np.isfinite(loss):
        raise RuntimeError("non-finite scene-dp loss")
    if not np.isfinite(bpp):
        raise RuntimeError("non-finite codec-dp bpp")
    return loss, bpp


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="dryrun", description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", choices=pdist.BACKENDS, required=True)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = p.parse_args(argv)
    loss, bpp = run(args.ranks, args.backend, args.device)
    print(f"dryrun_multichip({args.ranks}): ok, scene loss={loss:.4f}, "
          f"codec bpp={bpp:.4f}")


if __name__ == "__main__":
    main()
