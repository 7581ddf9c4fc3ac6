"""COLMAP preprocessing: raw images -> the scene layout `data.scene.Scene`
reads (own copy of gauspcc_tpu/cli/convert.py, the same commands and
layout): COLMAP feature extraction -> exhaustive matching -> mapper ->
undistortion into sparse/0, and optional {2, 4, 8}x downscales with PIL.
The COLMAP binary runs only when present; `--skip_matching` works on a
scene reconstructed already. It runs on the host only.

  python -m gauspcc_tpu_torch.cli.convert -s <scene_dir> [--resize] \
      [--camera OPENCV] [--colmap_executable colmap] [--skip_matching]

Input: <scene_dir>/input/*.jpg. Output: <scene_dir>/images/, sparse/0/,
and images_{2,4,8}/ with --resize.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def _run(cmd: list, what: str) -> None:
    print("+ " + " ".join(cmd))
    rc = subprocess.call(cmd)
    if rc != 0:
        sys.exit(f"{what} failed with code {rc}")


def colmap_reconstruct(source: str, colmap: str, camera: str,
                       use_gpu: bool) -> None:
    """feature_extractor -> exhaustive_matcher -> mapper (convert.py:32-70)."""
    os.makedirs(os.path.join(source, "distorted", "sparse"), exist_ok=True)
    db = os.path.join(source, "distorted", "database.db")
    gpu = "1" if use_gpu else "0"
    _run([colmap, "feature_extractor",
          "--database_path", db,
          "--image_path", os.path.join(source, "input"),
          "--ImageReader.single_camera", "1",
          "--ImageReader.camera_model", camera,
          "--SiftExtraction.use_gpu", gpu], "feature extraction")
    _run([colmap, "exhaustive_matcher", "--database_path", db,
          "--SiftMatching.use_gpu", gpu], "feature matching")
    _run([colmap, "mapper", "--database_path", db,
          "--image_path", os.path.join(source, "input"),
          "--output_path", os.path.join(source, "distorted", "sparse"),
          "--Mapper.ba_global_function_tolerance=0.000001"],
         "bundle adjustment")


def colmap_undistort(source: str, colmap: str) -> None:
    """image_undistorter + move model files into sparse/0 (convert.py:72-95)."""
    _run([colmap, "image_undistorter",
          "--image_path", os.path.join(source, "input"),
          "--input_path", os.path.join(source, "distorted", "sparse", "0"),
          "--output_path", source, "--output_type", "COLMAP"],
         "undistortion")
    sparse = os.path.join(source, "sparse")
    dest = os.path.join(sparse, "0")
    os.makedirs(dest, exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(dest, f))


def resize_images(source: str, factors=(2, 4, 8)) -> None:
    """images_<f>/ pyramids via PIL (convert.py:97-122 used ImageMagick)."""
    from PIL import Image

    img_dir = os.path.join(source, "images")
    names = sorted(os.listdir(img_dir))
    for f in factors:
        out_dir = os.path.join(source, f"images_{f}")
        os.makedirs(out_dir, exist_ok=True)
        for name in names:
            src = os.path.join(img_dir, name)
            dst = os.path.join(out_dir, name)
            if os.path.exists(dst):
                continue
            with Image.open(src) as im:
                im.resize((max(1, round(im.width / f)),
                           max(1, round(im.height / f))),
                          Image.LANCZOS).save(dst)
        print(f"images_{f}/: {len(names)} images")


def main(argv=None):
    p = argparse.ArgumentParser(prog="gauspcc-convert")
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--resize", action="store_true")
    args = p.parse_args(argv)
    source = args.source_path

    have_colmap = shutil.which(args.colmap_executable) is not None
    if not args.skip_matching:
        if not have_colmap:
            sys.exit("colmap binary not found; run with --skip_matching on a "
                     "pre-reconstructed scene, or install COLMAP")
        colmap_reconstruct(source, args.colmap_executable, args.camera,
                           not args.no_gpu)
        colmap_undistort(source, args.colmap_executable)
    elif not os.path.isdir(os.path.join(source, "images")):
        # pre-undistorted scene without the images/ convention: accept
        # input/ as the image source directly
        inp = os.path.join(source, "input")
        if os.path.isdir(inp):
            shutil.copytree(inp, os.path.join(source, "images"))

    if args.resize:
        resize_images(source)
    print("done")


if __name__ == "__main__":
    main()
