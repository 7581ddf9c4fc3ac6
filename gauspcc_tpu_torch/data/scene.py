"""Scene container: cameras, seed point cloud, train/test split (the
port's own copy of gauspcc_tpu/data/scene.py, numpy).

COLMAP (sparse/) or Blender (transforms_train.json) ingestion, the
llffhold = 8 eval split, NeRF++-style radius normalization for the spatial
learning-rate scale.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gauspcc_tpu_torch.data import colmap
from gauspcc_tpu_torch.data.cameras import Camera, fov2focal, focal2fov, get_nerfpp_norm


def load_blender_scene(source_path: str, white_background: bool = False,
                       load_images: bool = True):
    """NeRF-synthetic transforms_{train,test}.json loader
    (dataset_readers.py readNerfSyntheticInfo)."""
    cams = {"train": [], "test": []}
    for split in ("train", "test"):
        path = os.path.join(source_path, f"transforms_{split}.json")
        if not os.path.exists(path):
            continue
        meta = json.load(open(path))
        fovx = meta["camera_angle_x"]
        for i, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # blender -> COLMAP camera axes
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            img = None
            w = h = 800
            if load_images:
                img_path = os.path.join(source_path, frame["file_path"] + ".png")
                if os.path.exists(img_path):
                    try:
                        from PIL import Image

                        im = Image.open(img_path)
                        w, h = im.width, im.height
                        arr = np.asarray(im.convert("RGBA"), np.float32) / 255.0
                        bg = 1.0 if white_background else 0.0
                        rgb = arr[..., :3] * arr[..., 3:4] + bg * (1 - arr[..., 3:4])
                        img = rgb.transpose(2, 0, 1)
                    except ImportError:
                        pass
            fovy = focal2fov(fov2focal(fovx, w), h)
            cams[split].append(Camera(
                uid=i, R=R, T=T, fovx=fovx, fovy=float(fovy),
                width=w, height=h, image=img,
                image_name=os.path.basename(frame["file_path"]),
            ))
    return cams["train"], cams["test"]


class Scene:
    def __init__(self, source_path: str, eval_split: bool = True,
                 llffhold: int = 8, images_dir: str = "images",
                 resolution_scale: float = 1.0, white_background: bool = False,
                 load_images: bool = True):
        self.source_path = source_path
        blender = os.path.exists(os.path.join(source_path, "transforms_train.json"))
        self.is_blender = blender
        if blender:
            train, test = load_blender_scene(source_path, white_background,
                                             load_images)
            # the reference's random init cloud (a points3d.ply is not read)
            self.points = self._random_points()
            self.train_cameras = train
            self.test_cameras = test
        else:
            cams, xyz, rgb = colmap.load_colmap_scene(
                source_path, images_dir, resolution_scale, load_images
            )
            self.points = xyz.astype(np.float32)
            if eval_split:
                self.train_cameras = [c for i, c in enumerate(cams)
                                      if i % llffhold != 0]
                self.test_cameras = [c for i, c in enumerate(cams)
                                     if i % llffhold == 0]
            else:
                self.train_cameras = cams
                self.test_cameras = []
        norm = get_nerfpp_norm(self.train_cameras or self.test_cameras)
        self.cameras_extent = norm["radius"]

    @staticmethod
    def _random_points(n: int = 100_000, extent: float = 1.3) -> np.ndarray:
        rng = np.random.default_rng(0)
        return ((rng.random((n, 3)) * 2 - 1) * extent).astype(np.float32)
