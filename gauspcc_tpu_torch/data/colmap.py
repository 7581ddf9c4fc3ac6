"""COLMAP binary/text model parsing (cameras, images, points3D): the port's
own copy of gauspcc_tpu/data/colmap.py (numpy).

Only the fields the pipeline needs are materialized. Images are loaded
with PIL if it is installed, else the cameras carry no image.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from gauspcc_tpu_torch.data.cameras import Camera, focal2fov

_CAMERA_MODEL_PARAMS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = _CAMERA_MODEL_PARAMS.get(model_id, ("UNKNOWN", 0))
            params = _read(f, f"<{n_params}d")
            cams[cam_id] = dict(model=name, width=int(w), height=int(h),
                                params=np.array(params))
    return cams


def read_images_binary(path: str) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)  # skip 2D points
            images[image_id] = dict(qvec=qvec, tvec=tvec, camera_id=cam_id,
                                    name=name.decode("utf-8"))
    return images


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb


def read_points3d_text(path: str):
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            e = line.split()
            xyz.append([float(e[1]), float(e[2]), float(e[3])])
            rgb.append([int(e[4]), int(e[5]), int(e[6])])
    return np.array(xyz), np.array(rgb, np.uint8)


def _load_image(path: str, resolution_scale: float = 1.0):
    try:
        from PIL import Image
    except ImportError:
        return None
    img = Image.open(path)
    if resolution_scale != 1.0:
        img = img.resize(
            (round(img.width / resolution_scale), round(img.height / resolution_scale))
        )
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def load_colmap_scene(source_path: str, images_dir: str = "images",
                      resolution_scale: float = 1.0, load_images: bool = True):
    """Returns (cameras: list[Camera], points_xyz, points_rgb).

    Downscales intrinsics consistently with the image resize. Mip-NeRF360
    style: images at `images_dir` (e.g. images_2/images_4 for pre-downscaled).
    """
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams_meta = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images_meta = read_images_binary(os.path.join(sparse, "images.bin"))
    pts_path = os.path.join(sparse, "points3D.bin")
    if os.path.exists(pts_path):
        xyz, rgb = read_points3d_binary(pts_path)
    else:
        xyz, rgb = read_points3d_text(os.path.join(sparse, "points3D.txt"))

    cameras = []
    for image_id in sorted(images_meta, key=lambda i: images_meta[i]["name"]):
        meta = images_meta[image_id]
        cam = cams_meta[meta["camera_id"]]
        w = round(cam["width"] / resolution_scale)
        h = round(cam["height"] / resolution_scale)
        p = cam["params"]
        if cam["model"] == "SIMPLE_PINHOLE" or cam["model"] == "SIMPLE_RADIAL":
            fx = fy = p[0]
        else:
            fx, fy = p[0], p[1]
        fovx = focal2fov(fx / resolution_scale, w)
        fovy = focal2fov(fy / resolution_scale, h)
        img = None
        if load_images:
            img_path = os.path.join(source_path, images_dir, meta["name"])
            if os.path.exists(img_path):
                img = _load_image(img_path, 1.0)
        R = qvec2rotmat(meta["qvec"]).T
        cameras.append(Camera(
            uid=image_id, R=R, T=meta["tvec"].astype(np.float64),
            fovx=float(fovx), fovy=float(fovy), width=w, height=h,
            image=img, image_name=meta["name"],
        ))
    return cameras, xyz, rgb
