"""Camera model (own copy of gauspcc_tpu/data/cameras.py:18-73), with the
field-of-view conversions and the NeRF++ radius normalization the scene
readers use.

`world_view_transform` is W2V^T, so points transform as row vectors
([p, 1] @ viewmatrix), the convention the rasterizer uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Camera:
    uid: int
    R: np.ndarray  # [3,3] camera-to-world rotation (COLMAP convention: R = qvec^T)
    T: np.ndarray  # [3] world-to-view translation
    fovx: float
    fovy: float
    width: int
    height: int
    image: np.ndarray | None = None  # [3, H, W] float32 in [0,1]
    image_name: str = ""

    def _w2v(self) -> np.ndarray:
        w2v = np.eye(4, dtype=np.float32)
        w2v[:3, :3] = self.R.T
        w2v[:3, 3] = self.T
        return w2v

    @property
    def world_view_transform(self) -> np.ndarray:
        """[4,4] W2V^T (row-vector convention)."""
        return self._w2v().T.astype(np.float32)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self._w2v())[:3, 3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return float(np.tan(self.fovx * 0.5))

    @property
    def tanfovy(self) -> float:
        return float(np.tan(self.fovy * 0.5))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


def get_nerfpp_norm(cameras: list[Camera]) -> dict:
    """Scene radius normalization: 1.1 x the largest camera distance from
    the cameras' mean centre."""
    centers = np.stack([c.camera_center for c in cameras])
    avg = centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=1)
    radius = float(dist.max()) * 1.1
    return {"translate": -avg[0], "radius": radius if radius > 0 else 1.0}
