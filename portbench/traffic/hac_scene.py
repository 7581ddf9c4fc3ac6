"""The seeded HAC scene of the `hac` cells: ground-truth Gaussians, orbit
cameras and their ground-truth frames, the anchors, and every leaf of an
untrained phase-2 state.

The scene's structure (where its clusters sit) comes from the
configuration's `structure_seed`, the same for every run, so that every
seed gives a scene of the same layout and about the same work; everything
else (the Gaussians about the clusters, their colours, scales and
opacities, the seed points, every leaf) comes from `--seed`.

Frozen copies:

- `scene_geometry`: gauspcc_tpu_torch/cli/soak.py:63-127 (`build_scene`,
  kind "textured"), the numpy calls in the same order. Departures: the
  cluster centres are drawn from their own generator (`structure_seed`),
  the rest from `--seed`'s; the ground-truth frames come from the
  benchmark's plain renderer (reference/raster.py), not the program's; the
  frame size, the number of seed points and the cameras' count come from
  the configuration.
- `orbit_camera`: soak.py:48-60 (`_orbit_camera`) with the camera algebra of
  gauspcc_tpu_torch/data/cameras.py:28-52.
- `voxelize`: gauspcc_tpu_torch/models/hac/model.py:83-88 (`voxelize_points`).
- `morton_order`: gauspcc_tpu_torch/ops/sparse.py:54-63 (`morton_order_np`);
  the anchors are laid out in this order, the order the port's
  `train_scene` keeps them in (train.py `sort_anchors`).
- `knn_mean_dist`: model.py:74-79.

The leaves (`make_leaves`) have `init_state`'s shapes (model.py:154-196),
but values drawn from the seed on the card (see the draws' laws below), so
the state is an untrained one whose every attribute is live.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import hac as ref
from portbench.reference import raster as ref_raster


class OrbitCamera(NamedTuple):
    uid: int
    viewmatrix: np.ndarray  # [4, 4] W2V^T
    camera_center: np.ndarray  # [3]
    fov: float
    hw: int

    @property
    def tanfov(self) -> float:
        return float(np.tan(self.fov * 0.5))

    def raster_config(self, max_k: int = 256, max_d: int = 32):
        return ref_raster.RasterConfig(self.hw, self.hw, self.tanfov,
                                       self.tanfov, max_tiles_per_gaussian=max_d,
                                       max_gaussians_per_tile=max_k)


def orbit_camera(uid, angle, hw, radius=4.0, height=0.6, fov=0.9) -> OrbitCamera:
    pos = np.array([radius * np.cos(angle), height, radius * np.sin(angle)])
    fwd = -pos / np.linalg.norm(pos)
    up0 = np.array([0.0, 1.0, 0.0])
    right = np.cross(up0, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    r_w2v = np.stack([right, up, fwd])
    t = -r_w2v @ pos
    w2v = np.eye(4, dtype=np.float32)
    w2v[:3, :3] = r_w2v
    w2v[:3, 3] = t
    center = np.linalg.inv(w2v)[:3, 3].astype(np.float32)
    return OrbitCamera(uid, w2v.T.astype(np.float32), center, fov, hw)


def _orbit(i, ang, hw) -> OrbitCamera:
    return orbit_camera(i, ang, hw, radius=3.5 + 0.6 * np.sin(3 * ang),
                        height=0.4 + 0.5 * np.cos(2 * ang))


class SceneGeometry(NamedTuple):
    gt: dict  # numpy arrays of the ground-truth Gaussians
    cameras: list  # OrbitCamera, all n_cams
    train_idx: list
    test_idx: list
    seed_points: np.ndarray  # [n_seed, 3] float32
    extent: float


def scene_geometry(seed: int, hw: int, n_gt: int, n_cams: int,
                   n_seed: int, structure_seed: int = 0) -> SceneGeometry:
    """The soak's "textured" scene (soak.py:63-127) without its frames:
    its cluster centres from `structure_seed`, the rest from `seed`."""
    rng = np.random.default_rng(seed)
    n_clusters = max(8, n_gt // 150)
    centers = np.random.default_rng(structure_seed).random((n_clusters, 3)) * 1.6 - 0.8
    idx = rng.integers(0, n_clusters, n_gt)
    means = (centers[idx] + rng.normal(0, 0.12, (n_gt, 3))).astype(np.float32)
    lo_f = np.array([[2.1, 0.7, 1.3], [0.9, 2.4, 1.7], [1.5, 1.1, 2.6]])
    phases = np.array([0.0, 2.1, 4.2])
    hi_f = np.array([[5.3, 7.1, 4.2], [6.7, 3.9, 5.8], [4.4, 6.1, 7.3]])
    colors = (0.5 + 0.27 * np.sin(means @ lo_f.T + phases)
              + 0.18 * np.sin(means @ hi_f.T + 1.3 * phases + 0.7))
    colors = np.clip(colors, 0.0, 1.0).astype(np.float32)
    scales = (rng.random((n_gt, 3)) * 0.06 + 0.03).astype(np.float32)
    opac = (rng.random((n_gt, 1)) * 0.45 + 0.5).astype(np.float32)
    rots = np.tile([1.0, 0, 0, 0], (n_gt, 1)).astype(np.float32)
    cams = [_orbit(i, ang, hw) for i, ang in enumerate(
        np.linspace(0, 2 * np.pi, n_cams, endpoint=False))]
    sel = rng.integers(0, n_gt, n_seed)
    seed_pts = means[sel] + rng.normal(0, 0.02, (n_seed, 3)).astype(np.float32)
    extent = float(np.linalg.norm(
        np.ptp(np.stack([c.camera_center for c in cams]), axis=0)) * 0.5)
    hold = 8
    test = [i for i in range(n_cams) if i % hold == 0]
    train = [i for i in range(n_cams) if i % hold != 0]
    gt = {"means3d": means, "colors": colors, "opacities": opac,
          "scales": scales, "rotations": rots}
    return SceneGeometry(gt, cams, train, test, seed_pts.astype(np.float32),
                         extent)


def novel_cameras(n_cams: int, n_novel: int, hw: int) -> list:
    """`n_novel` orbit cameras half-way between the scene's, on the same
    orbit law (views no training camera saw)."""
    step = 2 * np.pi / n_cams
    return [_orbit(1000 + i, (i + 0.5) * step, hw) for i in range(n_novel)]


@torch.no_grad()
def gt_frames(geo: SceneGeometry, device, white_background: bool = True):
    """[3, H, W] float32 ground truth of every camera, by the plain
    renderer at K 256, D 32 (the soak's caps)."""
    gt = {k: torch.from_numpy(v).to(device) for k, v in geo.gt.items()}
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=device)
    frames = []
    for cam in geo.cameras:
        vm = torch.from_numpy(cam.viewmatrix).to(device)
        img, _ = ref_raster.rasterize(gt["means3d"], gt["colors"],
                                      gt["opacities"], gt["scales"],
                                      gt["rotations"], vm, bg,
                                      cam.raster_config())
        frames.append(img)
    return frames


def voxelize(points: np.ndarray, voxel_size: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = points.copy()
    rng.shuffle(pts)
    return np.unique(np.round(pts / voxel_size), axis=0) * voxel_size


def morton_order(xyz: np.ndarray) -> np.ndarray:
    x = np.asarray(xyz).astype(np.int64)
    x = x - x.min(axis=0, keepdims=True)
    m = int(x.max()) + 1
    key = x @ np.power(m, np.arange(3, dtype=np.int64))
    return np.argsort(key, kind="stable")


def knn_mean_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k + 1)
    return (d[:, 1:] ** 2).mean(axis=1)


def bucket_capacity(n: int, minimum: int = 1024) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def anchors(geo: SceneGeometry, voxel_size: float, seed: int) -> np.ndarray:
    """The voxelised seed points in the codec's (morton) order."""
    pts = voxelize(geo.seed_points, voxel_size, seed).astype(np.float32)
    order = morton_order(np.round(pts / voxel_size))
    return np.ascontiguousarray(pts[order])


@torch.no_grad()
def make_leaves(shape: ref.HACShape, points: np.ndarray, seed: int, device):
    """(leaves, rest) of an untrained state on `device`: the trainable
    leaves by the port's names, drawn from a torch.Generator on the card
    seeded by `seed`, and the frozen fields.

    Laws (sizes assumed, see configs/hac.json "assumed"): offsets U(-1, 1)
    (in units of the anchor's scale), masks' logits N(2, 1), features N(0,
    1), scalings log(sqrt(knn mean squared distance)) + N(0, 0.1), hash
    tables U(-1e-4, 1e-4) (init_uniform's law), every MLP's weights and
    biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (init_uniform's law), the
    deform MLP's even fc1 biases + 10 (init_seeded)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2**63))
    n = points.shape[0]
    cap = bucket_capacity(n)
    shapes = ref.leaf_shapes(shape, cap)
    k = shape.n_offsets

    def u(shp, lo, hi):
        return torch.rand(shp, generator=gen, device=dev) * (hi - lo) + lo

    def nrm(shp, mean, std):
        return torch.randn(shp, generator=gen, device=dev) * std + mean

    live = torch.zeros(cap, dtype=torch.bool, device=dev)
    live[:n] = True
    livef = live.to(torch.float32)
    dist2 = np.maximum(knn_mean_dist(points), 1e-7)
    log_s = torch.zeros(cap, device=dev)
    log_s[:n] = torch.from_numpy(np.log(np.sqrt(dist2)).astype(np.float32)).to(dev)
    leaves = {
        "anchors/offset": u((cap, k, 3), -1.0, 1.0) * livef[:, None, None],
        "anchors/mask": nrm((cap, k, 1), 2.0, 1.0) * livef[:, None, None],
        "anchors/anchor_feat": nrm((cap, shape.feat_dim), 0.0, 1.0) * livef[:, None],
        "anchors/scaling": (log_s[:, None] + nrm((cap, 6), 0.0, 0.1)) * livef[:, None],
    }
    for name, shp in shapes.items():
        if name.startswith("nets/tables/"):
            leaves[name] = u(shp, -1e-4, 1e-4)
        elif name.startswith("nets/"):
            fc_w = shapes[name.rsplit("/", 1)[0] + "/weight"]
            bound = 1.0 / float(np.sqrt(fc_w[1]))
            leaves[name] = u(shp, -bound, bound)
    leaves["nets/mlp_deform/fc1/bias"][0::2] += 10.0
    anchor = torch.zeros((cap, 3), device=dev)
    anchor[:n] = torch.from_numpy(points).to(dev)
    rot = torch.zeros((cap, 4), device=dev)
    rot[:n, 0] = 1.0
    rest = {
        "anchor": anchor, "rotation": rot,
        "opacity": torch.full((cap, 1), float(np.log(0.1 / 0.9)), device=dev),
        "valid": live,
    }
    mn, mx = ref.anchor_bound(anchor, live)
    rest["x_bound_min"], rest["x_bound_max"] = mn, mx
    return leaves, rest


def noise_draw(shape: ref.HACShape, cap: int, gen: torch.Generator, device):
    """One phase-2 step's uniform draws: (feat [cap, F], scaling [cap, 6],
    offsets [cap, K, 3]), as generate_neural_gaussians takes them."""
    return (torch.rand((cap, shape.feat_dim), generator=gen, device=device),
            torch.rand((cap, 6), generator=gen, device=device),
            torch.rand((cap, shape.n_offsets, 3), generator=gen, device=device))
