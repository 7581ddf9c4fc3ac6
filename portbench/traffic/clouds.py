"""Seeded point clouds for the `gauspcgc` cells.

Frozen copies, each with the seed taken as an argument:

- `batch_clouds`: bench.py:179-191 (`bench_codec_batch`'s 8 clouds: 60
  centres in a 2,500 span, 40,000 draws, sigma 18, unique voxels).
  Departure: the centres come from bench.py's fixed seed 5 in a generator
  of their own, the draws about them from `seed`, so every seed gives
  clouds of the same layout and about the same size.
- `synth_clouds` and its families: gauspcc_tpu_torch/codecs/gauspcgc/cli.py
  :202-287 (`_synth_clustered`, `_rand_rot`, `_synth_surface`,
  `synth_clouds`), unchanged.
- `kdtree_partition`: gauspcc_tpu_torch/codecs/gauspcgc/data.py:102-117,
  unchanged; MAX_PATCH_POINTS is data.py:24's.
"""

from __future__ import annotations

import numpy as np

MAX_PATCH_POINTS = 150_000


def batch_clouds(seed: int, count: int = 8, n_centers: int = 60,
                 span: int = 2500, draws: int = 40_000, sigma: float = 18.0,
                 structure_seed: int = 5):
    """The batch's clouds: their centres from `structure_seed` (bench.py's
    5), the same for every run, the points about them from `seed`."""
    rng = np.random.default_rng(seed)
    layout = np.random.default_rng(structure_seed)
    clouds = []
    for _ in range(count):
        centers = layout.integers(0, span, size=(n_centers, 3))
        pts = centers[rng.integers(0, len(centers), draws)] + rng.normal(
            0, sigma, (draws, 3))
        clouds.append(np.unique(np.round(pts), axis=0).astype(np.int64))
    return clouds


def _synth_clustered(rng):
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
        else:
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
        p += rng.normal(0, rng.uniform(0.3, 1.5), p.shape)
        parts.append(p)
    return np.concatenate(parts), f"surface objs={n_obj} span={span}"


def synth_clouds(seed: int, count: int, kind: str = "mixed"):
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


def kdtree_partition(points: np.ndarray, max_num: int) -> list[np.ndarray]:
    parts: list[np.ndarray] = []
    stack = [points]
    while stack:
        data = stack.pop()
        if len(data) <= max_num:
            parts.append(data)
            continue
        axis = int(np.argmax(np.var(data, axis=0)))
        order = np.argsort(data[:, axis], kind="stable")
        mid = len(data) // 2
        stack.append(data[order[:mid]])
        stack.append(data[order[mid:]])
    return parts
