"""Point-cloud IO and patch datasets for codec training (host side,
numpy): the port's copy of gauspcc_tpu/codecs/gauspcgc/data.py
(`read_points` :25, `save_ply_ascii_geo` :76, `read_point_clouds` :87,
`kdtree_partition` :96, `quantize_cloud` :118, `PatchDataset` :125,
`WholeCloudDataset` :169).

Parity targets: GausPcgc/kit/io.py (readers, ascii PLY writer, KD-tree
partition) and GausPcgc/dataset.py (PCDataset / PCDataset_Patch: optional
1/0.001 scaling, round-to-int, <=150k-point KD patches). numpy and a
thread pool; the PLY parsed directly. `PatchDataset` draws from Python's
`random.Random(seed)`, as the JAX package's does, so its epoch orders and
patch picks equal JAX's for one seed.
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np

RAW_SCALE = 1.0 / 0.001  # dataset.py:21-24 scaling for non-pre-quantized data
MAX_PATCH_POINTS = 150_000


# ---------------------------------------------------------------------------
# readers / writers
# ---------------------------------------------------------------------------

def read_points(path: str) -> np.ndarray:
    """Read xyz from .bin (KITTI float32 Nx4), .npy/.npz, or .ply."""
    ext = os.path.splitext(path)[-1].lower()
    if ext == ".bin":
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    if ext == ".npy":
        return np.load(path)[:, :3].astype(np.float32)
    if ext == ".npz":
        return np.load(path)["points"][:, :3].astype(np.float32)
    if ext == ".ply":
        return _read_ply(path)
    raise ValueError(f"unsupported point cloud format: {path}")


def _read_ply(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
        props = [
            (l.split()[1], l.split()[2])
            for l in header
            if l.startswith("property") and len(l.split()) == 3
        ]
        names = [p[1] for p in props]
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")

        np_types = {
            "float": np.float32, "float32": np.float32,
            "double": np.float64, "float64": np.float64,
            "int": np.int32, "int32": np.int32, "uint32": np.uint32,
            "short": np.int16, "ushort": np.uint16,
            "char": np.int8, "uchar": np.uint8, "uint8": np.uint8,
        }
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n, dtype=np.float64)
            return data[:, [ix, iy, iz]].astype(np.float32)
        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(f"f{i}", endian + np.dtype(np_types[t]).str[1:])
                          for i, (t, _) in enumerate(props)])
        data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        return np.stack(
            [data[f"f{ix}"], data[f"f{iy}"], data[f"f{iz}"]], axis=1
        ).astype(np.float32)


def save_ply_ascii_geo(coords: np.ndarray, path: str) -> None:
    """ASCII geometry-only PLY writer (kit/io.py:36-49)."""
    coords = np.asarray(coords, dtype=np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {coords.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        np.savetxt(f, coords, fmt="%.6g")


def read_point_clouds(paths: list[str], workers: int = 16) -> list[np.ndarray]:
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(read_points, paths))


# ---------------------------------------------------------------------------
# KD-tree partition
# ---------------------------------------------------------------------------

def kdtree_partition(points: np.ndarray, max_num: int) -> list[np.ndarray]:
    """Recursively split along the max-variance axis at the median until each
    part holds <= max_num points (kit/io.py:54-78), iteratively."""
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


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def quantize_cloud(xyz: np.ndarray, posQ: float = 1.0,
                   pre_quantized: bool = True) -> np.ndarray:
    if not pre_quantized:
        xyz = xyz * RAW_SCALE
    return np.round(xyz / posQ).astype(np.int64)


class PatchDataset:
    """Random <=max_num-point KD patch per draw (PCDataset_Patch)."""

    def __init__(self, paths, posQ=1.0, pre_quantized=True,
                 max_num=MAX_PATCH_POINTS, seed=11):
        self.clouds = read_point_clouds(list(paths))
        self.posQ = posQ
        self.pre_quantized = pre_quantized
        self.max_num = max_num
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.clouds)

    def sample(self, idx: int) -> np.ndarray:
        return self.sample_with_key(idx)[1]

    def sample_with_key(self, idx: int):
        """-> ((idx, part), xyz). The KD partition of a file is
        deterministic, so (idx, part) keys a reusable geometry cache in the
        trainer (the per-step host pyramid/map build dominated step time
        on the 1-core host otherwise)."""
        xyz = self.clouds[idx]
        part = -1
        if len(xyz) > self.max_num:
            parts = self._partition(idx)
            part = self.rng.randrange(len(parts))
            xyz = parts[part]
        return (idx, part), quantize_cloud(xyz, self.posQ, self.pre_quantized)

    def _partition(self, idx: int):
        cache = getattr(self, "_parts_cache", None)
        if cache is None:
            cache = self._parts_cache = {}
        if idx not in cache:
            cache[idx] = kdtree_partition(self.clouds[idx], self.max_num)
        return cache[idx]

    def epoch_order(self):
        order = list(range(len(self.clouds)))
        self.rng.shuffle(order)
        return order


class WholeCloudDataset:
    """Full clouds, for validation (PCDataset)."""

    def __init__(self, paths, posQ=1.0, pre_quantized=True):
        self.clouds = read_point_clouds(list(paths))
        self.posQ = posQ
        self.pre_quantized = pre_quantized

    def __len__(self):
        return len(self.clouds)

    def get(self, idx: int) -> np.ndarray:
        return quantize_cloud(self.clouds[idx], self.posQ, self.pre_quantized)
