"""Tiny cells for the CPU tests: each benchmark cell's files with its
sizes cut so that a run takes seconds on the CPU (the widths too: these
sizes serve the tests only)."""

from __future__ import annotations

import copy

import numpy as np

from portbench import harness
from portbench.traffic import clouds

TINY_HAC = {"feat_dim": 8, "n_offsets": 3, "voxel_size": 0.01,
            "n_features_per_level": 2, "log2_hashmap_size": 10,
            "log2_hashmap_size_2d": 8, "resolutions_3d": [6, 12, 24],
            "resolutions_2d": [8, 32], "q_feat": 1.0, "q_scaling": 0.001,
            "q_offsets": 0.2}
SEED = 2**31 + 5


def cell(name: str) -> harness.CellSpec:
    spec = harness.load_cell(name)
    spec.config = copy.deepcopy(spec.config)
    spec.traffic = dict(spec.traffic)
    if spec.config_name == "hac":
        spec.config["model"] = TINY_HAC
        spec.config["scene"] = {"resolution": 48, "n_gt": 300, "n_cams": 9,
                                "n_seed_points": 800, "structure_seed": 0}
        if "n_novel" in spec.traffic:
            spec.traffic["n_novel"] = 3
    elif spec.driver == "gauspcgc_code":
        spec.traffic.update(clouds=2, centers=10, span=300, draws=3000,
                            sigma=6.0)
        # at this size the coder's framing is about a tenth of the stream:
        # a sound run reads bits_gap 0.108 here, faults.coarse_cdf 0.242
        spec.limits["bits_gap"] = 0.16
    elif spec.driver == "gauspcgc_train":
        spec.config["model"] = {"channels": 8, "kernel_size": 3,
                                "dtype": "bf16"}
        spec.traffic.update(max_patch_points=1500)
    return spec


def small_clouds(seed, count, kind="mixed"):
    """Stand-in for synth_clouds at the tests' size: `count` clouds of
    ~3,000 voxels in a 200 span."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        pts = rng.integers(0, 200, (3000, 3)).astype(np.float32)
        yield np.unique(pts, axis=0), "tiny"


def patch_sizes(monkeypatch) -> None:
    monkeypatch.setattr(clouds, "synth_clouds", small_clouds)
