"""The cat3dgs cells at a tiny size for the CPU tests (feat_dim 8 in four
slices of 2, 3 offsets, planes of 6, 12 and 24 pixels, the hac cells' tiny
scene), and the faults each can have. `register()` adds them to
`tiny.cell` and `faults.CELL_FAULTS`, which the whole-run tests read."""

from __future__ import annotations

import copy

from portbench import faults, harness
from portbench.tests import tiny

TINY_CAT = {"feat_dim": 8, "n_offsets": 3, "voxel_size": 0.01,
            "chcm_slices": [2, 2, 2, 2], "chcm_for_offsets": False,
            "chcm_for_scaling": False, "tri_feat": 1, "multiscale": [1, 2, 4],
            "contract": True, "base_resolution": 6,
            "arm_layers": [16, 16, 16, 16], "q_feat": 1.0, "q_scaling": 0.001,
            "q_offsets": 0.2}
TINY_SCENE = {"resolution": 48, "n_gt": 300, "n_cams": 9, "n_seed_points": 800,
              "structure_seed": 0}
SEED = tiny.SEED
# a step that keeps its state, one group at twice its rate (mlp_color),
# half the image left out
CAT_FAULTS = ["unchanged_state", "one_group_rate", "half_image"]


def cell(name: str) -> harness.CellSpec:
    spec = harness.load_cell(name)
    spec.config = copy.deepcopy(spec.config)
    spec.traffic = dict(spec.traffic)
    spec.config["model"] = dict(TINY_CAT)
    spec.config["scene"] = dict(TINY_SCENE)
    return spec


def register() -> None:
    cells = [w["name"] for w in harness.benchmark()["workloads"]
             if w["config"] == "cat3dgs"]
    others = tiny.cell

    def sized(name: str) -> harness.CellSpec:
        return cell(name) if name in cells else others(name)

    tiny.cell = sized
    for name in cells:
        faults.CELL_FAULTS.setdefault(name, list(CAT_FAULTS))
