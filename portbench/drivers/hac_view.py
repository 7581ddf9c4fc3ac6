"""HAC's eval render, closed loop, one client (cell hac.view).

Set-up builds the seeded state as hac_train does (no ground-truth frames:
nothing scores the views), fits its context box with the program's
`update_anchor_bound`, and picks the caps as the port's `evaluate` does
(`select_eval_k` on the first held-out camera, `select_eval_d` over every
camera of the cell). The cameras are the scene's held-out ones and
`n_novel` novel orbit cameras between the training ones; each is rendered
once in set-up. The window renders them round and round through the
program's `render_image` on a black background; a view is complete when
its uint8 frame is on the host, converted as the SIBR viewer's frames
are (`network_gui.image_to_bytes`). After the window the plain reference
renders a sample of the cameras, drawn from the seed, at its own caps, and
the program's frames of those cameras (kept from the window) are compared
with them.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import harness
from portbench.counts import blend as blend_counts
from portbench.counts import hac_ops
from portbench.drivers import _hac
from portbench.reference import hac as ref
from portbench.traffic import hac_scene

LIMITS = {"frame_max_gap": 2e-3}
N_SAMPLE = 4  # cameras the reference renders
TRACE_FRAMES = 8


class Session:
    def __init__(self, cell, seed: int, device):
        from gauspcc_tpu_torch.models.hac import pipeline
        from gauspcc_tpu_torch.models.hac import render as hac_render
        from gauspcc_tpu_torch.utils import network_gui

        self.limits = {**LIMITS, **cell.limits}
        self.hac_render, self.to_bytes = hac_render, network_gui.image_to_bytes
        inp = self.inp = _hac.Inputs(cell, seed, device, with_frames=False)
        harness.mark("inputs")
        dev = inp.device
        self.state, self.cfg = _hac.program_state(inp, cell.config)
        harness.mark("state")
        geo = inp.geo
        sc = cell.config["scene"]
        self.views = [geo.cameras[i] for i in geo.test_idx] + hac_scene.novel_cameras(
            sc["n_cams"], int(cell.traffic["n_novel"]), sc["resolution"])
        self.cams = [_hac.program_camera(c, dev) for c in self.views]
        self.bg = torch.zeros(3, device=dev)
        # evaluate()'s caps (pipeline.py:570-575), through the program's
        # own rules on these cameras
        self.k = pipeline.select_eval_k(self.state, self.cfg,
                                        _CamView(self.views[0]))
        self.d = pipeline.select_eval_d(self.state, self.cfg,
                                        [_CamView(c) for c in self.views])
        self.rcfg = _hac.program_raster(self.views[0], self.k, self.d)
        harness.mark("eval_caps")
        rng = np.random.default_rng(seed)
        self.sample = sorted(rng.choice(len(self.views), N_SAMPLE, replace=False).tolist())
        self.kept: dict[int, torch.Tensor] = {}
        for cam in self.cams:  # every view once: the allocator's sizes
            self._view(cam)

    def _view(self, cam):
        img = self.hac_render.render_image(self.state, self.cfg, cam, self.rcfg,
                                           self.bg)
        frame = self.to_bytes(img.cpu().numpy())
        return img, frame

    def window(self, seconds: float, trace: bool) -> harness.Window:
        records: dict = {}
        lat = []
        rec = (_hac.record_blends(TRACE_FRAMES, records) if trace
               else contextlib.nullcontext())
        n = len(self.cams)
        with rec:
            harness.sync(self.inp.device)
            t0 = time.perf_counter()
            i = 0
            while True:
                a = time.perf_counter()
                img, _ = self._view(self.cams[i % n])
                lat.append(time.perf_counter() - a)
                if i % n in self.sample and i % n not in self.kept:
                    self.kept[i % n] = img
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        self.records = records
        window_s = t1 - t0
        views = len(lat)
        values = {"view_ms": window_s / views * 1e3,
                  "view_p95_ms": float(np.quantile(np.array(lat), 0.95)) * 1e3}
        self.p95_ms = values["view_p95_ms"]
        return harness.Window(attempted=views, failed=0, values=values,
                              seconds=window_s)

    def trace_info(self) -> dict:
        records = self.records
        fwd = [blend_counts.blend_bound(*r[:5], **r[5]) for r in records["forward"]]
        n = min(len(fwd), len(records["visible"]))
        ops = [hac_ops.view_ops(self.inp.shape, int(records["visible"][i].sum()),
                                fwd[i]["ops"]) for i in range(n)]
        self.records = {}
        return {"blend_fwd_bound_ms": [b["bound_ms"] for b in fwd],
                "blend_fwd": fwd,
                "anchors": self.inp.points.shape[0], "rows": self.inp.cap,
                "caps_k_d": [self.k, self.d],
                "ops_per_unit": float(np.mean(ops)) if ops else None,
                "peak_flops": hac_ops.PEAK_FP32_FLOPS,
                "view_p95_ms": self.p95_ms}

    def release(self) -> None:
        for i in self.sample:  # a window too short to reach a sampled camera
            if i not in self.kept:
                self.kept[i] = self._view(self.cams[i])[0]
        self.frames = dict(self.kept)
        del self.state, self.kept
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False) -> dict:
        """The plain reference's frames of the sampled cameras, at the caps
        its own copies of evaluate's rules pick."""
        inp = self.inp
        cams = [inp.ref_camera(c) for c in self.views]
        rcfg0 = self.views[0].raster_config()
        with ref.precision(tf32=tf32):
            k = ref.select_eval_k(inp.leaves, inp.rest, inp.shape, cams[0],
                                  rcfg0, self.bg)
            d = ref.select_eval_d(inp.leaves, inp.rest, inp.shape, cams, rcfg0)
            rcfg = self.views[0].raster_config(k, d)
            frames = {i: ref.render_image(inp.leaves, inp.rest, inp.shape,
                                          cams[i], rcfg, self.bg)
                      for i in self.sample}
        return {"caps": (k, d), "frames": frames}

    def compare(self, got: dict, want: dict) -> list:
        caps_gap = float(tuple(got["caps"]) != tuple(want["caps"]))
        gap = max(float((got["frames"][i] - want["frames"][i]).abs().max())
                  for i in self.sample)
        return [harness.Check("caps_differ", caps_gap, 0.0),
                harness.Check("frame_max_gap", gap, self.limits["frame_max_gap"])]

    def check(self) -> list:
        got = {"caps": (self.k, self.d), "frames": self.frames}
        return self.compare(got, self.reference())

    def control(self) -> list:
        """The reference in TF32 in the program's place."""
        return self.compare(self.reference(tf32=True), self.reference())


class _CamView:
    """What select_eval_k / select_eval_d read of a camera: its size, its
    field of view and its matrices (data/cameras.py Camera's fields)."""

    def __init__(self, cam):
        self.height = self.width = cam.hw
        self.tanfovx = self.tanfovy = cam.tanfov
        self.world_view_transform = cam.viewmatrix
        self.camera_center = cam.camera_center
        self.image = None


def setup(cell, seed: int, device):
    return Session(cell, seed, device)
