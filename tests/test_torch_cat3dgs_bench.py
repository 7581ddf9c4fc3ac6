"""CAT-3DGS's published configuration through the port's family step, held
against the benchmark's plain reference (portbench/reference/cat3dgs.py)
on the CPU at a tiny size (portbench/tests/tiny_cat.py: feat_dim 8 in the
four slices (2, 2, 2, 2), 3 offsets, planes of 6, 12 and 24 pixels, a
48x48 scene), with the view-frequency mask weights on (and differing from
1: the cameras' field of view narrowed to a third).

Tolerances (this CPU reads about a tenth of each): the three losses within
1e-5 relative; every leaf's first gradient, the ARMs' and the planes'
included, within 1e-5 of the leaf's largest reference component; the
planes' bits a parameter within 1e-6 relative; the leaves' change after
the first step within 1e-4 of the reference change's norm, after the third
within 1e-2 (a gradient component near 0 may take Adam's step the other
way).

The program's PCA frame agrees with the reference's own fit within 1e-5,
and its first mask gradient repeats the move the weights make in the
reference's within 1e-3 of that move.

Also: `correct` comes out false under every planted fault, the planes'
rate dropped from the loss, the frame fitted without its outlier filter
and the mask weights ignored among them; `mask_weights=None` leaves HAC's
step as it was; the CAT spans and the `arm_planes` counter, and the
readers of the cell's per-layer metrics; the counts behind its shares; the
configuration's published widths; a program without `mask_weights` stops
the cell's set-up at once. This file imports no JAX.
"""

import ast
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gauspcc_tpu_torch.models.cat3dgs import field as cat_field
from gauspcc_tpu_torch.models.cat3dgs import render as cat_render
from gauspcc_tpu_torch.utils import profiling
from portbench import faults, harness
from portbench.counts import arm_rate, cat_ops, hac_ops
from portbench.drivers import cat3dgs_train as cat_driver
from portbench.reference import cat3dgs as ref
from portbench.tests import tiny, tiny_cat
from portbench.traffic import hac_scene

CELL = "cat3dgs.train_rd"


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tiny.patch_sizes(monkeypatch)
    profiling.reset()
    yield
    profiling.recording()
    profiling.reset()
    torch.set_num_threads(threads)


def session(seed=tiny_cat.SEED):
    spec = tiny_cat.cell(CELL)
    return harness.driver(spec.driver).setup(spec, seed, "cpu")


@pytest.fixture
def narrow_views(monkeypatch):
    """The tiny scene's cameras at a third of their field of view, so that
    some anchors fall outside some views and the view-frequency weights of
    the mask differ from 1 (with the orbit's own field of view every anchor
    of the tiny scene is in every view, and the weights are all 1)."""
    geometry = hac_scene.scene_geometry

    def narrow(*a, **k):
        geo = geometry(*a, **k)
        return geo._replace(cameras=[c._replace(fov=c.fov / 3) for c in geo.cameras])

    monkeypatch.setattr(hac_scene, "scene_geometry", narrow)


def dropped_plane_rate(setattr_) -> None:
    """The planes' rate left out of the loss: the ARMs' bits read 0."""
    setattr_(cat_field, "field_rate_bits",
             lambda field, planes_q=None: torch.zeros((), device=field.gains.device))


def unfiltered_frame(setattr_) -> None:
    """The PCA frame fitted to every anchor, the local outliers kept."""
    setattr_(cat_field, "lof_inliers",
             lambda points, *a, **k: np.ones(len(points), dtype=bool))


def ignored_mask_weights(setattr_) -> None:
    """The step's mask weights ignored where the mask selects anchors for
    the rate."""
    orig = cat_render.weighted_mask
    setattr_(cat_render, "weighted_mask", lambda state, weights=None: orig(state))


CAT_FAULTS = {"dropped_plane_rate": (dropped_plane_rate,
                                     {"arm_bits_gap", "arm_grad_gap"}),
              "unfiltered_frame": (unfiltered_frame, {"frame_gap"}),
              "ignored_mask_weights": (ignored_mask_weights, {"mask_weights_gap"})}


def _norm(t):
    return float(torch.linalg.norm(t.double()))


def test_the_phase5_step_matches_the_plain_reference(narrow_views):
    s = session()
    assert s.cfg.chcm_slices == (2, 2, 2, 2) and s.weights is not None
    assert not torch.all(s.weights == 1.0)  # the weights act
    s.release()
    got = s.program_readings()
    want, steps = s.reference()
    g1 = want.g1
    assert tuple(got.caps) == tuple(want.caps)
    for a, b in zip(got.losses, want.losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert abs(got.arm1 - want.arm1) <= 1e-6 * abs(want.arm1) and want.arm1 > 0
    assert abs(got.arm1 - steps.arm1_f64) <= 1e-6 * steps.arm1_f64
    assert max(cat_driver.frame_gaps(got.frame, want.frame).values()) <= 1e-5
    free = ~steps.drawn
    move = (g1["anchors/mask"] - steps.mask_grad_unit)[free]
    assert float(move.abs().max()) > 0  # the weights move the rate's gradient
    assert cat_driver.along_gap((got.g1["anchors/mask"] - g1["anchors/mask"])[free],
                         move) <= 1e-3
    assert got.g1.keys() == g1.keys()
    arms = [k for k in g1 if k.startswith(("nets/field/arms/", "nets/field/scales/"))]
    assert len(arms) == 3 * 5 * 2 + 3
    for k, g in g1.items():
        scale = float(g.abs().max())
        assert scale > 0, k  # every leaf, the ARMs' and the planes' too, moves
        assert float((got.g1[k] - g).abs().max()) <= 1e-5 * scale, k
    w0 = s.inp.leaves
    for mine, theirs, tol in ((got.after1, want.after1, 1e-4),
                              (got.after, want.after, 1e-2)):
        for k in theirs:
            assert _norm(mine[k] - theirs[k]) <= tol * _norm(theirs[k] - w0[k]), k


def test_a_sound_run_is_correct_with_the_cell_checks():
    spec = tiny_cat.cell(CELL)
    r = harness.run_cell(spec, seed=tiny_cat.SEED, seconds=0.2, trace=False,
                         t_start=time.perf_counter(), device="cpu")
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == ["caps_differ", "loss_gap", "grad_gap",
                                 "change_gap", "step1_change_gap",
                                 "arm_bits_gap", "arm_grad_gap", "frame_gap",
                                 "mask_weights_gap"]
    assert set(r["metrics"]) == {"train_step_ms", "setup_s"}


@pytest.mark.parametrize("fault", tiny_cat.CAT_FAULTS + list(CAT_FAULTS))
def test_a_planted_fault_is_not_correct(fault, monkeypatch, request):
    plant, fails = CAT_FAULTS.get(fault, (faults.FAULTS.get(fault), set()))
    if fault == "ignored_mask_weights":
        request.getfixturevalue("narrow_views")  # weights that act
    plant(monkeypatch.setattr)
    r = harness.run_cell(tiny_cat.cell(CELL), seed=tiny_cat.SEED, seconds=0.2,
                         trace=False, t_start=time.perf_counter(), device="cpu")
    assert r["correct"] is False, r["checks"]
    failed = {k for k, v in r["checks"].items() if v["value"] > v["limit"]}
    assert fails <= failed, r["checks"]


def test_no_mask_weights_leaves_the_hac_step_as_it_was(monkeypatch):
    """A HAC step with mask_weights=None hands HAC's objective exactly the
    arguments it took before, and gives the leaves, moments and statistics
    of a step called without the argument, bit for bit."""
    spec = tiny.cell("hac.train_rd")
    drv = harness.driver(spec.driver)
    plain, passed = drv.setup(spec, tiny.SEED, "cpu"), drv.setup(spec, tiny.SEED, "cpu")
    seen = []
    loss_fn = plain.family.training_loss

    def spy(*a, **k):
        seen.append(sorted(k))
        return loss_fn(*a, **k)

    noise = [torch.rand_like(t) for t in plain.check_noise[0]]
    cam = plain.cams[0]
    for s, kw in ((plain, {}), (passed, {"mask_weights": None})):
        s.family = dataclasses.replace(s.family, training_loss=spy)
        step = s._make_step(s.rcfg)
        s.params, s.opt_state, s.stats, _ = step(
            s.params, s.rest, s.opt_state, s.stats, cam, phase=2, noise=noise, **kw)
    assert seen == [["generator"], ["generator"]]
    leaves = plain.hac_train.param_leaves
    a, b = leaves(plain.params), leaves(passed.params)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in plain.opt_state["nu"]:
        assert torch.equal(plain.opt_state["nu"][k], passed.opt_state["nu"][k]), k
    for k in plain.stats:
        assert torch.equal(plain.stats[k], passed.stats[k]), k


def test_weights_of_one_give_the_unweighted_cat_step(narrow_views):
    """CAT-3DGS's objective with weights of 1 everywhere gives the loss and
    the mask's gradient it gives without weights, bit for bit; the cell's
    weights change that gradient (the hard mask's forward may not move)."""
    s = session()
    bg = torch.ones(3)
    m2d = torch.zeros((s.inp.cap * s.cfg.n_offsets, 2))
    mask = s.params["anchors"]["mask"]
    out = []
    for w in (None, torch.ones(s.inp.cap), s.weights):
        with torch.enable_grad():
            mask.requires_grad_(True)
            loss, _ = s.family.training_loss(
                s.params, s.rest, s.cfg, s.cams[0], s.rcfg, bg, 5,
                s.check_noise[0], m2d, s.opt.lmbda, s.opt.lambda_dssim,
                mask_weights=w)
            (g,) = torch.autograd.grad(loss, [mask])
        out.append((float(loss.detach()), g))
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])
    assert not torch.equal(out[2][1], out[0][1])


def test_a_program_without_mask_weights_stops_the_set_up_at_once(monkeypatch):
    from gauspcc_tpu_torch.models.hac import train as hac_train

    def old_step_gradients(cfg, rcfg, opt, params, rest, cam, phase=0,
                           noise=None, generator=None, *, loss_fn=None,
                           grad_mask=None, white_background=False):
        raise AssertionError("not reached")

    monkeypatch.setattr(hac_train, "step_gradients", old_step_gradients)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="mask_weights"):
        session()
    assert time.perf_counter() - t0 < 5.0


# ---------------------------------------------------------------------------
# spans and readers
# ---------------------------------------------------------------------------


def test_a_traced_cat_step_records_its_spans_and_is_the_same():
    plain, traced = session(), session()
    plain._step()
    with profile(activities=[ProfilerActivity.CPU]):
        traced._step()
    leaves = traced.hac_train.param_leaves
    a, b = leaves(plain.params), leaves(traced.params)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    got = profiling.spans()
    names = {s.id: s.name for s in got}
    (step,) = [s for s in got if s.name == "hac.step"]
    under = {s.name: s for s in got if s.root == step.id and s is not step}
    assert {"cat.field", "cat.chcm", "cat.arm_rate", "cat.arm_rate.bwd",
            "cat.field.bwd", "hac.backward", "optim.update"} <= set(under)
    n_planes = 3 * len(traced.cfg.multiscale) * traced.cfg.tri_feat
    assert under["cat.arm_rate"].counters == {"arm_planes": n_planes}
    assert profiling.counters()["arm_planes"] == n_planes
    for name in ("cat.field", "cat.chcm", "cat.arm_rate"):
        assert names[under[name].parent] in ("hac.objective", "hac.step")
        assert under[name].end_ns >= under[name].start_ns
    for name in ("cat.arm_rate.bwd", "cat.field.bwd"):
        assert names[under[name].parent] == "hac.backward"
        span = under[name]
        assert span.end_ns is not None and span.start_ns <= span.end_ns
        bwd = under["hac.backward"]
        assert bwd.start_ns <= span.start_ns <= span.end_ns <= bwd.end_ns
    assert under["cat.field"].end_ns <= under["cat.arm_rate"].start_ns


def _span(name, id_, parent, root, ms=None):
    return profiling.Span(name, id_, parent, root, 0, 1, ms, {})


SPANS = [_span("hac.step", 0, None, 0), _span("cat.arm_rate", 1, 0, 0, 10.0),
         _span("cat.field.bwd", 2, 0, 0, 30.0),
         _span("cat.arm_rate.bwd", 3, 0, 0, 22.0),
         _span("hac.step", 4, None, 4), _span("cat.arm_rate", 5, 4, 4, 12.0),
         _span("cat.field.bwd", 6, 4, 4, 34.0),
         _span("cat.arm_rate.bwd", 7, 4, 4, 26.0),
         _span("cat.arm_rate", 8, None, 8, 500.0)]  # not under a step


@pytest.mark.parametrize("name,want", [
    ("arm_rate_ms.cat", (10 + 22 + 12 + 26) / 2),
    ("field_bwd_ms.cat", (30 + 34) / 2),
    ("arm_rate_roofline.cat", 100 * 0.007 / 35.0)])
def test_a_span_reader_gives_the_number_worked_out_by_hand(name, want, monkeypatch):
    run = harness.TracedRun(harness.load_cell(CELL), [], 1.0, 0.5, 2,
                            {"arm_rate_bound_ms": 0.007})
    reader = harness.metric_reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: SPANS)
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    monkeypatch.setattr(profiling, "spans", lambda: [
        s for s in SPANS if s.name not in ("cat.arm_rate.bwd", "cat.field.bwd")])
    assert reader.read(run) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert reader.read(run) is None


def test_the_cell_and_its_metrics_are_in_the_benchmark():
    bench = harness.benchmark()
    spec = harness.load_cell(CELL)
    assert spec.chips == 1 and spec.driver == "cat3dgs_train"
    assert {m["name"] for m in spec.end_to_end} == {"train_step_ms", "setup_s"}
    mine = {"arm_rate_ms.cat", "field_bwd_ms.cat", "arm_rate_roofline.cat"}
    shared = {"launches_per_step.train", "k1_fwd_roofline.train",
              "k1_bwd_roofline.train", "idle.train", "mfu.train",
              "optim_ms.train"}  # hac.train_rd's, the cell appended
    assert {m["name"] for m in spec.per_layer} == mine | shared
    for m in spec.per_layer:
        want = [CELL] if m["name"] in mine else ["hac.train_rd", CELL]
        assert m["workloads"] == want and m["moves"] == "train_step_ms"
        assert callable(harness.metric_reader(m["name"]).read)
    run = harness.TracedRun(spec, [], 2.0, 1.0, 4,
                            {"ops_per_unit": 6.7e9, "peak_flops": 67e12})
    assert harness.metric_reader("mfu.train").read(run) == pytest.approx(0.02)
    (conf,) = [c for c in bench["configs"] if c["name"] == "cat3dgs"]
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"]) == ["scene", "state"]


def test_the_configuration_keeps_the_published_settings():
    conf = harness.load_cell(CELL).config
    m, t = conf["model"], conf["train"]
    assert m["chcm_slices"] == [5, 10, 15, 20] and sum(m["chcm_slices"]) == m["feat_dim"] == 50
    assert (m["n_offsets"], m["voxel_size"]) == (10, 0.001)
    assert (t["iterations"], t["lmbda"], t["cam_mask"]) == (40000, 0.001, 1)
    assert cat_field.adapt_resolution(159_990) == m["base_resolution"] == 67
    from gauspcc_tpu_torch.models.cat3dgs import render as cat_render

    first = harness.load_cell(CELL).traffic["first_step"]
    assert cat_render.phase_of_step(first) == 5 == cat_render.phase_of_step(40_000)
    assert cat_render.phase_of_step(first - 1) == 4


def test_the_counts_at_the_published_widths():
    shape = ref.CATShape.from_config(harness.load_cell(CELL).config)
    arm = arm_rate.arm_rate_bound(shape)
    assert arm["pixels"] == 3 * (67**2 + 134**2 + 268**2) == 282_807
    assert arm["ops_per_pixel"] == 2 * (12 * 16 + 3 * 16 * 16 + 16 * 2) == 1984
    assert arm["bwd_ops"] == 2 * arm["fwd_ops"] == 2 * 282_807 * 1984
    params = 3 * ((12 * 16 + 16) + 3 * (16 * 16 + 16) + (16 * 2 + 2))
    assert arm["fwd_bytes"] == 4 * 282_807 + 4 * params
    assert arm["bound_ms"] == pytest.approx(
        (arm["fwd_ops"] + arm["bwd_ops"]) / 67e12 * 1e3)  # operations bind
    assert shape.ctx_dim == 9 and shape.grid_out_dim == 2 * 5 + 2 * 36 + 3
    chcm = sum(2 * a * 100 + 2 * 100 * 2 * c for a, c in ((5, 10), (15, 15), (30, 20)))
    scaffold = 2 * (54 * 50 + 50 * 10 + 54 * 50 + 50 * 70 + 54 * 50 + 50 * 30
                    + 9 * 100 + 100 * 85)
    assert cat_ops.dense_flops_per_anchor(shape) == scaffold + chcm
    assert cat_ops.sample_flops_per_anchor(shape) == 3 * 3 * 4 * 4
    ops = cat_ops.train_step_ops(shape, 1000, 16, 16, 7, 11)
    assert ops == (3 * (1000 * (scaffold + chcm + 144) + hac_ops.ssim_flops(16, 16))
                   + 3 * 282_807 * 1984 + 18)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    forbidden = {"jax", "jaxlib", "flax", "gauspcc_tpu", "gauspcc_tpu_torch"}
    root = Path(harness.HERE)
    for path in (root / "reference" / "cat3dgs.py", root / "traffic" / "cat_scene.py",
                 root / "counts" / "arm_rate.py", root / "counts" / "cat_ops.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops.add(node.module.split(".")[0])
        assert not tops & forbidden, (path, tops & forbidden)
