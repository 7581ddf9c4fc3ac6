"""The recorder of gauspcc_tpu_torch.utils.profiling (spans, counters,
the sync count) and the benchmark's readers of it (portbench/layer_metrics).

On the CPU: a span off records nothing and takes no clock; under a CPU
profiler spans nest with their parent and root, their host intervals are
ordered and contained and share the profiler's clock, counts land on the
innermost span; leaving the profiler restores the sync debug mode and the
warning filters; each reader on hand-built kernels and spans gives the
number worked out by hand; a HAC step and a codec step give the same
leaves, bit for bit, traced and untraced. Marked `cuda`: on the card a
span's edges bracket its op's host event and come before its kernel. This
file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_spans.py
"""

import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gauspcc_tpu_torch.utils import profiling
from portbench import harness
from portbench.tests import tiny

SYNC = "called a synchronizing CUDA operation (Triggered internally)"


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.recording()  # any profiler has stopped: the recorder goes off
    profiling.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_a_span_off_records_nothing_and_reads_no_clock(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("a span off took a mark")

    monkeypatch.setattr(profiling, "mark", fail)
    with profiling.span("off"):
        profiling.count("n")

    @profiling.span("off.fn")
    def fn(x):
        return x + 1

    assert fn(1) == 2
    profiling.backward_span("off.bwd", torch.ones(1, requires_grad=True) * 2,
                            [torch.ones(1, requires_grad=True)])
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.span("off") is profiling.span("off")  # no new object
    assert not profiling.recording()


def test_spans_nest_with_their_parent_root_and_counts():
    x = torch.zeros(256, 256)

    @profiling.span("leaf.fn")
    def leaf():
        x.fill_(2.0)
        profiling.count("n", 3)

    with cpu_profile() as prof:
        with profiling.span("root"):
            with profiling.span("mid"):
                leaf()
                profiling.count("n")
            with profiling.span("mid"):
                pass
        with profiling.span("root2"):
            profiling.count("m")
        profiling.count("m", 5)  # outside every span
    got = profiling.spans()
    assert [s.name for s in got] == ["root", "mid", "leaf.fn", "mid", "root2"]
    root, mid, fn, mid2, root2 = got
    assert [s.id for s in got] == [0, 1, 2, 3, 4]
    assert (root.parent, mid.parent, fn.parent, mid2.parent, root2.parent) == (
        None, 0, 1, 0, None)
    assert [s.root for s in got] == [0, 0, 0, 0, 4]
    for outer, inner in ((root, mid), (mid, fn), (root, mid2)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert mid.end_ns <= mid2.start_ns and root.end_ns <= root2.start_ns
    assert fn.counters == {"n": 3} and mid.counters == {"n": 1}
    assert root2.counters == {"m": 1} and root.counters == {}
    assert profiling.counters() == {"n": 4, "m": 6}
    if not torch.cuda.is_initialized():  # no card: no events
        assert all(s.device_ms is None for s in got)
    # the profiler's own host event of the fill lies inside the span
    _, host = harness.device_events(prof)
    (fill,) = [h for h in host if h[0] == "aten::fill_"]
    assert fn.start_ns <= fill[1] <= fill[2] <= fn.end_ns
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_recordings_add_up_and_a_span_left_open_is_closed():
    with cpu_profile():
        with profiling.span("first"):
            pass
    with profiling.span("between"):  # no profiler: not recorded
        pass
    with cpu_profile():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
            # a span whose exit never comes is closed with its parent
            profiling.span("dangling").__enter__()
    got = profiling.spans()
    assert [s.name for s in got] == ["first", "outer", "inner", "dangling"]
    assert [s.root for s in got] == [0, 1, 1, 1]
    assert got[3].end_ns == got[1].end_ns


def test_phases_and_backward_spans_record_marks_taken_elsewhere():
    w = torch.nn.Parameter(torch.randn(8))
    with cpu_profile():
        with profiling.span("step"):
            a = profiling.mark(torch.device("cpu"))
            b = profiling.mark(torch.device("cpu"))
            profiling.add_span("phase", a, b)
            y = (w * 3.0).sin()
            profiling.backward_span("bwd", y, [w])
            (g,) = torch.autograd.grad(y.sum(), [w])
    step, phase, bwd = profiling.spans()
    assert (phase.name, phase.parent, phase.start_ns, phase.end_ns) == (
        "phase", step.id, a.ns, b.ns)
    assert bwd.name == "bwd" and bwd.parent == step.id and bwd.root == step.id
    assert step.start_ns <= bwd.start_ns <= bwd.end_ns <= step.end_ns
    assert torch.equal(g, 3.0 * (w * 3.0).cos().detach())
    assert profiling.elapsed_ms(a, b) == (b.ns - a.ns) / 1e6
    assert not profiling._REC.hooks  # removed when the recorder went off


def test_leaving_the_profiler_restores_the_sync_mode_and_the_filters(monkeypatch):
    modes = [0]
    monkeypatch.setattr(profiling, "mark",
                        lambda device=None: profiling.Mark(time.time_ns()))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with cpu_profile():  # the profiler's own first imports
        pass
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        filters, show = list(warnings.filters), warnings.showwarning
        with cpu_profile():
            with profiling.span("step"):
                assert profiling.recording() and modes[-1] == "warn"
                warnings.warn(SYNC)
                warnings.warn(SYNC)
                warnings.warn("another warning")
        assert not profiling.recording()
        assert modes == [0, "warn", 0]
        assert warnings.filters == filters and warnings.showwarning is show
    assert [str(w.message) for w in shown] == ["another warning"]
    assert profiling.spans()[0].counters == {"syncs": 2}
    assert profiling.counters() == {"syncs": 2}


def test_filters_added_while_profiling_stay_and_cuda_started_later_is_watched(
        monkeypatch):
    modes, up = [0], [False]
    monkeypatch.setattr(profiling, "mark",
                        lambda device=None: profiling.Mark(time.time_ns()))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: up[0])
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with cpu_profile():
        pass
    with warnings.catch_warnings():
        filters = list(warnings.filters)
        with cpu_profile():
            with profiling.span("before cuda"):
                assert profiling.recording() and modes == [0]
            warnings.filterwarnings("ignore", message="added while profiling")
            mine = warnings.filters[0]
            up[0] = True  # CUDA starts inside the profiled region
            with profiling.span("after cuda"):
                assert modes == [0, "warn"]
            with profiling.span("again"):
                assert modes == [0, "warn"]
        assert not profiling.recording()
        assert modes == [0, "warn", 0]
        assert warnings.filters == [mine] + filters


def test_a_phase_recorded_from_its_marks_takes_no_mark_of_its_own(monkeypatch):
    a = profiling.mark(torch.device("cpu"))
    b = profiling.mark(torch.device("cpu"))
    taken = []
    monkeypatch.setattr(profiling, "mark", lambda device=None: taken.append(1))
    with cpu_profile():
        profiling.add_span("phase", a, b)
    (phase,) = profiling.spans()
    assert taken == [] and (phase.start_ns, phase.end_ns) == (a.ns, b.ns)


def test_trace_records_the_spans_and_switches_the_recorder_off(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.span("traced"):
            torch.ones(4).sum()
        assert profiling._REC.on
    assert not profiling._REC.on
    assert [s.name for s in profiling.spans()] == ["traced"]


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _span(name, id_, parent, root, a, b, ms=None, **counters):
    return profiling.Span(name, id_, parent, root, a, b, ms, counters)


def _run(kernels, units, cell="hac.view"):
    return harness.TracedRun(harness.load_cell(cell), kernels, 1.0, 0.5,
                             units, {})


READERS = {
    # name: (spans, kernels, units, value worked out by hand)
    "grid_bwd_ms.train": (
        [_span("hac.step", 0, None, 0, 0, 100), _span("hac.grid.bwd", 1, 0, 0,
                                                      10, 90, 560.0),
         _span("hac.step", 2, None, 2, 100, 200),
         _span("hac.grid.bwd", 3, 2, 2, 110, 190, 600.0),
         _span("hac.grid.bwd", 4, None, 4, 200, 210, 7.0)], [], 2, 580.0),
    "optim_ms.train": (
        [_span("hac.step", 0, None, 0, 0, 100),
         _span("optim.update", 1, 0, 0, 80, 90, 3.5),
         _span("codec.step", 2, None, 2, 100, 200),
         _span("optim.update", 3, 2, 2, 180, 190, 9.0)], [], 1, 3.5),
    "neural_ms.view": (
        [_span("hac.view", 0, None, 0, 0, 100),
         _span("hac.neural", 1, 0, 0, 10, 40, 30.0),
         _span("hac.step", 2, None, 2, 100, 200),
         _span("hac.neural", 3, 2, 2, 110, 140, 99.0),
         _span("hac.view", 4, None, 4, 200, 300),
         _span("hac.neural", 5, 4, 4, 210, 240, 34.0)], [], 2, 32.0),
    "tile_lists_ms.view": (
        [_span("hac.view", 0, None, 0, 0, 100),
         _span("raster.tile_lists", 1, 0, 0, 50, 60, 12.5)], [], 1, 12.5),
    # kernels 0-10, 15-20, 18-30, 60-70: gaps 10-15 and 30-60; frame
    # conversions 12-40 and 55-65 overlap them by 3 + 10 + 5 ns
    "host_idle_ms.view": (
        [_span("gui.frame_bytes", 0, None, 0, 12, 40),
         _span("gui.frame_bytes", 1, None, 1, 55, 65),
         _span("hac.view", 2, None, 2, 0, 12)],
        [("k", 0, 10), ("k", 15, 20), ("k", 18, 30), ("k", 60, 70)], 2,
        18 / 1e6 / 2),
    # the same gaps; merge 5-12 and pyramid 11-14 join into 5-14 (4 ns of
    # the first gap), write 31-33 (2), parse 40-45 (5), split 58-61 (2);
    # codec.geometry is no host phase
    "host_idle_ms.code": (
        [_span("codec.encode", 0, None, 0, 0, 35),
         _span("codec.merge", 1, 0, 0, 5, 12),
         _span("codec.pyramid", 2, 0, 0, 11, 14),
         _span("codec.geometry", 3, 0, 0, 30, 60),
         _span("codec.write", 4, 0, 0, 31, 33),
         _span("codec.decode", 5, None, 5, 35, 70),
         _span("codec.parse", 6, 5, 5, 40, 45),
         _span("codec.split", 7, 5, 5, 58, 61)],
        [("k", 0, 10), ("k", 15, 20), ("k", 18, 30), ("k", 60, 70)], 1,
        13 / 1e6),
    "syncs_per_trip.code": (
        [_span("codec.encode", 0, None, 0, 0, 10, syncs=3),
         _span("codec.geometry", 1, 0, 0, 1, 2, syncs=2),
         _span("rans.encode", 2, 0, 0, 3, 4),
         _span("codec.decode", 3, None, 3, 10, 20, syncs=4),
         _span("codec.split", 4, 3, 3, 15, 20, syncs=1),
         _span("codec.step", 5, None, 5, 20, 30, syncs=50)], [], 2, 5.0),
    "syncs_per_step.ctrain": (
        [_span("codec.step", 0, None, 0, 0, 10, syncs=1),
         _span("codec.level.fwd", 1, 0, 0, 1, 2, syncs=2),
         _span("optim.update", 2, 0, 0, 8, 9),
         _span("codec.step", 3, None, 3, 10, 20, syncs=1),
         _span("codec.encode", 4, None, 4, 20, 30, syncs=9)], [], 2, 2.0),
}
ABSENT = {"grid_bwd_ms.train": "hac.grid.bwd", "optim_ms.train": "optim.update",
          "neural_ms.view": "hac.neural", "tile_lists_ms.view": "raster.tile_lists",
          "host_idle_ms.view": "gui.frame_bytes", "host_idle_ms.code": None,
          "syncs_per_trip.code": None, "syncs_per_step.ctrain": None}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_the_number_worked_out_by_hand(name, monkeypatch):
    spans, kernels, units, want = READERS[name]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    got = harness.metric_reader(name).read(_run(kernels, units))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_none_without_its_span(name, monkeypatch):
    spans, kernels, units, _ = READERS[name]
    gone = ABSENT[name]
    kept = ([s for s in spans if s.name != gone] if gone else
            [s for s in spans if s.name.startswith("hac.")])
    reader = harness.metric_reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: kept)
    assert reader.read(_run(kernels, units)) is None
    # a program without the recorder: nothing to read, nothing raised
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(_run(kernels, units)) is None


# readers listed for more than one cell: both training cells run GroupAdam
# under hac.step
SHARED_READERS = {"optim_ms.train": ["hac.train_rd", "cat3dgs.train_rd"]}


def test_the_readers_are_in_the_benchmark():
    per_layer = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in READERS:
        assert per_layer[name]["source"] == "program_span"
        if name in SHARED_READERS:
            assert per_layer[name]["workloads"] == SHARED_READERS[name]
        else:
            assert len(per_layer[name]["workloads"]) == 1


# ---------------------------------------------------------------------------
# the program's steps, traced and untraced
# ---------------------------------------------------------------------------

def _two_sessions(cell_name, monkeypatch):
    torch.set_num_threads(2)
    tiny.patch_sizes(monkeypatch)
    spec = tiny.cell(cell_name)
    drv = harness.driver(spec.driver)
    return [drv.setup(spec, tiny.SEED, "cpu") for _ in range(2)]


def _same_leaves(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_a_hac_step_is_the_same_traced(monkeypatch):
    plain, traced = _two_sessions("hac.train_rd", monkeypatch)
    for _ in range(2):
        plain._step()
        with cpu_profile():
            traced._step()
    leaves = traced.hac_train.param_leaves
    _same_leaves(leaves(plain.params), leaves(traced.params))
    _same_leaves(plain.opt_state["mu"], traced.opt_state["mu"])
    _same_leaves(plain.stats, traced.stats)
    got = profiling.spans()
    names = {s.id: s.name for s in got}
    steps = [s for s in got if s.name == "hac.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for step in steps:
        under = {s.name for s in got if s.root == step.id and s is not step}
        assert {"hac.prefilter", "hac.neural", "raster.project",
                "raster.tile_lists", "raster.blend", "hac.objective",
                "hac.backward", "hac.grid.bwd", "optim.update",
                "hac.stats"} <= under
    grid = [s for s in got if s.name == "hac.grid.bwd"]
    assert len(grid) == 2
    assert all(names[s.parent] == "hac.backward" and s.end_ns is not None
               for s in grid)


def test_a_codec_step_is_the_same_traced(monkeypatch):
    plain, traced = _two_sessions("gauspcgc.train", monkeypatch)
    idx = plain._step()[0]
    traced.order = list(plain.order) + [idx]
    with cpu_profile():
        traced._step()
    _same_leaves(dict(plain.net.named_parameters()),
                 dict(traced.net.named_parameters()))
    _same_leaves(plain.opt_state["nu"], traced.opt_state["nu"])
    got = profiling.spans()
    assert got[0].name == "codec.step" and got[0].parent is None
    names = [s.name for s in got[1:]]
    levels = len(traced.prepared[idx][0])
    assert names.count("codec.level.fwd") == names.count("codec.level.bwd") == levels
    assert names[-1] == "optim.update"


def test_a_round_trip_records_the_codec_phases(monkeypatch):
    torch.set_num_threads(2)
    tiny.patch_sizes(monkeypatch)
    spec = tiny.cell("gauspcgc.code_batch8")
    session = harness.driver(spec.driver).setup(spec, tiny.SEED, "cpu")
    with cpu_profile():
        session._round_trip()
    got = profiling.spans()
    roots = [s.name for s in got if s.parent is None]
    assert roots == ["codec.encode", "codec.decode"]
    by_root = {r: {s.name for s in got if got[s.root].name == r} for r in roots}
    assert {"codec.merge", "codec.pyramid", "codec.write", "codec.geometry",
            "codec.context", "codec.cdf", "codec.rans",
            "rans.encode"} <= by_root["codec.encode"]
    assert {"codec.parse", "codec.split", "codec.geometry", "codec.context",
            "codec.cdf_and_rans", "rans.decode"} <= by_root["codec.decode"]
    n_enc = sum(s.name == "rans.encode" for s in got)
    assert n_enc == sum(s.name == "rans.decode" for s in got) > 0
    assert n_enc == 4 * sum(s.name == "codec.rans" for s in got)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the profiler's device clock")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_on_the_card_shares_the_profilers_clock(card):
    """The span's host interval holds its op's host event, and the span
    begins before the op's kernel does, to within 50 us of the two clocks'
    disagreement; its events bracket the kernel on the device."""
    x = torch.empty(1 << 22, device=card)
    x.fill_(0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x.add_(1.0)  # the session's first op pays its set-up
        with profiling.span("fill"):
            x.fill_(1.0)
        torch.cuda.synchronize()
    dev, host = harness.device_events(prof)
    (s,) = profiling.spans()
    (fill,) = [h for h in host if h[0] == "aten::fill_"]
    kernel = [d for d in dev if harness._is_kernel(d[0])][-1]
    assert s.start_ns <= fill[1] <= fill[2] <= s.end_ns
    assert s.start_ns - 50_000 <= kernel[1]
    assert (kernel[2] - kernel[1]) / 1e6 <= s.device_ms < 50.0
