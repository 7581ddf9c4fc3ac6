"""The benchmark's files: every cell, configuration, driver and per-layer
metric resolves by name, BENCHMARK.json keeps to its contract's shapes, and
a new cell or metric takes new files only."""

import json
import re
import shutil

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    spec = harness.load_cell(cell)
    assert spec.chips == 1
    assert callable(harness.driver(spec.driver).setup)
    reported = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.per_layer:
        assert m["moves"] in reported, (m["name"], cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric).read)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file(conf):
    assert conf["file"].startswith("portbench/configs/")
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert sorted(conf["reduced"]) == sorted(data["reduced"])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
        names.append(m["name"])
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
            + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                assert "\t" not in entry[key]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """A cell and a per-layer metric added as files beside copies of the
    benchmark's own resolve with no code edited."""
    base = tmp_path / "pb"
    for kind in ("workloads", "layer_metrics", "drivers"):
        shutil.copytree(harness.HERE / kind, base / kind)
    (base / "workloads" / "hac.view_extra.json").write_text(json.dumps({
        "config": "hac", "driver": "hac_view", "traffic": {"n_novel": 5},
        "limits": {"frame_max_gap": 1e-3}, "why": "a test's extra cell"}))
    (base / "layer_metrics" / "views_per_s.extra.py").write_text(
        "def read(run):\n    return run.units / run.window_s\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "hac.view_extra", "config": "hac",
                               "traffic": "view_extra", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "views_per_s.extra", "unit": "views/s", "better": "higher",
        "source": "host_clock", "layer": "view", "moves": "view_ms",
        "workloads": ["hac.view_extra"]})
    for m in bench["end_to_end"]:
        if m["name"] == "view_ms":
            m["workloads"].append("hac.view_extra")
    spec = harness.load_cell("hac.view_extra", bench, base=base)
    assert spec.traffic == {"n_novel": 5} and spec.driver == "hac_view"
    assert spec.limits == {"frame_max_gap": 1e-3}
    assert harness.load_cell("hac.view").limits == {}
    assert [m["name"] for m in spec.per_layer] == ["views_per_s.extra"]
    assert callable(harness.driver(spec.driver, base).setup)
    run = harness.TracedRun(spec, [], 2.0, 1.0, 10, {})
    assert harness.metric_reader("views_per_s.extra", base).read(run) == 5.0
