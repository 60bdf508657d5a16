"""BENCHMARK.json against the benchmark's contract, and every entry
against the files it names."""

import json
import re

import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert bench["paths"] == ["port_bench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its budget at this length
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("port_bench/") and c["name"] in used
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] == []
        assert len(conf["source"]) <= 200 and conf["source"] == c["source"]
        assert conf["codec"]["compute_dtype"] in ("float32", "bfloat16")


def test_workloads_resolve_to_their_files(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        files = harness.cell_files(bench, w)
        for path in files.values():
            assert path.is_file(), path
        lim = harness.load_json(files["limits"])
        assert set(lim) >= {"control_precision", "limits"}
        from port_bench.reference import precision
        assert lim["control_precision"] in precision.PRECISIONS
        driver = harness.load_module(files["driver"])
        assert callable(driver.run)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    per = bench["per_layer"]
    names = list(e2e) + [m["name"] for m in per]
    assert len(set(names)) == len(names)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    cells = [w["name"] for w in bench["workloads"]]
    for w in cells:
        mine = harness.metrics_for(bench, w, "end_to_end")
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layers = harness.metrics_for(bench, w, "per_layer")
        assert layers
        for m in layers:  # each per-layer metric moves an end-to-end metric of its cell
            assert m["moves"] in [e["name"] for e in mine]
    layer_names = {}
    for m in per:  # one layer, one spelling
        layer_names.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layer_names.values())


def test_files_named_from_names():
    for path in harness.BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_traffic_files_are_data():
    for path in (harness.BENCH / "traffic").iterdir():
        assert path.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv"), path
        tr = json.loads(path.read_text())
        assert (harness.BENCH / "drivers" / f"{tr['driver']}.py").is_file()
