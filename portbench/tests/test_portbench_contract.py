"""BENCHMARK.json against the benchmark's rules, and the harness finding
every piece of a cell by name."""

import importlib.util
import json
import os
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|head|"
                   r"expansion|experts_per_tok")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_lines(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_metrics_and_cells_fit_together(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(cells) // 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", ()):
            assert m["moves"] in harness.end_to_end_names(bench, w)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        reported = harness.end_to_end_names(bench, w)
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.per_layer_metrics(bench, w)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_piece_is_found_by_name(bench):
    for w in bench["workloads"]:
        wl = harness.cell(w["name"], bench)
        for key in ("params", "limits", "sweep_kernels", "trace_seconds",
                    "replicas_param"):
            assert key in wl
        assert wl["replicas_param"] in wl["params"]
        cfg = harness.load_json("configs", f"{w['config']}.json")
        assert cfg["name"] == w["config"]
        traffic = harness.load_module("traffic", w["traffic"])
        for fn in ("prepare", "job", "end_to_end", "counts", "judge"):
            assert callable(getattr(traffic, fn))
        assert callable(harness.load_module("reference",
                                            cfg["generator"]).build)
    for m in bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))


def test_a_suffixed_metric_is_read_by_its_stem():
    """``<stem>.<suffix>`` with no file of its own is read by
    ``metrics/<stem>.py``: a later cell's ``device_idle_pct.<cell>`` needs
    no new reader; a name with neither file is refused."""
    a = harness.load_module("metrics", "device_idle_pct.sa")
    b = harness.load_module("metrics", "device_idle_pct.some_new_cell")
    assert a.read.__doc__ == b.read.__doc__ and a.__file__ == b.__file__
    assert a.__file__.endswith(os.path.join("metrics", "device_idle_pct.py"))
    with pytest.raises(harness.RunFailed):
        harness.load_module("metrics", "no_such_metric.sa")


def test_a_new_cell_is_picked_up_without_an_edit(tmp_path, bench):
    """A copy of the benchmark with one more cell: a workload file and an
    entry, nothing else touched."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = dict(bench["workloads"][0], name="sk4096.sa-r32")
    grown = dict(bench, workloads=bench["workloads"] + [new])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(grown))
    wl = json.loads((tmp_path / "portbench" / "workloads" /
                     f"{bench['workloads'][0]['name']}.json").read_text())
    wl["params"]["n_replicas"] = 32
    (tmp_path / "portbench" / "workloads" / "sk4096.sa-r32.json").write_text(
        json.dumps(wl))
    spec = importlib.util.spec_from_file_location(
        "portbench_copy_harness", tmp_path / "portbench" / "harness.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    got = copy.cell("sk4096.sa-r32", copy.benchmark())
    assert got["params"]["n_replicas"] == 32
    assert got["traffic"] == new["traffic"]
    assert copy.per_layer_metrics(copy.benchmark(), "sk4096.sa-r32") == []
    with pytest.raises(copy.RunFailed):
        copy.cell("no.such.cell", copy.benchmark())
