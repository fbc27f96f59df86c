"""Cells, configurations and per-layer metrics are found by name, also new
ones dropped into a copy as files; ``BENCHMARK.json`` keeps to the
benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from qkdbench import registry, run
from qkdbench.tests.tiny import DECODE, REPO, SESSION, tiny_copy

BENCH = REPO / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads(BENCH.read_text())


@pytest.mark.parametrize("cell", [SESSION, DECODE])
def test_each_cell_finds_its_files(cell):
    c = registry.cell(BENCH, cell)
    assert c.workload["name"] == cell
    assert c.config["name"] == c.entry["config"]
    assert callable(c.driver().run)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(c.metric_reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        registry.cell(BENCH, "no-such-cell")


def test_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for p in b["paths"]:
        assert (REPO / p).is_dir() and not p.startswith("/") and ".." not in p
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in b["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])


NEW_CONFIG = {"name": "reg2k", "source": "test", "reduced": [],
              "code": {"n": 2048, "dv": 3, "dc": 6, "seed": 7},
              "decoder": {"alg": "layered", "max_iters": 20,
                          "alpha": 0.8125, "batch": 16, "dtype": "float32"}}
NEW_CELL = {"name": "reg2k-b16-bsc4", "config": "reg2k", "driver": "decode",
            "why": "test",
            "traffic": {"qbers": [0.04], "batches_per_qber": 2,
                        "max_inflight": 2, "check_calls_per_qber": 1,
                        "trace_seconds": 0.3}}
NEW_METRIC = '''
def read(record):
    return float(record["calls"])
'''


def test_new_files_alone_add_a_cell(tmp_path, capsys):
    """A configuration, a cell and a per-layer metric added as new files
    (and entries): the harness finds and runs them, and the new metric's
    reader is called."""
    bench, root = tiny_copy(tmp_path)
    (root / "configs" / "reg2k.json").write_text(json.dumps(NEW_CONFIG))
    (root / "workloads" / "reg2k-b16-bsc4.json").write_text(
        json.dumps(NEW_CELL))
    (root / "layer_metrics" / "calls_made.test.py").write_text(NEW_METRIC)
    b = json.loads(bench.read_text())
    b["configs"].append({"name": "reg2k", "source": "test", "reduced": [],
                         "file": "qkdbench/configs/reg2k.json",
                         "why": "test"})
    b["workloads"].append({"name": "reg2k-b16-bsc4", "config": "reg2k",
                           "traffic": "bsc4", "chips": 1, "why": "test"})
    b["end_to_end"][2]["workloads"].append("reg2k-b16-bsc4")
    b["per_layer"].append({"name": "calls_made.test", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "kernels", "moves": "decoded_bits_per_s",
                           "workloads": ["reg2k-b16-bsc4"]})
    bench.write_text(json.dumps(b))
    rc = run.main(["--workload", "reg2k-b16-bsc4", "--seed", "5",
                   "--seconds", "1", "--trace", "1"], bench_path=bench,
                  root=root, require_card=False)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["calls_made.test"]["value"] >= 1
    assert set(res["metrics"]) == {"calls_made.test"}
