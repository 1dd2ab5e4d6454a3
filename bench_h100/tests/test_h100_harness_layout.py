"""BENCHMARK.json against the files the harness finds by name: a
configuration, a traffic mix, a per-layer metric or a cell is added with
new files and entries only."""

import json
import os
import re

from harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return common.benchmark()


def test_every_name_has_its_files():
    b = _bench()
    root = common.ROOT
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert os.path.exists(os.path.join(root, c["file"]))
        cfg = common.config(c["name"])
        assert cfg["name"] == c["name"]
        assert os.path.exists(os.path.join(
            common.BENCH_DIR, "reference", cfg["reference"] + ".py"))
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(common.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
        assert hasattr(common.metric_reader(m["name"]), "read")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        tr = common.traffic(w["traffic"])
        drv = common.driver(tr["kind"])
        assert hasattr(drv, "Driver") and drv.FAULTS
        assert set(common.limits(w["name"])) <= set(drv.NUMBERS)
        assert common.limits(w["name"])
        reported = {n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in b["per_layer"]
                 if w["name"] in m.get("workloads", [])]
        assert layer and all(m["moves"] in reported for m in layer)


def test_limits_files_name_their_readings():
    for w in _bench()["workloads"]:
        path = os.path.join(common.BENCH_DIR, "limits", w["name"] + ".json")
        spec = json.load(open(path))
        for name, entry in spec.items():
            assert isinstance(entry["limit"], (int, float)), name


def test_subseeds_take_any_whole_number():
    big = 2**31 + 977
    assert common.subseed(big, "data") != common.subseed(big + 1, "data")
    assert 0 <= common.subseed(big, "x") < 2**63
    assert common.subseed(-5, "x") == common.subseed(-5, "x")
