"""Every configuration, traffic mix and per-layer reader is a file found
by the name BENCHMARK.json gives; the benchmark's contract on the file."""

import json
import re

import pytest

from schedbench import cluster
from schedbench.tests.small import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell, centry, cfg, traffic = cluster.cell_files(ROOT, BENCH, w["name"])
        assert cfg["name"] == w["config"] == centry["name"]
        assert traffic["name"] == w["traffic"]
        assert centry["file"].startswith("schedbench/")


def test_every_configuration_pins_the_scheduler():
    for path in (ROOT / "schedbench" / "configs").glob("*.json"):
        cfg = cluster.load_json(path)
        s = cfg["scheduler"]
        assert s["pipeline_depth"] == 2
        assert (s["device_batch_size"], s["wave_m_cand"], s["wave_n_waves"]) == (4096, 512, 16)
        assert s["split_phase_readback"] is True and s["antientropy_period_s"] == 5.0
    for c in BENCH["configs"]:
        cfg = cluster.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        for k in c["reduced"]:
            assert k in cfg


def test_every_metric_has_a_reader():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(cluster.load_named("metrics", m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] == "pods_per_s"


def test_every_traffic_finds_its_loop_and_no_other_loop_runs():
    for w in BENCH["workloads"]:
        _, _, _, traffic = cluster.cell_files(ROOT, BENCH, w["name"])
        assert callable(cluster.load_named("loops", traffic["loop"]).make)
    with pytest.raises(KeyError):
        cluster.load_named("loops", "open")


def test_names_and_keys_keep_to_the_contract():
    assert set(BENCH) == {
        "command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer",
    }
    names = (
        [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    )
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} == {"pods_per_s", "setup_s"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 0
