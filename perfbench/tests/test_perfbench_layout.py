"""BENCHMARK.json against the benchmark's files and the contract's shape,
and new cells found by name from files alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_the_contract_keys_and_names():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[k]}) == len(SPEC[k])
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in SPEC[k]]
    assert len(set(metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer")
               for m in SPEC[k])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        cell = harness.Cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = cell.per_layer()
        assert layers
        assert all(m["moves"] in e2e for m in layers)
        assert cell.limits


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_reader_declares_what_benchmark_json_says(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    mod = harness.reader(metric)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])


def test_roofline_and_mfu_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"
    assert any("mfu" in m["name"].split(".")[0].split("_")
               for m in SPEC["per_layer"])


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a limit file and a per-layer metric
    added as files plus a workloads entry are found with no edit."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((ROOT / SPEC["configs"][0]["file"]).read_text())
    cfg["name"] = "ngp-new"
    (root / "perfbench" / "configs" / "ngp-new.json").write_text(
        json.dumps(cfg))
    (root / "perfbench" / "traffic" / "mix_new.json").write_text(
        json.dumps({"kind": "train", "warm_blocks": 1, "rate_blocks": 1,
                    "trace_blocks": 1, "threads_per_rank": 1}))
    (root / "perfbench" / "limits" / "cell-new.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.5}}))
    (root / "perfbench" / "metrics" / "new_metric.train.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nSOURCE = "device_trace"\n'
        'MOVES = "train_rays_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx["units"] * 2.0\n')
    spec["configs"].append(dict(spec["configs"][0], name="ngp-new",
                                file="perfbench/configs/ngp-new.json"))
    spec["workloads"].append({"name": "cell-new", "config": "ngp-new",
                              "traffic": "mix_new", "chips": 1,
                              "why": "a new cell"})
    spec["end_to_end"][0]["workloads"].append("cell-new")
    spec["per_layer"].append({"name": "new_metric.train", "unit": "%",
                              "better": "lower", "source": "device_trace",
                              "layer": "device",
                              "moves": "train_rays_per_s",
                              "workloads": ["cell-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.Cell("cell-new", root)
    assert cell.config["name"] == "ngp-new"
    assert cell.traffic["warm_blocks"] == 1
    assert cell.limits == {"loss_gap": 0.5}
    assert [m["name"] for m in cell.per_layer()] == ["new_metric.train"]
    got = harness.read_per_layer(cell, {"units": 3})
    assert got == {"new_metric.train": {"value": 6.0, "unit": "%"}}


def test_a_new_kind_of_traffic_is_found_by_name(tmp_path):
    """A traffic kind that no generator has yet is a file of its own,
    `perfbench/kinds/<kind>.py`, which a run loads by the mix's `kind`."""
    import torch

    from perfbench import loops

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "perfbench" / "kinds" / "replay.py").write_text(
        "def measure(run):\n    return 'replayed ' + run.cell.name\n")
    (root / "perfbench" / "traffic" / "mix_replay.json").write_text(
        json.dumps({"kind": "replay"}))
    (root / "perfbench" / "limits" / "cell-replay.json").write_text(
        json.dumps({"limits": {}}))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "cell-replay",
                              "config": SPEC["configs"][0]["name"],
                              "traffic": "mix_replay", "chips": 1,
                              "why": "a new kind"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    run = loops.Run(harness.Cell("cell-replay", root), 1, 1.0, False, 0, 1,
                    torch.device("cpu"), 0.0)
    assert loops.main_rank(run) == "replayed cell-replay"


def test_an_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.Cell("no-such-cell")
