"""What the benchmark reads from its own files, by the names in
BENCHMARK.json: a cell, its configuration (the cell's `config` entry names
the file), its traffic mix (`perfbench/traffic/<traffic>.json`), its
correctness limits (`perfbench/limits/<cell>.json`) and the reader of each
per-layer metric (`perfbench/metrics/<metric>.py`, loaded by path).  A new
configuration, mix, limit file or metric is new files and entries; nothing
here changes for it.  Also the result line and the checks every run makes
before it prints one."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "ngp_pl_tpu")


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.root = root
        self.spec = spec
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads((root / "perfbench" / "traffic"
                                   / f"{self.entry['traffic']}.json")
                                  .read_text())
        path = root / "perfbench" / "limits" / f"{name}.json"
        self.limits = json.loads(path.read_text())["limits"]
        self.chips = int(self.entry["chips"])

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def reader(name: str, root: Path = ROOT):
    """The reader module of per-layer metric `name`."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(cell: Cell, ctx: Dict) -> Dict:
    """{name: {"value", "unit"}} of every per-layer metric whose reader
    found something to read."""
    out = {}
    for m in cell.per_layer():
        value = reader(m["name"], cell.root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def banned_loaded() -> List[str]:
    """Modules in sys.modules whose top-level name is one of BANNED_MODULES,
    names compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in BANNED_MODULES)


def compare(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} of every number compared; a number is
    within its limit when it is at most the limit."""
    missing = set(limits) - set(readings)
    if missing:
        raise RuntimeError(f"no reading for the limits {sorted(missing)}")
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, checks: Dict,
                breakdown: Optional[Dict] = None) -> str:
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)
