"""A cell of BENCHMARK.json and the files it names: its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`), its
correctness limits (`limits/<cell>.json`) and the metrics it reports."""

from __future__ import annotations

import copy
import json
import os
from typing import NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: {number: limit}
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: str  # the checkout


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load(root: str, workload: str, overrides: Optional[dict] = None) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json.  `overrides`
    ({"config": {...}, "traffic": {...}}) is merged into its files (the
    tests' small sizes)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        limits = json.load(f)
    overrides = overrides or {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(
        workload, w["chips"], _merge(config, overrides.get("config")),
        _merge(traffic, overrides.get("traffic")), limits, e2e, per_layer, root,
    )


def write_ini(path: str, sections: dict) -> str:
    with open(path, "w") as f:
        for section, keys in sections.items():
            f.write(f"[{section}]\n")
            for k, v in keys.items():
                f.write(f"{k}={v}\n")
    return path
