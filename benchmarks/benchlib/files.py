"""Finding a cell's files by the names in ``BENCHMARK.json``:
``configs/<config>.json`` with ``models/<config>.py`` (how the program
builds that model and composes its batches), ``traffic/<mix>.json``,
``limits/<cell>.json`` (the limits of the numbers compared) and
``metrics/<metric>.py`` (a per-layer reader with ``read(view)``). A later
change adds a configuration, a mix or a metric as new files alone.

Several roots may be searched in order, so that a test can add files from a
temporary directory beside the benchmark's own.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


class Files:
    def __init__(self, bench: dict, roots=(HERE,)):
        self.bench = bench
        self.roots = [Path(r) for r in roots]
        self._modules = {}

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(r) for r in self.roots]}")

    def _json(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def module(self, kind: str, name: str):
        key = (kind, name)
        if key not in self._modules:
            path = self.path(kind, name, ".py")
            mod_name = f"bench_{kind}_" + re.sub(r"\W", "_", name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def model(self, config: str):
        return self.module("models", config)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def end_to_end(self, cell: dict) -> list:
        """The end-to-end metrics that ``cell`` reports."""
        return [m for m in self.bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def readers(self, cell: dict) -> dict:
        """``{metric: (unit, reader module)}`` of the per-layer metrics that
        ``cell`` reports: those that list it, and those without a list whose
        end-to-end metric the cell reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        out = {}
        for m in self.bench["per_layer"]:
            listed = m.get("workloads")
            if (cell["name"] in listed) if listed is not None \
                    else m["moves"] in moved:
                out[m["name"]] = (m["unit"], self.module("metrics",
                                                         m["name"]))
        return out
