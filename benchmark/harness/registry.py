"""Find a cell's pieces by name: everything that belongs to one
configuration, one traffic mix or one metric sits in files of its own,
which the harness finds from `BENCHMARK.json` and never lists in code.

Under the benchmark's folder (`benchmark/` at the root of the checkout):

- `configs/<config>.json`: the configuration's sizes and parameters; its
  `programme` key names the adapter `programmes/<programme>.py` (the calls
  into the program) and the counts `counts/<programme>.py` (the problem's
  work);
- `reference/<config>.py`: the configuration's plain reference;
- `traffic/<traffic>.json`: the mix's parameters; its `kind` names the
  driver `drivers/<kind>.py`;
- `limits/<cell>.json`: the cell's compared numbers and their limits;
- `metrics/<metric>.py`: one reader for each metric of `BENCHMARK.json`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = "benchmark"


def load_module(path, prefix):
    """The Python file at `path`, loaded under a name of its own."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    name = f"bench_{prefix}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return json.loads(path.read_text())


class Registry:
    """The benchmark of the checkout at `root`."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR
        self.spec = _json(self.root / "BENCHMARK.json")
        self._cells = {w["name"]: w for w in self.spec["workloads"]}

    def cell(self, name):
        try:
            return self._cells[name]
        except KeyError:
            raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(self._cells)}") from None

    def config(self, name):
        return _json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name):
        return _json(self.dir / "traffic" / f"{name}.json")

    def limits(self, cell):
        return _json(self.dir / "limits" / f"{cell}.json")

    def programme(self, name):
        return load_module(self.dir / "programmes" / f"{name}.py", "programme")

    def counts(self, name):
        return load_module(self.dir / "counts" / f"{name}.py", "counts")

    def reference(self, config):
        return load_module(self.dir / "reference" / f"{config}.py", "reference")

    def driver(self, kind):
        return load_module(self.dir / "drivers" / f"{kind}.py", "driver")

    def reader(self, metric):
        return load_module(self.dir / "metrics" / f"{metric}.py", "metric")

    def metrics(self, cell, traced):
        """The metrics a run of `cell` reports: the end-to-end ones without
        tracing, the per-layer ones with it.  A metric with a `workloads`
        key is the listed cells'; one without it is every cell's that
        reports the end-to-end metric it moves."""
        e2e = [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
