"""What the benchmark holds, found by name.

`BENCHMARK.json` at the root of the checkout lists the configurations, the
cells and the metrics. Everything that belongs to one of them is a file of
its own under `gpubench/`, so that a new cell, traffic mix or metric is a
new file and an edit of nothing that exists:

  configs/<config>.json          a configuration: sizes, recipe, source
  traffic/<traffic>.json         a traffic mix: its `kind` and parameters
  traffic/<kind>.py              the load of every mix of that kind
  limits/<cell>.json             the limit of each number `correct` compares
  layer_metrics/<metric>.py      the reader of a per-layer metric, or
  layer_metrics/<prefix>.py      the reader of every metric <prefix>.<suffix>
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
# the configuration file's sections that the program's Config reads
CONFIG_SECTIONS = ("DATASET", "MODEL", "TRAINING", "TEST", "SETUP")


class Invalid(ValueError):
    pass


def _line(text, what):
    if not isinstance(text, str) or not 1 <= len(text) <= 200 \
            or "\n" in text or "\t" in text:
        raise Invalid(f"{what}: 1 to 200 characters on one line, no tab")


def _name(text, what):
    if not isinstance(text, str) or not NAME.match(text):
        raise Invalid(f"{what} {text!r} is not a valid name")


def _keys(entry, required, what, optional=()):
    keys = set(entry)
    if not required <= keys or not keys <= required | set(optional):
        raise Invalid(f"{what}: keys {sorted(keys)}, expected "
                      f"{sorted(required)} (optional {sorted(optional)})")


class Benchmark:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / "gpubench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    # ------------------------------------------------------------ lookup

    def _by_name(self, key, name):
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._by_name("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._by_name("configs", name)
                           ["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def traffic_module(self, kind: str):
        return _load(self.dir / "traffic" / f"{kind}.py",
                     f"gpubench.traffic.{kind}")

    def reader_path(self, metric: str) -> Path:
        whole = self.dir / "layer_metrics" / f"{metric}.py"
        if whole.exists():
            return whole
        return self.dir / "layer_metrics" / f"{metric.split('.')[0]}.py"

    def reader(self, metric: str):
        path = self.reader_path(metric)
        return _load(path, f"gpubench.layer_metrics.{path.stem}").read

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics read in `cell`: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in reported)]

    # ------------------------------------------------------------ checks

    def validate(self):
        """Raise Invalid unless BENCHMARK.json keeps its rules and every
        file it implies exists."""
        s = self.spec
        if set(s) != TOP_KEYS:
            raise Invalid(f"BENCHMARK.json keys {sorted(s)}")
        if not (isinstance(s["run_seconds"], int)
                and 1 <= s["run_seconds"] <= 51):
            raise Invalid(f"run_seconds {s['run_seconds']}")
        if not 1 <= len(s["command"]) <= 32 or not 1 <= len(s["paths"]) <= 16:
            raise Invalid("command or paths")
        for word in s["command"]:
            _line(word, "command word")
        names = set()
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            for entry in s[key]:
                _name(entry.get("name"), key)
                if entry["name"] in names:
                    raise Invalid(f"{entry['name']!r} is named twice")
                names.add(entry["name"])
        configs = {c["name"] for c in s["configs"]}
        for c in s["configs"]:
            _keys(c, CONFIG_KEYS, f"config {c['name']}")
            _line(c["source"], "source")
            _line(c["why"], "why")
            if len(c["reduced"]) > 16:
                raise Invalid("reduced has more than 16 keys")
            for key in c["reduced"]:
                _name(key, "reduced key")
            if not (self.root / c["file"]).is_file():
                raise Invalid(f"config file {c['file']} is missing")
        cells = {w["name"] for w in s["workloads"]}
        pairs = set()
        for w in s["workloads"]:
            _keys(w, CELL_KEYS, f"workload {w['name']}")
            _name(w["traffic"], "traffic")
            _line(w["why"], "why")
            if w["config"] not in configs or w["chips"] not in (1, 4):
                raise Invalid(f"workload {w['name']}: config or chips")
            if (w["config"], w["traffic"]) in pairs:
                raise Invalid(f"workload {w['name']}: pair appears twice")
            pairs.add((w["config"], w["traffic"]))
            traffic = self.traffic(w["traffic"])
            if not (self.dir / "traffic" / f"{traffic['kind']}.py").is_file():
                raise Invalid(f"traffic kind {traffic['kind']} has no module")
            if not (self.dir / "limits" / f"{w['name']}.json").is_file():
                raise Invalid(f"workload {w['name']} has no limits file")
        used = {w["config"] for w in s["workloads"]}
        if used != configs:
            raise Invalid(f"configs used by no cell: {configs - used}")
        e2e = {}
        for m in s["end_to_end"]:
            _keys(m, E2E_KEYS, f"metric {m['name']}", ("workloads",))
            if m["source"] not in SOURCES_E2E:
                raise Invalid(f"metric {m['name']}: source {m['source']}")
            if not 0 < m["bound"] <= 0.25:
                raise Invalid(f"metric {m['name']}: bound {m['bound']}")
            e2e[m["name"]] = m
        for m in s["per_layer"]:
            _keys(m, LAYER_KEYS, f"metric {m['name']}", ("workloads",))
            _line(m["layer"], "layer")
            if m["source"] not in SOURCES or m["moves"] not in e2e:
                raise Invalid(f"metric {m['name']}: source or moves")
            if not self.reader_path(m["name"]).is_file():
                raise Invalid(f"metric {m['name']} has no reader")
        for m in s["end_to_end"] + s["per_layer"]:
            if not UNIT.match(m["unit"]) or m["better"] not in (
                    "lower", "higher"):
                raise Invalid(f"metric {m['name']}: unit or better")
            if not set(m.get("workloads", [])) <= cells:
                raise Invalid(f"metric {m['name']}: unknown workloads")
        for m in s["per_layer"]:
            for cell in m.get("workloads", []):
                if e2e[m["moves"]] not in self.end_to_end(cell):
                    raise Invalid(f"metric {m['name']}: {cell} does not "
                                  f"report {m['moves']}")
        for cell in cells:
            reported = self.end_to_end(cell)
            if "setup_s" not in {m["name"] for m in reported} \
                    or len(reported) < 2 or not self.per_layer(cell):
                raise Invalid(f"workload {cell} reports too few metrics")
        return self


def _load(path: Path, name: str):
    """The module at `path`, imported under `name` (once)."""
    loaded = sys.modules.get(name)
    if loaded is not None and Path(loaded.__file__) == path:
        return loaded
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
