"""What ``BENCHMARK.json`` names, found by name in files of their own.

A cell ``<config>.<traffic>`` resolves to its configuration file (the
``file`` of its ``configs`` entry), its traffic mix
(``simbench/traffic/<traffic>.json``), the end-to-end metrics it
reports (``simbench/e2e/<name>.py``) and the per-layer metrics it
reports (``simbench/metrics/<name>.py``). A metric named
``<base>.<group>`` is one quantity split by the cells that report it: an
end-to-end metric, so that each group keeps a bound of its own, and a
per-layer one, so that it ``moves`` the end-to-end metric its cells
report; it reads with ``<base>.py`` unless it has a file of its own. A metric applies to the cells its
``workloads`` key lists; a per-layer metric without one applies to every
cell that reports the end-to-end metric it ``moves``. Adding a
configuration, a mix or a metric is adding its file and its entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic mix file
    end_to_end: list  # [(entry, module)]
    per_layer: list  # [(entry, module)]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _module(root: Path, kind: str, name: str):
    """The reader file ``simbench/<kind>/<name>.py`` (or its base's) as a
    module."""
    path = root / "simbench" / kind / f"{name}.py"
    if not path.is_file():
        path = root / "simbench" / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"simbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str, e2e: set | None = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e is None or entry["moves"] in e2e


def resolve_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name``, with everything it reads loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "simbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [(m, _module(root, "e2e", m["name"])) for m in bench["end_to_end"]
           if _applies(m, name)]
    names = {m["name"] for m, _ in e2e}
    layer = [(m, _module(root, "metrics", m["name"])) for m in bench["per_layer"]
             if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)
