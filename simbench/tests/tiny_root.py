"""A checkout with the benchmark's cells cut to a size the CPU runs in
seconds: each configuration's file with fewer nodes and rows, under the
same traffic mixes and metric readers."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from simbench import cells

ROOT = cells.ROOT
TINY = {
    "north_star_10k": dict(num_nodes=64, num_rows=32, write_rate=0.03125),
    "catchup_16k": dict(num_nodes=128, num_rows=64, sync_hot_actors=64),
}


def make_tiny_root(path: Path) -> Path:
    """``path`` laid out as a checkout whose cells are the benchmark's at
    ``TINY`` sizes; returns ``path``."""
    shutil.copytree(ROOT / "simbench", path / "simbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = cells.load_benchmark()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["sim"].update(TINY[c["name"]])
        (path / c["file"]).write_text(json.dumps(cfg))
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path
