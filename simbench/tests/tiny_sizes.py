"""The tiny sizes of the configurations that came after
``tiny_root.TINY``, so that ``make_tiny_root`` cuts every configuration
the benchmark has. Importing this module adds them; the harness's tests
import it through their ``conftest.py``."""

from __future__ import annotations

from simbench.tests.tiny_root import TINY

ADDED = {
    "churn_10k": dict(num_nodes=48, num_rows=16),
}

for _name, _sizes in ADDED.items():
    TINY.setdefault(_name, _sizes)
