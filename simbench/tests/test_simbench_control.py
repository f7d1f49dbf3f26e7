"""The control: the reference put in the program's place, with its write
coin compared in bfloat16 instead of the configurations' float32, comes
out as not correct, while the reference itself reads 0 in every number.

North star at its own size (10 000 nodes); catch-up at 4 096 of its
16 384 nodes, which a test run holds. ``python -m simbench.control``
runs the same at each cell's own size.
"""

from __future__ import annotations

import json

import pytest

from simbench import cells, control

SEEDS = (2 ** 31 + 101, 7, 3_000_000_019)


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


@pytest.mark.parametrize("name,nodes", [("north_star_10k.converge", None),
                                        ("catchup_16k.outage30", 4096)])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(bench, name, nodes, seed):
    cell = cells.resolve_cell(bench, name)
    if nodes is not None:
        cell.config["sim"]["num_nodes"] = nodes
    ref = control.readings(cell, seed, "float32")
    assert all(v == 0 for v in ref.values())
    ctl = control.readings(cell, seed, "bfloat16")
    assert ctl["writes_wrong"] > 0 and ctl["heads_wrong"] > 0


def test_control_prints_a_line_per_seed(capsys):
    assert control.main(["--workload", "catchup_16k.no_outage", "--seeds",
                         "5", "6"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [5, 6]
    assert all(x["control"]["writes_wrong"] > 0 for x in lines)
