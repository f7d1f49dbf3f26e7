"""The control of the judge: the reference put in the program's place,
with its one float stage a step below the precision the configuration
states, must come out as not correct.

    python3 -m simbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed, for each cluster a run with that seed judges, the writes
are drawn twice: in the configuration's float32 (the reference) and with
the write coin's compare in bfloat16 (the control). The outputs a
converged cluster must hold are worked out from each
(``oracle.lww_outputs``) and judged against the float32 writes. Prints
one JSON line per seed: the reference's own numbers (each 0) and the
control's. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from simbench import cells as cells_mod
from simbench import schedule as sched
from simbench.reference import draws, oracle


def readings(cell, seed: int, precision: str) -> dict:
    """The judge's numbers, summed over the clusters a run with ``seed``
    judges, for outputs worked out from writes drawn at ``precision``."""
    sim = cell.config["sim"]
    traffic = cell.traffic
    n = int(sim["num_nodes"])
    args = sched.run_args(traffic)
    wr = int(traffic["write_rounds"])
    alive = sched.alive_rows(traffic, wr, n)
    dims = dict(num_nodes=n, num_rows=int(sim["num_rows"]),
                num_cols=int(sim["num_cols"]))
    total = {k: 0 for k in oracle.CHECKS if k != "rounds_wrong"}
    for i in sched.judged_clusters(seed):
        cs = sched.cluster_seed(seed, i)
        truth = draws.draw_writes(sim, cs, alive, wr, args["chunk"])
        made = draws.draw_writes(sim, cs, alive, wr, args["chunk"],
                                 precision=precision)
        out = oracle.lww_outputs(made, **dims)
        got = oracle.judge(truth, out, alive_end=alive[-1] | True,
                           converge=True, **dims)
        for k, v in got.items():
            total[k] += v
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m simbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    cell = cells_mod.resolve_cell(cells_mod.load_benchmark(), a.workload)
    for seed in a.seeds:
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "reference": readings(cell, seed, "float32"),
                          "control": readings(cell, seed, "bfloat16")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
