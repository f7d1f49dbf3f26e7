"""``python -m corro_sim_torch`` — the port's command line
(:mod:`corro_sim_torch.cli`, the same entry as the corro-sim-torch
script)."""

import sys

from corro_sim_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
