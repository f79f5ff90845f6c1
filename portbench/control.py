"""Run a cell with its control in the program's place.

    python3 portbench/control.py --workload <cell> --seed <n> --seconds <s>

The control is the cell's plain reference computed one step below what the
configuration states (``install_control`` in the cell's ``kinds/`` module):
float32 with TF32 products for the capacity cells, the least-congested
choice on loads one step older for the simulator.  The run is otherwise the
benchmark's own, check included; its compared numbers must come out over
their limits.  The benchmark's runs never run it.
"""

from __future__ import annotations

import sys

from run import main

if __name__ == "__main__":
    sys.exit(main(control=True))
