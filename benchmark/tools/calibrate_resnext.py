"""``calibrate.py`` for the cells that the ``infer_resnext`` runner runs:
the same readings, with the blobs, the check and the FLOP count pointed at
the ResNeXt reference (``harness/infer_resnext.pointed_at_resnext``), and
the faults planted in the ResNeXt trunk (``tests/faults_resnext.py``)
nameable beside ``tests/faults.py``'s.

    python3 benchmark/tools/calibrate_resnext.py --cell x101_mask.infer_b8 --seeds 6 \
        --control 3 --faults stride_on_1x1,groups_permuted,keep_the_lowest_survivors

On the card only, at the cell's own sizes.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    from benchmark import run
    from benchmark.harness.infer_resnext import pointed_at_resnext
    from benchmark.tests import faults, faults_resnext
    from benchmark.tools import calibrate

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--cell", required=True)
    cell = p.parse_known_args(argv)[0].cell
    faults.FAULTS.update(faults_resnext.FAULTS)
    with pointed_at_resnext(run.load_cell(cell)[3]):
        calibrate.main(argv)


if __name__ == "__main__":
    main()
