#!/usr/bin/env python3
"""Run one cell of the benchmark once (see ``harness/main.py``)::

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
