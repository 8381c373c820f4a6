"""Run one benchmark cell once on the card and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(``python3 -m benchmark.run`` works too), from the root of a checkout.
"""

import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark import harness

    harness.prepare_environment()
    sys.exit(harness.main(sys.argv[1:],
                          time.perf_counter() - harness.process_age_s()))
