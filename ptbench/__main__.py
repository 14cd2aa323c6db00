"""python3 -m ptbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import time

START = time.perf_counter()

import sys  # noqa: E402

from ptbench.run import main  # noqa: E402

sys.exit(main(start=START))
