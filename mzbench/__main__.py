"""``python -m mzbench --workload CELL --seed N --seconds S --trace 0|1``"""

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402

from mzbench.harness import main  # noqa: E402

sys.exit(main(t_process=T_PROCESS))
