"""One run of a cell at the small size on the CPU, printed as
``bench/run.py`` prints it, with the top-level names of every module the
process loaded as the first line of standard error:

    python3 bench/tests/cpu_run.py <workload> <trace 0|1>
"""

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parents[1] / "src")]

import small  # noqa: E402
from run import emit  # noqa: E402

if __name__ == "__main__":
    res, notes = small.run(sys.argv[1], trace=bool(int(sys.argv[2])))
    print(json.dumps({"modules": sorted({n.split(".")[0]
                                         for n in sys.modules})}),
          file=sys.stderr)
    emit(res, notes)
