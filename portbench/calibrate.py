"""Readings that set a cell's limits: the system's numbers over many seeds
and the control's, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 2] [--detail FILE]

Per seed it makes one run of the cell as ``run.py`` does (``--seconds``
of window: the eval and stream checks judge the window's answers,
training its checked first steps) and prints one JSON line:
``{"kind": "program" | "control", "seed", "numbers"}``. The control is
the reference computed one precision below the configuration's (float8:
``reference/model.py``) judged in the system's place. ``--detail``
appends each run's check detail (training: every leaf's gap) to FILE.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


def readings(workload: str, seed: int, kind: str, seconds: float,
             device=None, overrides=None, keep=None):
    """The numbers of one seed: the system's (``kind="program"``) or the
    control's (``kind="control"``)."""
    result = run.execute(workload, seed, seconds, False, device=device,
                         overrides=overrides, control=kind == "control",
                         keep=keep, t0=time.perf_counter(),
                         log=lambda msg: print(msg, file=sys.stderr))
    return {k: c["value"] for k, c in result["checks"].items()}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--detail", default="")
    a = p.parse_args(argv)

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    jobs = [("program", s) for s in ints(a.seeds)]
    jobs += [("control", s) for s in ints(a.control_seeds)]
    for kind, seed in jobs:
        t0 = time.perf_counter()
        keep = {}
        numbers = readings(a.workload, seed, kind, a.seconds, keep=keep)
        line = {"workload": a.workload, "kind": kind, "seed": seed}
        print(json.dumps(line | {"numbers": numbers,
                                 "seconds": time.perf_counter() - t0}),
              flush=True)
        if a.detail and keep.get("detail") is not None:
            with open(a.detail, "a") as f:
                f.write(json.dumps(line | {"detail": keep["detail"]}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
