#!/usr/bin/env python3
"""``chip_smoke.py``'s whole run with every top-level function of it timed:
inclusive seconds and calls of each, printed as ``TIMING`` lines at the
end and written to ``chiprun_out/timing.json``.  It finds the
timing-only work worth cutting when a new phase must fit the run's time
limit.

    python3 chip_smoke_timing.py       # on one card; exits as chip_smoke
"""
import functools
import json
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

TOTALS = {}


def timed(name, fn):
    @functools.wraps(fn)
    def inner(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            tot = TOTALS.setdefault(name, [0.0, 0])
            tot[0] += time.perf_counter() - t
            tot[1] += 1
    return inner


def main() -> int:
    for name, obj in list(vars(CS).items()):
        if (isinstance(obj, types.FunctionType)
                and obj.__module__ == CS.__name__
                and name not in ("main", "parse_args", "fail")):
            setattr(CS, name, timed(name, obj))
    t0 = time.perf_counter()
    try:
        return CS.main([])
    finally:
        rows = sorted(TOTALS.items(), key=lambda kv: -kv[1][0])
        os.makedirs(ROOT / "chiprun_out", exist_ok=True)
        with open(ROOT / "chiprun_out" / "timing.json", "w") as f:
            json.dump({"total_s": time.perf_counter() - t0,
                       "functions": dict(rows)}, f, indent=1)
        print("TIMING inclusive seconds, calls:")
        for name, (sec, n) in rows:
            print(f"TIMING {sec:9.1f} {n:6d} {name}")


if __name__ == "__main__":
    sys.exit(main())
