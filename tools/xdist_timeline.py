"""When each test file ran, and on which pytest-xdist worker.

As a pytest plugin it appends one line per test start and end to
``$XDIST_TIMELINE_DIR/<worker>.txt`` (wall-clock seconds, the event, the
test id); without that variable it does nothing:

    XDIST_TIMELINE_DIR=out python -m pytest tests/ -p tools.xdist_timeline \
        -p xdist -n 6 --dist loadfile ...

or, leaving a given command line as it is, through the environment:

    XDIST_TIMELINE_DIR=out PYTHONPATH=tools PYTEST_PLUGINS=xdist_timeline \
        python -m pytest tests/ ...

Run as a script on that directory, it prints each file's worker, its
first start and last end in seconds from the run's first test, and the
time between them, longest file first:

    python tools/xdist_timeline.py out
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _log(event: str, nodeid: str) -> None:
    out = os.environ.get("XDIST_TIMELINE_DIR")
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if not out or not worker:   # only the workers run tests under xdist
        return
    with open(Path(out) / f"{worker}.txt", "a") as f:
        f.write(f"{time.time():.3f} {event} {nodeid}\n")


def pytest_runtest_logstart(nodeid, location):
    _log("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _log("end", nodeid)


def summarize(directory) -> list:
    """[(file, worker, start_s, end_s)] longest first; times from the
    first test start of the run."""
    spans = {}
    for path in sorted(Path(directory).glob("*.txt")):
        for line in path.read_text().splitlines():
            t, _event, nodeid = line.split(" ", 2)
            key = (nodeid.split("::")[0], path.stem)
            lo, hi = spans.get(key, (float("inf"), float("-inf")))
            spans[key] = (min(lo, float(t)), max(hi, float(t)))
    t0 = min(lo for lo, _ in spans.values())
    rows = [(f, w, lo - t0, hi - t0) for (f, w), (lo, hi) in spans.items()]
    return sorted(rows, key=lambda r: r[2] - r[3])


def main(argv=None) -> None:
    rows = summarize((argv or sys.argv[1:])[0])
    for f, w, lo, hi in rows:
        print(f"{w:5s} {lo:8.1f} {hi:8.1f} {hi - lo:8.1f}  {f}")
    print(f"last end {max(r[3] for r in rows):.1f} s")


if __name__ == "__main__":
    main()
