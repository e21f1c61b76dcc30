"""Replay a test run's per-test times under pytest-xdist's ``--dist
loadfile`` scheduling, for several orders of the files.

xdist (3.8, ``scheduler/loadscope.py``) hands each worker one file, and
one more whenever ``threshold`` or fewer of its tests are unfinished,
the running one included (2 there), so a file can wait behind another
on a busy worker.  This script takes each test's time from a junit XML, runs that
rule on ``--workers`` workers and prints the run's length (the last
worker's end) for each order of the files.  Times under load depend on
what runs beside them, so compare orders, not absolute seconds.

    python tools/xdist_schedule_sim.py run.xml [--workers 6]
"""
from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def load(path) -> dict:
    """{test file: [seconds of each test, in run order]} from a junit XML."""
    files = collections.OrderedDict()
    for case in ET.parse(path).iter("testcase"):
        name = case.get("classname").split(".")[-1]
        files.setdefault(name, []).append(float(case.get("time")))
    return files


def makespan(order, files, workers: int = 6, threshold: int = 2) -> float:
    """The end of the last worker when the files go out in `order`, a
    worker taking the next file whenever `threshold` or fewer of its
    tests are unfinished."""
    queue = collections.deque(order)
    pending = {w: collections.deque() for w in range(workers)}

    def assign(w):
        if queue:
            pending[w].extend(files[queue.popleft()])

    for w in pending:
        assign(w)
    for w in pending:
        if len(pending[w]) <= threshold:
            assign(w)
    heap = [(0.0, w) for w in pending]
    end = 0.0
    while heap:
        now, w = heapq.heappop(heap)
        if not pending[w]:
            continue
        done = now + pending[w].popleft()     # starts now
        if len(pending[w]) + 1 <= threshold:
            assign(w)
        heapq.heappush(heap, (done, w))
        end = max(end, done)
    return end


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)
    files = load(args.junit)
    by_name = sorted(files)     # pytest's collection order
    port = [f for f in by_name if f.startswith("test_torch_")]
    jax = [f for f in by_name if f not in port]
    orders = {
        "collection (loadscope-reorder off)": by_name,
        "most tests first (xdist's default)": sorted(
            by_name, key=lambda f: -len(files[f])),
        "fewest tests first": sorted(by_name, key=lambda f: len(files[f])),
        "port files first": port + jax,
    }
    print(f"worker seconds {sum(map(sum, files.values())):.1f}, "
          f"longest file {max(map(sum, files.values())):.1f} s")
    for name, order in orders.items():
        print(f"{name}: {makespan(order, files, args.workers):.1f} s")
    # a worker runs a test only once the next is queued (or it is told to
    # stop), so 1 is the least threshold that runs
    print(f"collection, the next file taken with 1 test unfinished: "
          f"{makespan(by_name, files, args.workers, 1):.1f} s")


if __name__ == "__main__":
    main()
