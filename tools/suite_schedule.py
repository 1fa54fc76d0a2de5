#!/usr/bin/env python3
"""Where a pytest-xdist `--dist loadfile` run of the suite spends its time,
from the run's JUnit XML (`--junitxml=FILE`): each test file's summed test
time (setup, call and teardown, as pytest writes them) and a replay of
xdist's schedule on those times, so a change to how the files are cut can be
judged before a run of the whole suite.

    python3 tools/suite_schedule.py RUN.xml [--workers 6] [--top 25]
                                    [--split FILE:PATTERN ...]

The replay follows xdist's LoadScopeScheduling with its default reordering:
the files are queued by test count, most first (ties in path order), each
worker takes one file and then a second, and a worker takes the next file
whenever two or fewer of its own tests are left.  It holds each test at its
time in RUN.xml and leaves out the workers' start-up and collection, so its
makespan is a lower bound of the run's wall time.  --split FILE:PATTERN moves
the tests of FILE whose names hold PATTERN into a file of their own
(FILE_PATTERN), to replay a split of FILE.
"""

from __future__ import annotations

import argparse
import collections
import sys
import xml.etree.ElementTree as ET


def load(path: str) -> dict:
    """{test file: [(test name, seconds), ...]} in the order the XML lists them."""
    files = collections.OrderedDict()
    for tc in ET.parse(path).iter("testcase"):
        mod = (tc.get("classname") or "?").split(".")
        name = mod[1] if len(mod) > 1 else mod[0]
        files.setdefault(name, []).append((tc.get("name"), float(tc.get("time") or 0.0)))
    return files


def split(files: dict, spec: str) -> dict:
    """files with the tests of spec's FILE whose names hold PATTERN in a file
    of their own."""
    name, pattern = spec.split(":", 1)
    out = collections.OrderedDict(files)
    moved = [t for t in out[name] if pattern in t[0]]
    out[name] = [t for t in out[name] if pattern not in t[0]]
    out[f"{name}_{pattern}"] = moved
    return out


def replay(files: dict, workers: int):
    """(makespan, [(finish time, [files in the order taken]) a worker])."""
    queue = sorted(sorted(files), key=lambda f: -len(files[f]))
    pending = [collections.deque() for _ in range(workers)]
    clock, taken = [0.0] * workers, [[] for _ in range(workers)]

    def take(w):
        if queue:
            f = queue.pop(0)
            pending[w].extend(t for _, t in files[f])
            taken[w].append(f)

    for w in range(workers):
        take(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            take(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]), key=lambda w: clock[w])
        clock[w] += pending[w].popleft()
        if len(pending[w]) <= 2:
            take(w)
    return max(clock), list(zip(clock, taken))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--split", action="append", default=[])
    a = ap.parse_args()
    files = load(a.xml)
    for spec in a.split:
        files = split(files, spec)
    sums = {f: sum(t for _, t in ts) for f, ts in files.items()}
    total = sum(sums.values())
    print(f"{len(files)} files, {sum(map(len, files.values()))} tests, {total:.1f} s of test "
          f"time: {total / a.workers:.1f} s a worker if the {a.workers} balanced")
    for f, s in sorted(sums.items(), key=lambda kv: -kv[1])[:a.top]:
        print(f"{s:8.1f} s {len(files[f]):4d} tests  {f}")
    span, per = replay(files, a.workers)
    print(f"replayed schedule: makespan {span:.1f} s")
    for end, taken in per:
        print(f"  worker ends at {end:7.1f} s: " + ", ".join(f"{f} {sums[f]:.0f}" for f in taken))
    return 0


if __name__ == "__main__":
    sys.exit(main())
