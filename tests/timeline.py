"""A pytest plugin that logs when each test ran and on which xdist worker,
and a summary of such a log: the files each worker ran, from when to when.

    PYTEST_TIMELINE=timeline.jsonl PYTHONPATH=tests python -m pytest tests/ \\
        -n 6 --dist loadfile -p timeline
    python tests/timeline.py timeline.jsonl

Each line of the log is one test: ``{"w": worker, "id": node id, "t0": start,
"t1": stop}`` (seconds since the epoch, setup and teardown included). Without
``PYTEST_TIMELINE`` the plugin logs nothing.
"""
import collections
import json
import os
import sys
import time

import pytest


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    t0 = time.time()
    yield
    out = os.environ.get("PYTEST_TIMELINE")
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(dict(w=os.environ.get("PYTEST_XDIST_WORKER", "-"),
                                    id=item.nodeid, t0=t0, t1=time.time())) + "\n")


def summary(path):
    """Print each worker's files in order (start, stop, summed seconds, tests;
    seconds from the first test's start), when each worker ended, and the
    summed seconds of the port's files and of the others."""
    rows = [json.loads(line) for line in open(path)]
    start = min(r["t0"] for r in rows)
    files = collections.defaultdict(lambda: [float("inf"), 0.0, 0.0, "", 0])
    for r in rows:
        f = files[r["id"].split("::")[0]]
        f[0] = min(f[0], r["t0"] - start)
        f[1] = max(f[1], r["t1"] - start)
        f[2] += r["t1"] - r["t0"]
        f[3] = r["w"]
        f[4] += 1
    workers = collections.defaultdict(list)
    for name, (t0, t1, secs, w, n) in files.items():
        workers[w].append((t0, t1, secs, n, name))
    for w in sorted(workers):
        print(f"{w}: ends at {max(t1 for _, t1, *_ in workers[w]):.1f} s")
        for t0, t1, secs, n, name in sorted(workers[w]):
            print(f"  {t0:7.1f} {t1:7.1f} {secs:7.1f} s {n:4d} tests  {name}")
    port = sum(f[2] for name, f in files.items() if "/test_torch_" in name)
    other = sum(f[2] for f in files.values()) - port
    print(f"the port's files {port:.1f} s, the others {other:.1f} s")


if __name__ == "__main__":
    summary(sys.argv[1])
