"""A closed loop: one call in flight, the next made as the last completes,
until the window's seconds have passed. The call that is running when the
time is up completes and counts; the window ends with it."""
from __future__ import annotations

import time


def window(step, seconds: float, traffic: dict):
    """``step(i)`` makes call i and returns its record. Returns the seconds
    the window held the program's calls and the calls' records, each with
    the call's ``seconds``. The seconds a step spent summarising a result
    for the comparison (its record's ``check_s``) are left out of both, and
    the window runs that much longer."""
    records = []
    paused = 0.0
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        rec = step(len(records))
        now = time.perf_counter()
        check = rec.get("check_s", 0.0)
        paused += check
        rec["seconds"] = now - t - check
        records.append(rec)
        if now - start - paused >= seconds:
            return now - start - paused, records
