"""The benchmark harness's CPU tests (``bench/tests``), collected with the
port's tests.

Each test sees only the banned modules (JAX and the JAX package,
``bench.harness.BANNED``) that it loads itself: those that other test
files of the same session loaded are hidden from ``sys.modules`` for the
test and put back after it, so a banned module the harness loads still
shows in ``test_banned_modules_compare_whole_top_level_names`` and
``test_result_line_shape``.
"""
import sys

import pytest

pytest.importorskip("torch")

from bench import harness  # noqa: E402
from bench.tests.test_bench_discovery import *  # noqa: E402,F401,F403
from bench.tests.test_bench_faults import *  # noqa: E402,F401,F403
from bench.tests.test_bench_metrics import *  # noqa: E402,F401,F403
from bench.tests.test_bench_runs import *  # noqa: E402,F401,F403


@pytest.fixture(autouse=True)
def _hermetic_modules(monkeypatch):
    for name in harness.banned_modules():
        monkeypatch.delitem(sys.modules, name)
