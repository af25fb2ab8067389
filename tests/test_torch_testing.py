"""The port's test harnesses: repro_torch.testing's plan fuzzer and chaos
cases (the distributed cases are in tests/test_torch_dist_cases.py, the
chaos cases' runs against the reference in tests/test_torch_serving.py).

The fuzzer side by side: one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as in
tests/test_torch_dist.py) builds each of ``PLANS`` with
``repro.testing.plan_fuzz`` on 8 host devices and records its op trace,
the canonical key of its optimized plan, ``explain(verify=True)`` and the
fused result; the port builds the same (seed, index) with
``repro_torch.testing.plan_fuzz`` on 8 virtual shards on the CPU. Cost-
sized plans run on analyzed inputs: the port's ``ctx.analyze``; on the
reference ``analyze_table`` of the gathered table put on with
``dataclasses.replace`` (its ``DistContext.analyze`` raises on the
installed jax), as tests/test_torch_plan.py does. Tolerance: none. The op
traces, keys and explain texts must be equal, and the results' rows bit
for bit, shard by shard, in order; the port must also pass its own
``check_frame`` (verifier-clean, fused equal to eager).

Two reference faults the fuzzer finds are repaired in the port (ROADMAP
§3). The reference's optimizer is not idempotent on some plans (seed
20260807 plan 44, seed 3 plan 3): a projection that a consumer narrowed
reaches further down (a window's or a sort's input) only on a second pass,
and its verifier says so. There the port's plan carries that projection
and is clean, and its rows equal the reference's. And the reference's
generator raises on seed 20260807 plan 107 (an aggregation with no
candidate column), where the port's generator skips the aggregation.
"""
import dataclasses
import os
import pickle
import random
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
P = 8
CI_SEED = 20260807
# (seed, plan index): the reference CI leg's seed and another, plain and
# cost-sized plans among them, and the two faults named above
PLANS = [(CI_SEED, i) for i in range(5)] + [(3, i) for i in range(4)] + \
    [(CI_SEED, 44), (CI_SEED, 107)]
NOT_IDEMPOTENT, GENERATOR_RAISES = (CI_SEED, 44), (CI_SEED, 107)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(F, ctx, inputs, seed, i):
    """Plan ``i`` of ``seed`` exactly as ``run_fuzz`` draws it."""
    r = random.Random(f"{seed}:{i}")
    cost_sized = r.random() < 0.5
    return cost_sized, F.random_frame(ctx, inputs[seed][cost_sized], r,
                                      max_ops=6, cost_sized=cost_sized)


def observe(PL, ctx, st) -> dict:
    fr = st.frame
    schemas = [t.schema for t in fr._inputs]
    stats = [t.stats for t in fr._inputs]
    optimized = PL.optimize(fr.logical_plan(), schemas, ctx.num_shards, stats,
                            verify=False)
    out, _ = ctx._run_plan(fr.logical_plan(), fr._inputs, optimize=True)
    if hasattr(out, "to_numpy"):  # the port's (p, C) layout
        cols, rc = out.to_numpy()
    else:
        cols = {k: np.asarray(v) for k, v in out.columns.items()}
        rc = np.asarray(out.row_counts)
    return {"ops": list(st.ops), "key": PL.canonical_key(optimized),
            "explain": fr.explain(verify=True), "rc": np.asarray(rc),
            "cols": cols}


def reference_main(out_path: str) -> None:
    """Build and run ``PLANS`` on the reference (8 host devices)."""
    from repro.core import plan as PL
    from repro.core import stats as RS
    from repro.core.context import DistContext
    from repro.testing import plan_fuzz as F

    ctx = DistContext(axis_name="fuzz")

    def analyze(t):
        st = RS.analyze_table(t.to_table())
        st = dataclasses.replace(
            st, max_shard_rows=float(np.asarray(t.row_counts).max()))
        return dataclasses.replace(t, stats=st)

    inputs = {s: {False: F.make_inputs(ctx, s, analyze=False),
                  True: [analyze(t) for t in
                         F.make_inputs(ctx, s + 1, analyze=False)]}
              for s in sorted({s for s, _ in PLANS})}
    res = {}
    for seed, i in PLANS:
        try:
            cost_sized, st = build(F, ctx, inputs, seed, i)
        except ValueError as e:
            res[(seed, i)] = {"generator_error": repr(e)}
            continue
        res[(seed, i)] = {"cost_sized": cost_sized, **observe(PL, ctx, st)}
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    # the reference's optimizer raises on plan 44 under the gate: its
    # findings are read from explain(verify=True) instead
    env["REPRO_VERIFY_PLANS"] = "0"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, \
        f"reference run failed:\n{proc.stdout}\n{proc.stderr}"
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port():
    from repro_torch.core.context import DistContext
    from repro_torch.testing import plan_fuzz as F

    ctx = DistContext(num_shards=P, device="cpu")
    inputs = {s: {False: F.make_inputs(ctx, s, analyze=False),
                  True: F.make_inputs(ctx, s + 1, analyze=True)}
              for s in sorted({s for s, _ in PLANS})}
    return ctx, inputs


def value_bound(name: str) -> float:
    """The largest |value| column ``name`` can hold, by the generator's own
    tag rules: base columns their tag's bound, sums and running sums
    ``MAX_ROWS`` times their input's, variances its square, counts and
    ranks ``MAX_ROWS``, every other aggregate or window output (mean, min,
    max, first, cummax, running_mean, lag, lead) and a join's ``_r`` copy
    its input's."""
    import re

    from repro_torch.testing import plan_fuzz as F

    base = {**F._FACT_COLS, **F._DIM_COLS}
    if name in base:
        return float(base[name][1])
    if name in ("rank", "dense_rank", "row_number") or name.endswith("_count"):
        return float(F.MAX_ROWS)
    m = re.fullmatch(r"(.+)_(sum|cumsum|var|mean|min|max|first|cummax|"
                     r"running_mean|r|lag\d*|lead\d*)", name)
    assert m, name
    b = value_bound(m.group(1))
    return {"sum": F.MAX_ROWS * b, "cumsum": F.MAX_ROWS * b,
            "var": b * b}.get(m.group(2), b)


def same_shard_rows(got: dict, want: dict) -> None:
    """Every shard's valid rows bit for bit, in order; a variance within
    the rounding of ``mean*mean`` that XLA's fused multiply-add skips in
    the reference's jitted program (ROADMAP §3): at most
    2**-22 * (M**2 + |var|), M the input column's :func:`value_bound`."""
    np.testing.assert_array_equal(got["rc"], want["rc"])
    assert sorted(got["cols"]) == sorted(want["cols"])
    for k, w in want["cols"].items():
        g = got["cols"][k]
        assert g.dtype == w.dtype, k
        g = g.reshape((P, -1) + g.shape[1:])
        w = w.reshape((P, -1) + w.shape[1:])
        for s in range(P):
            a, b = g[s, :want["rc"][s]], w[s, :want["rc"][s]]
            if k.endswith("_var"):
                bound = 2.0 ** -22 * (value_bound(k[:-4]) ** 2
                                      + np.abs(b.astype(np.float64)))
                diff = np.abs(a.astype(np.float64) - b)
                assert (diff <= bound).all(), (k, s, diff.max())
                continue
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=f"{k} shard {s}")


@pytest.mark.parametrize("seed,index", PLANS)
def test_fuzzed_plan_matches_the_reference(reference, port, seed, index):
    from repro_torch.core import plan as PL
    from repro_torch.testing import plan_fuzz as F

    ctx, inputs = port
    want = reference[(seed, index)]
    cost_sized, st = build(F, ctx, inputs, seed, index)
    if (seed, index) == GENERATOR_RAISES:
        assert "randrange" in want["generator_error"]
        F.check_frame(ctx, st)
        return
    assert cost_sized == want["cost_sized"]
    got = observe(PL, ctx, st)
    assert got["ops"] == want["ops"]
    assert got["explain"].endswith("\nverification: clean")
    findings = want["explain"].rsplit("\nverification: ", 1)[1]
    if (seed, index) == NOT_IDEMPOTENT or findings != "clean":
        # the reference's one projection pass: idempotence findings only,
        # and the port's fixpoint plan differs from its plan
        lines = findings.splitlines()[1:]
        assert lines and all("[idempotence]" in ln for ln in lines), findings
        assert got["explain"] != want["explain"]
    else:
        assert got["key"] == want["key"]
        assert got["explain"] == want["explain"]
    same_shard_rows(got, want)
    F.check_frame(ctx, st)


def test_the_plans_cover_both_input_kinds(reference):
    kinds = {v["cost_sized"] for v in reference.values() if "ops" in v}
    assert kinds == {False, True}


def test_run_fuzz_at_8_virtual_shards_is_clean():
    from repro_torch.testing import plan_fuzz as F

    s = F.run_fuzz(24, CI_SEED, num_shards=P, device="cpu")
    assert s["plans"] == 24 and s["rows"] > 0
    assert 0 < s["cost_sized"] < 24 and s["cacheable"] == 24
    assert s["verify"]["verify_findings"] == 0
    assert os.environ["REPRO_VERIFY_PLANS"] == "1"


def test_the_fuzzer_cli_prints_its_summary(capsys):
    from repro_torch.testing import plan_fuzz as F

    assert F.main(["--plans", "3", "--seed", "5", "--shards", "4",
                   "--device", "cpu"]) == 0
    assert "[plan-fuzz] OK: 3 plans" in capsys.readouterr().out


def test_check_frame_catches_a_divergent_fused_result(monkeypatch):
    """A fused run that drops a row fails the plan with its op trace."""
    from repro_torch.core.context import DistContext
    from repro_torch.testing import plan_fuzz as F

    ctx = DistContext(num_shards=P, device="cpu")
    inputs = F.make_inputs(ctx, 1, analyze=False)
    st = F.random_frame(ctx, inputs, random.Random("1:0"), max_ops=3)
    real = ctx._run_plan

    def lossy(plan, tabs, *, optimize=False, report=None):
        out, stats = real(plan, tabs, optimize=optimize, report=report)
        if optimize:
            rc = out.row_counts.clone()
            rc[int(rc.argmax())] -= 1
            out = dataclasses.replace(out, row_counts=rc)
        return out, stats

    monkeypatch.setattr(ctx, "_run_plan", lossy)
    with pytest.raises(AssertionError, match="fused result != eager"):
        F.check_frame(ctx, st)


# ---------------------------------------------------------------------------
# chaos cases (held to tests/test_chaos.py in tests/test_torch_serving.py,
# which runs them against the reference)
# ---------------------------------------------------------------------------


def test_chaos_rows_compare_in_shard_order():
    """A chaos case's results are equal only with the same rows on the
    same shards in the same order: a permutation within a shard, or a row
    moved to another shard, is a difference."""
    from repro_torch.core.context import DistContext
    from repro_torch.testing import chaos_cases as C

    ctx = DistContext(num_shards=P, device="cpu")
    dt = ctx.scatter(C._orders(4, device="cpu"), local_capacity=8)
    base = C._rows(dt)
    assert C._same(base, C._rows(dt))
    swapped = {k: v.clone() for k, v in dt.columns.items()}
    for v in swapped.values():
        v[0, [0, 1]] = v[0, [1, 0]]
    assert not C._same(base, C._rows(dataclasses.replace(dt, columns=swapped)))
    rc = dt.row_counts.clone()
    rc[0] -= 1
    rc[1] += 1
    moved = {k: v.clone() for k, v in dt.columns.items()}
    for v in moved.values():  # shard 0's last row becomes shard 1's last
        v[1, rc[1] - 1] = v[0, rc[0]]
    assert not C._same(base, C._rows(dataclasses.replace(
        dt, columns=moved, row_counts=rc)))


def test_chaos_cli_prints_the_reference_keys(capsys):
    import json

    from repro_torch.testing import chaos_cases as C

    assert C.main(["cache_and_compile", "--rows", "64", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("JSON:")
    out = json.loads(line[5:])
    assert set(out) == {f"{m}_{k}" for m in ("miss", "evict") for k in (
        "identical", "fires", "recompiles", "failed")} | {
        "compile_identical", "compile_retries", "compile_failed"}
    assert out["miss_identical"] and out["compile_identical"]


if __name__ == "__main__":
    reference_main(sys.argv[1])
