"""The plan verifier and the collective auditor: repro_torch.core.verify
against repro.core.verify.

One subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
in tests/test_torch_plan.py) runs the reference; the port runs the same
code on 8 virtual shards on the CPU. Tolerance: none. These must be equal:

- ``explain(verify=True)`` of every frame of tests/test_torch_plan.py, over
  plain and analyzed tables (the plan and, after it, ``verification:
  clean``);
- ``format_findings`` of hand-broken optimized plans that trip each of the
  five rules: an orphaned column, a forged scan tag, a forged
  ``skip_shuffle``, a Limit moved across a Sort, ``sized`` without stats,
  an unresolved ``auto``, stages out of range or past the bucket, and a
  logical plan passed off as optimized (idempotence), character for
  character;
- on ``case_verify_audit``'s pipelines (``repro.testing.dist_cases``):
  ``expected_collectives``, the port's ``audit_collectives`` count of the
  collectives its virtual mesh issued, and the reference's jaxpr count.

The tables' placement tags are put on with ``dataclasses.replace`` (the
verifier reads tags and schemas, not rows); the analyzed variants carry
``analyze_table`` stats on the reference and ``ctx.analyze``'s on the port,
as in tests/test_torch_plan.py.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_plan as TP  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
P = 8


def tagged_tables(api, ctx) -> tuple[dict, dict]:
    """(plain, analyzed) inputs of tests/test_torch_plan.py, the two tagged
    tables by ``dataclasses.replace``."""
    data = TP.inputs()
    plain = {n: api.make(ctx, data[n]) for n in ("a", "b", "s1", "s2", "c")}
    plain["a_sorted"] = dataclasses.replace(
        plain["a"], partitioning=api.R.RangePartitioning(
            ("k",), P, api.R.fresh_range_fingerprint()))
    plain["b_part"] = dataclasses.replace(
        plain["b"], partitioning=api.R.Partitioning(("k",), P, 7))
    return plain, {n: api.analyze(ctx, t) for n, t in plain.items()}


def _find(node, PL, cls):
    if isinstance(node, cls):
        return node
    for c in PL.children(node):
        hit = _find(c, PL, cls)
        if hit is not None:
            return hit
    return None


def _swap(node, PL, old, new):
    if node is old:
        return new
    kids = [_swap(c, PL, old, new) for c in PL.children(node)]
    return PL._with_children(node, kids) if kids else node


def broken_plans(api, T) -> dict:
    """name -> format_findings of a hand-broken optimized plan."""
    PL, V = api.PL, api.V
    a, s = T["plain"]["a"], T["stats"]["a"]
    ctx = api.ctx_of(a)
    out = {}

    def check(name, frame, breaker, stats=None):
        logical = frame.logical_plan()
        schemas = [t.schema for t in frame._inputs]
        opt = PL.optimize(logical, schemas, P, stats, verify=False)
        bad = breaker(opt) if breaker is not None else logical
        out[name] = V.format_findings(
            V.verify_plan(logical, bad, schemas, P, stats))

    def set_on(cls, **kw):
        def breaker(opt):
            node = _find(opt, PL, cls)
            return _swap(opt, PL, node, dataclasses.replace(node, **kw))
        return breaker

    gb = ctx.frame(a).project(["k", "v"]).groupby("k", {"v": "sum"},
                                                    strategy="shuffle")
    check("orphaned_column", gb, set_on(PL.Project, columns=("k",)))
    check("forged_scan_tag", gb, set_on(
        PL.Scan, partitioning=api.R.Partitioning(("k",), P, 7)))
    check("forged_skip_shuffle", gb, set_on(PL.GroupBy, skip_shuffle=True))
    check("sized_without_stats", gb, set_on(PL.GroupBy, sized=True))
    check("unresolved_auto", gb, set_on(PL.GroupBy, strategy="auto"))
    check("stages_out_of_range", gb, set_on(PL.GroupBy, stages=9))
    check("stages_past_bucket", gb, set_on(PL.GroupBy, stages=4,
                                           bucket_capacity=2))
    sized = ctx.frame(s).groupby("k", {"v": "sum"}, strategy="shuffle")
    check("sized_bucket_unset", sized,
          set_on(PL.GroupBy, bucket_capacity=None), [s.stats])
    top = ctx.frame(a).sort("k").limit(50)

    def limit_below_sort(opt):
        lim = _find(opt, PL, PL.Limit)
        srt = lim.child
        return dataclasses.replace(srt, child=dataclasses.replace(
            lim, child=srt.child))

    check("limit_across_sort", top, limit_below_sort)
    sel = ctx.frame(a).project(["k", "v", "w"]).select(
        lambda c: c["v"] > 0, key="v>0")
    check("not_idempotent", sel, None)
    return out


def audit_pipelines(api, ctx) -> dict:
    """``case_verify_audit``'s pipelines: 8 shards of 200 rows."""
    def int_table(n, kr, seed):
        rng = np.random.default_rng(seed)
        return {"k": rng.integers(0, kr, n).astype(np.int32),
                "d0": rng.integers(-40, 40, n).astype(np.float32),
                "d1": rng.integers(-40, 40, n).astype(np.float32)}

    cap, kr = 200, 800
    orders = api.make(ctx, [(int_table(cap, kr, 500 + i), cap)
                            for i in range(P)])
    users = api.make(ctx, [(int_table(cap, kr, 600 + i), cap)
                           for i in range(P)])
    bucket = 2 * cap
    return {
        "groupby_chain": (
            ctx.frame(orders).join(ctx.frame(users), "k",
                                   bucket_capacity=bucket,
                                   out_capacity=4 * cap)
            .select(lambda c: c["d0"] > 0.0, key="pos")
            .groupby("k", (("d0", "sum"), ("d0", "count")),
                     strategy="shuffle", bucket_capacity=bucket)),
        "sort_join_align": (
            ctx.frame(orders).sort("k", bucket_capacity=bucket)
            .join(ctx.frame(users), "k", algorithm="sort",
                  bucket_capacity=bucket, out_capacity=4 * cap)),
        "sort_window": (
            ctx.frame(orders).sort(("k", "d1"), bucket_capacity=bucket)
            .window(("k",), (("rank", None, 0), ("cumsum", "d0", 0)),
                    order_by=("d1",), bucket_capacity=bucket)),
        "staged_shuffle": (
            ctx.frame(orders).partition_by("k", bucket_capacity=bucket,
                                           stages=3)),
        "ring_shuffle": (
            ctx.frame(orders).partition_by("k", bucket_capacity=bucket,
                                           shuffle_mode="ring")),
        "sorted_limit": (
            ctx.frame(orders).sort("k", bucket_capacity=bucket).limit(17)),
    }


def run_all(api) -> dict:
    ctx = api.ctx()
    plain, analyzed = tagged_tables(api, ctx)
    T = {"plain": plain, "stats": analyzed}
    res = {"explain": {(case, v): TP.CASES[case](ctx, T[v]).explain(
        verify=True) for case in TP.CASES for v in T},
        "broken": broken_plans(api, T), "audit": {}}
    for name, fr in audit_pipelines(api, ctx).items():
        audit = api.V.audit_collectives(fr)
        res["audit"][name] = {"expected": audit["expected"],
                              "actual": audit["actual"]}
    return res


def reference_api():
    import jax.numpy as jnp

    from repro.core import plan as PL
    from repro.core import repartition as R
    from repro.core import stats as RS
    from repro.core import verify as V
    from repro.core.context import DistContext
    from repro.core.table import Table

    def make(ctx, parts):
        return ctx.from_local_parts([
            Table({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(n, jnp.int32)) for cols, n in parts])

    def analyze(ctx, t):
        st = RS.analyze_table(t.to_table())
        st = dataclasses.replace(
            st, max_shard_rows=float(np.asarray(t.row_counts).max()))
        return dataclasses.replace(t, stats=st)

    ctx = DistContext()
    return types.SimpleNamespace(PL=PL, R=R, V=V, make=make, analyze=analyze,
                                 ctx=lambda: ctx, ctx_of=lambda t: ctx)


def port_api():
    from repro_torch.core import plan as PL
    from repro_torch.core import repartition as R
    from repro_torch.core import verify as V
    from repro_torch.core.context import DistContext
    from repro_torch.core.table import Table

    ctx = DistContext(num_shards=P, device="cpu")

    def make(ctx, parts):
        return ctx.from_local_parts([
            Table.from_numpy(cols, row_count=n, device="cpu")
            for cols, n in parts])

    return types.SimpleNamespace(PL=PL, R=R, V=V, make=make,
                                 analyze=lambda c, t: c.analyze(t),
                                 ctx=lambda: ctx, ctx_of=lambda t: ctx)


def reference_main(out_path: str) -> None:
    res = run_all(reference_api())
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, \
        f"reference run failed:\n{proc.stdout}\n{proc.stderr}"
    with open(path, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def port():
    return run_all(port_api())


@pytest.mark.parametrize("case", list(TP.CASES))
def test_explain_verify_matches_reference(reference, port, case):
    for v in ("plain", "stats"):
        got = port["explain"][(case, v)]
        assert got == reference["explain"][(case, v)], (case, v)
        assert got.endswith("\nverification: clean"), (case, v)


def test_broken_plans_match_reference(reference, port):
    assert sorted(port["broken"]) == sorted(reference["broken"])
    for name, want in reference["broken"].items():
        assert port["broken"][name] == want, name
    rules = {name: {line.split("]")[0].strip(" -[")
                    for line in text.splitlines()[1:]}
             for name, text in port["broken"].items()}
    assert {"pushdown"} <= rules["orphaned_column"]
    assert {"partitioning"} <= rules["forged_scan_tag"]
    assert {"partitioning"} <= rules["forged_skip_shuffle"]
    assert {"pushdown"} <= rules["limit_across_sort"]
    for name in ("sized_without_stats", "unresolved_auto",
                 "stages_out_of_range", "stages_past_bucket",
                 "sized_bucket_unset"):
        assert {"cost-sizing"} <= rules[name], name
    assert {"idempotence"} <= rules["not_idempotent"]


def test_collective_audit_matches_reference(reference, port):
    for name, want in reference["audit"].items():
        got = port["audit"][name]
        assert want["expected"] == want["actual"], name
        assert got["expected"] == want["expected"], name
        assert got["actual"] == want["actual"], name


def test_verify_counters_and_gate(monkeypatch):
    from repro_torch.core import plan as PL
    from repro_torch.core import verify as V

    api = port_api()
    ctx = api.ctx()
    a = api.make(ctx, TP.inputs()["a"])
    frame = ctx.frame(a).groupby("k", {"v": "sum"})
    V.reset_counters()
    monkeypatch.setenv(V.ENV_FLAG, "0")
    frame.optimized()
    assert V.counter_snapshot() == {"verify_runs": 0, "verify_findings": 0}
    monkeypatch.setenv(V.ENV_FLAG, "1")
    frame.optimized()
    assert ctx.cache_stats()["verify_runs"] == 1
    logical = frame.logical_plan()
    bad = dataclasses.replace(PL.optimize(logical, [a.schema], P,
                                          verify=False), strategy="auto")
    with pytest.raises(V.PlanVerificationError, match="cost-sizing"):
        V.verify_or_raise(logical, bad, [a.schema], P)
    assert V.counter_snapshot()["verify_findings"] >= 1


if __name__ == "__main__":
    reference_main(sys.argv[1])
