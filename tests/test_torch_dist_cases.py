"""The port's distributed cases (``repro_torch.testing.dist_cases``) on 8
virtual shards on the CPU, each held to what tests/test_dist.py asserts of
the reference's case of the same name (``dist_cases.checks``, which
chip_smoke.py's phase 15 uses too); a planted bad output of each case
fails those checks. The port needs no subprocess: its shards are virtual.
The LM-side cases are here too: the MoE cases (``moe_ep``,
``moe_decode_psum``), the seq-sharded decode (``flash_decode_shard``), pod
compression (``compress_pod``) and the elastic restore
(``elastic_restore``), on virtual meshes of the reference's shapes.
"""
import functools

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def run_case(case: str) -> dict:
    """The case's JSON, run once (plants copy it)."""
    from repro_torch.testing import dist_cases as D

    return D.CASES[case](device="cpu")


def assert_checked(case: str) -> None:
    from repro_torch.testing import dist_cases as D

    r = run_case(case)
    failed = [k for k, ok in D.checks({case: r}).items() if not ok]
    assert not failed, (failed, r)


def test_every_relational_case_is_ported():
    from repro_torch.testing import dist_cases as D

    assert sorted(D.CASES) == sorted([
        "join_union_sort", "intersect_difference", "groupby", "plan_fused",
        "sort_chain", "sort_align_skew", "global_limit", "overflow_retry",
        "cost_groupby", "window_chain", "window_thin_shards", "sort_multikey",
        "serving_async", "async_overflow_deferred", "staged_shuffle",
        "verify_audit", "moe_ep", "moe_decode_psum", "flash_decode_shard",
        "compress_pod", "elastic_restore"])


def test_dist_cases_cli_prints_one_json_line(capsys):
    import json

    from repro_torch.testing import dist_cases as D

    assert D.main(["intersect_difference", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("JSON:")
    assert json.loads(out[0][5:]) == {"intersect_ok": True,
                                      "difference_ok": True}


def test_dist_join_union_sort():
    assert_checked("join_union_sort")


def test_dist_intersect_difference():
    assert_checked("intersect_difference")


def test_dist_groupby_both_strategies():
    assert_checked("groupby")


def test_plan_fused_matches_eager():
    """The fused frame: strictly fewer AllToAlls and wire bytes than the
    eager chain, bit-identical to it."""
    assert_checked("plan_fused")


def test_sort_chain_elides_one_alltoall():
    """The range-provenance contract: fused sort->join runs exactly one
    fewer AllToAll than eager (the sorted side stays put, the other side
    range-aligns), with an identical row multiset; the surviving range tag
    then elides the downstream groupby shuffle entirely."""
    assert_checked("sort_chain")


def test_sort_align_survives_probe_skew():
    """Default bucket sizing on the range-aligned join side must absorb a
    one-destination pileup (all probe keys in one anchor range) without
    overflow or divergence from eager."""
    assert_checked("sort_align_skew")


def test_global_limit_matches_local_oracle():
    """limit(n) is a true global head-n / post-sort top-n — bit-identical
    to the local oracle, never the per-shard heads."""
    assert_checked("global_limit")


def test_overflow_retry_recompiles_once_and_matches_oracle():
    """The cost model's safety contract: a skewed repartition whose
    stats-sized capacity overflows re-runs exactly once at conservative
    capacities and matches the local oracle bit-for-bit."""
    assert_checked("overflow_retry")


def test_cost_model_groupby_strategy_and_wire():
    """Cost-driven physical planning: two_phase at low key cardinality,
    raw shuffle at high, strictly fewer dense wire bytes than the
    fixed-slack baseline at both ends, bit-identical results, no retry."""
    assert_checked("cost_groupby")


def test_window_chain_elides_shuffle_and_matches_oracle():
    """The window-subsystem contract: over a dist_sort output the window
    runs with 0 AllToAlls (boundary all_gather only) and is bit-identical
    to the single-host oracle for all 8 functions; the unsorted lowering
    (sort inside the window node) pays one shuffle and stays
    bit-identical too."""
    assert_checked("window_chain")


def test_window_thin_shard_carries_match_oracle():
    """Group portions smaller than the lag/lead offset and an empty
    middle shard: the boundary buffers must merge across several shards
    and still match the single-host oracle bit-for-bit."""
    assert_checked("window_thin_shards")


def test_dist_sort_multikey():
    assert_checked("sort_multikey")


def test_dist_staged_shuffle():
    """The pipelined-shuffle contract on 8 shards: every staging and the
    ppermute ring are bit-identical to the monolithic exchange — same
    rows, same overflow under skew, same wire-byte accounting — and an
    empty (capacity-0) table shuffles without the old clip-bound crash."""
    assert_checked("staged_shuffle")


def test_verify_audit_matches_traced_collectives():
    """The collective auditor on 8 shards: verify.expected_collectives'
    static per-record accounting equals the collectives the run made
    (VirtualMesh.counts), for every distributed operator family (hash
    groupby chain, sort->join alignment, sort->window carries, staged +
    ring repartitions, global limit)."""
    assert_checked("verify_audit")


def test_serving_async_interleaved_matches_sequential():
    """The serving contract: N interleaved collect_async clients over a
    shared session are bit-identical per query to sequential collects,
    the warm cache prepares NOTHING (inline keyless lambdas included),
    and resolving futures out of submission order changes nothing."""
    assert_checked("serving_async")


def test_async_overflow_verification_is_deferred():
    """Deferred overflow verification: a wrong cost estimate is invisible
    at submit time (no host sync, future unresolved), discovered at
    result(), retried at safe capacities EXACTLY ONCE with oracle-exact
    rows; a repeat submit routes straight to the safe executable, and the
    sized + safe executables live under distinct cache namespaces."""
    assert_checked("async_overflow_deferred")


def test_moe_ep_matches_local():
    assert_checked("moe_ep")
    assert run_case("moe_ep")["moe_dropped_local"] == 0.0


def test_moe_decode_psum_matches_local():
    assert_checked("moe_decode_psum")


def test_flash_decode_shard_matches_plain():
    assert_checked("flash_decode_shard")
    # one LSE merge: 2 psums and 1 pmax over the model axis
    assert run_case("flash_decode_shard")["merges"] == {"psum": 2, "pmax": 1}


def test_pod_compressed_training_tracks_exact():
    assert_checked("compress_pod")
    r = run_case("compress_pod")
    assert r["ef_finite"] and r["ef_max_abs"] > 0


def test_elastic_checkpoint_restore():
    assert_checked("elastic_restore")
    assert run_case("elastic_restore")["restored_steps"] == [1, 1, 1]


def _with(key, value):
    return lambda r: {**r, key: value(r)}


def _nested(key, sub, value):
    return lambda r: {**r, key: {**r[key], sub: value(r[key])}}


# one bad output a case, planted in its real JSON: each must fail its checks
PLANTED = {
    "join_union_sort": _with("join_hash_rows", lambda r: r["join_hash_rows"] + 1),
    "intersect_difference": _with("difference_ok", lambda r: False),
    "groupby": _with("two_phase_fewer_rows", lambda r: False),
    "plan_fused": _with("fused_wire", lambda r: r["eager_wire"]),
    "sort_chain": _with("fused_alltoall", lambda r: r["eager_alltoall"]),
    "sort_align_skew": _with("fused_overflow", lambda r: 1),
    "global_limit": _with("ok", lambda r: False),
    "overflow_retry": _with("retries", lambda r: 2),
    "cost_groupby": _nested("low", "strategy", lambda r: "shuffle"),
    "window_chain": _with("fused_window_wire", lambda r: 1),
    "window_thin_shards": _with("rows", lambda r: r["rows_expect"] - 1),
    "sort_multikey": _with("order_ok", lambda r: False),
    "serving_async": _with("warm_compiles", lambda r: 1),
    "async_overflow_deferred": _with("cache_namespaces", lambda r: ["plan"]),
    "staged_shuffle": _with("stages_reported", lambda r: [1, 1, 1]),
    "verify_audit": _nested("ring_shuffle", "actual",
                            lambda r: {**r["actual"], "all_to_all": 1}),
    "moe_ep": _with("moe_ep_err", lambda r: 2e-5),
    "moe_decode_psum": _with("moe_decode_err", lambda r: 1e-3),
    "flash_decode_shard": _with("flash_decode_err", lambda r: 2e-4),
    "compress_pod": _with("loss_close", lambda r: False),
    "elastic_restore": _with("elastic_ok", lambda r: False),
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_a_planted_bad_output_fails_its_checks(case):
    from repro_torch.testing import dist_cases as D

    bad = PLANTED[case](run_case(case))
    assert not all(D.checks({case: bad}).values()), bad
