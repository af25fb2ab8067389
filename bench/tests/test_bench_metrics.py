"""The metric arithmetic: rows over the window, the union of device
intervals, the seams' least bytes and their share of the roofline."""
import pytest
import torch

from bench import harness, peaks, profiling


def reader(name):
    return harness.readers([{"name": name}])[name]


def test_rows_per_s_is_all_rows_over_all_the_window():
    run = harness.Run(window_s=2.0, calls=[
        {"rows": 100, "ok": True}, {"rows": 100, "ok": True},
        {"rows": 100, "ok": False}])
    assert reader("rows_per_s").read(run) == 100.0
    assert reader("rows_per_s").read(harness.Run()) is None


def test_interval_union_and_idle_share():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0)]
    busy, gaps = profiling._union_seconds([(s, e) for _, s, e in ops])
    assert busy == pytest.approx(30e-6)
    assert gaps == [(20.0, 30.0)]
    t = profiling.Trace(device_ops=ops, window_s=60e-6, calls=1)
    share = reader("device_idle_share").read(harness.Run(trace=t))
    assert share == pytest.approx(50.0)


def test_breakdown_ranks_and_truncates():
    t = profiling.Trace(device_ops=[("x" * 500, 0.0, 3.0), ("y", 3.0, 4.0),
                                    ("x" * 500, 5.0, 6.0)],
                        gaps=[("aten::sort", 1e-3), ("aten::sort", 2e-3),
                              ("cudaMalloc", 1e-4)])
    b = profiling.breakdown(t)
    assert b["device_ops"][0] == ["x" * profiling.NAME_CHARS, pytest.approx(4e-6)]
    assert b["idle_gaps"][0] == ["aten::sort", pytest.approx(3e-3)]


def test_hash_partition_least_bytes():
    mod = reader("hash_partition_roofline")
    cols = [torch.zeros(1000, dtype=torch.int32),
            torch.zeros(1000, dtype=torch.float32)]
    rec = mod.meter(cols, torch.tensor(600), 8, seed=7)
    rec = {k: harness._resolve(v) for k, v in rec.items()}
    # 600 valid rows x 8 B of columns read, 1000 int32 ids written
    assert mod.least_bytes(rec) == 600 * 8 + 4 * 1000


def test_segment_reduce_least_bytes():
    mod = reader("segment_reduce_roofline")
    seg = torch.tensor([0, 0, 1, -1, -1, 2], dtype=torch.int32)
    rec = mod.meter(torch.ones(6), seg, 3, "sum", contiguous_runs=True)
    rec = harness._resolve(rec)
    # every id read, the 4 in-range rows' values, 3 outputs written
    assert mod.least_bytes(rec) == 6 * 4 + 4 * 4 + 3 * 4


def test_seam_share_needs_matching_calls_and_device_time():
    t = profiling.Trace(calls=3, metered_calls=1,
                        seams={"s": {"launched": 6, "device_s": 1e-3}},
                        metered={"s": [{"b": 3.35e9 / 2}, {"b": 3.35e9 / 2}]})
    share = peaks.seam_share(t, "s", lambda r: r["b"])
    # 3 calls x 3.35e9 B at 3.35e12 B/s = 3 ms over 1 ms of device time
    assert share == pytest.approx(300.0)
    t.seams["s"]["launched"] = 5
    assert peaks.seam_share(t, "s", lambda r: r["b"]) is None
    assert peaks.roofline_share(1.0, 0.0) is None


def test_closed_loop_leaves_the_check_out_of_the_window(monkeypatch):
    from bench.loops import closed

    clock = iter([0.0, 0.0, 1.0, 1.0, 6.0, 6.0, 7.0, 7.0, 8.0])
    monkeypatch.setattr(closed.time, "perf_counter", lambda: next(clock))

    def step(i):
        # call 1 spends 4 of its 5 seconds summarising its result
        return {"rows": 10, "ok": True, **({"check_s": 4.0} if i == 1 else {})}

    window_s, calls = closed.window(step, 3.5, {})
    assert window_s == 4.0 and len(calls) == 4
    assert [c["seconds"] for c in calls] == [1.0, 1.0, 1.0, 1.0]
    run = harness.Run(window_s=window_s, calls=calls)
    assert reader("rows_per_s").read(run) == 10.0


def test_exchange_and_host_counters():
    t = profiling.Trace(calls=2, host_ops=30, syncs=4, sync_calls=2,
                        reports=[[{"wire_bytes": 2**20}, {"wire_bytes": 2**21}],
                                 [{"wire_bytes": 3 * 2**20}]])
    run = harness.Run(trace=t)
    assert reader("exchange_mib_per_call").read(run) == 3.0
    assert reader("host_ops_per_call").read(run) == 15.0
    assert reader("host_syncs_per_call").read(run) == 2.0
    assert reader("host_syncs_per_call").read(harness.Run()) is None


def test_row_digest_reads_both_words_of_a_64_bit_column():
    from bench.reference.digest import row_hashes

    x = torch.tensor([1.0, 1.0, 3.0], dtype=torch.float64)
    low = torch.nextafter(x[:1], torch.tensor([2.0], dtype=torch.float64))
    h = row_hashes({"v": x})
    assert h[0] == h[1] and h[0] != h[2]
    # 1.0 and the next double differ in the low word alone
    assert row_hashes({"v": low})[0] != h[0]
    k = torch.tensor([5, 5], dtype=torch.int32)
    assert row_hashes({"k": k, "v": x[:2]})[0] == row_hashes({"k": k, "v": x[:2]})[1]
