"""The relational token pipeline: repro_torch.data against repro.data.

Two halves. The reference's tests of tests/test_pipeline.py rerun on the
port's pipeline on the CPU. Then the port is held against the reference in
this process (one JAX CPU device, one shard on each side):
``lm_samples_table`` and ``lm_labels_table`` bit for bit, and
``global_batch`` in order (tokens and weights bit for bit) over three
(seed, step) pairs, one with a threshold that forces every refill and the
wrap-pad. The 8-shard comparison rides the reference subprocess of
tests/test_torch_dist.py.

``last_stats``: the counts, minima, maxima and sources are equal bit for
bit. The means and variances sum float32 qualities in [0, 1) whose order
differs between the packages (the reference's segment sums are its kernel's
tile sums; the port's plain version adds row by row), so they are held
within the rounding of two summation orders of the group's n values:
``mean`` within 2**-24 * (2n + 2) * mean and ``var`` within
2**-24 * (6n + 4) * (mean**2 + var) (recursive summation errs by at most
(n - 1) * 2**-24 * sum|x| each way, x >= 0 here; ``var`` =
``sumsq/n - mean*mean`` adds the mean's error twice and a few roundings).
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tensors, restored after it:
    the port's many small CPU ops spin in the thread pool's barriers when
    test workers share the cores (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipeline(**kw):
    from repro_torch.data.pipeline import PipelineConfig, RelationalTokenPipeline

    return RelationalTokenPipeline(PipelineConfig(**kw), device=CPU)


# ---------------------------------------------------------------------------
# tests/test_pipeline.py on the port
# ---------------------------------------------------------------------------


def test_batch_shapes_and_determinism():
    p = _pipeline(seq_len=48, global_batch=12, vocab_size=999, seed=3)
    b0 = p.global_batch(0)
    assert b0["tokens"].shape == (12, 48)
    assert b0["weight"].shape == (12,)
    assert b0["tokens"].dtype == np.int32
    assert b0["weight"].dtype == np.float32
    np.testing.assert_array_equal(b0["tokens"], p.global_batch(0)["tokens"])
    assert not np.array_equal(b0["tokens"], p.global_batch(1)["tokens"])
    assert p.batch_specs() == {"tokens": ((12, 48), torch.int32),
                               "weight": ((12,), torch.float32)}


def test_quality_filter_semantics():
    """Every emitted row passed the quality filter + label join."""
    p = _pipeline(seq_len=16, global_batch=8, vocab_size=100,
                  quality_threshold=0.5, seed=11)
    b = p.global_batch(0)
    surviving = []
    for refill in range(p.config.max_refills):
        samples, labels = p._round(0, refill)
        sn = samples.to_numpy()
        lab = set(labels.to_numpy()["sample_id"].tolist())
        for i in range(len(sn["sample_id"])):
            if sn["quality"][i] > 0.5 and sn["sample_id"][i] in lab:
                surviving.append(tuple(sn["tokens"][i].tolist()))
        if len(surviving) >= p.config.global_batch:
            break
    got = {tuple(r.tolist()) for r in b["tokens"]}
    assert got <= set(surviving)
    assert (b["weight"] > 0).all()


def test_tokens_in_vocab():
    p = _pipeline(seq_len=16, global_batch=8, vocab_size=77, seed=1)
    b = p.global_batch(5)
    assert b["tokens"].min() >= 1 and b["tokens"].max() < 77


def test_prefetcher_order():
    from repro_torch.data.pipeline import Prefetcher

    p = _pipeline(seq_len=8, global_batch=4, vocab_size=50, seed=2)
    direct = [p.global_batch(i)["tokens"] for i in range(3)]
    pf = list(itertools.islice(Prefetcher(p, depth=2), 3))
    for a, b in zip(direct, pf):
        np.testing.assert_array_equal(a, b["tokens"])


def test_quality_stats_stage():
    """The groupby stats stage: per-source mean/var/count over ALL refill
    rounds consumed for the batch (partial -> combine)."""
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import source_quality_stats

    p = _pipeline(seq_len=8, global_batch=16, vocab_size=50,
                  quality_threshold=0.9, collect_stats=True, seed=5)
    p.global_batch(0)
    s = p.last_stats
    assert s is not None
    n_rounds = int(round(s["quality_count"].sum())) // p._raw_rows
    src, qual = [], []
    for refill in range(max(n_rounds, 1)):
        d = p._round(0, refill)[0].to_numpy()
        src.append(d["source"])
        qual.append(d["quality"])
    src, qual = np.concatenate(src), np.concatenate(qual)
    assert s["quality_count"].sum() == len(src)
    for i, b in enumerate(s["source"]):
        g = qual[src == b]
        assert s["quality_count"][i] == len(g)
        np.testing.assert_allclose(s["quality_mean"][i], g.mean(), atol=1e-5)
        np.testing.assert_allclose(s["quality_var"][i], g.var(), atol=1e-4)

    t = synthetic.lm_samples_table(300, 8, 50, seed=9, device=CPU)
    d = t.to_numpy()
    st = source_quality_stats(t).to_numpy()
    assert st["quality_count"].sum() == 300
    assert set(st["source"].tolist()) == set(d["source"].tolist())


def test_synthetic_streams_independent():
    from repro_torch.data import synthetic

    a = synthetic.random_table(100, seed=0, step=0, shard=0, device=CPU)
    b = synthetic.random_table(100, seed=0, step=0, shard=1, device=CPU)
    c = synthetic.random_table(100, seed=0, step=1, shard=0, device=CPU)
    ka = a.columns["k"]
    assert not torch.equal(ka, b.columns["k"])
    assert not torch.equal(ka, c.columns["k"])
    a2 = synthetic.random_table(100, seed=0, step=0, shard=0, device=CPU)
    assert torch.equal(ka, a2.columns["k"])


def test_zipf_skew():
    from repro_torch.data import synthetic

    t = synthetic.zipf_table(5000, a=1.3, key_range=1000, seed=4, device=CPU)
    _, counts = np.unique(t.columns["k"].numpy(), return_counts=True)
    assert counts.max() > 20 * (5000 / 1000)


def test_prefetcher_propagates_worker_error():
    """A crash in the source iterator re-raises in the CONSUMER."""
    from repro_torch.data.pipeline import Prefetcher

    def flaky():
        yield {"tokens": np.zeros((2, 4), np.int32)}
        yield {"tokens": np.ones((2, 4), np.int32)}
        raise RuntimeError("source blew up")

    pf = Prefetcher(flaky(), depth=2)
    assert len([next(pf), next(pf)]) == 2
    with pytest.raises(RuntimeError, match="source blew up"):
        next(pf)


def test_prefetcher_clean_stop_unaffected():
    from repro_torch.data.pipeline import Prefetcher

    def fine():
        yield from range(3)

    assert list(Prefetcher(fine(), depth=2)) == [0, 1, 2]


def test_pipeline_defaults_to_the_card():
    from repro_torch.data.pipeline import PipelineConfig, RelationalTokenPipeline

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RelationalTokenPipeline(PipelineConfig(seq_len=8, global_batch=4,
                                               vocab_size=50))


# ---------------------------------------------------------------------------
# against the reference, one shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (3, 2, 5), (9, 7, 1)])
def test_lm_tables_equal_the_reference_bit_for_bit(seed, step, shard):
    from repro.data import synthetic as RS
    from repro_torch.data import synthetic as TS

    want = RS.lm_samples_table(37, 11, 501, seed=seed, step=step,
                               shard=shard).to_numpy()
    got = TS.lm_samples_table(37, 11, 501, seed=seed, step=step, shard=shard,
                              device=CPU).to_numpy()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      want[k].view(np.int32), err_msg=k)
    ids = want["sample_id"]
    lw = RS.lm_labels_table(ids, seed=seed, step=step, shard=shard).to_numpy()
    lg = TS.lm_labels_table(ids, seed=seed, step=step, shard=shard,
                            device=CPU).to_numpy()
    assert list(lg) == list(lw) and 0 < len(lw["sample_id"]) < len(ids)
    for k in lw:
        assert lg[k].dtype == lw[k].dtype
        np.testing.assert_array_equal(lg[k].view(np.int32),
                                      lw[k].view(np.int32), err_msg=k)


def assert_stats_match(got: dict, want: dict) -> None:
    """``last_stats``: exact but for the means and variances, which are held
    within the summation-order bound of the module docstring."""
    assert sorted(got) == sorted(want)
    for k in ("source", "quality_count", "quality_min", "quality_max"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = want["quality_count"].astype(np.float64)
    mean = want["quality_mean"].astype(np.float64)
    var = want["quality_var"].astype(np.float64)
    u = 2.0 ** -24
    for k, bound in (("quality_mean", u * (2 * n + 2) * mean),
                     ("quality_var", u * (6 * n + 4) * (mean ** 2 + var))):
        assert got[k].dtype == want[k].dtype, k
        diff = np.abs(got[k].astype(np.float64) - want[k])
        assert (diff <= bound).all(), (k, diff, bound)


# (seed, step, config): the second forces a refill; the third exhausts
# max_refills far short of the batch, so the wrap-pad fills it
REFERENCE_CASES = [
    (0, 0, dict(seq_len=24, global_batch=20, vocab_size=700)),
    (4, 3, dict(seq_len=16, global_batch=24, vocab_size=300,
                quality_threshold=0.6, collect_stats=True, num_sources=8)),
    (7, 1, dict(seq_len=8, global_batch=32, vocab_size=50,
                quality_threshold=0.97, max_refills=3, collect_stats=True)),
]


@pytest.mark.parametrize("seed,step,cfg", REFERENCE_CASES)
def test_global_batch_equals_the_reference_in_order(seed, step, cfg):
    from repro.data.pipeline import PipelineConfig as RC
    from repro.data.pipeline import RelationalTokenPipeline as RP
    from repro_torch.data.pipeline import PipelineConfig, RelationalTokenPipeline

    ref = RP(RC(seed=seed, **cfg))
    port = RelationalTokenPipeline(PipelineConfig(seed=seed, **cfg),
                                   device=CPU)
    want, got = ref.global_batch(step), port.global_batch(step)
    for k in ("tokens", "weight"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      want[k].view(np.int32), err_msg=k)
    if cfg.get("quality_threshold", 0) > 0.9:
        # the wrap-pad repeats the few rows that passed, in order
        rows = {tuple(r) for r in got["tokens"].tolist()}
        assert len(rows) < cfg["global_batch"] // 2
    if cfg.get("collect_stats"):
        assert_stats_match(port.last_stats, ref.last_stats)
    else:
        assert port.last_stats is None and ref.last_stats is None


def test_plans_are_prepared_once_across_refills():
    """The keyed quality predicate keeps the plan cache warm: the first
    batch prepares the chain's plan once, later batches prepare none."""
    p = _pipeline(seq_len=8, global_batch=16, vocab_size=60,
                  quality_threshold=0.6, seed=2)
    p.global_batch(0)
    first = p._ctx.cache_stats()
    assert first["misses"] == 1 and first["hits"] >= 1  # refills hit
    for step in (1, 2):
        p.global_batch(step)
    st = p._ctx.cache_stats()
    assert st["misses"] == 1 and st["hits"] > first["hits"]
