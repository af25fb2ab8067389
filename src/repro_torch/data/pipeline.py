"""Relational ETL -> token batches: the paper's Fig. 5/6 integration story
(the port of ``repro.data.pipeline``).

The paper's claim is that data engineering should be a *library function*
inside the training program. Here the pre-processing pipeline for LM
training is the relational operator chain

    samples = lm_samples_table(...)              # 'CSV read'
    frame(samples).select(quality > θ)           # Select   (paper §II-B-1)
        .join(labels, on=sample_id)              # Join     (paper §II-B-3)
        .project(tokens, weight).limit(B)        # Project  (paper §II-B-2)
        .collect()

built as a :class:`~repro_torch.core.frame.LazyFrame` plan and run by
``collect()``: the optimizer pushes the quality filter and the
tokens/weight projection below the join, and on a one-shard context elides
every shuffle. The select's predicate carries a key, so every refill round
hits the context's plan cache: after the first batch no plan is prepared.
The pipeline is a pure function of ``(seed, step)`` (restart and replay
determinism), and :class:`Prefetcher` overlaps batch assembly with the
training step.

Host traffic per refill round: the two tables, drawn on the host from the
seeded numpy streams, are uploaded once; the round's batch rows are read
back once. The label table is built from the host's sample ids, so making
it reads nothing from the device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.core import ops_agg as A
from repro_torch.core import ops_local as L
from repro_torch.core.context import DistContext
from repro_torch.core.table import Table, concat_tables, to_device
from repro_torch.data import synthetic


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    quality_threshold: float = 0.2
    oversample: float = 1.6     # raw rows generated per emitted row
    max_refills: int = 8        # deterministic refill rounds before padding
    collect_stats: bool = False  # per-source quality stats (groupby stage)
    num_sources: int = 16        # source-bucket cardinality bound (stats)
    seed: int = 0


class RelationalTokenPipeline:
    """Deterministic relational ETL producing fixed-shape token batches.

    ``ctx``: the context the chain runs on; None makes a one-shard
    ``DistContext`` on ``device`` (``cuda`` unless the caller asks for
    another).
    """

    def __init__(self, config: PipelineConfig, ctx: DistContext | None = None,
                 *, device: str | torch.device = "cuda"):
        self.config = config
        c = config
        self._raw_rows = max(4, int(np.ceil(c.global_batch * c.oversample)))
        self._ctx = ctx or DistContext(num_shards=1, device=device)
        self.last_stats: dict[str, np.ndarray] | None = None

    # -- shapes ----------------------------------------------------------------
    def batch_specs(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        c = self.config
        return {"tokens": ((c.global_batch, c.seq_len), torch.int32),
                "weight": ((c.global_batch,), torch.float32)}

    # -- batch assembly ----------------------------------------------------------
    def _round(self, step: int, refill: int) -> tuple[Table, Table]:
        """Refill round ``refill`` of batch ``step``: the samples and their
        labels, drawn on the host and uploaded once each."""
        c = self.config
        samples = synthetic.lm_samples_table(
            self._raw_rows, c.seq_len, c.vocab_size,
            seed=c.seed, step=step, shard=refill, device="cpu")
        labels = synthetic.lm_labels_table(
            samples.columns["sample_id"].numpy(),
            seed=c.seed, step=step, shard=refill, device="cpu")
        dev = self._ctx.device
        return to_device(samples, dev), to_device(labels, dev)

    def _etl_frame(self, samples: Table, labels: Table):
        """The relational chain (select -> join -> project -> limit). The
        trailing ``limit`` is a true GLOBAL head-n, so a round yields at
        most ``global_batch`` rows across all shards.

        Capacities are skew-proof: the join's shuffle bucket holds a whole
        shard's rows and out_capacity covers every sample globally
        (sample_id is unique on each side), so batch content never
        silently truncates, whatever the shard count. The labels take the
        samples' capacity (their ids are a subset), so every round has the
        same shapes and reuses the plan the first one prepared; the
        reference sizes them by their own count, which changes the shapes
        of its program from round to round but no row.
        """
        c = self.config
        ds = self._ctx.scatter(samples)
        dl = self._ctx.scatter(labels, local_capacity=ds.local_capacity)
        thr = c.quality_threshold
        return (self._ctx.frame(ds)
                .select(lambda cols: cols["quality"] > thr,
                        key=("quality_gt", thr))
                .join(self._ctx.frame(dl), "sample_id", how="inner",
                      algorithm="hash",
                      bucket_capacity=ds.local_capacity,
                      out_capacity=self._ctx.num_shards * ds.local_capacity)
                .project(["tokens", "weight"])
                .limit(c.global_batch))

    def _stats_partial(self, samples: Table) -> Table:
        # one partial a refill round, bounded by the source cardinality
        return A.partial_groupby(L.project(samples, ["source", "quality"]),
                                 "source", SOURCE_STAT_AGGS,
                                 out_capacity=self.config.num_sources)

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        """Assemble batch ``step``: numpy ``tokens`` int32 (B, S) and
        ``weight`` float32 (B,). Pure in (seed, step); refills are
        deterministic."""
        c = self.config
        need = c.global_batch
        toks = np.zeros((need, c.seq_len), np.int32)
        wts = np.zeros((need,), np.float32)
        got = 0
        stat_partials = []
        for refill in range(c.max_refills):
            samples, labels = self._round(step, refill)
            if c.collect_stats:
                stat_partials.append(self._stats_partial(samples))
            batch = self._etl_frame(samples, labels).collect() \
                .to_table().to_numpy()
            take = min(len(batch["weight"]), need - got)
            toks[got: got + take] = batch["tokens"][:take]
            wts[got: got + take] = batch["weight"][:take]
            got += take
            if got >= need:
                break
        if c.collect_stats:
            cat = stat_partials[0]
            for part in stat_partials[1:]:
                cat = concat_tables(cat, part)
            self.last_stats = A.combine_groupby(
                cat, "source", SOURCE_STAT_AGGS,
                out_capacity=c.num_sources).to_numpy()
        if got < need:  # pathological filter rate: wrap-pad deterministically
            reps = -(-need // max(got, 1))
            toks[got:] = np.tile(toks[:got], (reps, 1))[: need - got]
            wts[got:] = np.tile(wts[:got], reps)[: need - got]
        return {"tokens": toks, "weight": wts}

    def __iter__(self):
        step = 0
        while True:
            yield self.global_batch(step)
            step += 1


SOURCE_STAT_AGGS = (("quality", "count"), ("quality", "mean"),
                    ("quality", "var"), ("quality", "min"),
                    ("quality", "max"))


def source_quality_stats(samples: Table) -> Table:
    """Quality-bucket statistics: GroupBy source -> count/mean/var/min/max
    of the quality score (the data-quality dashboard stage)."""
    return A.groupby(samples, "source", SOURCE_STAT_AGGS)


class Prefetcher:
    """Background-thread prefetch with bounded depth (host-side overlap).

    Decouples batch assembly from the training step: a slow ETL round (the
    'straggler') is absorbed by the queue instead of stalling the step.
    """

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._done = object()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        # a crash in the source iterator must surface in the CONSUMER,
        # not vanish into the worker thread as a silent early end-of-data
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
