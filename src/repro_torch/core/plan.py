"""Lazy logical-plan IR, its optimizer and cost model, and the executor
(the port of ``repro.core.plan``).

A plan is a small tree of relational nodes. The optimizer rewrites it in
the reference's order (:func:`optimize_with_partitioning`):

1. **Predicate column probing**: each ``Select`` predicate runs once over
   two zero rows a column on the CPU behind a recording mapping, which
   learns the columns it reads. A predicate that defeats the probe stays
   where it is.
2. **Predicate pushdown** below ``Project``/``Sort``/``Repartition`` and
   into the side of a ``Join`` whose columns it reads (inner/left joins
   push left, inner/right push right): rows drop before the AllToAll.
3. **Limit pushdown** below an order-preserving ``Project``.
4. **Projection pushdown**: ``Project`` nodes under every shuffle keep
   only the columns the rest of the plan reads.
5. **Shuffle elision**: :class:`~repro_torch.core.repartition.Partitioning`
   and :class:`~repro_torch.core.repartition.RangePartitioning` tags flow
   bottom-up; an input already hash-partitioned on an operator's keys
   (same seed and modulus), or range-partitioned on a key prefix, skips
   its shuffle, and a join range-aligns its other side to a sorted side.
6. **Cost model**: per-operator estimators propagate
   :class:`~repro_torch.core.stats.TableStats` from analyzed inputs, resolve
   each GroupBy's ``strategy="auto"`` (``shuffle`` when ``p * NDV`` exceeds
   the rows, else ``two_phase``; ``two_phase`` without stats), size every
   unset bucket and join output from the estimates, and mark those nodes
   ``sized``, so that an overflow re-runs the plan at safe capacities.

:func:`execute_plan` runs the optimized plan over the virtual mesh: each
node calls its ``ops_dist`` operator on the shards, and every potential
shuffle returns one :class:`ShuffleStats`, zeros where elided.
:func:`shuffle_report` derives the same per-shuffle records the executor
appends to ``report`` from the plan alone, without running it.
"""
from __future__ import annotations

import dataclasses
import types
from dataclasses import dataclass, field, replace
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import ops_agg as A
from repro_torch.core import ops_dist as D
from repro_torch.core import ops_local as L
from repro_torch.core import stats as S
from repro_torch.core import trace
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.repartition import (Partitioning, RangePartitioning,
                                          default_bucket_capacity,
                                          range_prefix_matches)
from repro_torch.core.table import ColumnSpec, Table

# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    """Base class of plan IR nodes (immutable, structurally comparable)."""


@dataclass(frozen=True)
class Scan(Node):
    """Leaf: the ``slot``-th input DistTable of the plan."""

    slot: int
    partitioning: Partitioning | RangePartitioning | None = None


@dataclass(frozen=True)
class Select(Node):
    """Row filter by a user predicate over the columns dict.

    ``key``: user-supplied hashable cache key for the predicate (without it
    the plan has no canonical key). ``columns``: the predicate's probed
    column footprint (filled by the optimizer; None = unknown).
    """

    child: Node
    predicate: Callable = field(compare=False)
    key: object = None
    columns: tuple[str, ...] | None = None


@dataclass(frozen=True)
class Project(Node):
    child: Node
    columns: tuple[str, ...]


@dataclass(frozen=True)
class Limit(Node):
    """True global head(n): the first n rows in shard order (the global
    top-n after a Sort)."""

    child: Node
    n: int


@dataclass(frozen=True)
class Repartition(Node):
    """Explicit hash repartition on ``keys``: pre-partition once so later
    joins/groupbys on the same keys (and seed) elide their shuffles."""

    child: Node
    keys: tuple[str, ...]
    seed: int = 7
    bucket_capacity: int | None = None
    skip_shuffle: bool = False
    sized: bool = False  # bucket filled in by the cost model (estimate!)
    stages: int | None = None  # shuffle pipeline depth (None = cost pick)
    shuffle_mode: str = "alltoall"


@dataclass(frozen=True)
class Join(Node):
    left: Node
    right: Node
    on: tuple[str, ...]
    how: str = "inner"
    algorithm: str = "sort"
    bucket_capacity: int | None = None
    out_capacity: int | None = None
    seed: int = 7
    shuffle_seed: int | None = None  # resolved by the optimizer
    skip_left_shuffle: bool = False
    skip_right_shuffle: bool = False
    # range fast path (set by the optimizer): the named side is range-
    # partitioned on align_keys (a prefix of `on`); the other side is
    # range-aligned to its boundaries instead of hash-shuffled.
    align: str | None = None          # None | "left" | "right"
    align_keys: tuple[str, ...] | None = None
    sized: bool = False      # bucket filled by the cost model (estimate!)
    out_sized: bool = False  # out_capacity filled by the cost model; a
    # user-set out_capacity (deliberate truncation) is never a bad estimate
    stages: int | None = None
    shuffle_mode: str = "alltoall"


@dataclass(frozen=True)
class GroupBy(Node):
    child: Node
    keys: tuple[str, ...]
    pairs: tuple[tuple[str, str], ...]  # normalized (col, op) aggregations
    # "auto" leaves the shuffle-vs-two-phase choice to the cost pass
    # (arXiv:2010.14596); "two_phase" without statistics
    strategy: str = "auto"
    bucket_capacity: int | None = None
    partial_capacity: int | None = None
    out_capacity: int | None = None
    seed: int = 7
    shuffle_seed: int | None = None
    skip_shuffle: bool = False
    sized: bool = False
    stages: int | None = None
    shuffle_mode: str = "alltoall"


@dataclass(frozen=True)
class Sort(Node):
    child: Node
    by: tuple[str, ...]
    bucket_capacity: int | None = None
    samples_per_shard: int = 64
    skip_shuffle: bool = False
    sized: bool = False
    stages: int | None = None
    shuffle_mode: str = "alltoall"


@dataclass(frozen=True)
class Window(Node):
    """Row-preserving window functions over (by, order_by)-sorted segments
    (``ops_dist.dist_window``). An input range-partitioned on a (by +
    order_by) prefix elides the shuffle, as for Sort. ``funcs`` is the
    canonical ``ops_agg.normalize_funcs`` tuple."""

    child: Node
    by: tuple[str, ...]
    order_by: tuple[str, ...]
    funcs: tuple[tuple, ...]
    bucket_capacity: int | None = None
    samples_per_shard: int = 64
    skip_shuffle: bool = False
    sized: bool = False
    stages: int | None = None
    shuffle_mode: str = "alltoall"


@dataclass(frozen=True)
class SetOp(Node):
    """Shared shape of the whole-row-hash binary operators."""

    left: Node
    right: Node
    bucket_capacity: int | None = None
    seed: int = 7
    mode: str = "symmetric"  # Difference only
    skip_left_shuffle: bool = False
    skip_right_shuffle: bool = False
    sized: bool = False
    stages: int | None = None
    shuffle_mode: str = "alltoall"


@dataclass(frozen=True)
class Union(SetOp):
    pass


@dataclass(frozen=True)
class Intersect(SetOp):
    pass


@dataclass(frozen=True)
class Difference(SetOp):
    pass


@dataclass(frozen=True)
class Distinct(Node):
    child: Node
    bucket_capacity: int | None = None
    seed: int = 7
    skip_shuffle: bool = False
    sized: bool = False
    stages: int | None = None
    shuffle_mode: str = "alltoall"


def children(node: Node) -> tuple[Node, ...]:
    if isinstance(node, Scan):
        return ()
    if isinstance(node, (Join, SetOp)):
        return (node.left, node.right)
    return (node.child,)


def _with_children(node: Node, kids: Sequence[Node]) -> Node:
    if isinstance(node, Scan):
        return node
    if isinstance(node, (Join, SetOp)):
        return replace(node, left=kids[0], right=kids[1])
    return replace(node, child=kids[0])


def remap_scans(node: Node, mapping: dict[int, int]) -> Node:
    """Renumber Scan slots (merging two frames' input lists into one)."""
    if isinstance(node, Scan):
        return replace(node, slot=mapping[node.slot])
    return _with_children(node, [remap_scans(c, mapping)
                                 for c in children(node)])


# ---------------------------------------------------------------------------
# schema inference
# ---------------------------------------------------------------------------

JOIN_SUFFIX = "_r"  # ops_local.join's clash suffix, mirrored here


class _Analysis:
    """Memoized per-node output schema (name -> ColumnSpec of one row).
    Memo keys are node identities; node refs are held so ids cannot be
    recycled mid-pass."""

    def __init__(self, input_schemas: Sequence[dict]):
        self.inputs = [dict(s) for s in input_schemas]
        self._memo: dict[int, tuple[Node, dict]] = {}

    def schema(self, node: Node) -> dict:
        hit = self._memo.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        out = self._schema(node)
        self._memo[id(node)] = (node, out)
        return out

    def _schema(self, node: Node) -> dict:
        if isinstance(node, Scan):
            return dict(self.inputs[node.slot])
        if isinstance(node, Project):
            ch = self.schema(node.child)
            return {k: ch[k] for k in node.columns}
        if isinstance(node, Join):
            lsch = self.schema(node.left)
            rsch = self.schema(node.right)
            out = dict(lsch)
            for k, v in rsch.items():
                out[k + JOIN_SUFFIX if k in lsch else k] = v
            return out
        if isinstance(node, GroupBy):
            ch = self.schema(node.child)
            out = {k: ch[k] for k in node.keys}
            for col, op in node.pairs:
                base = ch[col]
                if op in ("mean", "var"):
                    spec = ColumnSpec(base.shape, torch.float32)
                elif op == "count":
                    spec = ColumnSpec((), torch.int32)
                else:
                    spec = base
                out[f"{col}_{op}"] = spec
            return out
        if isinstance(node, Window):
            out = dict(self.schema(node.child))
            for fn, col, off in node.funcs:
                name = A.window_output_name(fn, col, off)
                if col is None:  # rank / dense_rank / row_number
                    spec = ColumnSpec((), torch.int32)
                elif fn == "running_mean":
                    spec = ColumnSpec((), torch.float32)
                else:  # lag / lead / cumsum / cummax keep the input dtype
                    spec = out[col]
                out[name] = spec
            return out
        # Select / Limit / Sort / Distinct / Repartition / set ops: unchanged
        return dict(self.schema(children(node)[0]))


# ---------------------------------------------------------------------------
# optimizer pass 1: predicate column probing
# ---------------------------------------------------------------------------


class _RecordingColumns(dict):
    """Columns dict that records which names a predicate reads."""

    def __init__(self, cols: dict):
        super().__init__(cols)
        self.accessed: set[str] = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.accessed.add(k)
        return super().get(k, default)


def probe_predicate(predicate: Callable, schema: dict) -> tuple[str, ...] | None:
    """Learn a predicate's column footprint by running it over zeros (two
    rows a column, on the CPU: a predicate is plain torch code).

    Returns the sorted accessed-column tuple, or None when the probe fails
    (exception, or no recorded access, e.g. the predicate iterates the
    dict), which pins the Select in place during pushdown.
    """
    cols = _RecordingColumns({
        k: torch.zeros((2,) + tuple(s.shape), dtype=s.dtype)
        for k, s in schema.items()
    })
    try:
        out = predicate(cols)
        _ = np.shape(out)  # must be array-like
    except Exception:  # noqa: BLE001 - any failure disables pushdown only
        return None
    return tuple(sorted(cols.accessed)) or None


def _annotate_selects(node: Node, an: _Analysis) -> Node:
    kids = [_annotate_selects(c, an) for c in children(node)]
    node = _with_children(node, kids)
    if isinstance(node, Select) and node.columns is None:
        cols = probe_predicate(node.predicate, an.schema(node.child))
        if cols is not None:
            node = replace(node, columns=cols)
    return node


# ---------------------------------------------------------------------------
# optimizer pass 2: predicate pushdown (filter before shuffle)
# ---------------------------------------------------------------------------


def _pushdown_selects(node: Node, an: _Analysis) -> Node:
    kids = [_pushdown_selects(c, an) for c in children(node)]
    node = _with_children(node, kids)
    if not isinstance(node, Select) or node.columns is None:
        return node
    refs = set(node.columns)
    ch = node.child
    if isinstance(ch, Project) and refs <= set(ch.columns):
        return replace(ch, child=_pushdown_selects(
            replace(node, child=ch.child), an))
    if isinstance(ch, (Sort, Repartition)):
        return replace(ch, child=_pushdown_selects(
            replace(node, child=ch.child), an))
    if isinstance(ch, Join):
        lnames = set(an.schema(ch.left))
        rnames = set(an.schema(ch.right))
        # a one-sided filter through an outer join changes which rows of the
        # other side surface unmatched: only inner/left joins push left,
        # inner/right push right
        if refs <= lnames and ch.how in ("inner", "left"):
            return replace(ch, left=_pushdown_selects(
                replace(node, child=ch.left), an))
        if refs <= rnames and not (refs & lnames) and ch.how in ("inner",
                                                                 "right"):
            return replace(ch, right=_pushdown_selects(
                replace(node, child=ch.right), an))
    return node


# ---------------------------------------------------------------------------
# optimizer pass 2b: limit pushdown (truncate before wide-row work)
# ---------------------------------------------------------------------------


def _pushdown_limits(node: Node) -> Node:
    """``Limit(Project(x)) -> Project(Limit(x))``: Project keeps row order
    and count, so the global head-n commutes with it. Project is the only
    target: Select changes membership, Sort/Repartition placement."""
    kids = [_pushdown_limits(c) for c in children(node)]
    node = _with_children(node, kids)
    if isinstance(node, Limit) and isinstance(node.child, Project):
        proj = node.child
        return replace(proj, child=_pushdown_limits(
            replace(node, child=proj.child)))
    return node


# ---------------------------------------------------------------------------
# optimizer pass 3: projection pushdown (narrow rows before shuffle)
# ---------------------------------------------------------------------------


def _project_to(child: Node, cols: set[str], an: _Analysis) -> Node:
    """Project ``child`` down to ``cols`` (child-schema order) if narrower."""
    sch = an.schema(child)
    if set(sch) == cols:
        return child
    ordered = tuple(k for k in sch if k in cols)
    if isinstance(child, Project):
        return replace(child, columns=ordered)
    return Project(child, ordered)


def _pushdown_projections(node: Node, needed: set[str] | None,
                          an: _Analysis) -> Node:
    if isinstance(node, Scan):
        return node
    if isinstance(node, Project):
        return replace(node, child=_pushdown_projections(
            node.child, set(node.columns), an))
    if isinstance(node, Select):
        child_needed = (None if (needed is None or node.columns is None)
                        else needed | set(node.columns))
        return replace(node, child=_pushdown_projections(
            node.child, child_needed, an))
    if isinstance(node, Limit):
        return replace(node, child=_pushdown_projections(node.child, needed,
                                                         an))
    if isinstance(node, (Sort, Repartition, Window)):
        if isinstance(node, Sort):
            keys = set(node.by)
        elif isinstance(node, Repartition):
            keys = set(node.keys)
        else:  # Window: partition keys + order keys + function inputs
            keys = set(node.by) | set(node.order_by) \
                | {c for _, c, _ in node.funcs if c is not None}
        cn = None if needed is None else needed | keys
        child = _pushdown_projections(node.child, cn, an)
        if cn is not None:
            # window output names in `cn` are not child columns: the
            # intersection with the child schema drops them
            child = _project_to(child, cn & set(an.schema(child)) | keys, an)
        return replace(node, child=child)
    if isinstance(node, Join):
        lsch = an.schema(node.left)
        rsch = an.schema(node.right)
        need_out = set(an.schema(node)) if needed is None else set(needed)
        ln = {k for k in lsch if k in need_out} | set(node.on)
        rn = set(node.on)
        for k in rsch:
            if (k + JOIN_SUFFIX if k in lsch else k) in need_out:
                rn.add(k)
                if k in lsch:
                    # a consumed '<k>_r' keeps its suffix only while the name
                    # still clashes: keep the left copy alive
                    ln.add(k)
        left = _project_to(_pushdown_projections(node.left, ln, an), ln, an)
        right = _project_to(_pushdown_projections(node.right, rn, an), rn, an)
        return replace(node, left=left, right=right)
    if isinstance(node, GroupBy):
        cn = set(node.keys) | {c for c, _ in node.pairs}
        child = _project_to(_pushdown_projections(node.child, cn, an), cn, an)
        return replace(node, child=child)
    # set ops & distinct compare whole rows: every child column is needed
    kids = [_pushdown_projections(c, None, an) for c in children(node)]
    return _with_children(node, kids)


# ---------------------------------------------------------------------------
# optimizer pass 4: shuffle elision via Partitioning/RangePartitioning tags
# ---------------------------------------------------------------------------


def _range_fp(node: Node):
    """Plan-internal splitter provenance: the canonical form of the subtree
    that computes the splitters (equal subtrees in one plan see the same
    inputs). None (uncanonicalizable subtree) never matches."""
    try:
        return ("plan", _canon(node))
    except _Uncacheable:
        return None


def _elide(node: Node, p: int, an: _Analysis
           ) -> tuple[Node, Partitioning | RangePartitioning | None]:
    if isinstance(node, Scan):
        part = node.partitioning
        if part is not None and part.num_partitions != p:
            part = None
        return node, part
    if isinstance(node, Select):
        c, cp = _elide(node.child, p, an)
        return replace(node, child=c), cp
    if isinstance(node, Project):
        c, cp = _elide(node.child, p, an)
        keep = cp if cp is not None and set(cp.keys) <= set(node.columns) \
            else None
        return replace(node, child=c), keep
    if isinstance(node, Limit):
        c, cp = _elide(node.child, p, an)
        return replace(node, child=c), cp
    if isinstance(node, Repartition):
        c, cp = _elide(node.child, p, an)
        target = Partitioning(node.keys, p, node.seed)
        skip = p == 1 or cp == target
        return replace(node, child=c, skip_shuffle=skip), target
    if isinstance(node, Join):
        l, lp = _elide(node.left, p, an)
        r, rp = _elide(node.right, p, an)
        # inner/left outputs keep true key values on their hash shard;
        # right/full emit zero-filled left keys, so no tag survives them
        inner_ish = node.how in ("inner", "left")

        def out_part(seed):
            if inner_ish:
                return Partitioning(node.on, p, seed)
            return None
        if p == 1:
            out = replace(node, left=l, right=r, skip_left_shuffle=True,
                          skip_right_shuffle=True, shuffle_seed=node.seed)
            return out, out_part(node.seed)
        l_range = range_prefix_matches(lp, node.on)
        r_range = range_prefix_matches(rp, node.on)
        # both sides range-partitioned by the same splitter computation:
        # equal keys are colocated already, skip both shuffles
        if l_range and r_range and lp == rp and lp.fingerprint is not None:
            out = replace(node, left=l, right=r, skip_left_shuffle=True,
                          skip_right_shuffle=True, shuffle_seed=node.seed)
            return out, (lp if inner_ish else None)
        target = None
        if isinstance(lp, Partitioning) and lp.keys == node.on:
            target = lp
        elif isinstance(rp, Partitioning) and rp.keys == node.on:
            target = rp
        if target is not None:
            out = replace(node, left=l, right=r,
                          skip_left_shuffle=lp == target,
                          skip_right_shuffle=rp == target,
                          shuffle_seed=target.seed)
            return out, out_part(target.seed)
        # one side range-partitioned (sort output): keep its placement and
        # range-align the other side to its boundaries (one AllToAll)
        if l_range:
            out = replace(node, left=l, right=r, skip_left_shuffle=True,
                          align="left", align_keys=lp.keys,
                          shuffle_seed=node.seed)
            return out, (lp if inner_ish else None)
        if r_range:
            out = replace(node, left=l, right=r, skip_right_shuffle=True,
                          align="right", align_keys=rp.keys,
                          shuffle_seed=node.seed)
            return out, (rp if inner_ish else None)
        out = replace(node, left=l, right=r, skip_left_shuffle=False,
                      skip_right_shuffle=False, shuffle_seed=node.seed)
        return out, out_part(node.seed)
    if isinstance(node, GroupBy):
        c, cp = _elide(node.child, p, an)
        # any hash partitioning on exactly the group keys colocates each key
        # (seed-independent); so does a range partitioning on a key prefix
        matches = (isinstance(cp, Partitioning) and cp.keys == node.keys) \
            or range_prefix_matches(cp, node.keys)
        if p == 1 or matches:
            out = replace(node, child=c, skip_shuffle=True,
                          shuffle_seed=node.seed)
            return out, cp if matches else Partitioning(node.keys, p,
                                                        node.seed)
        out = replace(node, child=c, shuffle_seed=node.seed)
        return out, Partitioning(node.keys, p, node.seed)
    if isinstance(node, Sort):
        c, cp = _elide(node.child, p, an)
        # an input range-partitioned on a by-prefix, or on an extension of
        # `by`, is placed already: a local sort gives the global order
        el = range_prefix_matches(cp, node.by) or (
            isinstance(cp, RangePartitioning)
            and node.by == cp.keys[:len(node.by)])
        if el:
            return replace(node, child=c, skip_shuffle=True), cp
        out = replace(node, child=c, skip_shuffle=p == 1)
        return out, RangePartitioning(node.by, p, _range_fp(out))
    if isinstance(node, Window):
        c, cp = _elide(node.child, p, an)
        keys = node.by + node.order_by
        # Sort's placement rules; windows keep rows and placement
        el = range_prefix_matches(cp, keys) or (
            isinstance(cp, RangePartitioning)
            and keys == cp.keys[:len(keys)])
        if el:
            return replace(node, child=c, skip_shuffle=True), cp
        out = replace(node, child=c, skip_shuffle=p == 1)
        return out, RangePartitioning(keys, p, _range_fp(out))
    if isinstance(node, SetOp):
        l, lp = _elide(node.left, p, an)
        r, rp = _elide(node.right, p, an)
        keys = tuple(sorted(an.schema(node.left)))  # whole-row hash order
        if p == 1:
            out = replace(node, left=l, right=r, skip_left_shuffle=True,
                          skip_right_shuffle=True)
            return out, Partitioning(keys, p, node.seed)
        target = None
        if isinstance(lp, Partitioning) and lp.keys == keys:
            target = lp
        elif isinstance(rp, Partitioning) and rp.keys == keys:
            target = rp
        elided_seed = target.seed if target is not None else node.seed
        if target is None:
            target = Partitioning(keys, p, node.seed)
        out = replace(node, left=l, right=r, seed=elided_seed,
                      skip_left_shuffle=lp == target,
                      skip_right_shuffle=rp == target)
        return out, Partitioning(keys, p, elided_seed)
    if isinstance(node, Distinct):
        c, cp = _elide(node.child, p, an)
        keys = tuple(sorted(an.schema(node.child)))
        # hash on exactly the whole row colocates duplicates; so does any
        # range partitioning (its keys are a subset of the row)
        matches = (isinstance(cp, Partitioning) and cp.keys == keys) \
            or isinstance(cp, RangePartitioning)
        skip = p == 1 or matches
        part = cp if matches else Partitioning(keys, p, node.seed)
        return replace(node, child=c, skip_shuffle=skip), part
    raise TypeError(node)


# ---------------------------------------------------------------------------
# optimizer pass 5: the cost model (cardinality estimation + sizing)
# ---------------------------------------------------------------------------


class _Estimator:
    """Memoized per-node :class:`~repro_torch.core.stats.TableStats`
    estimate. None = unknown (an input without statistics poisons every
    node above it). System R style: default selectivity for predicates,
    NDV-capped rows for GroupBy/Distinct, containment for joins."""

    def __init__(self, an: _Analysis, input_stats: Sequence):
        self.an = an
        self.inputs = list(input_stats)
        self._memo: dict[int, tuple[Node, object]] = {}

    def stats(self, node: Node) -> S.TableStats | None:
        hit = self._memo.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        out = self._stats(node)
        self._memo[id(node)] = (node, out)
        return out

    def _stats(self, node: Node) -> S.TableStats | None:
        if isinstance(node, Scan):
            if node.slot >= len(self.inputs):
                return None
            return self.inputs[node.slot]
        kids = [self.stats(c) for c in children(node)]
        if isinstance(node, Select):
            cs = kids[0]
            return None if cs is None else S.cap_rows(
                cs, cs.rows * S.DEFAULT_SELECTIVITY)
        if isinstance(node, Project):
            cs = kids[0]
            return None if cs is None else S.cap_rows(cs, cs.rows,
                                                      keep=node.columns)
        if isinstance(node, Limit):
            cs = kids[0]
            return None if cs is None else S.cap_rows(
                cs, min(float(node.n), cs.rows))
        if isinstance(node, (Sort, Repartition, Window)):
            # row- and key-preserving; a Window's result columns carry no
            # column statistics
            cs = kids[0]
            return None if cs is None else S.cap_rows(cs, cs.rows)
        if isinstance(node, GroupBy):
            cs = kids[0]
            if cs is None:
                return None
            ndv = cs.ndv(node.keys)
            rows = cs.rows if ndv is None else min(ndv, cs.rows)
            return S.cap_rows(cs, rows, keep=node.keys)
        if isinstance(node, Join):
            sl, sr = kids
            if sl is None or sr is None:
                return None
            # containment: |L><R| = |L|*|R| / max(ndv_l, ndv_r)
            dl = sl.ndv(node.on)
            dr = sr.ndv(node.on)
            dl = sl.rows if dl is None else dl
            dr = sr.rows if dr is None else dr
            m = sl.rows * sr.rows / max(dl, dr, 1.0)
            rows = {"inner": m, "left": m + sl.rows, "right": m + sr.rows,
                    "full": m + sl.rows + sr.rows}[node.how]
            lsch = self.an.schema(node.left)
            cols = dict(sl.columns)
            for k, c in sr.columns:
                cols[k + JOIN_SUFFIX if k in lsch else k] = c
            for k in node.on:  # equi-key: the smaller NDV survives
                a, b = sl.col(k), sr.col(k)
                if a is not None and b is not None:
                    cols[k] = S.ColumnStats(min(a.ndv, b.ndv), a.lo, a.hi)
            return S.cap_rows(
                S.TableStats(rows=rows, columns=tuple(sorted(cols.items()))),
                rows)
        if isinstance(node, (Union, Intersect, Difference)):
            sl, sr = kids
            if sl is None or sr is None:
                return None
            if isinstance(node, Intersect):
                rows = min(sl.rows, sr.rows)
            elif isinstance(node, Difference) and node.mode == "left":
                rows = sl.rows
            else:  # union / symmetric difference upper bound
                rows = sl.rows + sr.rows
            return S.cap_rows(sl, rows)
        if isinstance(node, Distinct):
            cs = kids[0]
            if cs is None:
                return None
            ndv = cs.ndv(tuple(self.an.schema(node.child)))
            rows = cs.rows if ndv is None else min(ndv, cs.rows)
            return S.cap_rows(cs, rows)
        raise TypeError(node)


def _schema_row_bytes(schema: dict) -> int:
    """Dense wire bytes per row of a schema (``ops_dist._row_bytes`` on
    ColumnSpecs)."""
    total = 0
    for spec in schema.values():
        n = 1
        for d in spec.shape:
            n *= d
        total += n * spec.dtype.itemsize
    return total


def _pick_node_stages(node: Node, est: _Estimator, p: int, bucket,
                      skipped: bool, *sources: Node):
    """The cost pass's shuffle-staging pick from the sized bucket and the
    shuffled input's schema. Keeps an explicit ``stages=``; leaves None
    (the runtime pick, same formula) when the bucket is not known yet."""
    if node.stages is not None or bucket is None or p <= 1 or skipped:
        return node.stages
    rb = max(_schema_row_bytes(est.an.schema(s)) for s in sources)
    return S.pick_stages(p * p * bucket * rb, bucket)


def _apply_costs(node: Node, est: _Estimator, p: int) -> Node:
    """Fill unset capacities and resolve ``auto`` strategies from estimates.

    Every capacity this pass writes is marked ``sized=True`` on its node:
    an overflow of a sized plan means the estimate was wrong and re-runs
    the plan once at safe capacities. A single-shard mesh is never sized.
    """
    kids = [_apply_costs(c, est, p) for c in children(node)]
    if isinstance(node, GroupBy):
        cs = est.stats(node.child)  # memo holds the pre-costing child
        strategy, bucket, sized = node.strategy, node.bucket_capacity, \
            node.sized
        # None = key cardinality unknown (no stats, or an unsketched key)
        ndv = cs.ndv(node.keys) if cs is not None else None
        if strategy == "auto":
            # two-phase ships p * ndv partial rows, raw shuffle every row:
            # the smaller wire volume wins; missing information takes the
            # two_phase fallback
            strategy = "two_phase" if ndv is None or p * ndv <= cs.rows \
                else "shuffle"
        if (bucket is None and cs is not None and p > 1
                and not node.skip_shuffle):
            src = cs.shard_rows(p)
            if strategy == "two_phase" and ndv is not None:
                src = min(src, ndv)
            bucket = S.size_bucket(src, p)
            sized = True
        stages = _pick_node_stages(node, est, p, bucket, node.skip_shuffle,
                                   node.child)
        return replace(node, child=kids[0], strategy=strategy,
                       bucket_capacity=bucket, sized=sized, stages=stages)
    if isinstance(node, Repartition):
        cs = est.stats(node.child)
        bucket, sized = node.bucket_capacity, node.sized
        if (bucket is None and cs is not None and p > 1
                and not node.skip_shuffle):
            bucket = S.size_bucket(cs.shard_rows(p), p)
            sized = True
        stages = _pick_node_stages(node, est, p, bucket, node.skip_shuffle,
                                   node.child)
        return replace(node, child=kids[0], bucket_capacity=bucket,
                       sized=sized, stages=stages)
    if isinstance(node, (Sort, Window)):
        cs = est.stats(node.child)
        bucket, sized = node.bucket_capacity, node.sized
        if (bucket is None and cs is not None and p > 1
                and not node.skip_shuffle):
            # sampled splitters miss true quantiles: widen the mean
            bucket = S.size_bucket(cs.shard_rows(p), p,
                                   factor=S.RANGE_SIZING_FACTOR)
            sized = True
        stages = _pick_node_stages(node, est, p, bucket, node.skip_shuffle,
                                   node.child)
        return replace(node, child=kids[0], bucket_capacity=bucket,
                       sized=sized, stages=stages)
    if isinstance(node, Join):
        sl, sr = est.stats(node.left), est.stats(node.right)
        js = est.stats(node)
        bucket, out = node.bucket_capacity, node.out_capacity
        sized, out_sized = node.sized, node.out_sized
        both_skipped = node.skip_left_shuffle and node.skip_right_shuffle
        if p > 1 and sl is not None and sr is not None:
            # a range-aligned join keeps its runtime capacity-bump bucket
            # (a whole source shard may target one anchor range)
            if bucket is None and node.align is None and not both_skipped:
                src = max(
                    0.0 if node.skip_left_shuffle else sl.shard_rows(p),
                    0.0 if node.skip_right_shuffle else sr.shard_rows(p))
                bucket = S.size_bucket(src, p)
                sized = True
            if out is None and js is not None:
                # sized by the estimated match count; the join's truncation
                # counter makes an underestimate loud
                out = S.size_output(js.rows, p,
                                    factor=S.JOIN_OUT_SIZING_FACTOR)
                out_sized = True
        stages = _pick_node_stages(node, est, p, bucket, both_skipped,
                                   node.left, node.right)
        return replace(node, left=kids[0], right=kids[1],
                       bucket_capacity=bucket, out_capacity=out,
                       sized=sized, out_sized=out_sized, stages=stages)
    if isinstance(node, SetOp):
        sl, sr = est.stats(node.left), est.stats(node.right)
        bucket, sized = node.bucket_capacity, node.sized
        both_skipped = node.skip_left_shuffle and node.skip_right_shuffle
        if (bucket is None and p > 1 and sl is not None and sr is not None
                and not both_skipped):
            src = max(0.0 if node.skip_left_shuffle else sl.shard_rows(p),
                      0.0 if node.skip_right_shuffle else sr.shard_rows(p))
            bucket = S.size_bucket(src, p)
            sized = True
        stages = _pick_node_stages(node, est, p, bucket, both_skipped,
                                   node.left, node.right)
        return replace(node, left=kids[0], right=kids[1],
                       bucket_capacity=bucket, sized=sized, stages=stages)
    if isinstance(node, Distinct):
        cs = est.stats(node.child)
        bucket, sized = node.bucket_capacity, node.sized
        if (bucket is None and cs is not None and p > 1
                and not node.skip_shuffle):
            bucket = S.size_bucket(cs.shard_rows(p), p)
            sized = True
        stages = _pick_node_stages(node, est, p, bucket, node.skip_shuffle,
                                   node.child)
        return replace(node, child=kids[0], bucket_capacity=bucket,
                       sized=sized, stages=stages)
    return _with_children(node, kids)


def apply_cost_model(plan: Node, input_schemas: Sequence[dict],
                     num_shards: int, input_stats: Sequence | None = None
                     ) -> Node:
    """The cost pass alone (strategy resolution + capacity sizing): the
    eager one-node plans run it without the logical rewrites."""
    an = _Analysis(input_schemas)
    est = _Estimator(an, input_stats if input_stats is not None
                     else [None] * len(input_schemas))
    return _apply_costs(plan, est, num_shards)


def estimate_output_stats(plan: Node, input_schemas: Sequence[dict],
                          input_stats: Sequence | None
                          ) -> S.TableStats | None:
    """The estimator's TableStats for the plan's result (None = unknown),
    attached to materialized DistTables so chained pipelines stay
    cost-sized without re-analyzing intermediates."""
    if input_stats is None or not any(s is not None for s in input_stats):
        return None
    an = _Analysis(input_schemas)
    return _Estimator(an, input_stats).stats(plan)


def _node_cost_sized(node: Node) -> bool:
    return getattr(node, "sized", False) or getattr(node, "out_sized", False)


def degrade_shuffles(plan: Node) -> Node:
    """The ``mono-shuffle`` recovery rung: the same plan with every
    exchange pinned to one monolithic AllToAll (``stages=1``, no ring):
    the same bits by the staging contract, but none of the pipelined-chunk
    machinery a ``shuffle.chunk`` fault lives in. ``stages=None`` (cost
    pick) is pinned too: the degraded run must not re-pick a staged
    depth."""
    node = _with_children(plan, [degrade_shuffles(c)
                                 for c in children(plan)])
    names = {f.name for f in dataclasses.fields(node)}
    upd = {}
    if "stages" in names and node.stages != 1:
        upd["stages"] = 1
    if "shuffle_mode" in names and node.shuffle_mode != "alltoall":
        upd["shuffle_mode"] = "alltoall"
    return replace(node, **upd) if upd else node


def plan_cost_sized(plan: Node) -> bool:
    """True when any capacity in the plan came from a cardinality estimate:
    then a runtime overflow warrants the safe re-run."""
    if _node_cost_sized(plan):
        return True
    return any(plan_cost_sized(c) for c in children(plan))


def _stats_arity(node: Node) -> int:
    """How many ShuffleStats entries :func:`execute_plan` emits for ``node``."""
    if isinstance(node, (Join, SetOp)):
        return 2
    if isinstance(node, (Limit, Repartition, GroupBy, Sort, Window,
                         Distinct)):
        return 1
    return 0


def cost_sized_stats_mask(plan: Node) -> list[bool]:
    """Per-ShuffleStats flag: did this entry's capacities come from
    estimates? Mirrors :func:`execute_plan`'s depth-first post-order stats
    (children left to right, then the node's own entries), so an overflow
    of a user-set capacity never triggers the re-run."""
    mask: list[bool] = []

    def walk(node: Node):
        for c in children(node):
            walk(c)
        mask.extend([_node_cost_sized(node)] * _stats_arity(node))

    walk(plan)
    return mask


def optimize_with_partitioning(
        plan: Node, input_schemas: Sequence[dict], num_shards: int,
        input_stats: Sequence | None = None, *,
        verify: bool | None = None,
) -> tuple[Node, Partitioning | RangePartitioning | None]:
    """All passes: probe -> predicate pushdown -> limit pushdown ->
    projection pushdown -> shuffle elision -> cost model. Pure plan to
    plan; also returns the result's static placement.

    ``verify`` runs ``repro_torch.core.verify`` over the (logical,
    optimized) pair and raises ``PlanVerificationError`` on any invariant
    violation; ``None`` defers to the ``REPRO_VERIFY_PLANS`` env gate
    (on under pytest). The verifier re-optimizes with ``verify=False``
    for its idempotence rule, so this never recurses."""
    logical = plan
    an = _Analysis(input_schemas)
    plan = _annotate_selects(plan, an)
    plan = _pushdown_selects(plan, an)
    plan = _pushdown_limits(plan)
    # to a fixpoint: a Project that a consumer narrowed in one pass lets the
    # next push its columns further down (a window's input). The reference
    # runs one pass, and its optimize() is then not idempotent on such plans
    # (plan_fuzz seed 20260807, plan 44); where one pass reaches the
    # fixpoint, both packages give the same plan.
    while (pushed := _pushdown_projections(plan, None, an)) != plan:
        plan = pushed
    plan, part = _elide(plan, num_shards, an)
    est = _Estimator(an, input_stats if input_stats is not None
                     else [None] * len(input_schemas))
    plan = _apply_costs(plan, est, num_shards)
    if verify is None or verify:
        from repro_torch.core import verify as V  # deferred: verify imports us

        if verify or V.verification_enabled():
            V.verify_or_raise(logical, plan, input_schemas, num_shards,
                              input_stats)
    return plan, part


def optimize(plan: Node, input_schemas: Sequence[dict], num_shards: int,
             input_stats: Sequence | None = None, *,
             verify: bool | None = None) -> Node:
    return optimize_with_partitioning(plan, input_schemas, num_shards,
                                      input_stats, verify=verify)[0]


def output_partitioning(plan: Node, input_schemas: Sequence[dict],
                        num_shards: int
                        ) -> Partitioning | RangePartitioning | None:
    """Static placement of the plan's result (tags the output DistTable)."""
    _, part = _elide(plan, num_shards, _Analysis(input_schemas))
    return part


# ---------------------------------------------------------------------------
# canonical cache key
# ---------------------------------------------------------------------------


class _Uncacheable(Exception):
    pass


def canonical_key(plan: Node):
    """Hashable canonical form of the plan, or None when any Select lacks a
    user key (callables cannot be canonicalized)."""
    try:
        return _canon(plan)
    except _Uncacheable:
        return None


def identity_key(plan: Node):
    """Content key for plans :func:`canonical_key` rejects: a keyless
    predicate is keyed by its ``__code__`` object (compared by content)
    plus the values of its closure cells, defaults, keyword defaults and
    every global its code names (recursively through nested code). None
    when any keyless callable cannot be content-keyed: an opaque callable,
    or a captured or referenced value that is unhashable or a tensor.

    The key holds those values, so rebinding a global the predicate reads
    changes the key. A captured object that hashes by identity but carries
    mutable state compares equal to itself after in-place mutation: such
    predicates must mutate by rebinding or carry an explicit ``key=``.
    """
    try:
        return _canon(plan, identity=True)
    except _Uncacheable:
        return None


def _value_token(v):
    """Content token for a value a keyless predicate depends on. Unhashable
    values reject caching, and so do tensors: they hash by identity while
    their contents change in place (as the reference's ndarrays, which are
    unhashable)."""
    if isinstance(v, torch.Tensor):
        raise _Uncacheable
    try:
        hash(v)
    except TypeError:
        raise _Uncacheable from None
    return (type(v), v)


def _referenced_names(code) -> set:
    """Every name ``code`` (or a code object nested in its constants) can
    look up as a global. Over-approximate: ``co_names`` also holds
    attribute names, which at worst add key components."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _referenced_names(const)
    return names


def _identity_of(predicate):
    """Hashable behaviour content of a keyless callable (see
    :func:`identity_key`)."""
    code = getattr(predicate, "__code__", None)
    if code is None:  # opaque callable: no visible behaviour content
        raise _Uncacheable
    try:
        cells = tuple(_value_token(c.cell_contents)
                      for c in getattr(predicate, "__closure__", None) or ())
    except ValueError:  # unfilled cell (self-referential def)
        raise _Uncacheable from None
    defaults = tuple(_value_token(d)
                     for d in getattr(predicate, "__defaults__", None) or ())
    kwdefaults = tuple(
        (n, _value_token(v)) for n, v in
        sorted((getattr(predicate, "__kwdefaults__", None) or {}).items()))
    gl = getattr(predicate, "__globals__", None) or {}
    globals_used = tuple(
        (n, _value_token(gl[n])) if n in gl else (n, "@absent")
        for n in sorted(_referenced_names(code)))
    return ("@code", code, cells, defaults, kwdefaults, globals_used)


def _predicate_fingerprint(predicate):
    """Structural identity of a predicate's code: two predicates given the
    same user key but different logic diverge. Captured values are not
    seen here; the user key must cover them."""
    code = getattr(predicate, "__code__", None)
    if code is None:
        return None
    return (code.co_code, tuple(map(str, code.co_consts)), code.co_names)


def _canon(node: Node, identity: bool = False):
    name = type(node).__name__
    if isinstance(node, Scan):
        return (name, node.slot)
    if isinstance(node, Select):
        if node.key is None:
            if not identity:
                raise _Uncacheable
            key = _identity_of(node.predicate)
        else:
            key = node.key
        return (name, key, _predicate_fingerprint(node.predicate),
                node.columns, _canon(node.child, identity))
    vals = []
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, Node) or callable(v):
            continue
        # staging knobs at their identity values keep the unstaged key
        if f.name == "stages" and v in (None, 1):
            continue
        if f.name == "shuffle_mode" and v == "alltoall":
            continue
        vals.append((f.name, v))
    return (name, tuple(vals)) + tuple(_canon(c, identity)
                                       for c in children(node))


# ---------------------------------------------------------------------------
# executor: the plan over the virtual mesh
# ---------------------------------------------------------------------------

Shards = list[Table]


def execute_plan(plan: Node, tables: Sequence[Shards], *, mesh: VirtualMesh,
                 report: list | None = None,
                 safe_capacity: bool = False) -> tuple[Shards, tuple]:
    """Evaluate the plan over the per-shard Tables of each input.

    Returns ``(output shards, stats)``: one ShuffleStats per potential
    shuffle in depth-first plan order (zeros where elided).

    ``safe_capacity`` is the overflow re-run: every capacity the plan left
    unset takes the bound no placement can exceed (a send bucket of the
    whole source shard) instead of the ``FALLBACK_SLACK`` default.
    Capacities the user set are kept in both modes (their overflow shows
    in the stats).
    """
    ex = _Executor(tables, mesh, report, safe_capacity)
    out = ex.run(plan)
    return out, tuple(ex.stats)


class _Executor:
    """One run of :func:`execute_plan`. A class, not nested recursive
    closures: those form a reference cycle that would keep every
    intermediate shard alive after the run until the garbage collector
    finds it."""

    def __init__(self, tables: Sequence[Shards], mesh: VirtualMesh,
                 report: list | None, safe_capacity: bool):
        self.tables = tables
        self.mesh = mesh
        self.p = mesh.axis_size
        self.report = report
        self.safe_capacity = safe_capacity
        self.stats: list = []
        self.memo: dict[int, Shards] = {}

    def default(self, c: int, slack: float = S.FALLBACK_SLACK) -> int:
        if self.safe_capacity:
            return c
        return default_bucket_capacity(c, self.p, slack)

    def cap(self, t: Shards, bucket: int | None,
            slack: float = S.FALLBACK_SLACK) -> int:
        return bucket if bucket is not None else self.default(t[0].capacity,
                                                              slack)

    def run(self, node: Node) -> Shards:
        hit = self.memo.get(id(node))
        if hit is None and isinstance(node, Scan):
            hit = self.memo[id(node)] = self._exec(node)
        elif hit is None:
            # the inputs first, so that each node's span holds its own work
            for child in children(node):
                self.run(child)
            with trace.span(_OP_SPANS.get(type(node), "repro_torch.op")):
                hit = self.memo[id(node)] = self._exec(node)
        return hit

    def _exec(self, node: Node) -> Shards:
        if isinstance(node, Scan):
            return list(self.tables[node.slot])
        if isinstance(node, Select):
            return [L.select(s, node.predicate) for s in self.run(node.child)]
        if isinstance(node, Project):
            return [L.project(s, list(node.columns))
                    for s in self.run(node.child)]
        if isinstance(node, Limit):
            out, st = D.dist_limit(self.run(node.child), node.n,
                                   mesh=self.mesh, report=self.report)
        elif isinstance(node, Repartition):
            t = self.run(node.child)
            out, st = D.dist_repartition_by(
                t, list(node.keys), mesh=self.mesh,
                bucket_capacity=self.cap(t, node.bucket_capacity),
                seed=node.seed, skip_shuffle=node.skip_shuffle,
                report=self.report,
                stages=node.stages, shuffle_mode=node.shuffle_mode)
        elif isinstance(node, Join):
            lt, rt = self.run(node.left), self.run(node.right)
            cb, out_capacity = _join_capacities(
                node, lt[0].capacity, rt[0].capacity, self.default, self.p)
            out, st = D.dist_join(
                lt, rt, list(node.on), mesh=self.mesh,
                bucket_capacity=cb, how=node.how, algorithm=node.algorithm,
                out_capacity=out_capacity, seed=node.seed,
                shuffle_seed=node.shuffle_seed,
                skip_left_shuffle=node.skip_left_shuffle,
                skip_right_shuffle=node.skip_right_shuffle,
                align=node.align, align_keys=node.align_keys,
                count_truncation=node.out_sized,
                report=self.report, stages=node.stages,
                shuffle_mode=node.shuffle_mode)
        elif isinstance(node, GroupBy):
            t = self.run(node.child)
            out, st = D.dist_groupby(
                t, list(node.keys), node.pairs, mesh=self.mesh,
                bucket_capacity=self.cap(t, node.bucket_capacity),
                strategy=_strategy(node),
                partial_capacity=node.partial_capacity,
                out_capacity=node.out_capacity, seed=node.seed,
                shuffle_seed=node.shuffle_seed,
                skip_shuffle=node.skip_shuffle, report=self.report,
                stages=node.stages, shuffle_mode=node.shuffle_mode)
        elif isinstance(node, Sort):
            t = self.run(node.child)
            out, st = D.dist_sort(
                t, list(node.by), mesh=self.mesh,
                bucket_capacity=self.cap(t, node.bucket_capacity,
                                         slack=_RANGE_SLACK),
                samples_per_shard=node.samples_per_shard,
                skip_shuffle=node.skip_shuffle, report=self.report,
                stages=node.stages, shuffle_mode=node.shuffle_mode)
        elif isinstance(node, Window):
            t = self.run(node.child)
            out, st = D.dist_window(
                t, list(node.by), node.funcs, mesh=self.mesh,
                order_by=list(node.order_by),
                bucket_capacity=self.cap(t, node.bucket_capacity,
                                         slack=_RANGE_SLACK),
                samples_per_shard=node.samples_per_shard,
                skip_shuffle=node.skip_shuffle, report=self.report,
                stages=node.stages, shuffle_mode=node.shuffle_mode)
        elif isinstance(node, SetOp):
            a, b = self.run(node.left), self.run(node.right)
            cb = node.bucket_capacity or max(self.cap(a, None),
                                             self.cap(b, None))
            kw = dict(mesh=self.mesh, bucket_capacity=cb, seed=node.seed,
                      skip_left_shuffle=node.skip_left_shuffle,
                      skip_right_shuffle=node.skip_right_shuffle,
                      report=self.report, stages=node.stages,
                      shuffle_mode=node.shuffle_mode)
            if isinstance(node, Union):
                out, st = D.dist_union(a, b, **kw)
            elif isinstance(node, Intersect):
                out, st = D.dist_intersect(a, b, **kw)
            else:
                out, st = D.dist_difference(a, b, mode=node.mode, **kw)
        elif isinstance(node, Distinct):
            t = self.run(node.child)
            out, st = D.dist_distinct(
                t, mesh=self.mesh,
                bucket_capacity=self.cap(t, node.bucket_capacity),
                seed=node.seed, skip_shuffle=node.skip_shuffle,
                report=self.report, stages=node.stages,
                shuffle_mode=node.shuffle_mode)
        else:
            raise TypeError(node)
        self.stats.extend(st)
        return out


# each operator's span (``core/trace.py``): repro_torch.op.join, ...
_OP_SPANS = {cls: "repro_torch.op." + cls.__name__.lower()
             for cls in (Select, Project, Limit, Repartition, Join, GroupBy,
                         Sort, Window, Union, Intersect, Difference, Distinct)}


# the no-stats bucket of the range-partitioned operators (Sort, Window):
# sampled splitters miss true quantiles, so the slack widens
_RANGE_SLACK = S.FALLBACK_SLACK * S.SORT_SLACK_FACTOR


def _strategy(node: GroupBy) -> str:
    """"auto" is resolved by the cost pass; a plan run without it gets the
    documented fallback."""
    return "two_phase" if node.strategy == "auto" else node.strategy


def _join_capacities(node: Join, c_left: int, c_right: int, cap, p: int
                     ) -> tuple[int, int]:
    """(send bucket, out_capacity) of a join whose inputs hold ``c_left``
    and ``c_right`` rows a shard; ``cap(c)`` is the executor's default
    bucket for capacity c."""
    cb = node.bucket_capacity or max(cap(c_left), cap(c_right))
    if node.bucket_capacity is None and node.align is not None:
        # range alignment is skew-prone: all of a source shard's rows may
        # target one anchor range, so the bucket covers the shuffled
        # side's whole capacity
        cb = max(cb, c_right if node.align == "left" else c_left)
    # default output budget = what a fully shuffled join gets (each operand
    # lands at p * cb rows), so an elided shuffle never shrinks it
    out_capacity = node.out_capacity
    if out_capacity is None:
        out_capacity = int(S.JOIN_OUT_FACTOR * p * cb)
    return cb, out_capacity


# ---------------------------------------------------------------------------
# static shuffle report
# ---------------------------------------------------------------------------


def _partial_schema(schema: dict, keys: Sequence[str], pairs) -> dict:
    """Schema of ``ops_agg.partial_groupby``'s output: the keys, then one
    column per algebraic partial (count int32, sumsq float32, the others
    the input column's type)."""
    out = {k: schema[k] for k in keys}
    for col, op in pairs:
        for prim in A._DECOMP[op]:
            name = A._prim_name(col, prim)
            if prim == "count":
                out[name] = ColumnSpec((), torch.int32)
            elif prim == "sumsq":
                out[name] = ColumnSpec(schema[col].shape, torch.float32)
            else:
                out[name] = schema[col]
    return out


def _record(label: str, schema: dict, bucket: int, skip: bool, p: int,
            node: Node) -> dict:
    """The record ``ops_dist._shuffle`` appends to ``report`` for one of
    ``node``'s shuffles."""
    rb = _schema_row_bytes(schema)
    stages = node.stages
    if stages is None and not skip:
        stages = S.pick_stages(p * p * bucket * rb, bucket)
    return {"op": label, "elided": bool(skip), "row_bytes": rb,
            "bucket": 0 if skip else bucket,
            "wire_bytes": 0 if skip else p * p * bucket * rb,
            "stages": 0 if skip else stages, "mode": node.shuffle_mode,
            "columns": len(schema),
            "carrier": any(schema[k].dtype.itemsize == 4
                           for k in sorted(schema))}


def shuffle_report(plan: Node, input_schemas: Sequence[dict],
                   input_capacities: Sequence[int], num_shards: int
                   ) -> list[dict]:
    """The records :func:`execute_plan` appends to ``report`` for ``plan``
    (one per potential shuffle, in execution order), derived from the plan,
    the input schemas and the inputs' per-shard capacities alone: nothing
    runs. Each node's output capacity follows its operator's rule (a
    shuffle lands ``p * bucket`` slots, a join ``out_capacity``, groupby's
    and the window's local sort pad an empty shard to one row)."""
    p = num_shards
    an = _Analysis(input_schemas)
    records: list[dict] = []
    memo: dict[int, int] = {}

    def default(c: int, slack: float = S.FALLBACK_SLACK) -> int:
        return default_bucket_capacity(c, p, slack)

    def cap(c: int, bucket: int | None, slack: float = S.FALLBACK_SLACK):
        return bucket if bucket is not None else default(c, slack)

    def slots(c: int, limit: int | None) -> int:
        c = max(c, 1)  # ops_local.pad_empty
        return c if limit is None else min(c, limit)

    def run(node: Node) -> int:
        if id(node) not in memo:
            memo[id(node)] = _walk(node)
        return memo[id(node)]

    def _walk(node: Node) -> int:
        if isinstance(node, Scan):
            return input_capacities[node.slot]
        if isinstance(node, (Select, Project)):
            return run(node.child)
        sch = an.schema(children(node)[0])
        if isinstance(node, Limit):
            c = run(node.child)
            records.append({"op": "limit", "elided": True,
                            "row_bytes": _schema_row_bytes(sch), "bucket": 0,
                            "wire_bytes": 0})
            return min(node.n, c)
        if isinstance(node, Repartition):
            c = run(node.child)
            b = cap(c, node.bucket_capacity)
            records.append(_record("repartition", sch, b, node.skip_shuffle,
                                   p, node))
            return c if node.skip_shuffle else p * b
        if isinstance(node, Join):
            cl, cr = run(node.left), run(node.right)
            cb, out = _join_capacities(node, cl, cr, default, p)
            for side, skip in (("left", node.skip_left_shuffle),
                               ("right", node.skip_right_shuffle)):
                child = node.left if side == "left" else node.right
                records.append(_record(f"join.{side}", an.schema(child), cb,
                                       skip, p, node))
            return out
        if isinstance(node, GroupBy):
            c = run(node.child)
            b = cap(c, node.bucket_capacity)
            strategy = _strategy(node)
            if node.skip_shuffle:
                records.append(_record(f"groupby.{strategy}", sch, b, True, p,
                                       node))
                return slots(c, node.out_capacity)
            if strategy == "two_phase":
                sch = _partial_schema(sch, node.keys, node.pairs)
            records.append(_record(f"groupby.{strategy}", sch, b, False, p,
                                   node))
            return slots(p * b, node.out_capacity)
        if isinstance(node, (Sort, Window)):
            c = run(node.child)
            b = cap(c, node.bucket_capacity, _RANGE_SLACK)
            label = "sort" if isinstance(node, Sort) else "window"
            records.append(_record(label, sch, b, node.skip_shuffle, p,
                                   node))
            c = c if node.skip_shuffle else p * b
            return c if isinstance(node, Sort) else max(c, 1)
        if isinstance(node, SetOp):
            ca, cb_ = run(node.left), run(node.right)
            b = node.bucket_capacity or max(default(ca), default(cb_))
            label = type(node).__name__.lower()
            out = 0
            for side, skip, c in (("left", node.skip_left_shuffle, ca),
                                  ("right", node.skip_right_shuffle, cb_)):
                child = node.left if side == "left" else node.right
                records.append(_record(f"{label}.{side}", an.schema(child), b,
                                       skip, p, node))
                out += c if skip else p * b
            return out
        if isinstance(node, Distinct):
            c = run(node.child)
            b = cap(c, node.bucket_capacity)
            records.append(_record("distinct", sch, b, node.skip_shuffle, p,
                                   node))
            return c if node.skip_shuffle else p * b
        raise TypeError(node)

    run(plan)
    return records


# ---------------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------------


def _shuffle_word(skip: bool) -> str:
    return "elided" if skip else "alltoall"


def _recovery_rungs(node: Node) -> list[str]:
    """The degradation rungs that apply to ``node`` should its run fail:
    the ``recovery=`` annotation of :func:`explain`."""
    rungs = []
    if isinstance(node, (Join, SetOp)):
        live = not (node.skip_left_shuffle and node.skip_right_shuffle)
    else:
        live = not getattr(node, "skip_shuffle", True)
    if live and any(f.name == "stages" for f in dataclasses.fields(node)):
        rungs.append("mono-alltoall")
    if isinstance(node, (GroupBy, Window)):
        rungs.append("oracle-kernel")
    if _node_cost_sized(node):
        rungs.append("safe-capacity")
    return rungs


def explain(plan: Node, input_schemas: Sequence[dict] | None = None,
            input_stats: Sequence | None = None, *,
            recovery: bool = False) -> str:
    """Human-readable plan tree: one node per line, with every potential
    shuffle marked ``alltoall`` or ``elided``.

    With ``input_schemas`` and ``input_stats`` every node also shows its
    estimated output rows (``~rows=``), and nodes whose capacities the cost
    model filled in show them (``bucket=``, ``out=``, ``cost-sized``).
    ``recovery=True`` appends each node's degradation rungs
    (``recovery=mono-alltoall+oracle-kernel+safe-capacity``): how the
    retry ladder would run the node again after a failure (see
    ``core/faults.py``).
    """
    est = None
    if input_schemas is not None and input_stats is not None \
            and any(s is not None for s in input_stats):
        est = _Estimator(_Analysis(input_schemas), input_stats)
    lines: list[str] = []

    def notes(node: Node) -> str:
        parts = []
        bucket = getattr(node, "bucket_capacity", None)
        if bucket is not None and not isinstance(node, (Select, Project,
                                                        Limit, Scan)):
            parts.append(f"bucket={bucket}")
        if isinstance(node, Join) and node.out_capacity is not None:
            parts.append(f"out={node.out_capacity}")
        stages = getattr(node, "stages", None)
        if stages is not None:
            parts.append(f"stages={stages}")
        if getattr(node, "shuffle_mode", "alltoall") != "alltoall":
            parts.append(f"mode={node.shuffle_mode}")
        if _node_cost_sized(node):
            parts.append("cost-sized")
        if est is not None:
            s = est.stats(node)
            if s is not None:
                parts.append(f"~rows={int(round(s.rows))}")
        if recovery:
            rungs = _recovery_rungs(node)
            if rungs:
                parts.append("recovery=" + "+".join(rungs))
        return (", " + ", ".join(parts)) if parts else ""

    def walk(node: Node, depth: int):
        pad = "  " * depth
        if isinstance(node, Scan):
            part = ""
            pt = node.partitioning
            if isinstance(pt, RangePartitioning):
                part = f", partitioned=range{pt.keys}/{pt.num_partitions}"
            elif pt is not None:
                part = (f", partitioned=hash{pt.keys}%"
                        f"{pt.num_partitions}@seed{pt.seed}")
            txt = f"Scan(slot={node.slot}{part}"
        elif isinstance(node, Select):
            txt = f"Select(key={node.key!r}, columns={node.columns}"
        elif isinstance(node, Project):
            txt = f"Project(columns={node.columns}"
        elif isinstance(node, Limit):
            txt = f"Limit(n={node.n}"
        elif isinstance(node, Repartition):
            txt = (f"Repartition(keys={node.keys}, seed={node.seed}, "
                   f"shuffle={_shuffle_word(node.skip_shuffle)}")
        elif isinstance(node, Join):
            extra = ""
            if node.align is not None:
                extra = f", align={node.align}{node.align_keys}"
            txt = (f"Join(on={node.on}, how={node.how}, "
                   f"algorithm={node.algorithm}, "
                   f"left={_shuffle_word(node.skip_left_shuffle)}, "
                   f"right={_shuffle_word(node.skip_right_shuffle)}{extra}")
        elif isinstance(node, GroupBy):
            txt = (f"GroupBy(keys={node.keys}, aggs={node.pairs}, "
                   f"strategy={node.strategy}, "
                   f"shuffle={_shuffle_word(node.skip_shuffle)}")
        elif isinstance(node, Sort):
            txt = (f"Sort(by={node.by}, "
                   f"shuffle={_shuffle_word(node.skip_shuffle)}")
        elif isinstance(node, Window):
            fn_names = tuple(A.window_output_name(fn, col, off)
                             for fn, col, off in node.funcs)
            txt = (f"Window(by={node.by}, order_by={node.order_by}, "
                   f"funcs={fn_names}, "
                   f"shuffle={_shuffle_word(node.skip_shuffle)}")
        elif isinstance(node, SetOp):
            extra = f", mode={node.mode}" if isinstance(node, Difference) \
                else ""
            txt = (f"{type(node).__name__}("
                   f"left={_shuffle_word(node.skip_left_shuffle)}, "
                   f"right={_shuffle_word(node.skip_right_shuffle)}{extra}")
        elif isinstance(node, Distinct):
            txt = f"Distinct(shuffle={_shuffle_word(node.skip_shuffle)}"
        else:
            txt = f"{type(node).__name__}("
        lines.append(f"{pad}{txt}{notes(node)})")
        for c in children(node):
            walk(c, depth + 1)

    walk(plan, 0)
    return "\n".join(lines)
