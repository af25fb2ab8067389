"""Static plan verifier + dynamic collective auditor (the port of
``repro.core.verify``).

The optimizer (``core/plan.py``) applies five interacting rewrite passes
(predicate/projection/limit pushdown, provenance-tag shuffle elision,
cost sizing + stage picking) and the plan cache replays whatever they
produce. This module re-checks that a rewritten plan is still the plan
the user wrote: a rule registry of static invariants run over every
(logical, optimized) pair, failing loudly (``PlanVerificationError``) on
violation.

Registered rules:

- ``schema``        : optimized output schema == logical output schema
                      (names, order, dtypes, trailing shapes).
- ``partitioning``  : every ``skip_*_shuffle`` elision is justified by a
                      matching hash/Range provenance tag derived
                      INDEPENDENTLY from the optimized tree (including
                      fingerprint provenance for range-range joins, and
                      a forged-fingerprint check across Scan tags).
- ``pushdown``      : rewrites never orphan a column reference: Select
                      predicates, projections, join keys, groupby keys,
                      sort/window keys all resolve against their input;
                      a Limit's non-Project descendant multiset is
                      unchanged (Project is the only node a Limit may
                      legally cross).
- ``cost-sizing``   : ``sized``/``out_sized`` marks imply estimates were
                      present AND the capacity is actually set; ``auto``
                      strategies are resolved; stage counts lie in
                      ``[1, MAX_SHUFFLE_STAGES]`` and never exceed the
                      bucket; ``cost_sized_stats_mask`` arity matches an
                      independently-maintained stats-arity table.
- ``idempotence``   : ``optimize(optimize(p))`` is a no-op and preserves
                      ``canonical_key`` (cache-key stability).

Verification is wired into ``optimize()`` behind the
``REPRO_VERIFY_PLANS`` env var (on under pytest via
``tests/conftest.py``); ``LazyFrame.explain(verify=True)`` appends the
findings, and ``DistContext.cache_stats()`` reports run/finding
counters. The findings' text is the reference's, character for
character (dtypes print by their numpy names).

The dynamic half, :func:`audit_collectives`, runs the frame's optimized
plan once and compares the collectives the virtual mesh counted
(``VirtualMesh.counts``) with the static accounting
:func:`expected_collectives` derives from the run's ``report`` records.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from dataclasses import dataclass
from typing import Callable, Sequence

from repro_torch.core import plan as PL
from repro_torch.core import stats as S
from repro_torch.core.repartition import (Partitioning, RangePartitioning,
                                          _chunk_bounds, range_prefix_matches)

ENV_FLAG = "REPRO_VERIFY_PLANS"


def verification_enabled() -> bool:
    """The ``REPRO_VERIFY_PLANS`` gate (default off; conftest turns it on
    for the test suite so every ``optimize()`` is checked)."""
    return os.environ.get(ENV_FLAG, "0").strip().lower() \
        not in ("", "0", "false", "off", "no")


# ---------------------------------------------------------------------------
# findings + counters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One invariant violation: the rule that fired, the offending node
    (short head form), and what broke."""

    rule: str
    node: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.node}: {self.message}"


class PlanVerificationError(AssertionError):
    """Raised by :func:`verify_or_raise`; carries the findings list."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        lines = "\n".join(f"  - {f}" for f in self.findings)
        super().__init__(
            f"plan verification failed "
            f"({len(self.findings)} finding(s)):\n{lines}")


_counters_lock = threading.Lock()
_counters = {"verify_runs": 0, "verify_findings": 0}


def counter_snapshot() -> dict:
    """Verifier counters (merged into ``DistContext.cache_stats()``)."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        for k in _counters:
            _counters[k] = 0


def _head(node) -> str:
    """Short display form of a node for findings: type + first key field."""
    name = type(node).__name__
    for attr in ("keys", "on", "by", "columns", "n", "slot"):
        v = getattr(node, attr, None)
        if v is not None:
            return f"{name}({attr}={v!r})"
    return name


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------


@dataclass
class _Check:
    """Everything a rule sees: the pre/post plans plus planning inputs."""

    logical: PL.Node
    optimized: PL.Node
    schemas: list
    p: int
    stats: list | None
    findings: list

    def add(self, rule: str, node, message: str) -> None:
        self.findings.append(Finding(rule, _head(node), message))


RULES: list[tuple[str, Callable]] = []


def rule(name: str):
    def deco(fn):
        RULES.append((name, fn))
        return fn
    return deco


# -- rule 1: schema preservation --------------------------------------------


@rule("schema")
def _check_schema(v: _Check) -> None:
    an = PL._Analysis(v.schemas)
    want = an.schema(v.logical)
    got = an.schema(v.optimized)
    if tuple(want) != tuple(got):
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        v.add("schema", v.optimized,
              f"output columns changed: missing={missing} extra={extra} "
              f"order {tuple(want)} -> {tuple(got)}")
        return
    for k in want:
        a, b = want[k], got[k]
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            v.add("schema", v.optimized,
                  f"column {k!r} changed: {a.shape}/{_dtype(a)} -> "
                  f"{b.shape}/{_dtype(b)}")


def _dtype(spec) -> str:
    """A column's dtype as the reference prints it (``int32``, not
    ``torch.int32``)."""
    return str(spec.dtype).removeprefix("torch.")


# -- rule 2: partitioning soundness (elision justification) -----------------


def _derive_partitioning(v: _Check, an: PL._Analysis):
    """Re-derive placement tags bottom-up over the OPTIMIZED tree,
    independently of ``plan._elide``, and flag every skip flag / range
    alignment the derived tag does not justify. Output tags follow the
    STORED flags (what will execute), so an unjustified skip both fires a
    finding and poisons nothing downstream spuriously."""
    p = v.p

    def derive(node: PL.Node):
        if isinstance(node, PL.Scan):
            part = node.partitioning
            if part is not None and part.num_partitions != p:
                part = None
            return part
        if isinstance(node, (PL.Select, PL.Limit)):
            return derive(node.child)
        if isinstance(node, PL.Project):
            cp = derive(node.child)
            if cp is not None and set(cp.keys) <= set(node.columns):
                return cp
            return None
        if isinstance(node, PL.Repartition):
            cp = derive(node.child)
            target = Partitioning(node.keys, p, node.seed)
            if node.skip_shuffle and cp != target:
                v.add("partitioning", node,
                      f"skip_shuffle unjustified: input tag {cp} "
                      f"!= {target}")
            return target
        if isinstance(node, PL.Join):
            lp, rp = derive(node.left), derive(node.right)
            inner_ish = node.how in ("inner", "left")
            seed_used = node.seed if node.shuffle_seed is None \
                else node.shuffle_seed
            l_range = range_prefix_matches(lp, node.on)
            r_range = range_prefix_matches(rp, node.on)
            both_range = (l_range and r_range and lp == rp
                          and lp.fingerprint is not None)

            def hash_match(tag):
                return (isinstance(tag, Partitioning)
                        and tag.keys == node.on
                        and tag.num_partitions == p
                        and tag.seed == seed_used)

            if node.align is not None:
                anchor, anchor_skip, other_skip = (
                    (lp, node.skip_left_shuffle, node.skip_right_shuffle)
                    if node.align == "left"
                    else (rp, node.skip_right_shuffle,
                          node.skip_left_shuffle))
                ok = (node.align in ("left", "right") and anchor_skip
                      and not other_skip
                      and range_prefix_matches(anchor, node.on)
                      and node.align_keys == anchor.keys)
                if not ok:
                    v.add("partitioning", node,
                          f"range alignment unjustified: align={node.align} "
                          f"align_keys={node.align_keys}, anchor tag "
                          f"{anchor}")
            else:
                if node.skip_left_shuffle and not (both_range
                                                   or hash_match(lp)):
                    v.add("partitioning", node,
                          f"skip_left_shuffle unjustified by left tag {lp}")
                if node.skip_right_shuffle and not (both_range
                                                    or hash_match(rp)):
                    v.add("partitioning", node,
                          f"skip_right_shuffle unjustified by right tag "
                          f"{rp}")
            if node.align == "left":
                out = lp
            elif node.align == "right":
                out = rp
            elif (node.skip_left_shuffle and node.skip_right_shuffle
                  and isinstance(lp, RangePartitioning) and lp == rp):
                out = lp
            else:
                out = Partitioning(node.on, p, seed_used)
            return out if inner_ish else None
        if isinstance(node, PL.GroupBy):
            cp = derive(node.child)
            matches = ((isinstance(cp, Partitioning)
                        and cp.keys == node.keys
                        and cp.num_partitions == p)
                       or range_prefix_matches(cp, node.keys))
            if node.skip_shuffle and not matches:
                v.add("partitioning", node,
                      f"skip_shuffle unjustified by input tag {cp}")
            return cp if matches else Partitioning(node.keys, p, node.seed)
        if isinstance(node, (PL.Sort, PL.Window)):
            cp = derive(node.child)
            keys = node.by if isinstance(node, PL.Sort) \
                else node.by + node.order_by
            el = range_prefix_matches(cp, keys) or (
                isinstance(cp, RangePartitioning)
                and keys == cp.keys[:len(keys)])
            if node.skip_shuffle and not el:
                v.add("partitioning", node,
                      f"skip_shuffle unjustified by input tag {cp}")
            return cp if el else RangePartitioning(keys, p,
                                                   PL._range_fp(node))
        if isinstance(node, PL.SetOp):
            lp, rp = derive(node.left), derive(node.right)
            keys = tuple(sorted(an.schema(node.left)))
            target = Partitioning(keys, p, node.seed)
            if node.skip_left_shuffle and lp != target:
                v.add("partitioning", node,
                      f"skip_left_shuffle unjustified by left tag {lp}")
            if node.skip_right_shuffle and rp != target:
                v.add("partitioning", node,
                      f"skip_right_shuffle unjustified by right tag {rp}")
            return target
        if isinstance(node, PL.Distinct):
            cp = derive(node.child)
            keys = tuple(sorted(an.schema(node.child)))
            matches = (isinstance(cp, Partitioning) and cp.keys == keys) \
                or isinstance(cp, RangePartitioning)
            if node.skip_shuffle and not matches:
                v.add("partitioning", node,
                      f"skip_shuffle unjustified by input tag {cp}")
            return cp if matches else Partitioning(keys, p, node.seed)
        raise TypeError(node)

    derive(v.optimized)


def _scan_tags(root: PL.Node) -> dict[int, object]:
    """slot -> the partitioning tag its Scan nodes claim (every Scan of a
    slot must agree — one input table, one provenance)."""
    tags: dict[int, object] = {}
    conflicts: set[int] = set()

    def collect(n: PL.Node):
        if isinstance(n, PL.Scan):
            if n.slot in tags and tags[n.slot] != n.partitioning:
                conflicts.add(n.slot)
            tags[n.slot] = n.partitioning
        for c in PL.children(n):
            collect(c)

    collect(root)
    for s in conflicts:
        tags[s] = ("<conflicting>", s)
    return tags


@rule("partitioning")
def _check_partitioning(v: _Check) -> None:
    # Forged provenance: partitioning tags on Scans are INPUT facts (the
    # tag a materialized DistTable actually carries — fingerprints are
    # fresh unique tokens per table, so equal tags mean the same table).
    # The optimizer may consume them but must never invent or alter one:
    # a tag that appears in the optimized tree but not on the same slot
    # in the logical tree is forged, and would falsely authorize
    # zero-shuffle elisions (e.g. a skip-both range-range join).
    want, got = _scan_tags(v.logical), _scan_tags(v.optimized)
    for slot, tag in sorted(got.items()):
        if tag != want.get(slot):
            v.add("partitioning", v.optimized,
                  f"scan slot {slot} claims partitioning {tag} but the "
                  f"logical plan's input carries {want.get(slot)} — "
                  f"forged provenance")
    if v.p == 1:
        return  # every elision is the identity on a single shard
    _derive_partitioning(v, PL._Analysis(v.schemas))


# -- rule 3: pushdown legality (no orphaned column references) --------------


def _limit_contexts(root: PL.Node) -> list[tuple]:
    """Per-Limit (preorder) signature: (n, multiset of non-Project
    descendant node types). Only Project commutes with the global head-n
    (order- and count-preserving), so these signatures must survive
    optimization untouched."""
    out: list[tuple] = []

    def under(n: PL.Node, acc: dict) -> None:
        if not isinstance(n, PL.Project):
            name = type(n).__name__
            acc[name] = acc.get(name, 0) + 1
        for c in PL.children(n):
            under(c, acc)

    def walk(n: PL.Node) -> None:
        if isinstance(n, PL.Limit):
            acc: dict = {}
            under(n.child, acc)
            out.append((n.n, tuple(sorted(acc.items()))))
        for c in PL.children(n):
            walk(c)

    walk(root)
    return out


@rule("pushdown")
def _check_pushdown(v: _Check) -> None:
    an = PL._Analysis(v.schemas)

    def refs_ok(node, names, what: str, child) -> None:
        try:
            sch = set(an.schema(child))
        except KeyError as e:
            v.add("pushdown", node,
                  f"{what}: input schema unresolvable (missing column {e})")
            return
        missing = sorted(set(names) - sch)
        if missing:
            v.add("pushdown", node,
                  f"{what} references columns its input no longer has: "
                  f"{missing}")

    def walk(node: PL.Node) -> None:
        for c in PL.children(node):
            walk(c)
        if isinstance(node, PL.Select):
            if node.columns is not None:
                refs_ok(node, node.columns, "predicate footprint",
                        node.child)
        elif isinstance(node, PL.Project):
            refs_ok(node, node.columns, "projection", node.child)
        elif isinstance(node, PL.Join):
            refs_ok(node, node.on, "join key", node.left)
            refs_ok(node, node.on, "join key", node.right)
        elif isinstance(node, PL.GroupBy):
            cols = node.keys + tuple(c for c, _ in node.pairs)
            refs_ok(node, cols, "groupby", node.child)
        elif isinstance(node, PL.Sort):
            refs_ok(node, node.by, "sort key", node.child)
        elif isinstance(node, PL.Window):
            cols = node.by + node.order_by + tuple(
                c for _, c, _ in node.funcs if c is not None)
            refs_ok(node, cols, "window", node.child)
        elif isinstance(node, PL.SetOp):
            try:
                ls, rs = an.schema(node.left), an.schema(node.right)
            except KeyError:
                return  # already reported at the offending child
            if sorted(ls) != sorted(rs):
                v.add("pushdown", node,
                      f"set-op operand schemas diverge: {sorted(ls)} vs "
                      f"{sorted(rs)}")

    walk(v.optimized)
    before = _limit_contexts(v.logical)
    after = _limit_contexts(v.optimized)
    if before != after:
        v.add("pushdown", v.optimized,
              f"Limit crossed a non-Project node: descendant signatures "
              f"{before} -> {after}")


# -- rule 4: cost-sizing consistency ----------------------------------------

# Deliberately independent of plan._stats_arity: this table is the
# verifier's own record of how many ShuffleStats entries each node emits,
# so the two drifting apart is itself a finding.
_STATS_ARITY = {
    "Join": 2, "Union": 2, "Intersect": 2, "Difference": 2,
    "Limit": 1, "Repartition": 1, "GroupBy": 1, "Sort": 1, "Window": 1,
    "Distinct": 1,
    "Scan": 0, "Select": 0, "Project": 0,
}


def _expected_stats_arity(plan: PL.Node) -> int:
    total = _STATS_ARITY[type(plan).__name__]
    return total + sum(_expected_stats_arity(c) for c in PL.children(plan))


@rule("cost-sizing")
def _check_cost_sizing(v: _Check) -> None:
    have_stats = v.stats is not None and any(s is not None for s in v.stats)

    def walk(node: PL.Node) -> None:
        for c in PL.children(node):
            walk(c)
        if getattr(node, "sized", False):
            if not have_stats:
                v.add("cost-sizing", node,
                      "sized mark without any input statistics")
            if getattr(node, "bucket_capacity", None) is None:
                v.add("cost-sizing", node,
                      "sized mark but bucket_capacity is unset")
        if getattr(node, "out_sized", False):
            if not have_stats:
                v.add("cost-sizing", node,
                      "out_sized mark without any input statistics")
            if node.out_capacity is None:
                v.add("cost-sizing", node,
                      "out_sized mark but out_capacity is unset")
        if isinstance(node, PL.GroupBy) and node.strategy == "auto":
            v.add("cost-sizing", node,
                  "strategy 'auto' survived optimization unresolved")
        st = getattr(node, "stages", None)
        if st is not None:
            if not 1 <= st <= S.MAX_SHUFFLE_STAGES:
                v.add("cost-sizing", node,
                      f"stages={st} outside [1, {S.MAX_SHUFFLE_STAGES}]")
            bucket = getattr(node, "bucket_capacity", None)
            if bucket is not None and st > max(1, bucket):
                v.add("cost-sizing", node,
                      f"stages={st} exceeds bucket_capacity={bucket}")

    walk(v.optimized)
    mask = len(PL.cost_sized_stats_mask(v.optimized))
    want = _expected_stats_arity(v.optimized)
    if mask != want:
        v.add("cost-sizing", v.optimized,
              f"cost_sized_stats_mask arity {mask} != expected "
              f"ShuffleStats count {want}")


# -- rule 5: optimizer idempotence + cache-key stability --------------------


def _first_diff(a, b, path: str = "plan") -> str:
    if type(a) is not type(b):
        return f"{path}: {type(a).__name__} -> {type(b).__name__}"
    if isinstance(a, PL.Node):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, PL.Node) or callable(va):
                continue
            if va != vb:
                return f"{path}.{f.name}: {va!r} -> {vb!r}"
        for i, (ca, cb) in enumerate(zip(PL.children(a), PL.children(b))):
            if ca != cb:
                return _first_diff(ca, cb, f"{path}[{i}]")
    return f"{path}: differs"


@rule("idempotence")
def _check_idempotence(v: _Check) -> None:
    reopt = PL.optimize(v.optimized, v.schemas, v.p, v.stats, verify=False)
    if reopt != v.optimized:
        v.add("idempotence", v.optimized,
              "optimize(optimize(p)) changed the plan: "
              + _first_diff(v.optimized, reopt))
    if PL.canonical_key(reopt) != PL.canonical_key(v.optimized):
        v.add("idempotence", v.optimized,
              "canonical_key not stable under re-optimization")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def verify_plan(logical: PL.Node, optimized: PL.Node,
                input_schemas: Sequence[dict], num_shards: int,
                input_stats: Sequence | None = None) -> list[Finding]:
    """Run every registered rule; returns the findings (empty = clean).

    Total on arbitrary (even deliberately broken) plans: a rule that
    crashes contributes a finding instead of raising, so hand-mutated
    trees and fuzzer output are reported, never a stack trace.
    """
    v = _Check(logical, optimized, list(input_schemas), num_shards,
               None if input_stats is None else list(input_stats), [])
    for name, fn in RULES:
        try:
            fn(v)
        except Exception as e:  # noqa: BLE001 — a crashed rule IS a finding
            v.findings.append(Finding(name, type(e).__name__,
                                      f"rule crashed: {e!r}"))
    with _counters_lock:
        _counters["verify_runs"] += 1
        _counters["verify_findings"] += len(v.findings)
    return v.findings


def verify_or_raise(logical: PL.Node, optimized: PL.Node,
                    input_schemas: Sequence[dict], num_shards: int,
                    input_stats: Sequence | None = None) -> None:
    findings = verify_plan(logical, optimized, input_schemas, num_shards,
                           input_stats)
    if findings:
        raise PlanVerificationError(findings)


def format_findings(findings: Sequence[Finding]) -> str:
    """Human-readable block for ``explain(verify=True)``."""
    if not findings:
        return "verification: clean"
    lines = [f"verification: {len(findings)} finding(s)"]
    lines += [f"  - {f}" for f in findings]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# collective accounting (shared with benchmarks) + the dynamic auditor
# ---------------------------------------------------------------------------

COLLECTIVES = ("all_to_all", "ppermute", "all_gather")


def _nchunks(width: int, stages: int) -> int:
    """Collectives ``staged_all_to_all`` issues for one ``(p, width)``
    buffer: one per chunk, and a single monolithic exchange when chunking
    degenerates (width 0/1 or stages <= 1)."""
    return max(1, len(_chunk_bounds(width, max(1, int(stages)))))


def _shuffle_collectives(rec: dict, p: int, exp: dict) -> None:
    """Fold one non-elided ``plan_report`` shuffle record into ``exp``,
    mirroring ``repartition``: per-column staged exchanges, the counts
    either riding a prepended slot of the 4-byte carrier column's first
    chunk or going out as one separate width-1 exchange."""
    if rec.get("elided"):
        return
    ncols, carrier = rec["columns"], rec["carrier"]
    bucket = rec["bucket"]
    if rec.get("mode", "alltoall") == "ring":
        # _ring_exchange: p-1 ppermute steps per buffer, stages ignored
        exp["ppermute"] += (ncols + (0 if carrier else 1)) * (p - 1)
        return
    stages = rec.get("stages") or 1
    if carrier:
        exp["all_to_all"] += ((ncols - 1) * _nchunks(bucket, stages)
                              + _nchunks(bucket + 1, stages))
    else:
        exp["all_to_all"] += ncols * _nchunks(bucket, stages) + 1


def _window_boundary_gathers(child_schema: dict, by, order_by, funcs) -> int:
    """How many all_gathers ``dist_window`` pays to stitch cross-shard
    groups: one per leaf of the window summary tree (plus the lead
    summary when any func carries lead state). Counted by building the
    summaries with ``ops_agg`` over a four-row zero table of the child
    schema on the CPU (the reference builds them abstractly)."""
    import torch

    from repro_torch.core import ops_agg as A
    from repro_torch.core.table import Table

    cols = {k: torch.zeros((4,) + tuple(s.shape), dtype=s.dtype)
            for k, s in child_schema.items()}
    t = Table(cols, torch.tensor(4, dtype=torch.int32))
    state = A.window_state(t, list(by), list(order_by))
    trees = [A.window_summary(t, state, list(by), list(order_by), funcs)]
    if A.carry_requirements(funcs)[3]:
        trees.append(A.window_lead_summary(t, state, list(by), funcs))

    def leaves(tree) -> int:
        if isinstance(tree, dict):
            return sum(leaves(v) for v in tree.values())
        if isinstance(tree, (tuple, list)):
            return sum(leaves(v) for v in tree)
        return 1

    return sum(leaves(tr) for tr in trees)


def expected_collectives(plan: PL.Node, input_schemas: Sequence[dict],
                         num_shards: int, report: Sequence[dict]) -> dict:
    """Static collective counts for an OPTIMIZED plan from its
    ``plan_report`` records: the exchange decomposition per shuffle, plus
    the gather sites the executor pays outside ``repartition`` (limit
    quotas, sort/window splitter samples, join range alignment, window
    boundary carries)."""
    p = num_shards
    an = PL._Analysis(input_schemas)
    exp = {name: 0 for name in COLLECTIVES}
    recs = list(report)
    pos = 0
    seen: set[int] = set()  # execute_plan memoizes shared subtrees by id

    def take(node: PL.Node) -> dict:
        nonlocal pos
        if pos >= len(recs):
            raise ValueError(
                f"plan_report exhausted at {type(node).__name__} — static "
                f"accounting and plan walk disagree")
        rec = recs[pos]
        pos += 1
        return rec

    def walk(node: PL.Node) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        for c in PL.children(node):
            walk(c)
        if isinstance(node, PL.Limit):
            take(node)  # limit's record carries no exchange
            if p > 1:
                exp["all_gather"] += 1  # per-shard valid-count gather
        elif isinstance(node, PL.Join):
            _shuffle_collectives(take(node), p, exp)  # join.left
            _shuffle_collectives(take(node), p, exp)  # join.right
            if node.align is not None and p > 1:
                # _range_align_pid: one boundary gather per align key
                exp["all_gather"] += len(node.align_keys)
        elif isinstance(node, PL.SetOp):
            _shuffle_collectives(take(node), p, exp)
            _shuffle_collectives(take(node), p, exp)
        elif isinstance(node, PL.Sort):
            _shuffle_collectives(take(node), p, exp)
            if not node.skip_shuffle and p > 1:
                # _lex_splitter_pids: one sample gather per key column
                exp["all_gather"] += len(node.by)
        elif isinstance(node, PL.Window):
            _shuffle_collectives(take(node), p, exp)
            if not node.skip_shuffle and p > 1:
                exp["all_gather"] += len(node.by + node.order_by)
            if p > 1:
                exp["all_gather"] += _window_boundary_gathers(
                    an.schema(node.child), node.by, node.order_by,
                    node.funcs)
        elif isinstance(node, (PL.Repartition, PL.GroupBy, PL.Distinct)):
            _shuffle_collectives(take(node), p, exp)

    walk(plan)
    if pos != len(recs):
        raise ValueError(
            f"{len(recs) - pos} unconsumed plan_report record(s) — static "
            f"accounting and plan walk disagree")
    return exp


def audit_collectives(frame, *, strict: bool = False) -> dict:
    """Dynamic cross-check: run the frame's optimized plan once and compare
    the collectives the virtual mesh issued (``VirtualMesh.counts``, zeroed
    just before) with :func:`expected_collectives`' static accounting of
    the same plan from the run's ``report`` records.

    Returns ``{"expected", "actual", "matched", "report"}``; with
    ``strict=True`` a mismatch raises :class:`PlanVerificationError`. Not
    trace-only, unlike the reference's jaxpr count: the port has no trace,
    so the plan runs on the frame's inputs and device (the output is
    dropped).
    """
    ctx = frame._ctx
    plan = frame.optimized()
    report: list[dict] = []
    mesh = ctx.mesh
    mesh.reset_counts()
    PL.execute_plan(plan, [t.shards() for t in frame._inputs], mesh=mesh,
                    report=report)
    actual = {name: int(mesh.counts.get(name, 0)) for name in COLLECTIVES}
    expected = expected_collectives(
        plan, [t.schema for t in frame._inputs], ctx.num_shards, report)
    result = {"expected": expected, "actual": actual,
              "matched": expected == actual, "report": report}
    if strict and not result["matched"]:
        raise PlanVerificationError([Finding(
            "collective-audit", _head(plan),
            f"counted collectives {actual} != static accounting "
            f"{expected}")])
    return result
