"""Three-term roofline of the port on one NVIDIA H100, from the dry run's
counts (no card needed).

Terms, per device, against NVIDIA's H100 SXM5 datasheet:

    compute    = FLOPs      / PEAK_FLOPS        989e12 FLOP/s dense bf16
    memory     = bytes      / HBM_BW            3.35e12 B/s HBM3
    collective = wire bytes / (NVLINK_BW / 2)   900e9 B/s NVLink, both ways

The reference (``repro/roofline/analysis.py``) reads the same three from a
compiled XLA executable: ``cost_analysis`` and ``memory_analysis``, and its
post-SPMD HLO text (``collective_stats``, ``hbm_bytes``), with a correction
for an XLA:CPU artefact (``cpu_upcast_temp_bytes``). The port has no HLO
and no compile step, so those are not ported. In their place:

- :class:`StepCost`, a ``TorchDispatchMode`` that sees every aten op a step
  runs (on the ``meta`` device in the dry run, or on any device) and counts
  - FLOPs by ``torch.utils.flop_counter``'s formulas (matrix products; an
    elementwise op counts none), and the hand-written kernels' own
    products, which their wrappers record on meta tensors
    (``kernels/meta``);
  - bytes: each op's inputs read once and outputs written once, the eager
    port's real traffic, since eager PyTorch fuses nothing. Views,
    reshapes and expands are free; an expanded input counts its distinct
    elements; an in-place slice update (``copy_``, ``index_copy_``,
    ``index_put_``) counts the slice read and written, as the reference
    counts ``dynamic-update-slice``. Bytes of score-shaped tensors (both
    minor dims >= 2048) are reported apart, as ``score_bytes``;
  - the live-bytes peak: every tensor an op allocates (not a view, not an
    in-place result) counts from its op until it is freed; what exists
    before the count starts (parameters, optimizer state, inputs) does not;
  - collectives, each kind apart: every one the port's ``NamedMesh`` issues
    (``psum``, ``pmax``, ``all_gather``, ``all_to_all``, ``ppermute``; the
    mesh's own ops inside it count no bytes), and the ones the reference's
    GSPMD inserts that the port's one-card step never issues, derived from
    the parameters' specs (``Model.param_specs``): ``megatron_all_reduce``
    after each product that contracts a weight's ``model``-sharded first
    dim (a row-parallel weight's, its output, forward, and once more in the
    backward where it is differentiated; the vocab-parallel head's, in the
    backward, for its input's gradient), ``embed_all_reduce`` after a
    lookup in a vocab-sharded table, ``gather_on_use`` of a weight whose
    spec FSDP-shards it (fsdp, the ``fsdp`` layout) and of the experts'
    weights outside expert parallelism, and per train step
    (:func:`train_collectives`) ``grad_reduce_scatter`` of each fp32
    gradient to its master shard each microbatch and ``param_all_gather``
    of each parameter its master spec shards further. A collective's bytes
    are its per-device result (what the reference's parser reads from each
    HLO collective's result shape), summed over the devices; all-reduces
    (``psum``, ``pmax``, Megatron's, the embedding's) move twice that on
    the wire.
- :func:`state_bytes`: the per-device bytes of parameters, optimizer state
  and cache, exact from their specs (in place of ``memory_stats``'
  argument bytes).

A count is of the step's global work on one process; per device is the
global count over the mesh's devices, which assumes the work shards evenly.
The pure functions (``DepthPair``, ``roofline_terms``, ``count_params``,
``active_params``, ``model_flops``) compute as the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.models.common import (
    DATA_AXIS, MODEL_AXIS, LayerSplit, spec_axes)

# --- NVIDIA H100 SXM5 (the datasheet; dense rates, 700 W) ------------------
PEAK_FLOPS = 989e12           # bf16 FLOP/s on the tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
NVLINK_BW = 900e9             # bytes/s, NVLink 4, both directions together
DEVICE_MEMORY = 80 * 10**9    # the datasheet's 80 GB, for runs without a card
SCORE_MIN = 2048              # both minor dims at least this: score-shaped

ALL_REDUCES = ("psum", "pmax", "megatron_all_reduce", "embed_all_reduce")

aten = torch.ops.aten
# in-place slice updates: the slice read and written (arg index of the data)
SLICE_UPDATES = {aten.copy_.default: 1, aten.index_copy_.default: 3,
                 aten.index_put_.default: 2}
PRODUCTS = (aten.mm.default, aten.addmm.default, aten.bmm.default)
# allocations that write nothing
EMPTIES = (aten.empty.memory_format, aten.empty_strided.default,
           aten.new_empty.default, aten.empty_like.default)
LOOKUPS = (aten.index.Tensor, aten.embedding.default)


def device_memory() -> int:
    """The card's memory in bytes, or the datasheet's 80 GB without one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return DEVICE_MEMORY


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor holds: an expanded (stride 0) dim
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _is_score(t: torch.Tensor) -> bool:
    return t.ndim >= 2 and t.shape[-1] >= SCORE_MIN and t.shape[-2] >= SCORE_MIN


def _axes_size(entries, mesh_shape: dict[str, int]) -> int:
    return math.prod(mesh_shape.get(a, 1) for e in entries for a in spec_axes(e))


def leaf_bytes(shape, dtype: torch.dtype, spec, mesh_shape: dict[str, int]
               ) -> float:
    """One device's bytes of a leaf of ``shape`` under ``spec``: each dim
    over the axes of its entry (a ``LayerSplit`` also over its layer
    axis)."""
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    div = _axes_size(spec, mesh_shape)
    if isinstance(spec, LayerSplit):
        div *= mesh_shape.get(spec.axis, 1)
    return n / div


def _flat(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif tree is not None:
        yield prefix.rstrip("/"), tree


def state_bytes(specs, shapes, mesh_shape: dict[str, int]) -> float:
    """Per-device bytes of a state tree: ``specs`` and ``shapes`` (tensors,
    meta or not) are nested dicts of one structure (a ``TrainState``'s or
    ``OptState``'s fields as dicts, a cache, the parameters)."""
    flat_shapes = dict(_flat(shapes))
    total = 0.0
    for name, s in _flat(specs):
        t = flat_shapes[name]
        total += leaf_bytes(tuple(t.shape), t.dtype, s, mesh_shape)
    return total


# ---------------------------------------------------------------------------
# the step counter
# ---------------------------------------------------------------------------


class StepCost(TorchDispatchMode):
    """Counts a step's work (see the module's docstring). ``model`` (a
    ``factory.Model``, optional) gives the parameter names, their specs
    (``Model.param_specs``), the layout and the mesh for the derived
    collectives; without one, only the mesh's own collectives count.

        with StepCost(model) as cost:
            step(...)
        cost.totals()   # global counts; per device: over cost.devices
    """

    def __init__(self, model=None):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.score_bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: Counter = Counter()
        self.coll_bytes: Counter = Counter()
        self.coll_counts: Counter = Counter()
        self.ops = 0
        self.live = 0
        self.peak_live = 0
        self._quiet = 0
        self._names = WeakIdKeyDictionary()
        self.mesh_shape: dict[str, int] = {}
        self.layout = "tp"
        self._specs: dict[str, tuple] = {}
        self._experts: set[str] = set()
        self._whole: dict[str, torch.Tensor] = {}
        if model is not None:
            if model.mesh is not None:
                self.mesh_shape = dict(model.mesh.shape)
            self.layout = model.cfg.layout
            self._specs = model.param_specs()
            for name, p in model.lm.named_parameters():
                self._names[p] = (name, False)
                self._whole[name] = p
                if ".moe." in f".{name}" and p.ndim == 3:
                    self._experts.add(name)

    @property
    def devices(self) -> int:
        return math.prod(self.mesh_shape.values()) if self.mesh_shape else 1

    # -- what the wrappers and the mesh report ------------------------------

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One hand-written kernel call on meta tensors (``kernels/meta``)."""
        self.kernel_calls[name] += 1
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.flops += flops
        self.bytes += nbytes

    def add_collective(self, kind: str, nbytes: float, count: int = 1) -> None:
        """``count`` collectives of ``kind``: ``nbytes`` per-device result
        bytes summed over the devices."""
        self.coll_bytes[kind] += nbytes
        self.coll_counts[kind] += count

    @contextlib.contextmanager
    def collective(self, kind: str, nbytes: float, count: int = 1):
        """``count`` collectives the ``NamedMesh`` issues: counted, and the
        mesh's own ops inside them count no FLOPs or bytes."""
        self.add_collective(kind, nbytes, count)
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- the ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        returns = func._schema.returns
        aliases = [r.alias_info for r in returns]
        if any(a is not None and not a.is_write for a in aliases):
            self._tag_view(func, args, out)
            return out
        fresh = all(a is None for a in aliases)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if fresh:
            for t in outs:
                self._allocated(t)
            if func is aten._to_copy.default:
                self._tag_view(func, args, out)
        if self._quiet or func in EMPTIES:
            return out
        self.ops += 1
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func in SLICE_UPDATES:
            src = args[SLICE_UPDATES[func]]
            nb = 2 * _distinct_bytes(src)
            self.bytes += nb
            if _is_score(src):
                self.score_bytes += nb
        else:
            for t in ins + outs:
                nb = _distinct_bytes(t)
                self.bytes += nb
                if _is_score(t):
                    self.score_bytes += nb
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if self._specs and self.mesh_shape:
            if func in PRODUCTS:
                self._product(func, args, out)
            elif func in LOOKUPS:
                self._lookup(args[0], out)
        return out

    def _allocated(self, t: torch.Tensor) -> None:
        nb = t.numel() * t.element_size()
        self.live += nb
        self.peak_live = max(self.peak_live, self.live)
        weakref.finalize(t, self._freed, nb)

    def _freed(self, nb: int) -> None:
        self.live -= nb

    def _tag_view(self, func, args, out) -> None:
        """A view (or a cast copy) of a parameter keeps its name; ``t`` and
        ``transpose`` mark it transposed."""
        src = args[0] if args else None
        if not isinstance(src, torch.Tensor) or src not in self._names:
            return
        name, flipped = self._names[src]
        if func in (aten.t.default, aten.transpose.int):
            flipped = not flipped
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._names[t] = (name, flipped)

    def _gathered_bytes(self, name: str, operand: torch.Tensor,
                        whole: torch.Tensor) -> float:
        """Σ over devices of the bytes a use of parameter ``name`` gathers:
        its FSDP axes (data; in the fsdp layout every axis of its spec), and
        in the tp layout an expert weight's model axis where it is used
        whole (no expert parallelism). An operand cut along its leading dim
        (one shard's experts, in the loop over the model axis's shards) is
        that part, gathered by that part of the devices, its leading axes
        spent by the cut. 0 where nothing is gathered."""
        sp = self._specs.get(name, ())
        axes = [a for e in sp for a in spec_axes(e)]
        cut = operand.shape[0] < whole.shape[0]
        if self.layout == "fsdp":
            gather = set(axes)
        else:
            gather = {a for a in axes if a == DATA_AXIS}
            if name in self._experts and MODEL_AXIS in axes and not cut:
                gather.add(MODEL_AXIS)
        if not gather:
            return 0.0
        spent = set(spec_axes(sp[0])) if cut and sp else set()
        keep = math.prod(self.mesh_shape.get(a, 1) for a in axes
                         if a not in gather and a not in spent)
        part = operand.shape[0] / whole.shape[0] if cut else 1.0
        return (self.devices * part) * whole.numel() * whole.element_size() \
            * part / keep

    def _product(self, func, args, out) -> None:
        mats = args[1:3] if func is aten.addmm.default else args[:2]
        for m in mats:
            if not isinstance(m, torch.Tensor) or m not in self._names:
                continue
            name, flipped = self._names[m]
            whole = self._whole[name]
            g = self._gathered_bytes(name, m, whole)
            if g:
                self.add_collective("gather_on_use", g)
            sp = self._specs.get(name, ())
            model = self.mesh_shape.get(MODEL_AXIS, 1)
            if self.layout == "tp" and not flipped and m.ndim == 2 and \
                    model > 1 and sp and MODEL_AXIS in spec_axes(sp[0]):
                nb = model * out.numel() * out.element_size()
                self.add_collective("megatron_all_reduce", nb)
                # a forward use that autograd records (not the recompute,
                # which runs inside the backward) pays one more there; the
                # op's output has no grad_fn yet at this level: its inputs
                # say whether it will
                if torch._C._current_autograd_node() is None and \
                        torch.is_grad_enabled() and any(
                            isinstance(a, torch.Tensor) and a.requires_grad
                            for a in args):
                    self.add_collective("megatron_all_reduce", nb)

    def _lookup(self, table, out) -> None:
        if not isinstance(table, torch.Tensor) or table not in self._names:
            return
        name, _ = self._names[table]
        whole = self._whole[name]
        g = self._gathered_bytes(name, table, whole)
        if g:
            self.add_collective("gather_on_use", g)
            return
        sp = self._specs.get(name, ())
        model = self.mesh_shape.get(MODEL_AXIS, 1)
        if self.layout == "tp" and model > 1 and sp and \
                MODEL_AXIS in spec_axes(sp[0]):
            self.add_collective("embed_all_reduce",
                                model * out.numel() * out.element_size())

    # -- results ------------------------------------------------------------

    def coll_wire_bytes(self) -> float:
        return sum(b * (2 if k in ALL_REDUCES else 1)
                   for k, b in self.coll_bytes.items())

    def totals(self) -> dict[str, float]:
        """The step's global counts, flat (what ``DepthPair`` extrapolates)."""
        out = {"flops": self.flops, "bytes": self.bytes,
               "score_bytes": self.score_bytes,
               "kernel_flops": self.kernel_flops,
               "kernel_bytes": self.kernel_bytes,
               "coll_bytes": float(sum(self.coll_bytes.values())),
               "coll_wire_bytes": self.coll_wire_bytes(),
               "peak_live_bytes": float(self.peak_live),
               "ops": float(self.ops)}
        for k, v in self.coll_bytes.items():
            out[f"coll_bytes/{k}"] = v
        for k, v in self.coll_counts.items():
            out[f"coll_count/{k}"] = float(v)
        return out


def train_collectives(model, microbatches: int
                      ) -> dict[str, tuple[float, int]]:
    """The train step's gradient collectives the reference's GSPMD inserts,
    {kind: (Σ over the devices of their per-device result bytes, count)}:
    each microbatch, each parameter's fp32 gradient reduce-scattered to its
    master shard (ZeRO-2); after the update, each parameter its master spec
    shards further than its own spec all-gathered back to its spec."""
    from repro_torch.train.steps import master_specs

    if model.mesh is None:
        return {}
    shape = dict(model.mesh.shape)
    devices = math.prod(shape.values())
    pspecs, mspecs = model.param_specs(), master_specs(model)
    out: dict[str, tuple[float, int]] = {}

    def add(kind, nb, n):
        b, c = out.get(kind, (0.0, 0))
        out[kind] = (b + nb, c + n)

    for name, p in model.lm.named_parameters():
        sh = tuple(p.shape)
        master = leaf_bytes(sh, torch.float32, mspecs[name], shape)
        if master < leaf_bytes(sh, torch.float32, (), shape):
            add("grad_reduce_scatter", devices * master * microbatches,
                microbatches)
        mine = leaf_bytes(sh, p.dtype, pspecs[name], shape)
        if leaf_bytes(sh, p.dtype, mspecs[name], shape) < mine:
            add("param_all_gather", devices * mine, 1)
    return out


# ---------------------------------------------------------------------------
# depth extrapolation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DepthPair:
    """Costs at two depths; solves cost(L) = c0 + L * c1."""
    l1: int
    l2: int
    cost1: dict
    cost2: dict

    def at(self, depth: float) -> dict:
        out = {}
        keys = set(self.cost1) | set(self.cost2)
        for k in keys:
            a, b = float(self.cost1.get(k, 0)), float(self.cost2.get(k, 0))
            c_layer = (b - a) / (self.l2 - self.l1)
            c0 = a - self.l1 * c_layer
            out[k] = max(c0 + depth * c_layer, 0.0)
        return out

    def per_layer(self) -> dict:
        keys = set(self.cost1) | set(self.cost2)
        return {k: (float(self.cost2.get(k, 0)) - float(self.cost1.get(k, 0)))
                / (self.l2 - self.l1) for k in keys}


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, *, links_used: int = 1) -> dict:
    """Seconds per term from per-device counts; the collective term sends
    its wire bytes one way of NVLink."""
    compute = flops_per_dev / PEAK_FLOPS
    memory = bytes_per_dev / HBM_BW
    collective = coll_bytes_per_dev / (NVLINK_BW / 2 * links_used)
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda kv: kv[1])
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dom[0],
            "bound_s": dom[1]}


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (the useful-compute yardstick)
# ---------------------------------------------------------------------------


def count_params(named) -> dict:
    """{'total': n, 'embed': n_embed} over ``named``: a module (its
    ``named_parameters``) or a mapping of names to tensors or shapes; a
    name holding ``embed``, ``lm_head`` or ``dec_pos`` is embedding."""
    items = named.named_parameters() if hasattr(named, "named_parameters") \
        else named.items()
    total = emb = 0
    for name, leaf in items:
        n = math.prod(getattr(leaf, "shape", leaf))
        total += n
        if "embed" in name or "lm_head" in name or "dec_pos" in name:
            emb += n
    return {"total": total, "embed": emb}


def active_params(cfg, params_count: dict) -> float:
    """N_active: non-embedding params, MoE experts scaled by top-k/E, the
    unembedding head added once (also where it is tied, as the
    reference)."""
    n_body = params_count["total"] - params_count["embed"]
    # lm_head participates in every token's matmul — count it
    n = n_body + (0 if cfg.tie_embeddings else 0)
    if cfg.moe_num_experts:
        e = cfg.moe_num_experts
        expert_p = cfg.num_layers * 3 * cfg.d_model * cfg.moe_d_ff * e
        n = n - expert_p + expert_p * cfg.moe_top_k / e
    n = n + cfg.vocab_size * cfg.d_model
    return float(n)


def model_flops(cfg, params_count: dict, kind: str, global_batch: int,
                seq_len: int) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode), N = active params
    (an encoder-decoder's tokens counted once, as the reference)."""
    n = active_params(cfg, params_count)
    if kind == "train":
        return 6.0 * n * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n * global_batch * seq_len
    return 2.0 * n * global_batch
