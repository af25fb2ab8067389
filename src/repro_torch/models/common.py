"""``ModelConfig``: the port's copy of ``repro/models/common.py``'s config,
and the reference's sharding rules as shape rules.

One dataclass covers every architecture family of the JAX package, and
keeps every field so a config copies over value for value.

The reference places each parameter, cache and batch leaf on its mesh by a
``PartitionSpec`` from ``ShardingRules``; the port runs on one card and
places nothing, so here the same rules give **specs** only: plain tuples,
one entry a dim, each an axis name, a tuple of axis names or None
(:func:`spec` normalises them as ``PartitionSpec`` does). A spec says what
one device of a ``NamedMesh`` would hold of a leaf; the dry run
(``launch/dryrun.py``) reads it for per-device bytes and for the
collectives the reference's GSPMD would insert (``roofline/analysis.py``),
and no arithmetic changes with it. :func:`decode_layout` is the rule the
port does compute with: ``decode_seq_shard`` and ``mla_seq_shard`` choose
the seq-sharded decodes of ``models/layers.py`` over its sequence axes.
``ep_shuffle``, ``layout``, ``moe_shuffle_stages`` and ``moe_shuffle_mode``
choose ``models/moe.moe_fwd``'s path over the model axis, and ``remat``
applies in training (``models/transformer.py``). ``scan_layers``, ``fsdp``
(but for the specs) and ``time_unroll`` are kept as fields and ignored:
PyTorch runs eagerly, layer by layer, and loops over chunks in Python.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# the reference's mesh axis names (launch/mesh.py builds the meshes)
POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- MoE -----------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # --- MLA -------------------------------------------------------------------
    attn_kind: str = "gqa"          # gqa | mla
    mla_q_lora: int = 0
    mla_kv_lora: int = 0
    mla_rope_dim: int = 0
    mla_nope_dim: int = 0
    mla_v_dim: int = 0

    # --- SSM / hybrid / xLSTM --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0
    ssm_chunk: int = 256
    attn_every: int = 0
    slstm_every: int = 0

    # --- enc-dec -----------------------------------------------------------------
    encoder_layers: int = 0

    # --- modality frontend -------------------------------------------------------
    frontend: str = "none"          # none | vision_stub | audio_stub
    num_frontend_tokens: int = 0

    # --- numerics ------------------------------------------------------------------
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16         # activation/compute dtype
    param_dtype: Any = torch.bfloat16   # parameter dtype

    # --- the reference's compile/sharding knobs (remat and the MoE path's read) -
    scan_layers: bool = True
    remat: str = "full"
    fsdp: bool = False
    layout: str = "tp"
    ep_shuffle: bool = True
    moe_shuffle_stages: int | None = None
    moe_shuffle_mode: str = "alltoall"
    decode_seq_shard: bool = True
    mla_seq_shard: bool = False
    time_unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """The vocab rounded up to a multiple of 128, as the reference pads
        its embedding tables; the logical vocab stays ``vocab_size``."""
        return -(-self.vocab_size // 128) * 128

    @property
    def d_inner(self) -> int:       # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)




# ---------------------------------------------------------------------------
# specs: the reference's sharding rules as shape rules
# ---------------------------------------------------------------------------


def _entry(p):
    if isinstance(p, tuple):
        if not p:
            return None
        return p[0] if len(p) == 1 else p
    return p


def spec(*parts) -> tuple:
    """A spec as a plain tuple: a one-axis tuple becomes the axis' name and
    an empty one None, as ``jax.sharding.PartitionSpec`` normalises them (so
    ``spec(...) == tuple(P(...))``)."""
    return tuple(_entry(p) for p in parts)


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class LayerSplit(tuple):
    """The spec of one layer's leaf in a group the reference stacks on a
    leading layer dim, where that layer dim is the one sharded (over
    ``axis``, by :func:`fsdp_extend`: llama3-8b's 32 layers over data 16).
    The tuple is the spec of the leaf's own dims; the leaf lies whole on
    the devices of one index of ``axis`` (layer i of n at index i // (n /
    size)), so a device holds ``1 / size`` of the group's bytes. Equal only
    to a ``LayerSplit`` of the same axis."""

    axis: str

    def __new__(cls, dims, axis: str):
        self = super().__new__(cls, dims)
        self.axis = axis
        return self

    def __eq__(self, other):
        return isinstance(other, LayerSplit) and self.axis == other.axis \
            and tuple(self) == tuple(other)

    def __ne__(self, other):  # tuple's own __ne__ would ignore the axis
        return not self == other

    def __hash__(self):
        return hash((tuple(self), self.axis))

    def __repr__(self):
        return f"LayerSplit({tuple(self)!r}, axis={self.axis!r})"


def axis_if_divisible(dim: int, axis: str, mesh_axis_size: int) -> str | None:
    """Shard a dim over ``axis`` only when the axis divides it (kv_heads 8
    cannot shard over model 16: replicate)."""
    return axis if dim % max(mesh_axis_size, 1) == 0 and dim >= mesh_axis_size \
        else None


class ShardingRules:
    """Logical dims -> specs for a mesh of ``mesh_shape`` (the reference's
    ``ShardingRules``, rule for rule).

    Megatron pairing: 'col' weights shard their output dim over ``model``,
    'row' weights their input dim, so each block pays one all-reduce
    forward and one backward. FSDP (``fsdp``, or the ``fsdp`` layout, where
    the model axis becomes a second batch/ZeRO axis) shards the
    complementary dim over ``data`` (gathered on use, gradients
    reduce-scattered)."""

    def __init__(self, mesh_shape: dict[str, int], fsdp: bool,
                 layout: str = "tp"):
        self.model = mesh_shape.get(MODEL_AXIS, 1)
        self.data = mesh_shape.get(DATA_AXIS, 1)
        self.pod = mesh_shape.get(POD_AXIS, 1)
        self.has_pod = POD_AXIS in mesh_shape
        self.fsdp = fsdp
        self.layout = layout
        if layout == "fsdp":
            self.fsdp = True

    def decode_layout(self, batch: int, seq_shard: bool = True):
        """(batch_axes | None, seq_axes | None) of a decode cache: the batch
        over the batch axes when (pod x data) divides it, the sequence then
        over ``model`` (if larger than 1); otherwise (small-batch long
        context) the batch whole and the sequence over (pod,) data, model.
        ``seq_shard`` False leaves the sequence whole."""
        dp = self.batch_axes()
        dp_size = self.pod * self.data
        if batch % dp_size == 0 and batch >= dp_size:
            return dp, ((MODEL_AXIS,) if seq_shard and self.model > 1
                        else None)
        axes = ((POD_AXIS,) if self.has_pod else ()) + (DATA_AXIS, MODEL_AXIS)
        return None, (axes if seq_shard else None)

    def _fs(self, dim: int) -> str | None:
        return DATA_AXIS if self.fsdp and dim % self.data == 0 \
            and dim >= self.data else None

    def _mp(self, dim: int) -> str | None:
        # in the fsdp layout the model axis shards storage, not math: the
        # weight is gathered on use, by the same divisibility rule
        return MODEL_AXIS if dim % self.model == 0 and dim >= self.model \
            else None

    def col(self, in_dim: int, out_dim: int) -> tuple:
        """(in, out) weight, its output dim over ``model``."""
        return spec(self._fs(in_dim), self._mp(out_dim))

    def row(self, in_dim: int, out_dim: int) -> tuple:
        """(in, out) weight, its input dim over ``model``."""
        return spec(self._mp(in_dim), self._fs(out_dim))

    def vec(self, dim: int = 0) -> tuple:
        """1-D parameter (norm scale, bias): replicated."""
        return spec(None)

    def embed(self, vocab: int, d: int) -> tuple:
        """Embedding table: vocab over ``model``; in the fsdp layout d stays
        whole (the unembedding gathers the table)."""
        if self.layout == "fsdp":
            return spec(self._mp(vocab), None)
        return spec(self._mp(vocab), self._fs(d))

    def expert_col(self, e: int, in_dim: int, out_dim: int) -> tuple:
        """(E, in, out) expert weight: experts over ``model`` (EP)."""
        return spec(self._mp(e), self._fs(in_dim), None)

    def expert_row(self, e: int, in_dim: int, out_dim: int) -> tuple:
        return spec(self._mp(e), None, self._fs(out_dim))

    def batch_axes(self):
        if self.layout == "fsdp":
            return (POD_AXIS, DATA_AXIS, MODEL_AXIS) if self.has_pod \
                else (DATA_AXIS, MODEL_AXIS)
        return (POD_AXIS, DATA_AXIS) if self.has_pod else (DATA_AXIS,)

    def act(self, *rest) -> tuple:
        """Activation spec: batch over the dp axes, then the given axes."""
        return spec(self.batch_axes(), *rest)


def map_specs(fn, tree):
    """``fn`` over every spec of a nested dict of specs."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_layer_specs(spec_tree):
    """A None (layer) dim put before every spec of a layer tree: the spec of
    the leaf stacked on L (the reference's parameters, the port's caches)."""
    return map_specs(lambda s: spec(None, *s), spec_tree)


def fsdp_extend(specs, shapes, data_size: int):
    """ZeRO sharding for the optimizer state: the first free dim that
    ``data`` divides is sharded over it, unless the spec already holds
    ``data``. ``specs`` and ``shapes`` (tensors or sizes) are nested dicts
    of one structure, or one spec and one shape."""
    if isinstance(specs, dict):
        return {k: fsdp_extend(v, shapes[k], data_size)
                for k, v in specs.items()}
    shape = tuple(getattr(shapes, "shape", shapes))
    parts = list(specs) + [None] * (len(shape) - len(specs))
    if any(DATA_AXIS in spec_axes(p) for p in parts):
        return specs
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % data_size == 0 and d >= data_size:
            parts[i] = DATA_AXIS
            return spec(*parts)
    return specs


def decode_layout(mesh_shape: dict[str, int], batch: int,
                  seq_shard: bool = True):
    """(batch_axes | None, seq_axes | None) of a decode cache on a mesh of
    ``mesh_shape``: ``ShardingRules.decode_layout`` in the tp layout, the
    rule the seq-sharded decodes split their cache by."""
    return ShardingRules(mesh_shape, False).decode_layout(batch, seq_shard)


def flat_specs(tree: dict, prefix: str = "") -> dict[str, tuple]:
    """A nested dict of specs as {dotted name: spec}, the names the port's
    modules give their parameters (``attn.wq``, ``moe.shared.wi``)."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(flat_specs(leaf, f"{prefix}{name}."))
        else:
            out[prefix + name] = leaf
    return out


def per_layer_specs(tree: dict, group: str, n: int) -> dict[str, tuple]:
    """One layer's spec tree for each of the ``n`` layers of ``group``
    (``layers.<i>.attn.wq``): the port holds a leaf a layer, and each takes
    the layer spec (the reference's stacked spec less its layer dim)."""
    one = flat_specs(tree)
    return {f"{group}.{i}.{name}": s for i in range(n)
            for name, s in one.items()}
