"""``ModelConfig``: the port's copy of ``repro/models/common.py``'s config,
and the one sharding rule the port computes with, ``decode_layout``.

One dataclass covers every architecture family of the JAX package, and
keeps every field so a config copies over value for value. The port runs
on one card: the reference's ``ShardingRules``, partition specs and
``fsdp_extend`` place arrays on devices and change no arithmetic, so they
are not carried over. The mesh (``launch/mesh.py``, virtual axes) reaches
only the code the reference writes per shard: ``decode_seq_shard`` and
``mla_seq_shard`` choose the seq-sharded decodes of ``models/layers.py``
(their shards given by :func:`decode_layout`), ``ep_shuffle``, ``layout``,
``moe_shuffle_stages`` and ``moe_shuffle_mode`` choose
``models/moe.moe_fwd``'s path over the model axis, and ``remat`` applies in
training (``models/transformer.py``). ``scan_layers``, ``fsdp`` and
``time_unroll`` are kept as fields and ignored: PyTorch runs eagerly,
layer by layer, and loops over chunks in Python.
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


def decode_layout(mesh_shape: dict[str, int], batch: int,
                  seq_shard: bool = True):
    """(batch_axes | None, seq_axes | None) of a decode cache on a mesh of
    ``mesh_shape`` (``ShardingRules.decode_layout`` of the reference, mesh
    free). When the batch divides the data-parallel axes (pod, data) it
    splits over them and the cache's sequence over ``model`` (if that axis
    is larger than 1); otherwise (small-batch long-context decode) the
    batch is whole and the sequence splits over every axis, (pod,) data,
    model. ``seq_shard`` False leaves the sequence whole."""
    pod = mesh_shape.get(POD_AXIS, 1)
    data = mesh_shape.get(DATA_AXIS, 1)
    model = mesh_shape.get(MODEL_AXIS, 1)
    has_pod = POD_AXIS in mesh_shape
    dp = (POD_AXIS, DATA_AXIS) if has_pod else (DATA_AXIS,)
    dp_size = pod * data
    if batch % dp_size == 0 and batch >= dp_size:
        return dp, ((MODEL_AXIS,) if seq_shard and model > 1 else None)
    axes = ((POD_AXIS,) if has_pod else ()) + (DATA_AXIS, MODEL_AXIS)
    return None, (axes if seq_shard else None)
