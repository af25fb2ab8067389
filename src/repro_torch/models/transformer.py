"""The decoder-only transformer of the port (``repro/models/transformer.py``),
dense GQA, dense MLA, MoE and the VLM backbone: ``Block`` (RMSNorm, GQA attention or, with
``cfg.attn_kind == "mla"``, MLA, RMSNorm, a SwiGLU MLP or, with
``cfg.moe_num_experts``, the MoE layer of ``models/moe.py``, two residual
adds) and ``Transformer`` (embedding, the blocks, final norm, a tied or
untied head), with ``init_cache``.

The reference scans stacked layer parameters under ``jit``; here
``Transformer.forward`` (the reference's ``lm_forward``) is a Python loop
over ``Block`` modules, each holding its own layer's tensors. The cache
stays stacked on L, as the reference's, and each block writes its slice in
place. While autograd records (training), ``cfg.remat`` applies as the
reference's ``_remat``: ``"full"`` runs each block under
``torch.utils.checkpoint`` (its input saved, its forward run again in the
backward; an MoE block routes the same tokens the same way again),
``"dots"`` likewise with the matmul outputs kept (below), ``"none"``
plainly. The forward's aux (``moe_aux``, ``moe_dropped``) is the sum over
the layers, in order, of fp32 tensors on the device (zeros for the dense
family), as the reference's scan sums them. The VLM front is the
reference's stub: ``embeds`` (B, n_front, d), precomputed patch
embeddings, are cast to the activation dtype, projected by ``front_proj``
(d, d) and put before the token embeddings; positions run over the whole
row, front rows first. The audio front is the encoder-decoder's
(``models/encdec.py``). Left for later: MLA with experts or a front.

``remat="dots"`` is the reference's ``dots_with_no_batch_dims_saveable``:
``torch.utils.checkpoint`` with a selective policy (:func:`remat_context`)
that saves the outputs of ``aten.mm``/``aten.addmm`` (the x·W projections,
the MLP, the MoE router: the port's projections are all ``@`` on 2-D
weights) and recomputes everything else (batched products, the flash
kernel, norms, activations). Every family's blocks take it
(``zamba.py``, ``xlstm.py``, ``encdec.py``).

The mesh (``forward(..., mesh=)``, a ``core/mesh.NamedMesh``; the model
keeps it, ``factory.build_model(cfg, device, mesh=)``) changes no dense
arithmetic: on one card there is no GSPMD, and prefill, training and the
MLP compute whole on any mesh. It reaches only the code the reference
writes per shard: the seq-sharded decodes of ``layers.attention_fwd`` and
``layers.mla_fwd``, and ``moe.moe_fwd``'s expert-parallel and psum paths
over the model axis (whose size also pads the experts at init,
``moe.padded_experts``).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as NN
from repro_torch.models import moe as MOE
from repro_torch.models.common import (
    MODEL_AXIS, ModelConfig, ShardingRules, per_layer_specs, stack_layer_specs)

AUX_KEYS = ("moe_aux", "moe_dropped")
REMAT_POLICIES = ("none", "full", "dots")
# the products "dots" saves: dot products with no batch dims
SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    # no autograd graph is built through the weights unless a train step
    # (train/steps.py) makes them trainable for its backward
    return nn.Parameter(t, requires_grad=False)


class FrozenTree(nn.Module):
    """A layer's (nested) dict of frozen parameters, read as the layers'
    functions read their trees (``p[name]``, ``name in p``); a nested dict,
    the MoE's ``shared`` expert, becomes a child (state-dict names
    ``attn.wq``, ``moe.router``, ``moe.shared.wi``, ...). Each leaf keeps
    its dtype (the MoE router fp32)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, FrozenTree(leaf))
            else:
                self.register_parameter(name, _frozen(leaf))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _remat_contexts():
    """``checkpoint``'s (forward, recompute) contexts. The recompute runs
    inside the backward, for CUDA tensors on autograd's device thread,
    where the caller's thread-local ``oracle_scope()`` is not set: it is
    carried over, so the recompute takes the forward's attention path."""
    again = kops.oracle_scope() if kops.oracle_only() else contextlib.nullcontext()
    return contextlib.nullcontext(), again


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save what ``dots_with_no_batch_dims_saveable`` saves (``SAVED_DOTS``)
    and recompute the rest."""
    if op in SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _dots_contexts():
    """The selective policy's (forward, recompute) contexts, the recompute
    also under ``_remat_contexts``' (the forward's attention path)."""
    fwd, rec = create_selective_checkpoint_contexts(dots_policy)
    _, again = _remat_contexts()
    return fwd, _entered(rec, again)


def remat_context(cfg: ModelConfig):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat`` ("full" or
    "dots"); None for "none", when a block runs plainly. Another value
    raises ``ValueError``."""
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"remat={cfg.remat!r}: one of {REMAT_POLICIES}")
    return {"none": None, "full": _remat_contexts,
            "dots": _dots_contexts}[cfg.remat]


def block_specs(cfg: ModelConfig, rules: ShardingRules) -> dict:
    """One block's spec tree, as its parameters nest."""
    s = {"ln1": rules.vec(),
         "attn": NN.mla_specs(cfg, rules) if cfg.attn_kind == "mla"
         else NN.attention_specs(cfg, rules),
         "ln2": rules.vec()}
    if cfg.moe_num_experts:
        s["moe"] = MOE.moe_specs(cfg, rules)
    else:
        s["mlp"] = NN.mlp_specs(cfg.d_model, cfg.d_ff, rules)
    return s


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 model_size: int = 1):
        super().__init__()
        self.cfg = cfg
        dev = generator.device
        self.ln1 = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype, dev))
        self.attn = FrozenTree(NN.init_mla(cfg, generator)
                               if cfg.attn_kind == "mla" else
                               NN.init_attention(cfg, generator))
        self.ln2 = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype, dev))
        if cfg.moe_num_experts:
            self.moe = FrozenTree(MOE.init_moe(cfg, generator, model_size))
        else:
            self.mlp = FrozenTree(NN.init_mlp(cfg.d_model, cfg.d_ff, cfg,
                                              generator))

    def forward(self, x: torch.Tensor, *, rope, mode: str, cache=None,
                pos: int | None = None, mesh=None):
        """(x, cache, aux): aux the MoE layer's {"moe_aux", "moe_dropped"},
        None for a dense block."""
        cfg = self.cfg
        h = NN.rms_norm(x, self.ln1, cfg.norm_eps)
        attend = NN.mla_fwd if cfg.attn_kind == "mla" else NN.attention_fwd
        a, cache = attend(self.attn, h, cfg, mode=mode, rope=rope,
                          cache=cache, pos=pos, mesh=mesh)
        x = x + a
        h = NN.rms_norm(x, self.ln2, cfg.norm_eps)
        if cfg.moe_num_experts:
            y, aux = MOE.moe_fwd(self.moe, h, cfg, None if mesh is None
                                 else mesh.view((MODEL_AXIS,)))
            return x + y, cache, aux
        return x + NN.mlp_fwd(self.mlp, h), cache, None


class Transformer(nn.Module):
    """Parameters are drawn from ``generator`` on its device, in the
    reference's distributions: embedding N(0, 0.02^2), every matrix
    N(0, 1/fan_in) with fan-in its second-to-last dim (so the untied head,
    (padded_vocab, d), has std 1/sqrt(padded_vocab)), norms ones; the
    experts padded for a model axis of ``model_size``."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 model_size: int = 1):
        super().__init__()
        mla = cfg.attn_kind == "mla"
        if cfg.family not in ("dense", "moe", "vlm") or \
                cfg.attn_kind not in ("gqa", "mla") or \
                bool(cfg.moe_num_experts) != (cfg.family == "moe") or \
                (mla and cfg.family != "dense") or \
                cfg.frontend not in ("none", "vision_stub") or \
                (mla and cfg.frontend != "none"):
            raise NotImplementedError(
                f"{cfg.arch}: only the dense GQA, dense MLA, MoE (GQA) and "
                f"VLM (GQA, vision_stub front) families run here; MLA "
                f"takes no front, and the audio front is the "
                f"encoder-decoder's (models/encdec.py)")
        self.cfg = cfg
        dev = generator.device
        self.embed = _frozen(NN.init_embed(cfg, generator))
        self.layers = nn.ModuleList(Block(cfg, generator, model_size)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _frozen(NN.init_norm(cfg.d_model, cfg.param_dtype,
                                               dev))
        self.lm_head = None if cfg.tie_embeddings else _frozen(NN._dense(
            (cfg.padded_vocab, cfg.d_model), cfg.param_dtype, generator))
        self.front_proj = _frozen(NN._dense(
            (cfg.d_model, cfg.d_model), cfg.param_dtype, generator)) \
            if cfg.frontend == "vision_stub" else None

    def forward(self, tokens: torch.Tensor, *, embeds=None,
                mode: str = "causal", cache=None, pos: int | None = None,
                mesh=None):
        """Returns (logits (B, S_total, padded_vocab), cache, aux).

        tokens (B, S) int; embeds (B, n_front, d) or None, projected and
        put first (S_total = n_front + S; a VLM's prefill and training);
        mode 'causal' (prefill, training) or 'decode' (S new tokens at
        ``pos``, a Python int, which counts the front rows). cache:
        ``init_cache``'s stacked {'k', 'v'} (MLA: {'c_kv', 'k_rope'}),
        written in place and returned. RoPE runs over the head dim, or
        MLA's rope dim. mesh: the model's ``NamedMesh`` or None.
        """
        cfg = self.cfg
        x = NN.embed_fwd(self.embed, tokens, cfg)
        if embeds is not None:
            if self.front_proj is None:
                raise ValueError(f"{cfg.arch} has no front (frontend "
                                 f"{cfg.frontend!r}) to take embeds")
            e = embeds.to(cfg.dtype) @ self.front_proj.to(cfg.dtype)
            x = torch.cat([e, x], 1)
        s = x.shape[1]
        start = pos if mode == "decode" else 0
        positions = torch.arange(s, device=x.device) + start
        rope_dim = cfg.mla_rope_dim if cfg.attn_kind == "mla" else cfg.hd
        rope = NN.rope_tables(positions, rope_dim, cfg.rope_theta)
        remat = remat_context(cfg) if cache is None and \
            torch.is_grad_enabled() and x.requires_grad else None
        total = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                 for k in AUX_KEYS}
        for i, block in enumerate(self.layers):
            layer_cache = None if cache is None else \
                {name: t[i] for name, t in cache.items()}
            if remat is not None:
                x, _, aux = checkpoint(block, x, rope=rope, mode=mode,
                                       mesh=mesh, use_reentrant=False,
                                       context_fn=remat)
            else:
                x, _, aux = block(x, rope=rope, mode=mode, cache=layer_cache,
                                  pos=pos, mesh=mesh)
            if aux is not None:
                total = {k: total[k] + aux[k] for k in AUX_KEYS}
        x = NN.rms_norm(x, self.final_norm, cfg.norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        logits = NN.unembed_fwd(head, x, cfg)
        return logits, cache, total


def param_specs(cfg: ModelConfig, rules: ShardingRules) -> dict[str, tuple]:
    """{parameter name: spec} of a :class:`Transformer`."""
    s = {"embed": NN.embed_spec(cfg, rules),
         **per_layer_specs(block_specs(cfg, rules), "layers", cfg.num_layers),
         "final_norm": rules.vec()}
    if not cfg.tie_embeddings:
        s["lm_head"] = rules.embed(cfg.padded_vocab, cfg.d_model)
    if cfg.frontend == "vision_stub":
        s["front_proj"] = rules.col(cfg.d_model, cfg.d_model)
    return s


def cache_specs(cfg: ModelConfig, rules: ShardingRules, batch: int
                ) -> dict[str, tuple]:
    """Specs of :func:`init_cache`'s stacked leaves."""
    one = NN.mla_cache_specs(cfg, rules, batch) if cfg.attn_kind == "mla" \
        else NN.attn_cache_specs(cfg, rules, batch)
    return stack_layer_specs(one)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device
               ) -> dict[str, torch.Tensor]:
    """Stacked (L, B, max_len, KV, hd) decode cache in ``cfg.dtype``; for
    MLA the stacked latents, {'c_kv' (L, B, max_len, kv_lora), 'k_rope'
    (L, B, max_len, rope_dim)}."""
    if cfg.attn_kind == "mla":
        one = NN.init_mla_cache(cfg, batch, max_len, device)
        return {name: t[None].repeat(cfg.num_layers, 1, 1, 1)
                for name, t in one.items()}
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
