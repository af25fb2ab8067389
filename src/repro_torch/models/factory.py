"""Model factory of the port (``repro/models/factory.py``): the dense, MoE
and VLM families (``transformer.Transformer``), the Mamba2 hybrid
(``zamba.Hybrid``), xLSTM (``ssm``, ``xlstm.XLSTM``) and the
encoder-decoder (``audio``, ``encdec.EncDec``).

``build_model(cfg, device, mesh=)`` returns a :class:`Model`: an
``nn.Module`` holding the family's network drawn from a
``torch.Generator``, with ``loss_fn``, ``forward``, ``init_cache`` and
``decode_step``. The parameters live in the module, so the step functions
take none (the reference passes its parameter tree to every call).

``build_model(cfg, "meta")`` gives the same modules with parameters on
PyTorch's ``meta`` device and draws no weight (the counterpart of
``jax.eval_shape(model.init)``): the dry run (``launch/dryrun.py``) runs
the steps on it to count their work. ``Model.param_specs()`` and
``Model.cache_specs(batch)`` are the reference's partition specs of every
parameter (by the port's names: a per-layer leaf takes the layer spec) and
of the decode cache, from ``Model.rules`` (``common.ShardingRules`` of the
mesh's shape).

The mesh (``launch/mesh.make_local_mesh``: named axes of virtual devices,
all on the one card) is kept as :attr:`Model.mesh` and passed to every
forward. A dense model computes the same arithmetic on any mesh; only the
reference's per-shard code reads it: the seq-sharded decodes, MoE's
expert-parallel and psum paths over the model axis (whose size pads the
experts when the weights are drawn), and the train step's
``compress_pod`` over the pod axis.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models import xlstm as XL
from repro_torch.models import zamba as ZB
from repro_torch.models.common import MODEL_AXIS, ModelConfig, ShardingRules
from repro_torch.utils import resolve_device


class NoDraw:
    """Stands in for a generator on the ``meta`` device: the layers' init
    helpers make empty meta tensors of their shapes and draw nothing."""

    device = torch.device("meta")


def network(cfg: ModelConfig, generator: torch.Generator,
            mesh=None) -> nn.Module:
    """The family's network, its weights drawn from ``generator`` (an MoE's
    experts padded for the mesh's model axis)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return TF.Transformer(cfg, generator, 1 if mesh is None else
                              mesh.axis_size(MODEL_AXIS))
    if cfg.family == "hybrid":
        return ZB.Hybrid(cfg, generator)
    if cfg.family == "ssm":
        return XL.XLSTM(cfg, generator)
    if cfg.family == "audio":
        return ED.EncDec(cfg, generator)
    raise ValueError(f"{cfg.arch}: unknown family {cfg.family!r}")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.rules = ShardingRules({} if mesh is None else mesh.shape,
                                   cfg.fsdp, layout=cfg.layout)
        self.lm = network(cfg, generator, mesh)

    @property
    def device(self) -> torch.device:
        return self.lm.embed.device

    def loss_fn(self, batch: dict[str, torch.Tensor]):
        """(loss, metrics): next-token cross-entropy over the padded vocab,
        weighted by the pipeline's per-sample ``weight``
        (``repro/models/factory.py:43-79``).

        Label 0 is padding: ``mask = (labels != 0) * weight``; the loss is
        ``sum((lse - logit[label]) * mask) / max(sum(mask), 1)``, in fp32.
        The reference contracts a one-hot (a sharding device); a gather of
        the label's logit is the same function. An MoE model adds
        ``0.01 * moe_aux / num_layers``. Metrics: ``loss``, ``tokens`` (the
        sum of the mask) and the forward's aux (summed over the layers;
        zero for the dense family), as the reference's. With ``embeds``
        (B, n_front, d), a VLM's logits of the front rows are dropped and
        the same loss taken over the text tokens; the encoder-decoder takes
        its frame embeddings (B, S_enc, d) there, and its logits are the
        decoder's, one a token."""
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        logits, _, aux = self.forward(tokens=tokens, embeds=embeds,
                                      mode="causal")
        if self.cfg.family == "vlm" and embeds is not None:
            logits = logits[:, embeds.shape[1]:]
        lg = logits[:, :-1].float()
        labels = tokens[:, 1:].long()
        mask = (labels != 0).float()
        if "weight" in batch:
            mask = mask * batch["weight"][:, None].float()
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, labels[..., None])[..., 0]
        tokens_n = mask.sum()
        loss = ((lse - ll) * mask).sum() / torch.clamp(tokens_n, min=1.0)
        if self.cfg.moe_num_experts:
            loss = loss + 0.01 * aux["moe_aux"] / self.cfg.num_layers
        metrics = {"loss": loss, "tokens": tokens_n, **aux}
        return loss, metrics

    def forward(self, *, tokens: torch.Tensor, embeds=None,
                mode: str = "causal", cache=None, pos: int | None = None):
        """(logits (B, S_total, padded_vocab), cache, aux), on the model's
        mesh."""
        return self.lm(tokens, embeds=embeds, mode=mode, cache=cache, pos=pos,
                       mesh=self.mesh)

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0):
        """The family's decode cache, zeros: the stacked KV (or MLA latent)
        cache, the hybrid's Mamba states and shared-block KV slots, xLSTM's
        mLSTM and sLSTM states (no dim grows with ``max_len``), or the
        encoder-decoder's self KV and ``enc_len`` rows of cross KV."""
        cfg, dev = self.cfg, self.device
        if cfg.family == "hybrid":
            return ZB.init_hybrid_cache(cfg, batch, max_len, dev)
        if cfg.family == "ssm":
            return XL.init_xlstm_cache(cfg, batch, dev)
        if cfg.family == "audio":
            return ED.init_encdec_cache(cfg, batch, max_len, enc_len, dev)
        return TF.init_cache(cfg, batch, max_len, dev)

    def param_specs(self) -> dict[str, tuple]:
        """{parameter name: spec}, keyed as ``self.lm.named_parameters()``."""
        cfg, rules = self.cfg, self.rules
        if cfg.family == "hybrid":
            return ZB.param_specs(cfg, rules)
        if cfg.family == "ssm":
            return XL.param_specs(cfg, rules)
        if cfg.family == "audio":
            return ED.param_specs(cfg, rules)
        return TF.param_specs(cfg, rules)

    def cache_specs(self, batch: int) -> dict:
        """Specs of :meth:`init_cache`'s leaves, one tree of one structure."""
        cfg, rules = self.cfg, self.rules
        if cfg.family == "hybrid":
            return ZB.hybrid_cache_specs(cfg, rules, batch)
        if cfg.family == "ssm":
            return XL.xlstm_cache_specs(cfg, rules, batch)
        if cfg.family == "audio":
            return ED.encdec_cache_specs(cfg, rules, batch)
        return TF.cache_specs(cfg, rules, batch)

    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        """(logits (B, S, vocab_size), cache): the vocab padding trimmed."""
        logits, cache, _ = self.forward(tokens=tokens, mode="decode",
                                        cache=cache, pos=pos)
        return logits[..., : self.cfg.vocab_size], cache


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda", *,
                mesh=None, generator: torch.Generator | None = None) -> Model:
    """A model of ``cfg`` with random weights on ``device`` (``cuda`` unless
    the caller asks for another; ``cuda`` without a card raises), drawn from
    ``generator``: one on ``device`` (by default a new one seeded 0), or one
    on the host, whose weights are then moved to ``device``, so that a seed
    gives the same model on every device (as the reference's key does).
    ``mesh``: a ``NamedMesh`` of virtual devices, or None (one device).
    On ``meta`` nothing is drawn (``generator`` must be None)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        if generator is not None:
            raise ValueError("a meta model draws no weight: pass no generator")
        return Model(cfg, NoDraw(), mesh)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif generator.device.type not in (dev.type, "cpu"):
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return Model(cfg, generator, mesh).to(dev)
