"""AdamW with global-norm clipping and a warmup-cosine schedule, the port of
``repro/train/optimizer.py``.

The state mirrors the parameters, keyed by the module's parameter names
(the network's ``named_parameters()``): fp32 master weights and the moments
``m`` and ``v``, and an int32 step ``count``. The update is plain torch, as
the reference's is plain XLA (no Pallas kernel), one leaf at a time, so its
temporaries stay the size of one leaf; it writes the masters, the moments
and the bf16 parameters in place (the reference donates its state).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    master: dict[str, torch.Tensor]  # fp32 master params
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: torch.Tensor              # int32, ()


def init_opt(params: dict[str, torch.Tensor]) -> OptState:
    z = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for n, p in params.items()}
    master = {n: p.detach().float().clone() for n, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(master=master, m=z, v={n: t.clone() for n, t in z.items()},
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def opt_state_specs(master_specs: dict[str, tuple]) -> OptState:
    """The optimizer state's specs: the masters' for ``master``, ``m`` and
    ``v``, a replicated ``count``."""
    return OptState(master=master_specs, m=dict(master_specs),
                    v=dict(master_specs), count=())


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac * lr`` at
    ``total_steps``; fp32, in the reference's order of operations."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


# the groups the reference stacks on a leading layer dim: the transformer's
# layers, the hybrid's Mamba blocks, xLSTM's mLSTM and sLSTM blocks, the
# encoder-decoder's two stacks (the port holds one module a layer, named
# ``<group>.<i>.``)
STACKED_GROUPS = ("layers.", "mamba.", "mlstm.", "slstm.", "enc_layers.",
                  "dec_layers.")


def reference_rank(name: str, p: torch.Tensor) -> int:
    """The rank of ``p``'s leaf in the reference's tree: the reference
    stacks every per-layer leaf on a leading L dim, so a parameter of a
    ``STACKED_GROUPS`` group has one more dim there (the per-layer norms,
    (d,) here, are (L, d) there, as are xLSTM's per-head gate biases, (H,)
    here; the hybrid's one shared block is not stacked)."""
    return p.ndim + (1 if name.startswith(STACKED_GROUPS) else 0)


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], state: OptState,
                  cfg: OptConfig):
    """One AdamW step on the fp32 masters; the parameters re-cast from them.
    Returns (params, state, metrics), the same tensors updated in place.

    The clip scale is ``min(1, clip / max(gnorm, 1e-9))`` with ``gnorm``
    over the fp32 grads; ``count`` is incremented before the schedule and
    the bias corrections; decoupled weight decay on the fp32 master of
    every leaf whose reference rank is >= 2 (matrices, the embedding and the
    stacked per-layer norms; not ``final_norm``)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    for name, p in params.items():
        mst, m, v = state.master[name], state.m[name], state.v[name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if reference_rank(name, p) >= 2:
            step = step + cfg.weight_decay * mst
        mst.sub_(lr * step)
        p.copy_(mst)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(state.master, state.m, state.v, count), metrics
