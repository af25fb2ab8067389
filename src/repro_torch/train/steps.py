"""Step functions of the port (``repro/train/steps.py``): the train step
(microbatched gradient accumulation, then AdamW), the eval step, prefill
and decode.

The model holds its parameters, so the serving steps close over it and
take none. A :class:`TrainState`'s ``params`` are the model's own parameter
tensors (keyed by the network's ``named_parameters()``); the train step
computes the loss through the model and updates those tensors, the fp32
masters and the moments in place (the reference donates its state). The
parameters stay frozen (``requires_grad`` False) outside the step's
backward, so serving builds no autograd graph. ``compress_pod`` (int8
error-feedback gradients across pods) needs a pod mesh, which the port
does not have yet.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch

from repro_torch.models.factory import Model, network
from repro_torch.train.optimizer import OptConfig, OptState, apply_updates, init_opt

_POD_TODO = ("compress_pod needs a multi-pod mesh, which the port does not "
             "have; ROADMAP.md queue 1 item 12.7 keeps it queued")


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt: OptState
    step: torch.Tensor  # int32, ()
    ef: Any             # error-feedback residuals (pod compression) or None


def init_train_state(model: Model, seed: int = 0, *,
                     compress_pod: bool = False) -> TrainState:
    """Draw the model's parameters afresh from a ``torch.Generator`` seeded
    ``seed`` on its device (as ``build_model`` draws them), in place, and
    return the state over them: fp32 masters, zero moments, step 0."""
    if compress_pod:
        raise NotImplementedError(_POD_TODO)
    fresh = network(model.cfg,
                    torch.Generator(device=model.device).manual_seed(seed))
    model.lm.load_state_dict(fresh.state_dict())
    del fresh
    return bind_state(model)


def bind_state(model: Model, src: TrainState | None = None) -> TrainState:
    """A train state over the model's parameters: fresh (fp32 masters of
    the parameters as they are, zero moments, step 0), or, from ``src`` (a
    state on any device, e.g. ``convert.train_state_from_jax``'s), a copy
    of it with ``src.params`` copied into the model's parameters."""
    params = dict(model.lm.named_parameters())
    if src is None:
        return TrainState(params=params, opt=init_opt(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=model.device), ef=None)
    dev = model.device
    model.lm.load_state_dict(src.params)
    opt = OptState(*({n: t.to(dev, torch.float32, copy=True)
                      for n, t in leaves.items()}
                     for leaves in (src.opt.master, src.opt.m, src.opt.v)),
                   count=src.opt.count.to(dev, torch.int32, copy=True))
    return TrainState(params=params, opt=opt,
                      step=src.step.to(dev, torch.int32, copy=True), ef=None)


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------


def _microbatch(batch: dict[str, torch.Tensor], k: int, num: int):
    """Interleaved microbatch k of ``num``: row r of the global batch belongs
    to microbatch r mod num."""
    def slice_one(x):
        return x.reshape((x.shape[0] // num, num) + tuple(x.shape[1:]))[:, k]
    return {name: slice_one(x) for name, x in batch.items()}


@contextlib.contextmanager
def _trainable(leaves):
    """The parameters require grad inside, and are frozen again after."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in leaves:
            p.requires_grad_(False)


def _accumulate_grads(model: Model, params: dict[str, torch.Tensor],
                      batch: dict[str, torch.Tensor], num: int):
    """fp32 grads and metrics, the mean over ``num`` microbatches: each
    microbatch's bf16 grads added into fp32 accumulators in order, then
    divided by ``num``; the metrics the mean of the per-microbatch metrics
    (a mean of means, as the reference's scan)."""
    names = list(params)
    leaves = [params[n] for n in names]
    acc, msum = None, None
    with _trainable(leaves):
        for k in range(num):
            mb = batch if num == 1 else _microbatch(batch, k, num)
            loss, metrics = model.loss_fn(mb)
            # a leaf the loss does not reach (a VLM's front_proj on a batch
            # without embeds) has a zero gradient, as jax.grad gives it
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
                leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
            metrics = {n: m.detach().float() for n, m in metrics.items()}
            if acc is None:
                acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for p in leaves]
                msum = {n: torch.zeros_like(m) for n, m in metrics.items()}
            torch._foreach_add_(acc, grads)  # bf16 -> fp32 exactly, then add
            msum = {n: msum[n] + metrics[n] for n in msum}
            del grads, loss
    if num > 1:
        torch._foreach_div_(acc, float(num))
        msum = {n: m / num for n, m in msum.items()}
    return dict(zip(names, acc)), msum


# ---------------------------------------------------------------------------
# step factories
# ---------------------------------------------------------------------------


def make_train_step(model: Model, ocfg: OptConfig, *, microbatches: int = 1,
                    compress_pod: bool = False):
    """Returns step_fn(state, batch) -> (state, metrics). ``state.params``
    must be the model's parameters (``init_train_state``/``bind_state``);
    ``batch`` holds ``tokens`` (B, S), ``weight`` (B,) and, for a VLM,
    ``embeds`` (B, n_front, d) (for the encoder-decoder, its frame
    embeddings (B, S_enc, d)) on the model's device, B a multiple of
    ``microbatches``."""
    if compress_pod:
        raise NotImplementedError(_POD_TODO)
    own = dict(model.lm.named_parameters())

    def step_fn(state: TrainState, batch):
        if state.params.keys() != own.keys() or any(
                state.params[n] is not p for n, p in own.items()):
            raise ValueError("state.params are not this model's parameters; "
                             "make the state with init_train_state or "
                             "bind_state")
        grads, metrics = _accumulate_grads(model, state.params, batch,
                                           microbatches)
        params, opt, om = apply_updates(state.params, grads, state.opt, ocfg)
        del grads
        return TrainState(params, opt, state.step + 1, state.ef), \
            {**metrics, **om}
    return step_fn


def make_eval_step(model: Model):
    """batch -> metrics, no gradient."""
    def eval_fn(batch):
        with torch.no_grad():
            return model.loss_fn(batch)[1]
    return eval_fn


def make_prefill_step(model: Model, max_len: int, enc_len: int = 0):
    """batch -> (last_logits (B, padded_vocab), cache): a causal pass over
    ``batch['tokens']`` (after a VLM's ``batch['embeds']``, its front rows;
    the encoder-decoder's ``batch['embeds']`` are its ``enc_len`` audio
    frames) that writes a fresh cache of ``max_len`` rows, the model's own
    (``Model.init_cache``: the stacked KV cache, MLA's latents, the
    hybrid's Mamba states and shared-block KV slots, xLSTM's states, or the
    encoder-decoder's self and cross KV). ``max_len`` counts a VLM's front
    rows. The logits keep the vocab padding, as the reference's prefill
    does."""
    def prefill_fn(batch):
        tokens = batch["tokens"]
        cache = model.init_cache(tokens.shape[0], max_len, enc_len)
        logits, cache, _ = model.forward(tokens=tokens,
                                         embeds=batch.get("embeds"),
                                         mode="causal", cache=cache)
        return logits[:, -1], cache
    return prefill_fn


def make_decode_step(model: Model):
    """(cache, tokens (B, 1), pos: int) -> (logits (B, vocab_size), cache),
    the cache updated in place."""
    def decode_fn(cache, tokens, pos: int):
        logits, cache = model.decode_step(cache, tokens, pos)
        return logits[:, -1], cache
    return decode_fn
