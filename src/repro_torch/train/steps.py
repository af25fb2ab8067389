"""Step functions of the port (``repro/train/steps.py``): the train step
(microbatched gradient accumulation, then AdamW), the eval step, prefill
and decode.

The model holds its parameters, so the serving steps close over it and
take none. A :class:`TrainState`'s ``params`` are the model's own parameter
tensors (keyed by the network's ``named_parameters()``); the train step
computes the loss through the model and updates those tensors, the fp32
masters and the moments in place (the reference donates its state). The
parameters stay frozen (``requires_grad`` False) outside the step's
backward, so serving builds no autograd graph.

Gradient compression (``compress_pod=True``, the reference's int8
error-feedback pod compression): on a mesh with a ``pod`` axis of n pods,
each pod takes its contiguous 1/n of the batch (the reference's
``P("pod")`` on the leading dim), accumulates its gradients over its own
microbatches, adds its error-feedback residual ``ef[name][pod]`` and
quantizes each of the reference's leaves (a per-layer leaf is one leaf
stacked over the layers there) to int8 with one fp32 scale
(:func:`_quantize`); the residual keeps what the quantization lost, and
the mean of the pods' dequantized gradients feeds AdamW. The pods run one after another, so one
pod's fp32 gradients are live beside the running sum of the dequantized
ones. Inside a pod, the data and model axes change no arithmetic (the
reference's GSPMD there is a layout).
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import (
    POD_AXIS, LayerSplit, fsdp_extend, spec)
from repro_torch.models.factory import Model, network
from repro_torch.train.optimizer import (
    OptConfig, OptState, apply_updates, init_opt, opt_state_specs)


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt: OptState
    step: torch.Tensor  # int32, ()
    # error-feedback residuals of pod compression, {name: (n_pods, *shape)
    # fp32} keyed as params, or None
    ef: Any


def init_train_state(model: Model, seed: int = 0, *,
                     compress_pod: bool = False, n_pods: int = 1
                     ) -> TrainState:
    """Draw the model's parameters afresh from a ``torch.Generator`` seeded
    ``seed`` on its device (as ``build_model`` draws them), in place, and
    return the state over them: fp32 masters, zero moments, step 0; with
    ``compress_pod``, zero residuals ``ef`` of ``n_pods`` rows a leaf."""
    fresh = network(model.cfg,
                    torch.Generator(device=model.device).manual_seed(seed),
                    model.mesh)
    model.lm.load_state_dict(fresh.state_dict())
    del fresh
    state = bind_state(model)
    if compress_pod:
        state = state._replace(ef=init_ef(state.params, n_pods))
    return state


def init_ef(params: dict[str, torch.Tensor], n_pods: int
            ) -> dict[str, torch.Tensor]:
    """Zero error-feedback residuals: (n_pods, *shape) fp32 a leaf."""
    return {n: torch.zeros((n_pods,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device) for n, p in params.items()}


def bind_state(model: Model, src: TrainState | None = None) -> TrainState:
    """A train state over the model's parameters: fresh (fp32 masters of
    the parameters as they are, zero moments, step 0), or, from ``src`` (a
    state on any device, e.g. ``convert.train_state_from_jax``'s), a copy
    of it with ``src.params`` copied into the model's parameters (and its
    ``ef``, if any, copied to the model's device)."""
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
    ef = None if src.ef is None else {
        n: t.to(dev, torch.float32, copy=True) for n, t in src.ef.items()}
    return TrainState(params=params, opt=opt,
                      step=src.step.to(dev, torch.int32, copy=True), ef=ef)


# ---------------------------------------------------------------------------
# specs (the reference's, by the port's names)
# ---------------------------------------------------------------------------


def master_specs(model: Model) -> dict[str, tuple]:
    """ZeRO specs of the fp32 optimizer state and the gradient accumulator:
    ``common.fsdp_extend`` of the parameter specs, applied as the reference
    applies it, to each stacked leaf (a group of :func:`stacked_leaves`,
    its shape (n, *shape), its spec (None, *layer spec)). Where that picks
    the layer dim, each layer's leaf gets a ``LayerSplit``."""
    specs = model.param_specs()
    params = dict(model.lm.named_parameters())
    data = max(model.rules.data, 1)
    out = {}
    for group, names in stacked_leaves(specs).items():
        layer_spec, shape = specs[names[0]], tuple(params[names[0]].shape)
        if "*" not in group:  # not stacked in the reference either
            out[names[0]] = fsdp_extend(layer_spec, shape, data)
            continue
        ext = fsdp_extend(spec(None, *layer_spec), (len(names),) + shape, data)
        one = ext[1:] if ext[0] is None else LayerSplit(ext[1:], ext[0])
        out.update({n: one for n in names})
    return out


def train_state_specs(model: Model, *, compress_pod: bool = False
                      ) -> TrainState:
    """The train state's specs: the parameters', the masters' for the
    optimizer state, a replicated step; with ``compress_pod``, the
    residuals' (pod, *master spec)."""
    ms = master_specs(model)
    ef = None
    if compress_pod:
        ef = {n: LayerSplit((POD_AXIS, *s), s.axis) if isinstance(s, LayerSplit)
              else spec(POD_AXIS, *s) for n, s in ms.items()}
    return TrainState(params=model.param_specs(), opt=opt_state_specs(ms),
                      step=(), ef=ef)


def batch_specs(model: Model, batch: dict[str, torch.Tensor]
                ) -> dict[str, tuple]:
    """A batch's specs: the leading dim over the dp axes."""
    b = model.rules.batch_axes()
    return {k: spec(b, *([None] * (x.ndim - 1))) for k, x in batch.items()}


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
# int8 error-feedback pod compression
# ---------------------------------------------------------------------------


def _quantize(g: torch.Tensor, s: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, s fp32 ()) of an fp32 leaf: s = max|g| / 127 + 1e-12 (or
    the given scale), q = clip(round(g / s), -127, 127), rounding half to
    even (as ``jnp.round``)."""
    if s is None:
        s = _scale([g])
    q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
    return q, s


def _scale(leaves: list[torch.Tensor]) -> torch.Tensor:
    """max |g| over the leaves / 127 + 1e-12, in fp32."""
    m = torch.stack([torch.amax(torch.abs(g)) for g in leaves]).amax()
    return m / 127.0 + 1e-12


def stacked_leaves(names) -> dict[str, list[str]]:
    """The port's parameter names grouped by the reference's leaf: the
    reference stacks each per-layer leaf on a leading layer dim
    (``layers.<i>.attn.wq`` are its one ``layers/attn/wq``; so are
    ``mamba.<i>.*``, ``mlstm.<j>.*``, ``slstm.<i>.*``, ``enc_layers.<i>.*``
    and ``dec_layers.<i>.*``), and quantizes each leaf with one scale."""
    groups: dict[str, list[str]] = {}
    for n in names:
        groups.setdefault(re.sub(r"^(\w+)\.\d+\.", r"\1.*.", n), []).append(n)
    return groups


def _pod_grads(model: Model, params, batch, ef, microbatches: int, n_pods: int):
    """The mean over the pods of each pod's dequantized int8 gradients, its
    residual ``ef[name][pod]`` updated in place (g + e - deq), and the pods'
    mean metrics. Pod i takes rows [i B/n, (i+1) B/n) of the batch. One
    scale quantizes each of the reference's stacked leaves
    (:func:`stacked_leaves`)."""
    b = next(iter(batch.values())).shape[0]
    if b % (n_pods * microbatches):
        raise ValueError(f"a batch of {b} rows does not split over {n_pods} "
                         f"pods x {microbatches} microbatches")
    rows = b // n_pods
    total, msum = None, None
    for pod in range(n_pods):
        local = {k: v[pod * rows:(pod + 1) * rows] for k, v in batch.items()}
        grads, metrics = _accumulate_grads(model, params, local, microbatches)
        for names in stacked_leaves(grads).values():
            for name in names:
                grads[name].add_(ef[name][pod])
            s = _scale([grads[name] for name in names])
            for name in names:
                g = grads[name]
                q, _ = _quantize(g, s)
                deq = q.float() * s
                ef[name][pod].copy_(g - deq)
                grads[name] = deq
        if total is None:
            total, msum = grads, metrics
        else:
            torch._foreach_add_(list(total.values()), list(grads.values()))
            msum = {n: msum[n] + metrics[n] for n in msum}
        del grads
    torch._foreach_div_(list(total.values()), float(n_pods))
    return total, {n: m / n_pods for n, m in msum.items()}


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
    ``microbatches``. ``compress_pod`` needs ``model.mesh`` with a ``pod``
    axis (``ValueError`` without one) and a state with ``ef``
    (``init_train_state(..., compress_pod=True, n_pods=)``); B is then a
    multiple of pods x microbatches."""
    n_pods = 0
    if compress_pod:
        mesh = model.mesh
        if mesh is None or POD_AXIS not in mesh.axis_names:
            raise ValueError("compress_pod needs a multi-pod mesh (a 'pod' "
                             "axis)")
        n_pods = mesh.axis_size(POD_AXIS)
    own = dict(model.lm.named_parameters())

    def step_fn(state: TrainState, batch):
        if state.params.keys() != own.keys() or any(
                state.params[n] is not p for n, p in own.items()):
            raise ValueError("state.params are not this model's parameters; "
                             "make the state with init_train_state or "
                             "bind_state")
        if n_pods:
            if state.ef is None or any(
                    e.shape[0] != n_pods for e in state.ef.values()):
                raise ValueError(f"compress_pod needs a state whose ef holds "
                                 f"{n_pods} pods' residuals")
            grads, metrics = _pod_grads(model, state.params, batch, state.ef,
                                        microbatches, n_pods)
        else:
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
