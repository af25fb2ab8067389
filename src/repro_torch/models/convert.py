"""The JAX package's parameter tree -> the port's module state.

``params_from_jax`` takes the reference's parameter tree with numpy
leaves (``jax.tree.map(np.asarray, params)``; layers stacked on a leading
L dim) and returns the state dict of the port's network, unstacked per
layer (nested groups, the MoE's ``shared`` expert, as dotted names): the
:class:`~repro_torch.models.transformer.Transformer`'s (a VLM's with its
``front_proj``), the :class:`~repro_torch.models.zamba.Hybrid`'s
(``embed``, ``mamba.<i>.<leaf>`` from the stacked Mamba blocks, the one
``shared`` block's leaves, ``final_norm``, ``lm_head``), the
:class:`~repro_torch.models.xlstm.XLSTM`'s (``mlstm.<j>`` from the
reference's stacked index j, ``slstm.<i>`` by period) or the
:class:`~repro_torch.models.encdec.EncDec`'s (``embed``, ``dec_pos``,
``enc_layers.<i>``, ``dec_layers.<i>``, ``enc_norm``, ``dec_norm``), in
``cfg.param_dtype`` but the MoE router, which stays fp32 as the reference
keeps it (a bf16 router would round the logits that pick the routes).
Loaded with ``load_state_dict``, the port computes the same function as the
reference on the same weights.

``train_state_from_jax`` carries the reference's whole ``TrainState``
(numpy leaves) across the same way: the parameters, the optimizer's fp32
masters and moments unstacked per layer, ``count``, ``step`` and the pod
compression's residuals ``ef``, as a
:class:`~repro_torch.train.steps.TrainState` of CPU tensors that
``train.steps.bind_state(model, state)`` puts on the model.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


def _tensor(a, dtype) -> torch.Tensor:
    a = np.array(a, order="C")  # a copy; (ascontiguousarray makes 0-d 1-d)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dtype)
    return torch.from_numpy(a).to(dtype)


# per-layer leaves kept in fp32 whatever ``param_dtype`` is
FP32_LEAVES = ("moe.router",)


def _layer_leaves(group, prefix: str):
    """(dotted name, stacked leaf) of a per-layer group, nested dicts
    flattened."""
    for name, leaf in group.items():
        if isinstance(leaf, dict):
            yield from _layer_leaves(leaf, f"{prefix}{name}.")
        else:
            yield prefix + name, leaf


def _unstack(sd: dict, group, prefix: str, dt) -> None:
    """A stacked group's leaves into ``sd`` as ``<prefix>.<i>.<leaf>``, one
    entry a layer of the leading dim."""
    for name, leaf in _layer_leaves(group, ""):
        for i in range(leaf.shape[0]):
            sd[f"{prefix}.{i}.{name}"] = _tensor(leaf[i], dt)


def params_from_jax(tree, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    dt = cfg.param_dtype
    sd = {"embed": _tensor(tree["embed"]["table"], dt)}
    if cfg.family == "audio":
        sd["dec_pos"] = _tensor(tree["dec_pos"], dt)
        sd["enc_norm"] = _tensor(tree["enc_norm"], dt)
        sd["dec_norm"] = _tensor(tree["dec_norm"], dt)
        _unstack(sd, tree["enc_layers"], "enc_layers", dt)
        _unstack(sd, tree["dec_layers"], "dec_layers", dt)
        return sd
    sd["final_norm"] = _tensor(tree["final_norm"], dt)
    if not cfg.tie_embeddings or cfg.family in ("hybrid", "ssm"):
        sd["lm_head"] = _tensor(tree["lm_head"], dt)
    if "front_proj" in tree:
        sd["front_proj"] = _tensor(tree["front_proj"], dt)
    if cfg.family == "hybrid":
        for name, leaf in _layer_leaves(tree["shared"], "shared."):
            sd[name] = _tensor(leaf, dt)
        _unstack(sd, tree["mamba"], "mamba", dt)
        return sd
    if cfg.family == "ssm":
        # the mLSTM stack in the reference's order (period by period, the
        # trailing blocks last), as the port's ``mlstm`` list holds it
        _unstack(sd, tree["mlstm"], "mlstm", dt)
        _unstack(sd, tree["slstm"], "slstm", dt)
        return sd
    layers = tree["layers"]
    for i in range(cfg.num_layers):
        sd[f"layers.{i}.ln1"] = _tensor(layers["ln1"][i], dt)
        sd[f"layers.{i}.ln2"] = _tensor(layers["ln2"][i], dt)
        for group in ("attn", "mlp", "moe"):
            if group not in layers:
                continue
            for name, leaf in _layer_leaves(layers[group], f"{group}."):
                sd[f"layers.{i}.{name}"] = _tensor(
                    leaf[i], torch.float32 if name in FP32_LEAVES else dt)
    return sd


def _pod_row(tree, j: int):
    """Row j of every leaf's leading (pod) dim, in a nested dict."""
    if isinstance(tree, dict):
        return {k: _pod_row(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def ef_from_jax(tree, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The reference's error-feedback residuals (a parameter tree whose
    leaves carry a leading pod dim, (n_pods, *shape) fp32) -> the port's,
    {parameter name: (n_pods, *shape) fp32}: each pod's row converted as
    parameters, then stacked again on the pod dim."""
    f32 = cfg.replace(param_dtype=torch.float32)
    n_pods = np.asarray(tree["embed"]["table"]).shape[0]
    rows = [params_from_jax(_pod_row(tree, j), f32) for j in range(n_pods)]
    return {n: torch.stack([r[n] for r in rows]) for n in rows[0]}


def train_state_from_jax(tree, cfg: ModelConfig):
    """The reference's ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's, CPU tensors keyed by
    the module's parameter names; pod compression's ``ef``, if any,
    through :func:`ef_from_jax`."""
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.steps import TrainState

    f32 = cfg.replace(param_dtype=torch.float32)
    opt = OptState(master=params_from_jax(tree.opt.master, f32),
                   m=params_from_jax(tree.opt.m, f32),
                   v=params_from_jax(tree.opt.v, f32),
                   count=_tensor(tree.opt.count, torch.int32))
    ef = None if tree.ef is None else ef_from_jax(tree.ef, cfg)
    return TrainState(params=params_from_jax(tree.params, cfg), opt=opt,
                      step=_tensor(tree.step, torch.int32), ef=ef)
