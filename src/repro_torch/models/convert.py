"""The JAX package's parameter tree -> the port's module state.

``params_from_jax`` takes the reference's LM parameter tree with numpy
leaves (``jax.tree.map(np.asarray, params)``; layers stacked on a leading
L dim) and returns the state dict of
:class:`~repro_torch.models.transformer.Transformer`, unstacked per layer,
in ``cfg.param_dtype``. Loaded with ``load_state_dict``, the port computes
the same function as the reference on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


def _tensor(a, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(dtype)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(dtype)


def params_from_jax(tree, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    dt = cfg.param_dtype
    sd = {"embed": _tensor(tree["embed"]["table"], dt),
          "final_norm": _tensor(tree["final_norm"], dt)}
    if not cfg.tie_embeddings:
        sd["lm_head"] = _tensor(tree["lm_head"], dt)
    layers = tree["layers"]
    for i in range(cfg.num_layers):
        sd[f"layers.{i}.ln1"] = _tensor(layers["ln1"][i], dt)
        sd[f"layers.{i}.ln2"] = _tensor(layers["ln2"][i], dt)
        for group in ("attn", "mlp"):
            for name, leaf in layers[group].items():
                sd[f"layers.{i}.{group}.{name}"] = _tensor(leaf[i], dt)
    return sd
