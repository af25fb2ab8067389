"""The assigned input shapes, their runnability rule and ``input_specs``
(the port of ``repro/configs/shapes.py``).

Four shapes per architecture:

  train_4k     seq 4096,   global_batch 256  -> the train step
  prefill_32k  seq 32768,  global_batch 32   -> the prefill step
  decode_32k   seq 32768,  global_batch 128  -> the decode step (one new
                                                token, a cache of seq_len)
  long_500k    seq 524288, global_batch 1    -> the decode step; only for
               the sub-quadratic families (ssm, hybrid); full-attention
               archs skip.

``input_specs`` returns tensors on PyTorch's ``meta`` device, the
counterpart of the reference's ``ShapeDtypeStruct``s: the names, shapes and
dtypes of every input, and no storage.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def runnable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether the (arch, shape) cell runs, with the skip reason if not."""
    cell = SHAPES[shape_name]
    if cell.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, (
            f"{cfg.arch} is pure full-attention ({cfg.family}); long_500k "
            "requires sub-quadratic sequence mixing (assignment skip rule)")
    return True, ""


def runnable_cells(cfg: ModelConfig) -> list[str]:
    return [n for n in SHAPES if runnable(cfg, n)[0]]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of this cell.

    train/prefill: {'tokens', 'weight'[, 'embeds']}: a VLM's tokens are the
    sequence less its front rows, which ``embeds`` (B, n_front, d) fill;
    the encoder-decoder's ``embeds`` are ``seq_len`` frames (B, S, d) beside
    ``seq_len`` tokens. decode: {'tokens' (B, 1)}; the cache is state, not
    input (``launch/dryrun.py`` builds it).
    """
    cell = SHAPES[shape_name]
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        specs = {"weight": _meta((b,), torch.float32)}
        if cfg.family == "vlm":
            nf = cfg.num_frontend_tokens
            specs["tokens"] = _meta((b, s - nf), torch.int32)
            specs["embeds"] = _meta((b, nf, cfg.d_model), torch.float32)
        elif cfg.family == "audio":
            specs["tokens"] = _meta((b, s), torch.int32)
            specs["embeds"] = _meta((b, s, cfg.d_model), torch.float32)
        else:
            specs["tokens"] = _meta((b, s), torch.int32)
        return specs
    return {"tokens": _meta((b, 1), torch.int32)}


def cache_shape(cfg: ModelConfig, shape_name: str) -> tuple[int, int]:
    """(batch, max_len) of the decode cache of this cell."""
    cell = SHAPES[shape_name]
    return cell.global_batch, cell.seq_len
