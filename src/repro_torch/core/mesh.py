"""VirtualMesh: p shards in one process, in place of ``shard_map`` and the
``jax.lax`` collectives the reference's operators use.

Per-shard values are stacked on a leading shard axis of length p. A
collective is one call over all shards:

- ``all_to_all`` takes the ``(p_src, p_dst, width, ...)`` send buffers of
  every shard and returns ``(p_dst, p_src, width, ...)``: shard i receives,
  at slot j, what shard j sent to i (``lax.all_to_all(split_axis=0,
  concat_axis=0, tiled=True)``);
- ``all_gather`` gives every shard the stacked ``(p, ...)`` values (one
  tensor that all shards read);
- ``ppermute`` moves shard ``src``'s value to shard ``dst`` for each pair
  of the permutation; shards that receive nothing get zeros;
- ``psum`` and ``pmax`` reduce the ``(p, ...)`` per-shard values to the one
  value every shard holds after ``lax.psum`` / ``lax.pmax``: the sum taken
  in shard order, one add at a time in the values' dtype.

Every collective issued is counted in :attr:`counts` by name, so that
wire accounting and a collective audit have something to read, and is
reported to every active counter (a ``TorchDispatchMode`` with a
``collective(kind, nbytes)`` context, ``roofline.analysis.StepCost``) with
its per-shard result bytes summed over the shards; the mesh's own ops
inside it are the collective's, not the step's.

:class:`NamedMesh` is the reference's named multi-axis mesh (``("pod",
"data", "model")`` or ``("data", "model")``, ``repro/launch/mesh.py``)
over virtual devices: it holds the axes' sizes, and a one-axis
``VirtualMesh`` view of any tuple of its axes (``view``), whose shards are
the axes' index tuples in row-major order and whose collectives count in
the mesh's own :attr:`NamedMesh.counts`.
"""
from __future__ import annotations

import contextlib
import math
from collections import Counter
from typing import Sequence

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


_UNTOLD = contextlib.nullcontext()


def issued(kind: str, nbytes: float, count: int = 1):
    """``count`` collectives of ``kind``, ``nbytes`` of results over all
    shards, told to every active counter for the length of the block (0:
    the block is part of one already told); a no-op with no mode active."""
    if not torch._C._len_torch_dispatch_stack():
        return _UNTOLD
    return _told(kind, nbytes, count)


@contextlib.contextmanager
def _told(kind: str, nbytes: float, count: int):
    with contextlib.ExitStack() as stack:
        for mode in _get_current_dispatch_mode_stack():
            if hasattr(mode, "collective"):
                stack.enter_context(mode.collective(kind, nbytes, count))
        yield


class VirtualMesh:
    """One mesh axis of ``num_shards`` virtual shards."""

    def __init__(self, num_shards: int, counts: Counter | None = None):
        if num_shards < 1:
            raise ValueError(num_shards)
        self.num_shards = num_shards
        self.counts: Counter = Counter() if counts is None else counts

    @property
    def axis_size(self) -> int:
        return self.num_shards

    def axis_index(self, shard: int) -> int:
        if not 0 <= shard < self.num_shards:
            raise IndexError(shard)
        return shard

    def reset_counts(self) -> None:
        self.counts.clear()

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """(p_src, p_dst, ...) send buffers -> (p_dst, p_src, ...) received."""
        p = self.num_shards
        if buf.shape[0] != p or buf.shape[1] != p:
            raise ValueError(f"all_to_all needs a ({p}, {p}, ...) buffer, got "
                             f"{tuple(buf.shape)}")
        self.counts["all_to_all"] += 1
        with issued("all_to_all", buf.numel() * buf.element_size()):
            return buf.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(p, ...) per-shard values -> the (p, ...) stack every shard sees."""
        if x.shape[0] != self.num_shards:
            raise ValueError(f"all_gather needs a leading shard axis, got "
                             f"{tuple(x.shape)}")
        self.counts["all_gather"] += 1
        with issued("all_gather",
                     self.num_shards * x.numel() * x.element_size()):
            return x

    def _stacked(self, name: str, x: torch.Tensor) -> None:
        if x.shape[0] != self.num_shards:
            raise ValueError(f"{name} needs a leading shard axis of "
                             f"{self.num_shards}, got {tuple(x.shape)}")
        self.counts[name] += 1

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(p, ...) per-shard values -> their sum, added in shard order."""
        self._stacked("psum", x)
        with issued("psum", x.numel() * x.element_size()):
            out = x[0]
            for i in range(1, self.num_shards):
                out = out + x[i]
            return out

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """(p, ...) per-shard values -> their elementwise maximum."""
        self._stacked("pmax", x)
        with issued("pmax", x.numel() * x.element_size()):
            return torch.amax(x, dim=0)

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """(p, ...) per-shard values -> out[dst] = x[src] for (src, dst) in
        ``perm``; other shards get zeros."""
        p = self.num_shards
        if x.shape[0] != p:
            raise ValueError(f"ppermute needs a leading shard axis, got "
                             f"{tuple(x.shape)}")
        self.counts["ppermute"] += 1
        with issued("ppermute", x.numel() * x.element_size()):
            out = torch.zeros_like(x)
            if perm:
                src = torch.tensor([s for s, _ in perm], device=x.device)
                dst = torch.tensor([d for _, d in perm], device=x.device)
                out[dst] = x[src]
            return out


class NamedMesh:
    """A named mesh of virtual devices: ``shape`` maps each axis name, in
    order, to its size (the reference's ``dict(mesh.shape)``)."""

    def __init__(self, shape: dict[str, int]):
        if not shape or any(n < 1 for n in shape.values()):
            raise ValueError(f"mesh shape {shape}")
        self.shape = dict(shape)
        self.counts: Counter = Counter()

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def axis_size(self, name: str) -> int:
        """The axis' size; 1 for an axis the mesh does not have."""
        return self.shape.get(name, 1)

    def view(self, axes: Sequence[str]) -> VirtualMesh:
        """The axes ``axes`` (each of this mesh's) as one axis of
        prod(sizes) shards, counting into :attr:`counts`."""
        missing = [a for a in axes if a not in self.shape]
        if missing or not axes:
            raise ValueError(f"axes {tuple(axes)} of a mesh {self.shape}")
        return VirtualMesh(math.prod(self.shape[a] for a in axes),
                           counts=self.counts)

    def reset_counts(self) -> None:
        self.counts.clear()

    def __repr__(self) -> str:
        return f"NamedMesh({self.shape})"
