"""The kernels' route for tensors on PyTorch's ``meta`` device.

A wrapper given meta tensors (the dry run's, ``launch/dryrun.py``) runs no
kernel and no plain version: it returns an empty output of the kernel's
shape and dtype and records the kernel's own work, its products and the
bytes it moves (each input read once, each output written once, the
formulas of PERF.md's kernel table), with every active counter: each
``TorchDispatchMode`` on the stack that has a ``record_kernel(name, flops,
nbytes)`` method (``roofline.analysis.StepCost``). The plain version would
count work the card never does, such as flash's (B, H, S, S) scores. A CUDA
tensor still launches its kernel, and a CPU tensor still takes the plain
version.
"""
from __future__ import annotations

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def record(name: str, flops: float, nbytes: float) -> None:
    """Give one kernel call's work to every active counter."""
    for mode in _get_current_dispatch_mode_stack():
        rec = getattr(mode, "record_kernel", None)
        if rec is not None:
            rec(name, flops, nbytes)
