"""Small shared utilities: pow2 math, rounding and device resolution."""
from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(n: int, m: int) -> int:
    return ceil_div(n, m) * m


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. Asking for ``cuda`` without a card raises; there is no silent
    move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU")
    return dev
