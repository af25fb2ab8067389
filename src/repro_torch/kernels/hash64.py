"""murmur3-fmix32 column hash: the wrapper of ``csrc/hash32.cu``.

Replaces ``repro/kernels/hash64.py::hash32`` (the Pallas ``_hash_kernel``):
the hash-partition and hash-join hot spot. On this card it is bound by bytes
(the function needs 4 B in and 4 B out a row, a few integer ops; the int64
holder writes 4 B more); the kernel reads and writes each row once with
16-byte vector accesses (see the source's note).

The result holds unsigned 32-bit hashes in int64 (values in [0, 2**32)),
the port's convention for u32 values (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

HASH_DTYPES = (torch.int32, torch.uint32, torch.float32)


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash a 1-D int32/uint32/float32 column to u32 (int64 holder).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``hash32.launches``) or raises.
    """
    if x.ndim != 1 or x.dtype not in HASH_DTYPES:
        raise TypeError(f"hash32 takes a 1-D int32/uint32/float32 column, "
                        f"got shape={tuple(x.shape)} dtype={x.dtype}")
    if x.device.type == "cpu":
        return ref.hash32_ref(x, seed)
    if x.device.type != "cuda":
        raise ValueError(f"hash32: unsupported device {x.device}")
    from repro_torch.kernels._build import check, library, stream_ptr

    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    n = x.numel()
    if n:
        vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        check("hash32", library().repro_hash32(
            x.data_ptr(), out.data_ptr(), n, seed & ref.U32, vec,
            stream_ptr(x)))
        hash32.launches += 1
    return out


hash32.launches = 0
