"""murmur3-fmix32 hashes: the wrappers of ``csrc/hash32.cu``.

Replaces ``repro/kernels/hash64.py::hash32`` (the Pallas ``_hash_kernel``):
the hash-partition and hash-join hot spot. Two entries:

* :func:`hash32`, the column hash: u32 hashes in the port's int64 holder
  (values in [0, 2**32), ``kernels/ref.py``), for the hash join's sort and
  searchsorted.
* :func:`hash32_partition`, ``hash_partition``'s destination in one pass:
  the columns' combined hash ``% P`` as int32, -1 at rows past
  ``row_count``. It replaces a chain of six eager int64 passes (~66 B a
  row) with one read of the key bytes and a 4-byte write a row.

Both are bound by bytes and read and write each row once with 16-byte
vector accesses where the pointers allow (see the source's note).
"""
from __future__ import annotations

import ctypes

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


def hash32_partition(columns: list[torch.Tensor], row_count: torch.Tensor,
                     num_partitions: int, seed: int = 0) -> torch.Tensor:
    """Per-row destination of a hash partition: (n,) int32, -1 at rows
    ``>= row_count``, else the columns' combined u32 hash ``% num_partitions``
    (``ref.hash_partition_ids_ref``).

    columns: 1-D int32/uint32/float32 of one length n (at most
    ``repro_hash32_partition_max_columns()`` of them on the card);
    row_count: the table's 0-d int32 count, on the columns' device (never
    read on the host). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in ``hash32_partition.launches``) or
    raises.
    """
    if not columns:
        raise ValueError("hash32_partition needs at least one column")
    n = columns[0].shape[0] if columns[0].ndim == 1 else -1
    for c in columns:
        if c.ndim != 1 or c.dtype not in HASH_DTYPES or c.shape[0] != n:
            raise TypeError(
                f"hash32_partition takes 1-D int32/uint32/float32 columns of "
                f"one length, got shape={tuple(c.shape)} dtype={c.dtype}")
    if not 1 <= num_partitions <= torch.iinfo(torch.int32).max:
        raise ValueError(f"num_partitions must be in [1, 2**31), got "
                         f"{num_partitions}")
    dev = columns[0].device
    if row_count.ndim != 0 or row_count.dtype != torch.int32:
        raise TypeError(f"row_count must be a 0-d int32 tensor, got "
                        f"shape={tuple(row_count.shape)} dtype={row_count.dtype}")
    if any(c.device != dev for c in columns) or row_count.device != dev:
        raise ValueError("hash32_partition: columns and row_count must share "
                         "one device")
    if dev.type == "cpu":
        return ref.hash_partition_ids_ref(columns, row_count, num_partitions,
                                          seed)
    if dev.type != "cuda":
        raise ValueError(f"hash32_partition: unsupported device {dev}")
    from repro_torch.kernels._build import check, library, stream_ptr

    lib = library()
    most = lib.repro_hash32_partition_max_columns()
    if len(columns) > most:
        raise ValueError(f"hash32_partition hashes at most {most} columns on "
                         f"the card, got {len(columns)}")
    columns = [c.contiguous() for c in columns]
    pid = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        ptrs = (ctypes.c_void_p * len(columns))(*[c.data_ptr() for c in columns])
        vec = int(all(p % 16 == 0 for p in ptrs) and pid.data_ptr() % 16 == 0)
        check("hash32_partition", lib.repro_hash32_partition(
            ptrs, len(columns), pid.data_ptr(), n, seed & ref.U32,
            num_partitions, row_count.data_ptr(), vec, stream_ptr(pid)))
        hash32_partition.launches += 1
    return pid


hash32_partition.launches = 0
