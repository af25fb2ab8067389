"""PyTorch/CUDA port of the distributed relational engine in ``repro``.

The package mirrors ``repro``'s module layout (``core.table``,
``core.ops_local``, ``core.ops_agg``, ``core.repartition``,
``core.ops_dist``, ``core.context``, ``kernels.*``, ``data.synthetic``) and
holds the same contracts: fixed-capacity columnar tables with front-compacted
valid rows, hash-partition + AllToAll shuffles with the same accounting, and
the same operator results bit for bit on integer-valued data.

It imports ``torch`` and ``numpy`` only. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; asking for ``cuda`` without a card
raises. On a CUDA tensor every kernel wrapper launches its hand-written
Hopper kernel (``kernels/csrc``); on a CPU tensor it takes the kernel's plain
PyTorch version (``kernels/ref.py``).
"""
