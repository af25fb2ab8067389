"""Build and load the CUDA kernels: one shared library with a plain C
interface, bound with ``ctypes``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one ``.so``
under ``<repo>/build/repro_torch_kernels/``, named by a hash of the sources,
the headers they include (``csrc/*.cuh``) and the flags, so that an edited
source or header rebuilds. Nothing is compiled when the
module is imported: the CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float
# C entry point -> argtypes; every one returns cudaGetLastError() as int
SIGNATURES = {
    "repro_hash32": [_P, _P, _LL, _U, _I, _P],
    "repro_hash32_partition": [_P, _I, _P, _LL, _U, _U, _P, _I, _P],
    "repro_hash32_partition_max_columns": [],
    "repro_histogram": [_P, _P, _LL, _I, _P, _P],
    "repro_histogram_scratch_ints": [],
    "repro_histogram_rows_per_step": [],
    "repro_histogram_max_blocks": [],
    "repro_bitonic": [_P, _P, _P, _P, _LL, _I, _P],
    "repro_bitonic_permutation": [_P, _I, _I, _P, _P, _P],
    "repro_bitonic_probe": [ctypes.c_ulonglong, _I, _P, _P],
    "repro_segment_reduce": [_P, _P, _P, _LL, _I, _I, _I, _P, _P, _P],
    "repro_segment_reduce_rows_per_block": [],
    "repro_segment_scan": [_P, _P, _P, _LL, _I, _I, _I, _P, _U, _P],
    "repro_segment_scan_epochs": [],
    "repro_segment_scan_rows_per_block": [],
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _I, _I, _P],
    "repro_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
    "repro_flash_attention_bwd_workspace": [_I] * 8,
    "repro_flash_attention_bwd_splits": [_I] * 5,
    "repro_flash_attention_smem": [_I, _I],
    "repro_flash_attention_bwd_smem": [_I, _I, _I],
}
# the entry points that return something else than int
RESTYPES = {"repro_flash_attention_bwd_workspace": _LL}
# per source of the last build in this process: (nvcc seconds, nvcc output)
LOGS: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def sources() -> list[Path]:
    """The translation units nvcc compiles, one process each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels (in parallel, one nvcc per source) and link the
    shared library, unless an up-to-date one exists. Returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        t0 = time.perf_counter()
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            # all start together, so this is the time until this one was done
            LOGS[src.name] = (time.perf_counter() - t0, log)
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, out)  # atomic: concurrent loaders see all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
