"""Atomic-commit checkpoints with integrity digests, the port of
``repro/train/checkpoint.py``, in the same on-disk format.

* **Atomic commit**: state is written into ``<dir>/tmp.<step>`` and renamed
  to ``<dir>/step_<n:08d>`` only after every leaf and the manifest are
  written and the manifest fsync'd; a crash mid-save never corrupts the
  latest checkpoint.
* **Format**: one ``.npy`` a leaf, ``<i:05d>_<path>.npy`` in the tree's
  leaf order (dict keys sorted, as JAX flattens), and ``manifest.json``
  with ``{file, shape, dtype, nbytes, crc32}`` a leaf; a bf16 leaf is
  stored as its uint16 bits and named ``"bfloat16"``. The two packages read
  each other's checkpoints.
* **Async save**: the state is copied to the host on the caller's thread
  before ``save`` returns (the train step updates it in place), then
  written on a background thread.
* **Retention**: keep the last ``keep`` checkpoints; older ones are deleted
  only after a newer commit.
* **Corruption detection and fallback**: ``restore`` checks every leaf's
  byte length and crc32 against the manifest and raises
  :class:`CheckpointCorruptError` on a truncated, bit-flipped or missing
  leaf or an unreadable manifest; :meth:`CheckpointManager.resume` falls
  back to the newest checkpoint that does verify, with a warning.

``restore`` loads into the tensors of ``like`` in place, as
``load_state_dict`` does, after every leaf has verified on the host: the
state on the card is not held twice, and a checkpoint that fails leaves
``like`` untouched.

**Elastic restore**: leaves are stored as full logical arrays, so a
checkpoint written under one mesh restores under any other. ``restore``
and :meth:`CheckpointManager.resume` take the reference's ``mesh`` and
``specs``: on the port's virtual mesh every device is the one card, so the
leaves land where ``like``'s tensors are, and ``specs`` (the reference's
partition specs, which place arrays and change no value) is not read.
A train state's pod-compression residuals ``ef`` ride as its last field,
after ``step``, as the reference's ``TrainState`` orders them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any

import numpy as np
import torch

MANIFEST = "manifest.json"

# torch dtype -> the name the manifest gives it (numpy's, and ml_dtypes'):
# the dtypes of the port's train state
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int32: "int32"}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its integrity check (truncated or corrupt)."""


def _flatten(tree, path=()):
    """[(path, leaf)] in JAX's leaf order: dict keys sorted, tuples and
    NamedTuples by position, None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), path + (f,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree) for x in _flatten(t, path + (i,))]
    return [(path, tree)]


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    return [("_".join(str(p) for p in path), leaf)
            for path, leaf in _flatten(tree)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(a numpy copy of a tensor's bits, its logical dtype name)."""
    t = leaf.detach()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:  # numpy has no bf16: keep the raw bits
        t = t.view(torch.int16)
    arr = t.cpu().numpy().copy()
    if name == "bfloat16":
        arr = arr.view(np.uint16)
    return arr, name


def save(ckpt_dir: str, step: int, state: Any, *, keep: int = 3,
         blocking: bool = True) -> threading.Thread | None:
    """Atomically write ``state`` (nested dicts, tuples and NamedTuples of
    tensors) as checkpoint ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # snapshot to host on the caller's thread: the state captured is the
    # state at call time even if saving is async
    host = [(name, *_to_host(leaf)) for name, leaf in _leaf_paths(state)]

    def _write():
        tmp = os.path.join(ckpt_dir, f"tmp.{step}")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr, logical) in enumerate(host):
            fn = f"{i:05d}_{name[:80]}.npy"
            np.save(os.path.join(tmp, fn), arr)
            raw = np.ascontiguousarray(arr)
            manifest["leaves"].append(
                {"file": fn, "shape": list(arr.shape), "dtype": logical,
                 "nbytes": int(raw.nbytes),
                 "crc32": zlib.crc32(raw.tobytes()) & 0xFFFFFFFF})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # the atomic commit point
        _retain(ckpt_dir, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _readable_manifest(path: str) -> bool:
    """True when the manifest parses: a half-written manifest marks the
    whole step unreadable rather than failing later in ``restore``."""
    try:
        with open(path) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and _readable_manifest(
                os.path.join(ckpt_dir, d, MANIFEST)):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_leaf(d: str, step: int, m: dict) -> torch.Tensor:
    """One leaf, verified against its manifest entry, as a CPU tensor."""
    try:
        arr = np.load(os.path.join(d, m["file"]))
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"step {step}: leaf {m['file']} unreadable ({e})") from e
    # manifests from before digests existed verify trivially
    if "nbytes" in m:
        raw = np.ascontiguousarray(arr)
        if int(raw.nbytes) != int(m["nbytes"]):
            raise CheckpointCorruptError(
                f"step {step}: leaf {m['file']} truncated "
                f"({raw.nbytes} bytes, manifest says {m['nbytes']})")
        crc = zlib.crc32(raw.tobytes()) & 0xFFFFFFFF
        if crc != int(m["crc32"]):
            raise CheckpointCorruptError(
                f"step {step}: leaf {m['file']} fails crc32 "
                f"({crc:#x} != {int(m['crc32']):#x})")
    arr = np.asarray(arr, order="C")  # (ascontiguousarray makes 0-d 1-d)
    if m["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if m["dtype"] != str(arr.dtype):
        raise ValueError(f"step {step}: leaf {m['file']} holds {m['dtype']} "
                         f"as {arr.dtype}, which the port does not read")
    return torch.from_numpy(arr)


def read_leaves(ckpt_dir: str, step: int) -> list[torch.Tensor]:
    """Every leaf of checkpoint ``step``, verified, as CPU tensors in the
    manifest's order (for a tree the caller knows, e.g. one the reference
    wrote, which ``convert`` then maps onto the port's)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"step {step}: unreadable manifest ({e})") from e
    return [_load_leaf(d, step, m) for m in manifest["leaves"]]


def restore(ckpt_dir: str, step: int, like: Any, *, mesh=None, specs=None
            ) -> Any:
    """Load checkpoint ``step`` into the tensors of ``like`` (its structure,
    shapes and devices), in place, and return ``like``. Every leaf is read
    and verified before any tensor of ``like`` is written. ``mesh`` and
    ``specs``: the elastic restore's target (module docstring)."""
    flat = _leaf_paths(like)
    loaded = read_leaves(ckpt_dir, step)
    if len(flat) != len(loaded):
        raise ValueError(f"tree mismatch: {len(flat)} leaves vs "
                         f"{len(loaded)} in the checkpoint")
    for (name, leaf), arr in zip(flat, loaded):
        if tuple(leaf.shape) != tuple(arr.shape):
            raise ValueError(f"step {step}: leaf {name} has shape "
                             f"{tuple(arr.shape)}, want {tuple(leaf.shape)}")
    with torch.no_grad():
        for (_, leaf), arr in zip(flat, loaded):
            leaf.copy_(arr)
    return like


class CheckpointManager:
    """Save every N steps, auto-resume and async writes, for the train
    loop."""

    def __init__(self, ckpt_dir: str, *, every: int = 50, keep: int = 3,
                 async_save: bool = True):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, state) -> bool:
        if step % self.every:
            return False
        self.wait()
        self._pending = save(self.dir, step, state, keep=self.keep,
                             blocking=not self.async_save)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def resume(self, like, *, mesh=None, specs=None):
        """(state, step) from the newest checkpoint that verifies, or
        (None, 0). A truncated or corrupt newest checkpoint is skipped with
        a warning and the next-newest retained step is tried. ``mesh`` and
        ``specs`` go to :func:`restore`."""
        bad = []
        for step in reversed(list_steps(self.dir)):
            try:
                state = restore(self.dir, step, like, mesh=mesh, specs=specs)
            except CheckpointCorruptError as e:
                bad.append(step)
                warnings.warn(
                    f"checkpoint step {step} is corrupt, trying an older "
                    f"one: {e}", RuntimeWarning, stacklevel=2)
                continue
            if bad:
                warnings.warn(
                    f"resumed from step {step}; corrupt step(s) "
                    f"{sorted(bad)} were skipped", RuntimeWarning,
                    stacklevel=2)
            return state, step
        return None, 0
