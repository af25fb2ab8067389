"""Fault-tolerant training loop, the port of ``repro/train/loop.py``:
checkpoint/restart with deterministic replay.

The state is (params, opt, step, and ef under ``compress_pod``) in the
checkpoint, and the data pipeline
is a pure function of the step index, so a restarted run replays the same
batch stream from the resume step: training is bitwise reproducible across
failures on one device (``tests/test_torch_checkpoint.py``, and
``chip_smoke.py`` phase 16 on the card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.data.pipeline import RelationalTokenPipeline
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig
from repro_torch.models.common import POD_AXIS
from repro_torch.train.steps import (
    TrainState, init_ef, init_train_state, make_train_step)


def pod_count(model) -> int:
    """The model's mesh's pod axis size (1 without a mesh)."""
    return 1 if model.mesh is None else model.mesh.axis_size(POD_AXIS)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    microbatches: int = 1
    compress_pod: bool = False
    seed: int = 0


def run(model, pipeline: RelationalTokenPipeline, ocfg: OptConfig,
        lcfg: LoopConfig, *, fail_at_step: int | None = None,
        log: Callable[[str], None] = print, state: TrainState | None = None):
    """Train until ``lcfg.total_steps``, resuming from the newest checkpoint
    that verifies. ``fail_at_step``: raise after that step's checkpoint
    (fault injection for tests). Returns (state, history of metric dicts).
    Batches move to the model's device; the state's tensors are updated in
    place."""
    step_fn = make_train_step(model, ocfg, microbatches=lcfg.microbatches,
                              compress_pod=lcfg.compress_pod)
    if state is None:
        state = init_train_state(model, lcfg.seed,
                                 compress_pod=lcfg.compress_pod,
                                 n_pods=pod_count(model))
    elif lcfg.compress_pod and state.ef is None:
        state = state._replace(ef=init_ef(state.params, pod_count(model)))
    start = 0
    manager = None
    if lcfg.ckpt_dir:
        manager = ckpt.CheckpointManager(lcfg.ckpt_dir, every=lcfg.ckpt_every,
                                         keep=lcfg.ckpt_keep)
        restored, start = manager.resume(state, mesh=model.mesh)
        if restored is not None:
            state = restored
            log(f"[resume] from step {start}")

    history = []
    t0 = time.perf_counter()
    for step in range(start, lcfg.total_steps):
        batch = pipeline.global_batch(step)
        batch = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if (step + 1) % lcfg.log_every == 0 or step + 1 == lcfg.total_steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["s_per_step"] = (time.perf_counter() - t0) / (step + 1 - start)
            history.append(m)
            log(f"[step {step+1:5d}] loss={m.get('loss', float('nan')):.4f} "
                f"gnorm={m.get('grad_norm', float('nan')):.3f} "
                f"({m['s_per_step']*1e3:.0f} ms/step)")
        if manager is not None:
            manager.maybe_save(step + 1, state)
        if fail_at_step is not None and step + 1 >= fail_at_step:
            if manager is not None:
                manager.wait()
            raise RuntimeError(f"injected failure at step {step+1}")
    if manager is not None:
        manager.wait()
    return state, history
