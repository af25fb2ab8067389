"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]`` (``repro/launch/train.py``).

Runs the end-to-end loop, the relational token pipeline feeding the train
step, on one device: ``cuda`` unless ``--device`` asks for another (and
``cuda`` without a card raises). The weights are drawn on the host from
``--seed`` and moved to the device, so one command trains the same model
on every device; ``--log-every`` (10, as the reference's loop) sets which
steps are logged and returned.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --tiny --steps 3 --batch 8 --seq 64 --device cpu

A VLM trains its text path (the pipeline's batches carry no front
embeddings), with the reference launcher's note on stderr. The
encoder-decoder (whisper-base) raises ``ValueError`` before any step: its
encoder needs audio frames, which the pipeline does not make (the
reference launcher starts and then fails in its encoder, ``AttributeError``
on the missing embeds); ``train.steps.make_train_step`` trains it on a
batch that holds ``embeds``.

``--devices N`` (N > 1) runs over a mesh of N virtual devices on the one
device (``launch/mesh.make_local_mesh``: ``--model-axis``, ``--pod-axis``,
the rest data), printed as the reference prints it; ``--compress-pod``
trains with int8 error-feedback gradients across the pod axis:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --tiny --steps 3 --batch 8 --seq 64 --devices 8 --model-axis 2 \\
        --pod-axis 2 --compress-pod --device cpu

Axes that do not split the devices, or any axis above 1 without
``--devices``, raise ``ValueError``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_config, get_tiny
from repro_torch.data.pipeline import PipelineConfig, RelationalTokenPipeline
from repro_torch.launch.mesh import flag_mesh
from repro_torch.models.factory import build_model
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import bind_state
from repro_torch.utils import resolve_device


def main(argv=None) -> list[dict]:
    """The CLI; returns the logged steps' metrics to a caller in the same
    process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--pod-axis", type=int, default=1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    if cfg.family == "audio":
        raise ValueError(
            f"{args.arch}: the encoder-decoder trains on audio frames with "
            f"its tokens, and the token pipeline feeds tokens only; train it "
            f"through train.steps.make_train_step with a batch holding "
            f"'embeds' (B, S_enc, {cfg.d_model})")
    dev = resolve_device(args.device)
    mesh = flag_mesh(args.devices, args.model_axis, args.pod_axis)
    if mesh is not None:
        print(f"mesh: {mesh.shape}")
    model = build_model(cfg, dev, mesh=mesh,
                        generator=torch.Generator().manual_seed(args.seed))
    if cfg.family == "vlm":
        print(f"note: {cfg.family} frontend is a stub; launcher trains the "
              "text path (tokens only) — use examples/ for full-batch runs",
              file=sys.stderr)
    pipe = RelationalTokenPipeline(PipelineConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size, seed=args.seed), device=dev)
    ocfg = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                     total_steps=args.steps)
    lcfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=args.log_every,
                      microbatches=args.microbatches,
                      compress_pod=args.compress_pod, seed=args.seed)
    _, history = run(model, pipe, ocfg, lcfg, state=bind_state(model))
    if history:
        print(f"final loss: {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
