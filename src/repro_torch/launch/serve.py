"""Serving launcher of the port: batched prefill + greedy decode with a KV
cache (``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --arch llama3-8b --tiny --batch 4
--prompt-len 32 --gen 16 --device cpu`` runs a batch of synthetic prompts
through prefill, then decode steps, and prints the reference's two lines.
Without ``--device`` it runs on ``cuda`` (and raises without a card). The
weights are drawn on the host from ``--seed`` and moved to the device, so
one command serves the same model on every device. The loop is
:func:`generate`, which the tests and ``chip_smoke.py`` call too.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_tiny
from repro_torch.models.factory import Model, build_model
from repro_torch.train.steps import make_decode_step, make_prefill_step
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor          # (B, gen) int32: the greedy tokens
    # with keep_logits: gen x (B, V), prefill's (padded vocab), then each
    # decode step's (vocab_size)
    logits: list[torch.Tensor]
    cache: dict[str, torch.Tensor]
    prefill_s: float              # prefill and its argmax
    decode_s: float               # the gen - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, tokens: torch.Tensor, gen: int, *,
             forced: torch.Tensor | None = None,
             keep_logits: bool = False) -> Generation:
    """Prefill ``tokens`` (B, S) into a cache of S + gen rows, then decode
    greedily: ``gen`` tokens in all, the first from prefill's logits (argmax
    over the padded vocab, as the reference), the rest from ``gen - 1``
    decode steps. ``forced`` (B, gen) feeds its tokens to the decode steps
    instead of the greedy ones (teacher forcing); the greedy tokens are
    still returned. The cache positions are Python ints and the tokens stay
    on the device: no host read inside the loop."""
    b, s = tokens.shape
    prefill = make_prefill_step(model, s + gen)
    decode = make_decode_step(model)
    dev = tokens.device
    kept = []
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill({"tokens": tokens})
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out = [tok]
        if keep_logits:
            kept.append(logits)
        _sync(dev)
        t1 = time.perf_counter()
        for i in range(gen - 1):
            fed = tok if forced is None else forced[:, i:i + 1]
            logits, cache = decode(cache, fed, s + i)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok)
            if keep_logits:
                kept.append(logits)
        _sync(dev)
        t2 = time.perf_counter()
    return Generation(torch.cat(out, 1), kept, cache, t1 - t0, t2 - t1)


def prompts(cfg, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    """Synthetic prompts as the reference launcher makes them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (batch, prompt_len))
    return torch.from_numpy(ids.astype(np.int32)).to(device)


def main(argv=None) -> Generation:
    """The CLI; returns the :class:`Generation` (its logits kept) to a
    caller in the same process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, dev,
                        generator=torch.Generator().manual_seed(args.seed))
    tokens = prompts(cfg, args.batch, args.prompt_len, args.seed, dev)
    res = generate(model, tokens, args.gen, keep_logits=True)
    steps = max(args.gen - 1, 1)
    print(f"prefill: {res.prefill_s:.3f}s  decode: "
          f"{res.decode_s / steps * 1e3:.1f} ms/tok  throughput: "
          f"{args.batch * (args.gen - 1) / max(res.decode_s, 1e-9):.1f} tok/s")
    print("generated token ids (first row):", res.tokens[0][:16].cpu().numpy())
    return res


if __name__ == "__main__":
    main()
