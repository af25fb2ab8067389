"""Serving launcher of the port: batched prefill + greedy decode with a KV
cache (``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --arch llama3-8b --tiny --batch 4
--prompt-len 32 --gen 16 --device cpu`` runs a batch of synthetic prompts
through prefill, then decode steps, and prints the reference's two lines.
Without ``--device`` it runs on ``cuda`` (and raises without a card). The
weights are drawn on the host from ``--seed`` and moved to the device, so
one command serves the same model on every device. The loop is
:func:`generate`, which the tests and ``chip_smoke.py`` call too.

``--devices N --model-axis m`` serves over a mesh of N virtual devices
(``launch/mesh.make_local_mesh``): the decode's KV cache splits on its
sequence (flash-decoding, ``models/layers.py``) and an MoE arch takes the
expert-parallel prefill and the psum decode over the model axis, its
experts padded to a multiple of m.

The encoder-decoder (whisper-base) serves as the reference launcher does:
``prompt_len`` random audio frames, drawn after the tokens, go through the
encoder; the cross cache holds ``prompt_len`` rows.

A VLM's prompts carry ``num_frontend_tokens`` random front embeddings,
drawn after the tokens from the same generator, as the reference launcher
draws them. Prefill writes those front rows first, so the cache holds
``n_front + prompt_len + gen`` rows and decode step i runs at ``n_front +
prompt_len + i``. Here the port departs from the reference launcher, which
sizes the cache ``prompt_len + gen`` and decodes at ``prompt_len + i``
(``repro/launch/serve.py:47,72``): with the reference's TINY config at
``--prompt-len 8 --gen 4`` its prefill overflows the cache and raises
``TypeError``, and at its defaults decode overwrites the prompt's last
K/V rows. The port follows the reference's serving test
(``tests/test_serve.py``), which counts the front rows.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_tiny
from repro_torch.launch.mesh import flag_mesh
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
             embeds: torch.Tensor | None = None,
             forced: torch.Tensor | None = None,
             keep_logits: bool = False) -> Generation:
    """Prefill ``tokens`` (B, S), after ``embeds`` (B, n_front, d) for a
    VLM, into a cache of n_front + S + gen rows, then decode greedily:
    ``gen`` tokens in all, the first from prefill's logits (argmax over the
    padded vocab, as the reference), the rest from ``gen - 1`` decode steps
    at positions n_front + S + i. The encoder-decoder's ``embeds`` are its
    audio frames (B, S_enc, d): the encoder's input and the cross cache's
    S_enc rows, not front rows (n_front 0). ``forced`` (B, gen) feeds its
    tokens to the decode steps instead of the greedy ones (teacher
    forcing); the greedy tokens are still returned. The cache positions
    are Python ints and the tokens stay on the device: no host read inside
    the loop."""
    b, s = tokens.shape
    audio = model.cfg.family == "audio"
    front = 0 if embeds is None or audio else embeds.shape[1]
    enc_len = embeds.shape[1] if audio and embeds is not None else 0
    prefill = make_prefill_step(model, front + s + gen, enc_len)
    decode = make_decode_step(model)
    dev = tokens.device
    kept = []
    batch = {"tokens": tokens}
    if embeds is not None:
        batch["embeds"] = embeds
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(batch)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out = [tok]
        if keep_logits:
            kept.append(logits)
        _sync(dev)
        t1 = time.perf_counter()
        for i in range(gen - 1):
            fed = tok if forced is None else forced[:, i:i + 1]
            logits, cache = decode(cache, fed, front + s + i)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok)
            if keep_logits:
                kept.append(logits)
        _sync(dev)
        t2 = time.perf_counter()
    return Generation(torch.cat(out, 1), kept, cache, t1 - t0, t2 - t1)


def prompt_inputs(cfg, batch: int, prompt_len: int, seed: int, device
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Synthetic prompts as the reference launcher makes them: (tokens (B,
    prompt_len) int32, and embeds float32 standard normals drawn next from
    the same generator: a VLM's (B, num_frontend_tokens, d_model), the
    encoder-decoder's audio frames (B, prompt_len, d_model); else None)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (batch, prompt_len))
    tokens = torch.from_numpy(ids.astype(np.int32)).to(device)
    if cfg.family not in ("vlm", "audio"):
        return tokens, None
    rows = cfg.num_frontend_tokens if cfg.family == "vlm" else prompt_len
    e = rng.standard_normal((batch, rows, cfg.d_model))
    return tokens, torch.from_numpy(e.astype(np.float32)).to(device)



def main(argv=None) -> Generation:
    """The CLI; returns the :class:`Generation` (its logits kept) to a
    caller in the same process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_tiny(args.arch) if args.tiny else get_config(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, dev, mesh=flag_mesh(args.devices,
                                                 args.model_axis),
                        generator=torch.Generator().manual_seed(args.seed))
    tokens, embeds = prompt_inputs(cfg, args.batch, args.prompt_len,
                                   args.seed, dev)
    res = generate(model, tokens, args.gen, embeds=embeds, keep_logits=True)
    steps = max(args.gen - 1, 1)
    print(f"prefill: {res.prefill_s:.3f}s  decode: "
          f"{res.decode_s / steps * 1e3:.1f} ms/tok  throughput: "
          f"{args.batch * (args.gen - 1) / max(res.decode_s, 1e-9):.1f} tok/s")
    print("generated token ids (first row):", res.tokens[0][:16].cpu().numpy())
    return res


if __name__ == "__main__":
    main()
