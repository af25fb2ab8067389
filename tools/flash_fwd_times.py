"""Time the forward flash entries of the checkout this runs in, on one CUDA
card: the serving entry at the MoE prefill layers' shapes (group sizes 1
and 6), llama3-8b's (row 6 of PERF.md's kernel table), hd 160 and hd 16,
and the LSE (training) entry at granite-3-2b's and qwen2-moe-a2.7b's
microbatch. Each is the median of 30 calls by chip_smoke.py's ``Timer``
(CUDA events, L2 flushed), beside its largest difference from the plain
version. Prints one JSON line.

To compare two commits on one card, unpack both and run this from each
root in turns in one command, e.g. parent, change, change, parent:

    python3 tools/flash_fwd_times.py change
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_lse)

SHAPES = (("g1", (4, 1024, 16, 16, 128), flash_attention),
          ("g6", (4, 1024, 48, 8, 128), flash_attention),
          ("row6", (4, 1024, 32, 8, 128), flash_attention),
          ("hd160", (4, 1024, 32, 8, 160), flash_attention),
          ("hd16", (4, 1024, 32, 8, 16), flash_attention),
          ("lse64", (2, 1024, 32, 8, 64), flash_attention_lse),
          ("lse_g1", (2, 1024, 16, 16, 128), flash_attention_lse))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    S._build.build()
    timer = S.Timer(dev)
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "card": S.nvidia_smi()}
    g = torch.Generator(device=dev).manual_seed(12)
    for name, (b, s, h, kv, hd), fn in SHAPES:
        q, k, v = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                   for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
        got = fn(q, k, v)
        got = got[0] if isinstance(got, tuple) else got
        err = float((got - ref.attention_ref(q, k, v)).float().abs().max())
        out[name] = {"ms": timer(lambda: fn(q, k, v), reps=30),
                     "max_abs_err": err}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
