"""Time the flash entries of the checkout this runs in, on one CUDA card:
the serving entry at the MoE prefill layers' shapes (group sizes 1 and 6),
llama3-8b's (row 6 of PERF.md's kernel table), hd 160, hd 16 and
minicpm3-4b's MLA widths (q k 96, p v 64), the LSE (training) entry at
granite-3-2b's, qwen2-moe-a2.7b's and minicpm3-4b's microbatch, and the
backward at the training shapes of PERF.md's rows 6b, 6b', 6b" and MLA's.
Each is the median of 30 calls by chip_smoke.py's ``Timer`` (CUDA events,
L2 flushed), beside its largest difference from the plain version; a
shape the checkout has no instance for is reported as such. Prints one
JSON line.

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
    flash_attention, flash_attention_bwd, flash_attention_lse)

# (name, (B, S, H, KV, q k width, p v width), entry)
SHAPES = (("g1", (4, 1024, 16, 16, 128, 128), flash_attention),
          ("g6", (4, 1024, 48, 8, 128, 128), flash_attention),
          ("row6", (4, 1024, 32, 8, 128, 128), flash_attention),
          ("hd160", (4, 1024, 32, 8, 160, 160), flash_attention),
          ("hd16", (4, 1024, 32, 8, 16, 16), flash_attention),
          ("mla", (4, 1024, 40, 40, 96, 64), flash_attention),
          ("lse64", (2, 1024, 32, 8, 64, 64), flash_attention_lse),
          ("lse_g1", (2, 1024, 16, 16, 128, 128), flash_attention_lse),
          ("lse_mla", (1, 1024, 40, 40, 96, 64), flash_attention_lse),
          ("bwd64", (2, 1024, 32, 8, 64, 64), flash_attention_bwd),
          ("bwd160", (1, 1024, 32, 8, 160, 160), flash_attention_bwd),
          ("bwd16", (4, 1024, 32, 8, 16, 16), flash_attention_bwd),
          ("bwd_mla", (1, 1024, 40, 40, 96, 64), flash_attention_bwd))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    S._build.build()
    timer = S.Timer(dev)
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(),
           "card": S.nvidia_smi()}
    g = torch.Generator(device=dev).manual_seed(12)
    for name, (b, s, h, kv, hd, dv), fn in SHAPES:
        q, k = (torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)
                for sh in ((b, s, h, hd), (b, s, kv, hd)))
        v = torch.randn((b, s, kv, dv), generator=g, device=dev).to(torch.bfloat16)
        try:  # the kernels first: a checkout without the instance raises
            if fn is flash_attention_bwd:
                o, lse = flash_attention_lse(q, k, v)
                do = torch.randn_like(o)
                args = (q, k, v, o, lse, do)
            else:
                args = (q, k, v)
            got = fn(*args)
        except (TypeError, ValueError) as e:  # no instance in this checkout
            out[name] = {"no_instance": str(e)[:120]}
            continue
        if fn is flash_attention_bwd:
            want = ref.attention_bwd_ref(q, k, v, do)
        else:
            want = (ref.attention_ref(q, k, v),)
        got = (got[0],) if fn is flash_attention_lse else \
            got if isinstance(got, tuple) else (got,)
        err = max(float((a - w).float().abs().max()) for a, w in zip(got, want))
        out[name] = {"ms": timer(lambda: fn(*args), reps=30), "max_abs_err": err}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
