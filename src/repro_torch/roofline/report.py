"""Render the dry run's JSON (``launch/dryrun.py``) as three markdown
sections: the dry-run matrix, the roofline table and the dominant-term
notes (the port of ``repro/roofline/report.py``), against the H100's
memory and peak.

    PYTHONPATH=src python -m repro_torch.roofline.report results/torch/dryrun.json
"""
from __future__ import annotations

import json
import sys

from repro_torch.roofline.analysis import PEAK_FLOPS

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
DEFAULT_PATH = "results/torch/dryrun.json"


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def fmt_ms(s):
    return f"{s * 1e3:.2f}"


def dryrun_table(data: dict) -> str:
    rows = ["| arch | shape | mesh | fits | GiB/dev (state + activations) | "
            "% of memory | collectives/step | count s |",
            "|---|---|---|---|---|---|---|---|"]
    for arch, shapes in data.items():
        for shape in SHAPE_ORDER:
            rec = shapes.get(shape)
            if rec is None:
                continue
            if "skipped" in rec:
                rows.append(f"| {arch} | {shape} | — | SKIP | — | — | "
                            f"{rec['skipped'].split('(')[0].strip()} | — |")
                continue
            for mesh in ("single", "multi"):
                r = rec.get(mesh)
                if r is None:
                    continue
                if not r.get("ok"):
                    rows.append(f"| {arch} | {shape} | {mesh} | FAIL | — | — "
                                f"| {r.get('error', '')[:60]} | — |")
                    continue
                m = r["memory"]
                cc = m["collective_counts"]
                cstr = " ".join(f"{k}:{v:.0f}" for k, v in sorted(cc.items()))
                rows.append(
                    f"| {arch} | {shape} | {mesh} | "
                    f"{'Y' if m['fits'] else 'OVER'} | "
                    f"{fmt_bytes(m['peak_bytes'])} "
                    f"({fmt_bytes(m['state_bytes']['total'])} + "
                    f"{fmt_bytes(m['activation_peak_bytes'])}) | "
                    f"{100 * m['hbm_frac']:.0f}% | {cstr} | "
                    f"{r['count_s']:.1f} |")
    return "\n".join(rows)


def roofline_table(data: dict) -> str:
    rows = ["| arch | shape | compute ms | memory ms (all / less score-shaped)"
            " | collective ms | dominant | MODEL_FLOPS/counted | roofline frac"
            " |",
            "|---|---|---|---|---|---|---|---|"]
    for arch, shapes in data.items():
        for shape in SHAPE_ORDER:
            r = shapes.get(shape, {}).get("roofline")
            if not r or "terms" not in r:
                continue
            t, tf = r["terms"], r["terms_flash"]
            # useful compute time over the bound of the counted work
            frac = (r["model_flops"] / r["chips"] / PEAK_FLOPS) / t["bound_s"]
            rows.append(
                f"| {arch} | {shape} | {fmt_ms(t['compute_s'])} | "
                f"{fmt_ms(t['memory_s'])} / {fmt_ms(tf['memory_s'])} | "
                f"{fmt_ms(t['collective_s'])} | {t['dominant']} | "
                f"{100 * r['useful_ratio']:.0f}% | {100 * frac:.0f}% |")
    return "\n".join(rows)


HINTS = {
    "collective": "reduce the TP degree or shard parameters instead of "
                  "activations (the fsdp layout), overlap the collectives",
    "memory": "fuse the eager elementwise chains (norms, RoPE, activations, "
              "the GLA's decay and masks, the fp32 logits) into kernels; "
              "the flash kernel already keeps the attention scores on chip",
    "compute": "at the tensor-core bound: only algorithmic wins left (MoE "
               "sparsity, shorter sequences, fewer layers)",
}


def bottleneck_notes(data: dict) -> str:
    notes = []
    for arch, shapes in data.items():
        for shape in SHAPE_ORDER:
            r = shapes.get(shape, {}).get("roofline")
            if not r or "terms" not in r:
                continue
            dom = r["terms"]["dominant"]
            notes.append(f"- **{arch} × {shape}** — {dom}-bound: "
                         f"{HINTS[dom]}.")
    return "\n".join(notes)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else DEFAULT_PATH
    with open(path) as f:
        data = json.load(f)
    print("### Dry-run matrix\n")
    print(dryrun_table(data))
    print("\n### Roofline (single pod, per step, per device, H100)\n")
    print(roofline_table(data))
    print("\n### Dominant-term notes\n")
    print(bottleneck_notes(data))


if __name__ == "__main__":
    main()
