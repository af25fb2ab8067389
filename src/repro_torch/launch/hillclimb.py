"""Config variants of three dry-run cells, each variant's roofline terms,
state bytes and fit on the production mesh (the port of
``repro/launch/hillclimb.py``; counted on meta, no card needed).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell llama3_train \\
        --out results/torch/perf_llama3.json [--variants a,b]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import fit_cell, roofline_cell
from repro_torch.launch.mesh import make_production_mesh


def measure(cfg, shape: str, mesh) -> dict:
    """A variant's roofline (``roofline_cell``) and its fit (``fit_cell``:
    state bytes, activation peak, against the card's memory)."""
    rec = roofline_cell(cfg, shape, mesh)
    rec["memory"] = fit_cell(cfg, shape, mesh)
    return rec


# --- variant sets per chosen cell -------------------------------------------

def cell_llama3_train():
    base = get_config("llama3-8b")
    return "llama3-8b", "train_4k", [
        ("baseline_tp16", base),
        ("fsdp_layout", base.replace(layout="fsdp")),
        ("fsdp_layout_remat_dots", base.replace(layout="fsdp", remat="dots")),
        ("tp16_remat_dots", base.replace(remat="dots")),
    ]


def cell_minicpm3_decode():
    base = get_config("minicpm3-4b")
    return "minicpm3-4b", "decode_32k", [
        ("baseline_latent_cache", base),
        ("latent_seqshard", base.replace(mla_seq_shard=True)),
    ]


def cell_qwen2_train():
    base = get_config("qwen2-moe-a2.7b")
    return "qwen2-moe-a2.7b", "train_4k", [
        ("baseline_ep_shuffle", base),
        ("gspmd_gathered_experts", base.replace(ep_shuffle=False)),
        ("ep_shuffle_cf1.0", base.replace(moe_capacity_factor=1.0)),
        ("ep_shuffle_cf2.0", base.replace(moe_capacity_factor=2.0)),
    ]


CELLS = {
    "llama3_train": cell_llama3_train,
    "minicpm3_decode": cell_minicpm3_decode,
    "qwen2_train": cell_qwen2_train,
}


def run(cell: str, out: dict, want=None) -> dict:
    """Each variant of ``cell`` (or those in ``want``) on the single-pod
    production mesh into ``out[arch][shape][variant]``; a variant that
    raises is recorded as its error."""
    mesh = make_production_mesh()
    arch, shape, variants = CELLS[cell]()
    for name, cfg in variants:
        if want and name not in want:
            continue
        print(f"[variant] {name}")
        try:
            rec = measure(cfg, shape, mesh)
            t, m = rec["terms"], rec["memory"]
            print(f"  compute {t['compute_s'] * 1e3:.1f}ms | mem "
                  f"{t['memory_s'] * 1e3:.1f}ms | coll "
                  f"{t['collective_s'] * 1e3:.1f}ms -> {t['dominant']} | "
                  f"peak {m['peak_bytes'] / 2**30:.1f} GiB/dev "
                  f"({'fits' if m['fits'] else 'OVER'})")
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {"error": f"{type(e).__name__}: {e}"}
            print(f"  FAIL: {e}")
        out.setdefault(arch, {}).setdefault(shape, {})[name] = rec
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--variants", default=None,
                    help="comma-separated subset of variant names")
    args = ap.parse_args(argv)
    want = set(args.variants.split(",")) if args.variants else None
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    run(args.cell, out, want)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print("[done]", args.out)


if __name__ == "__main__":
    main()
