"""The dry run of the port (``repro/launch/dryrun.py``): for every (arch x
input shape x mesh) cell, whether it fits a device of the production mesh
and what its three roofline terms are on an H100, with no card.

The reference lowers each cell's step over 512 fake XLA devices with
sharded ``ShapeDtypeStruct``s and reads the compiled executable. The port
has no compile step; it builds the same step (``train/steps.py``'s
``make_train_step``, ``make_prefill_step``, ``make_decode_step``) over a
model on PyTorch's ``meta`` device (``factory.build_model(cfg, "meta")``),
on the inputs of ``configs/shapes.input_specs``, runs it once under
``roofline.analysis.StepCost`` and reads the count:

- **fits** (:func:`fit_cell`): the state's per-device bytes, exact from the
  specs (parameters, and the optimizer state by the master specs for
  training, or the decode cache; ``analysis.state_bytes``), plus an
  activation peak: the live-bytes peak of one microbatch's step (the arch's
  remat and microbatch size) counted at two depths and extrapolated to full
  depth, as every other count, over the mesh's devices. Their sum against
  the card's memory (80 GB without a card).
- **roofline** (:func:`roofline_cell`, single pod): the step at two depths
  (``_depth_pairs``: a hybrid's periods and remainder, xLSTM's periods
  (and remainder), one layer otherwise; the audio encoder at the same
  depth), one microbatch, ``remat="none"``, extrapolated with
  ``DepthPair`` to full depth; per device is the global count over the
  mesh's devices (even sharding assumed). ``terms_flash`` drops the
  score-shaped bytes eager code still moves.
- **measure** (:func:`measure_cell`, ``--measure``, the counterpart of the
  reference's compile proof): one data shard's step (global batch / data
  rows of the single-pod mesh, the model axis of 16 as virtual shards)
  with the whole model at two depths on the card: wall and device ms, peak
  memory, their extrapolation to full depth, and the bound of the same
  work (its meta count over the card's roofs and the datasheet's).

Usage (``PYTHONPATH=src``; the dry run needs no card):

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
        [--mesh single|multi|both] [--roofline] [--out results.json] [--merge]
    python -m repro_torch.launch.dryrun --all --roofline
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
        --measure [--device cpu]        # on the card unless --device cpu
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config, train_microbatches
from repro_torch.configs.shapes import SHAPES, cache_shape, input_specs, runnable
from repro_torch.core.mesh import NamedMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.factory import build_model
from repro_torch.roofline import analysis as RA
from repro_torch.train import steps as ST
from repro_torch.train.optimizer import OptConfig
from repro_torch.utils import resolve_device

DEFAULT_OUT = "results/torch/dryrun.json"
SEED = 0


def _microbatches(model, cfg, cell, microbatches: int | None) -> int:
    """The reference's rule: the arch's count, at most the rows a dp shard
    holds (the fsdp layout's model axis is a batch axis too)."""
    mb = microbatches if microbatches is not None \
        else train_microbatches(cfg.arch)
    r = model.rules
    dp = r.pod * r.data * (r.model if r.layout == "fsdp" else 1)
    return max(1, min(mb, cell.global_batch // max(dp, 1)))


def _inputs(cfg, shape_name: str, rows: int | None, device, generator):
    """The cell's inputs: ``input_specs`` on meta, or drawn on ``device``
    (tokens in [1, vocab), weight 1, embeds N(0, 1)), ``rows`` of them if
    given."""
    specs = input_specs(cfg, shape_name)
    if rows is not None:
        specs = {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                                device="meta") for k, v in specs.items()}
    if device.type == "meta":
        return specs
    out = {}
    for k, v in specs.items():
        if k == "tokens":
            out[k] = torch.randint(1, cfg.vocab_size, v.shape, device=device,
                                   generator=generator, dtype=torch.int32)
        elif k == "weight":
            out[k] = torch.ones(v.shape, dtype=v.dtype, device=device)
        else:
            out[k] = torch.randn(v.shape, generator=generator, device=device,
                                 dtype=v.dtype)
    return out


def make_cell(cfg, shape_name: str, mesh, device="meta", *,
              microbatches: int | None = None, rows: int | None = None):
    """(model, step, args, microbatches): the cell's step over a model of
    ``cfg`` on ``device`` (meta, the reference's ``build_cell``: no weight
    drawn; otherwise drawn from ``SEED``) and the mesh ``mesh``, with its
    inputs (``rows`` of the batch if given, else the cell's global batch).
    Train: ``make_train_step`` at the reference's microbatch rule, on a
    fresh state; prefill:
    ``make_prefill_step`` (its cache of seq_len rows, the encoder-decoder's
    seq_len frames); decode: ``make_decode_step`` on a cache of seq_len rows
    at the last position."""
    dev = resolve_device(device)
    cell = SHAPES[shape_name]
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(cfg, dev, mesh=mesh, generator=gen)
    batch = _inputs(cfg, shape_name, rows, dev, gen)
    if cell.kind == "train":
        mb = _microbatches(model, cfg, cell, microbatches)
        b = next(iter(batch.values())).shape[0]
        mb = max(1, min(mb, b))
        step = ST.make_train_step(model, OptConfig(), microbatches=mb)
        return model, step, (ST.bind_state(model), batch), mb
    if cell.kind == "prefill":
        step = ST.make_prefill_step(model, cell.seq_len, enc_len=cell.seq_len)
        return model, step, (batch,), 1
    b, s = cache_shape(cfg, shape_name)
    if rows is not None:
        b = rows
    cache = model.init_cache(b, s, s if cfg.family == "audio" else 0)
    return model, ST.make_decode_step(model), (cache, batch["tokens"], s - 1), 1


def count_step(cfg, shape_name: str, mesh, *, microbatches: int | None = None,
               rows: int | None = None) -> dict:
    """The cell's step run once on meta under ``StepCost``: its global
    counts (``StepCost.totals``), the train step's gradient collectives
    included."""
    model, step, args, mb = make_cell(cfg, shape_name, mesh, "meta",
                                      microbatches=microbatches, rows=rows)
    with RA.StepCost(model) as cost:
        step(*args)
    if SHAPES[shape_name].kind == "train":
        for kind, (nb, n) in RA.train_collectives(model, mb).items():
            cost.add_collective(kind, nb, count=n)
    out = cost.totals()
    out["kernel_calls"] = dict(cost.kernel_calls)
    return out


def _depth_pairs(cfg):
    """[(label, (l1, l2), weight at full depth)], as the reference's."""
    if cfg.family == "hybrid":
        per = cfg.attn_every
        periods = cfg.num_layers // per
        rem = cfg.num_layers - periods * per
        return [("period", (per, 2 * per), periods), ("rem", (1, 2), rem)]
    if cfg.family == "ssm":
        per = cfg.slstm_every
        periods = cfg.num_layers // per
        rem = cfg.num_layers - periods * per
        pairs = [("period", (per, 2 * per), periods)]
        if rem:
            pairs.append(("rem", (1, 2), rem))
        return pairs
    return [("layer", (1, 2), cfg.num_layers)]


def at_depth(cfg, depth: int):
    """``cfg`` cut to ``depth`` layers (the encoder too)."""
    c = cfg.replace(num_layers=depth)
    if cfg.family == "audio":
        c = c.replace(encoder_layers=depth)
    return c


def _numeric(d: dict) -> dict:
    return {k: v for k, v in d.items() if isinstance(v, (int, float))}


def extrapolate(cfg, shape_name: str, mesh, *, remat: str | None,
                microbatches: int | None, rows: int | None = None):
    """(total, detail): the counts at full depth from the depth pairs: the
    depth-independent part once, each pair's per-unit part times its
    count. A pair's depths are one and two units (a layer, or a period of
    ``per`` layers), so its slope is taken per unit. (The reference divides
    a period pair's difference by ``per`` layers and multiplies by the
    periods, which counts a hybrid's and xLSTM's layers ``per`` times too
    few.)"""
    total: dict = {}
    detail: dict = {}
    for label, (l1, l2), weight in _depth_pairs(cfg):
        if weight == 0:
            continue
        costs = []
        for depth in (l1, l2):
            c = at_depth(cfg, depth)
            if remat is not None:
                c = c.replace(remat=remat)
            costs.append(count_step(c, shape_name, mesh,
                                    microbatches=microbatches, rows=rows))
        pair = RA.DepthPair(1, 2, _numeric(costs[0]), _numeric(costs[1]))
        per = pair.per_layer()
        if not total:
            total.update(pair.at(0))
        for k, v in per.items():
            total[k] = total.get(k, 0.0) + v * weight
        detail[label] = {"per_unit": per, "count": weight, "depths": [l1, l2],
                         "kernel_calls": costs[1]["kernel_calls"]}
    return total, detail


def devices_of(mesh) -> int:
    return math.prod(mesh.shape.values())


def state_of(cfg, shape_name: str, mesh) -> dict:
    """Per-device bytes of the cell's state, exact from the specs."""
    model = build_model(cfg, "meta", mesh=mesh)
    cell = SHAPES[shape_name]
    shape = dict(mesh.shape)
    params = dict(model.lm.named_parameters())
    out = {"params": RA.state_bytes(model.param_specs(), params, shape)}
    if cell.kind == "train":
        ms = ST.master_specs(model)
        f32 = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
               for n, p in params.items()}
        out["optimizer"] = 3 * RA.state_bytes(ms, f32, shape)
    else:
        b, s = cache_shape(cfg, shape_name)
        cache = model.init_cache(b, s, s if cfg.family == "audio" else 0)
        out["cache"] = RA.state_bytes(model.cache_specs(b), cache, shape)
    out["total"] = sum(out.values())
    return out


def fit_cell(cfg, shape_name: str, mesh) -> dict:
    """State bytes plus the activation peak per device against the card's
    memory, and the step's collectives at full depth (each kind's count and
    per-device bytes)."""
    cell = SHAPES[shape_name]
    state = state_of(cfg, shape_name, mesh)
    rows, mb = None, None
    if cell.kind == "train":
        model = build_model(cfg, "meta", mesh=mesh)
        mb = _microbatches(model, cfg, cell, None)
        rows = cell.global_batch // mb
        mb = 1  # one microbatch's rows: the step's peak is one microbatch's
    total, _ = extrapolate(cfg, shape_name, mesh, remat=None,
                           microbatches=mb, rows=rows)
    n = devices_of(mesh)
    act = total["peak_live_bytes"] / n
    peak = state["total"] + act
    mem = RA.device_memory()
    colls = {k.split("/", 1)[1]: v for k, v in total.items()
             if k.startswith("coll_count/")}
    return {"state_bytes": state, "activation_peak_bytes": act,
            "peak_bytes": peak, "device_memory": mem,
            "hbm_frac": peak / mem, "fits": peak <= mem,
            "collective_counts": colls}


def roofline_cell(cfg, shape_name: str, mesh) -> dict:
    """Three-term roofline via depth-pair extrapolation (one microbatch,
    ``remat="none"``, as the reference's)."""
    cell = SHAPES[shape_name]
    total, detail = extrapolate(cfg, shape_name, mesh, remat="none",
                                microbatches=1)
    chips = devices_of(mesh)
    per_device = {k: v / chips for k, v in total.items()
                  if not k.startswith("coll_count/") and k != "ops"}
    terms = RA.roofline_terms(per_device["flops"], per_device["bytes"],
                              per_device["coll_wire_bytes"])
    terms_flash = RA.roofline_terms(
        per_device["flops"], per_device["bytes"] - per_device["score_bytes"],
        per_device["coll_wire_bytes"])
    pc = RA.count_params(build_model(cfg, "meta", mesh=mesh).lm)
    mf = RA.model_flops(cfg, pc, cell.kind, cell.global_batch, cell.seq_len)
    counts = {k.split("/", 1)[1]: v for k, v in total.items()
              if k.startswith("coll_count/")}
    return {"per_device": per_device, "collective_counts": counts,
            "terms": terms, "terms_flash": terms_flash, "chips": chips,
            "model_flops": mf,
            "useful_ratio": mf / max(total["flops"], 1.0), "params": pc,
            "detail": detail}


# ---------------------------------------------------------------------------
# measured on the card
# ---------------------------------------------------------------------------


def shard_mesh() -> NamedMesh:
    """One data shard of the single-pod production mesh: its model axis (16
    virtual devices), data 1."""
    shape = dict(make_production_mesh().shape)
    return NamedMesh({k: (v if k == "model" else 1) for k, v in shape.items()})


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_ms(call, dev) -> tuple[float | None, int]:
    """(the summed device time of one call's GPU kernels from a
    ``torch.profiler`` trace of the device alone, the traces taken): (None,
    0) off the card; a trace that recorded no device event is taken once
    more."""
    if dev.type != "cuda":
        return None, 0
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for traces in (1, 2):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            call()
            _sync(dev)
        us = sum(e.time_range.elapsed_us() for e in p.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            break
    return us / 1e3, traces


def _outcome(kind: str, res) -> tuple[float | None, bool]:
    """(the train step's loss or None, whether the step's loss or logits
    are all finite) of a step's result."""
    if kind == "train":
        loss = float(res[1]["loss"])
        return loss, math.isfinite(loss)
    return None, bool(torch.isfinite(res[0]).all())


def time_cell(cfg, shape_name: str, mesh, device, *, rows: int,
              reps: int = 3, roofs=None, microbatches: int | None = None
              ) -> dict:
    """One config's step on ``device`` (weights and inputs drawn from
    ``SEED``): the median wall ms of ``reps`` steps after a warm-up (host
    clock to a synchronise), and on the card the peak memory allocated over
    them and the device ms of one profiled step; the bound of the same work
    (its meta count's FLOPs and bytes over ``roofs``: FLOP/s, bytes/s, the
    datasheet's without) and over the datasheet's; the last timed step's
    loss (train) and whether its loss or logits are finite; ``runs``, the
    steps run in all (a kernel launches its meta count's calls that many
    times). ``microbatches``: the train step's, the reference's rule
    without."""
    dev = resolve_device(device)
    peak_flops, peak_bw = roofs or (RA.PEAK_FLOPS, RA.HBM_BW)
    model, step, args, mb = make_cell(cfg, shape_name, mesh, dev, rows=rows,
                                      microbatches=microbatches)

    def call():
        return step(*args)

    call()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = call()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        # read, then dropped: a prefill's last-row logits are a view that
        # holds the whole (B, S, vocab) logits
        loss, finite = _outcome(SHAPES[shape_name].kind, res)
        del res
    peak = float(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else None
    dms, traces = _device_ms(call, dev)
    del model, step, args, call
    gc.collect()  # the autograd graph's cycles (checkpoint's frames)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    count = count_step(cfg, shape_name, mesh, microbatches=mb, rows=rows)
    bound = max(count["flops"] / peak_flops, count["bytes"] / peak_bw)
    sheet = max(count["flops"] / RA.PEAK_FLOPS, count["bytes"] / RA.HBM_BW)
    return {"depth": cfg.num_layers, "wall_ms": statistics.median(times),
            "device_ms": dms, "peak_bytes": peak, "microbatches": mb,
            "runs": 1 + reps + traces, "loss": loss, "finite": finite,
            "flops": count["flops"], "bytes": count["bytes"],
            "bound_ms": bound * 1e3, "datasheet_bound_ms": sheet * 1e3,
            "kernel_calls": count["kernel_calls"]}


def measure_cell(cfg, shape_name: str, device="cuda",
                 depths: tuple[int, int] = (1, 2), *, roofs=None,
                 reps: int = 3, rows: int | None = None,
                 microbatches: int | None = None) -> dict:
    """One data shard's step (global batch / data rows, the model
    axis as 16 virtual shards: ``shard_mesh``) with the whole model at
    ``depths`` on ``device`` (the card unless the caller asks for the
    CPU), each depth through :func:`time_cell`, and each number
    extrapolated to full depth (``DepthPair``). ``rows`` cuts the batch
    (the CPU tests); ``microbatches`` splits a train step finer than the
    reference's rule (where one card's memory needs it)."""
    dev = resolve_device(device)
    cell = SHAPES[shape_name]
    mesh = shard_mesh()
    if rows is None:
        data = make_production_mesh().shape["data"]
        rows = max(1, cell.global_batch // data)
    peak_flops, peak_bw = roofs or (RA.PEAK_FLOPS, RA.HBM_BW)
    per_depth = [time_cell(at_depth(cfg, d), shape_name, mesh, dev, rows=rows,
                           reps=reps, roofs=(peak_flops, peak_bw),
                           microbatches=microbatches)
                 for d in depths]
    keys = [k for k in ("wall_ms", "device_ms", "peak_bytes", "flops", "bytes",
                        "bound_ms", "datasheet_bound_ms")
            if per_depth[0][k] is not None]
    pair = RA.DepthPair(depths[0], depths[1],
                        {k: per_depth[0][k] for k in keys},
                        {k: per_depth[1][k] for k in keys})
    return {"arch": cfg.arch, "shape": shape_name, "rows": rows,
            "microbatches": per_depth[0]["microbatches"],
            "mesh": dict(mesh.shape), "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "roofs": {"flops_per_s": peak_flops, "bytes_per_s": peak_bw},
            "per_depth": per_depth, "full_depth": cfg.num_layers,
            "at_full_depth": pair.at(cfg.num_layers)}


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, meshes: list[str], *,
             do_roofline: bool, out: dict) -> None:
    cfg = get_config(arch)
    ok, reason = runnable(cfg, shape_name)
    rec = out.setdefault(arch, {}).setdefault(shape_name, {})
    if not ok:
        rec["skipped"] = reason
        print(f"[skip] {arch} x {shape_name}: {reason}")
        return
    for mesh_kind in meshes:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        t0 = time.perf_counter()
        try:
            fit = fit_cell(cfg, shape_name, mesh)
            dt = time.perf_counter() - t0
            rec[mesh_kind] = {"ok": True, "count_s": dt, "memory": fit}
            print(f"[ok] {arch} x {shape_name} x {mesh_kind}: state "
                  f"{fit['state_bytes']['total'] / 2**30:.2f} GiB/dev + "
                  f"activations {fit['activation_peak_bytes'] / 2**30:.2f} "
                  f"GiB ({100 * fit['hbm_frac']:.0f}% of "
                  f"{fit['device_memory'] / 1e9:.0f} GB), counted in "
                  f"{dt:.1f} s")
        except Exception as e:  # noqa: BLE001 — record and continue
            rec[mesh_kind] = {"ok": False, "error": f"{type(e).__name__}: {e}",
                              "traceback": traceback.format_exc()[-2000:]}
            print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: {e}")
        if do_roofline and mesh_kind == "single" and rec[mesh_kind].get("ok"):
            try:
                t0 = time.perf_counter()
                rec["roofline"] = roofline_cell(cfg, shape_name, mesh)
                rec["roofline"]["extract_s"] = time.perf_counter() - t0
                t = rec["roofline"]["terms"]
                print(f"     roofline: compute {t['compute_s'] * 1e3:.2f}ms "
                      f"memory {t['memory_s'] * 1e3:.2f}ms "
                      f"collective {t['collective_s'] * 1e3:.2f}ms "
                      f"-> {t['dominant']}-bound; useful "
                      f"{100 * rec['roofline']['useful_ratio']:.0f}%")
            except Exception as e:  # noqa: BLE001
                rec["roofline"] = {"error": f"{type(e).__name__}: {e}",
                                   "traceback": traceback.format_exc()[-2000:]}
                print(f"[FAIL roofline] {arch} x {shape_name}: {e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--measure", action="store_true",
                    help="run one data shard's step at two depths on the "
                         "device (the card unless --device cpu)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--merge", action="store_true",
                    help="merge into existing --out instead of overwriting")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out: dict = {}
    if args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    for arch, shape_name in cells:
        if args.measure:
            cfg = get_config(arch)
            if runnable(cfg, shape_name)[0]:
                depths = _depth_pairs(cfg)[0][1]
                r = measure_cell(cfg, shape_name, args.device, depths)
                out.setdefault(arch, {}).setdefault(shape_name, {})[
                    "measured"] = r
                f = r["at_full_depth"]
                print(f"[measured] {arch} x {shape_name} on "
                      f"{r['device_name']}: {r['rows']} rows at depths "
                      f"{list(depths)}: wall {f['wall_ms']:.1f} ms at full "
                      f"depth, bound {f['bound_ms']:.1f} ms")
        else:
            run_cell(arch, shape_name, meshes, do_roofline=args.roofline,
                     out=out)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)
    print(f"[done] wrote {args.out}")


if __name__ == "__main__":
    main()
