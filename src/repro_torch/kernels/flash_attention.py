"""GQA flash attention: the wrappers of ``csrc/flash_attention.cu`` (the
forward) and ``csrc/flash_attention_bwd.cu`` (its gradient).

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
``_flash_kernel``): every prefill's self-attention on the serving path
(``models/layers._sdpa``, through the ``kernels/ops.attention`` seam). The
TPU kernel's sequential k-block grid axis with VMEM scratch becomes a loop
inside one CTA per (128-row query tile, head, batch), with the online
softmax in registers. bf16 runs on Hopper's asynchronous units: a producer
warpgroup streams K/V tiles in with TMA through an mbarrier ring, two
consumer warpgroups run ``wgmma`` products (q k^T from shared memory, p v
with p from registers). fp32 (tests only) runs FMA loops over 64-row
tiles. The kernel is bound by operations at the serving shape. No atomics:
the same inputs give the same bits on every run. The q k width (q's and
k's last dim) and the p v width (v's) are template parameters; the pairs
with an instance are ``KERNEL_HEAD_DIMS``: 16, 64, 128 and 160 for both
(the GQA configs), and MLA's (96, 64) for minicpm3-4b and (24, 16) for its
TINY config (each width padded to whole 64-column boxes in shared memory;
160 with a one-stage K/V ring). Any other pair raises ``TypeError`` on the
card, with no fallback to the plain version. See the source's note.

Training: the TPU kernel has no gradient (the reference trains through
autodiff of its einsum attention). :func:`flash_attention_lse` is the
forward's training instance, which also writes each row's log-sum-exp;
:func:`flash_attention_bwd` is the hand-written gradient from it (a
``D = rowsum(dO o)`` pass, then persistent dK/dV and dQ kernels built as
the forward is: a producer warpgroup feeding TMA rings, two consumer
warpgroups on ``wgmma``; one dK/dV launch at every head dim, its items
dealt longest first, and where they are fewer than the SMs a KV head's
query heads split over items whose fp32 partials a fixed-order pass adds;
deterministic); :class:`FlashAttentionFn` joins the two under autograd.

Meta tensors (the dry run) take ``kernels/meta``'s route: an empty output
and the kernel's work recorded (:func:`flash_work`), on the widths and
dtypes the card takes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import meta, ref

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the (q k width, p v width) pairs with a kernel instance: (16, 16) the
# reduced GQA configs, (64, 64) granite-3-2b, (128, 128) llama3-8b and the
# MoE archs, (160, 160) stablelm-12b; MLA's q and k are nope + rope wide, v
# the value width: (96, 64) minicpm3-4b, (24, 16) its TINY config. Any
# other pair raises
KERNEL_HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (160, 160), (96, 64),
                    (24, 16))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd); k (B, S, KV, hd); v (B, S, KV, dv); H % KV == 0.
    Returns (B, S, H, dv) in q's dtype: ``softmax(q k^T / sqrt(hd)) v``,
    causal or not, query head h reading KV head ``h // (H // KV)``; dv is
    hd but for MLA's.

    A CPU tensor takes the plain version (:func:`ref.attention_ref`, any
    widths). A CUDA tensor launches the kernel (counted in
    ``flash_attention.launches``) or raises: it takes bf16 or fp32, a
    width pair (hd, dv) of ``KERNEL_HEAD_DIMS`` (``TypeError`` otherwise,
    with no fallback to the plain version), contiguous 16-byte-aligned
    tensors, and any S >= 1.
    """
    _check_shapes("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    if q.device.type == "meta":
        _check_meta("flash_attention", q, k, v)
        meta.record("flash_attention", *flash_work(q, k, v, causal))
        return _out_like(q, v)
    _check_card("flash_attention", q, k, v)
    out = _out_like(q, v)
    if out.numel() == 0:
        return out
    _forward(out, None, q, k, v, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: :func:`flash_attention`'s output (the same bits
    as the serving entry's) and each row's log-sum-exp of the scaled,
    masked scores, fp32 (B, H, S). A CPU tensor takes the plain version
    (:func:`ref.attention_lse_ref`); a CUDA tensor launches the kernel's
    LSE-writing instance (counted in ``flash_attention_lse.launches``) or
    raises, on the inputs :func:`flash_attention` takes."""
    _check_shapes("flash_attention_lse", q, k, v)
    if q.device.type == "cpu":
        return ref.attention_lse_ref(q, k, v, causal=causal)
    b, s, h, _ = q.shape
    if q.device.type == "meta":
        _check_meta("flash_attention_lse", q, k, v)
        meta.record("flash_attention_lse", *flash_work(q, k, v, causal,
                                                      lse=True))
        return _out_like(q, v), q.new_empty((b, h, s), dtype=torch.float32)
    _check_card("flash_attention_lse", q, k, v)
    out = _out_like(q, v)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _forward(out, lse, q, k, v, causal)
    flash_attention_lse.launches += 1
    return out, lse


flash_attention_lse.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), the gradient of :func:`flash_attention`'s function for
    the output gradient ``dout`` (B, S, H, dv), from the training forward's
    ``out`` and ``lse``; dk and dv sum over each KV head's query heads. A
    CPU tensor takes the plain version (:func:`ref.attention_bwd_ref`,
    autograd through ``attention_ref``). A CUDA tensor launches the kernels
    (five or six launches, counted once in
    ``flash_attention_bwd.launches``) or
    raises, on the inputs :func:`flash_attention` takes, with ``out`` and
    ``dout`` shaped as its output and typed as q, and ``lse`` (B, H, S)
    fp32."""
    _check_shapes("flash_attention_bwd", q, k, v)
    b, s, h, hd = q.shape
    dvw = v.shape[3]
    if out.shape != (b, s, h, dvw) or dout.shape != out.shape or \
            lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return ref.attention_bwd_ref(q, k, v, dout, causal=causal)
    if q.device.type == "meta":
        _check_meta("flash_attention_bwd", q, k, v)
        meta.record("flash_attention_bwd", *flash_work(q, k, v, causal,
                                                      backward=True))
        return tuple(torch.empty_like(x) for x in (q, k, v))
    _check_card("flash_attention_bwd", q, k, v, out, dout)
    if lse.dtype != torch.float32 or lse.device != q.device or \
            not lse.is_contiguous():
        raise TypeError("flash_attention_bwd takes a contiguous fp32 lse on "
                        "q's device")
    from repro_torch.kernels._build import check, library, stream_ptr

    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lib = library()
    kv, bf16 = k.shape[2], int(q.dtype == torch.bfloat16)
    # D = rowsum(dO o), the lse rows the kernels read and, where the dK/dV
    # launch splits a KV head's query heads, its fp32 partials
    workspace = torch.empty(
        lib.repro_flash_attention_bwd_workspace(b, s, h, kv, hd, dvw,
                                                int(causal), bf16),
        dtype=torch.float32, device=q.device)
    check("flash_attention_bwd", lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), workspace.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, kv, hd, dvw,
        1.0 / math.sqrt(hd), int(causal), bf16, stream_ptr(q)))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Self-attention with a gradient: :func:`flash_attention_lse` forward,
    :func:`flash_attention_bwd` backward. ``apply(q, k, v, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None


def flash_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, *, lse: bool = False, backward: bool = False
               ) -> tuple[float, float]:
    """(products in FLOPs, bytes) of one call of a flash entry on these
    inputs. The unmasked (query, key) pairs, s (s + 1) / 2 a head causal,
    s^2 not; forward 2 (hd + dv) FLOPs a pair (q k over hd, p v over dv),
    q, k, v read and the output (and the fp32 lse, a row each) written;
    backward 2 (3 hd + 2 dv) a pair (s and dP again, dV, dQ, dK), q, k, v,
    o, dO and lse read, dq, dk, dv written."""
    b, s, h, hd = q.shape
    dv = v.shape[3]
    pairs = b * h * (s * (s + 1) / 2 if causal else float(s * s))
    es = q.element_size()
    out = b * s * h * dv
    if backward:
        return (2.0 * (3 * hd + 2 * dv) * pairs,
                es * 2.0 * (q.numel() + out + k.numel() + v.numel())
                + 4.0 * b * h * s)
    return (2.0 * (hd + dv) * pairs,
            es * float(q.numel() + k.numel() + v.numel() + out)
            + (4.0 * b * h * s if lse else 0.0))


def _check_meta(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """The dtypes and widths the card takes (``_check_card`` less the
    device and the layout), so the dry run counts only calls the card
    runs."""
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{name} takes bf16 or fp32 tensors of one dtype, got "
                        f"{[t.dtype for t in (q, *others)]}")
    widths = (q.shape[3], others[1].shape[3])
    if widths not in KERNEL_HEAD_DIMS:
        raise TypeError(f"{name} has kernels for head dims (q k, p v) "
                        f"{KERNEL_HEAD_DIMS}, got {widths}")


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    """Self-attention shapes: k as q but its heads, v as k but its last dim
    (MLA's value width may differ from the q k width)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or \
            k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) or h % k.shape[2]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (self-attention, H % KV == 0)")


def _check_card(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """What the kernels take: one CUDA device, bf16 or fp32 of one dtype,
    a (q k, p v) width pair of ``KERNEL_HEAD_DIMS`` (q's last dim and v's,
    the second of ``others``), contiguous 16-byte-aligned tensors."""
    if q.device.type != "cuda" or any(t.device != q.device for t in others):
        raise ValueError(f"{name}: unsupported devices "
                         f"{[str(t.device) for t in (q, *others)]}")
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{name} takes bf16 or fp32 tensors of one dtype, got "
                        f"{[t.dtype for t in (q, *others)]}")
    widths = (q.shape[3], others[1].shape[3])
    if widths not in KERNEL_HEAD_DIMS:
        raise TypeError(f"{name} has kernels for head dims (q k, p v) "
                        f"{KERNEL_HEAD_DIMS}, got {widths}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, *others)):
        raise ValueError(f"{name} takes contiguous, 16-byte-aligned tensors")


def _out_like(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The output (B, S, H, dv) in q's dtype and device."""
    return q.new_empty((*q.shape[:3], v.shape[3]))


def _forward(out, lse, q, k, v, causal: bool) -> None:
    from repro_torch.kernels._build import check, library, stream_ptr

    b, s, h, hd = q.shape
    check("flash_attention", library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, k.shape[2], hd,
        v.shape[3], 1.0 / math.sqrt(hd), int(causal),
        int(q.dtype == torch.bfloat16), stream_ptr(q)))
