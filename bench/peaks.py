"""The card's published memory peak (NVIDIA's H100 SXM data sheet, at its
full 700 W) and a kernel seam's share of its roofline in a traced run.
Both seams the benchmark reads are bounded by bytes."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def roofline_share(nbytes: float, device_s: float) -> float | None:
    """The least time the bytes take at the memory's peak, as a percentage
    of the measured device time; None when nothing was measured (never 0
    for a share of the peak)."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s


def seam_share(trace, seam: str, least_bytes) -> float | None:
    """A seam's share of its roofline: the least bytes of the metered
    call's seam calls, times the traced calls, against the device time
    under the seam's profiler ranges. None unless the metered call made as
    many seam calls as a traced call did (the same work, so one call's
    bytes stand for each)."""
    if trace is None or seam not in trace.seams or not trace.metered.get(seam):
        return None
    seen = trace.seams[seam]
    recs = trace.metered[seam]
    if seen["launched"] != len(recs) * trace.calls // trace.metered_calls:
        return None
    nbytes = sum(least_bytes(r) for r in recs) * trace.calls / trace.metered_calls
    return roofline_share(nbytes, seen["device_s"])
