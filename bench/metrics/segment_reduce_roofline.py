"""The ``kernels/ops.segment_reduce`` seam's share of its roofline: the
least bytes its function needs at the shapes it was called with (every
row's segment id read, the value of each row whose id is in range read,
the (num_segments,) output written once) over the memory's peak, against
the device time of everything launched under the seam."""
from bench import peaks

# a seam's device time comes from a card's trace
CPU_SILENT = True

SEAM = "segment_reduce"


def meter(values, seg_ids, num_segments, op="sum", **kwargs):
    in_range = ((seg_ids >= 0) & (seg_ids < num_segments)).sum()
    width = values.element_size() * (values.numel() // max(1, values.shape[0]))
    return {"n": seg_ids.shape[0], "id_bytes": seg_ids.element_size(),
            "value_bytes": width, "segments": int(num_segments),
            "in_range": in_range}


def least_bytes(rec: dict) -> float:
    return (rec["n"] * rec["id_bytes"] + int(rec["in_range"]) * rec["value_bytes"]
            + rec["segments"] * rec["value_bytes"])


def read(run):
    return peaks.seam_share(run.trace, SEAM, least_bytes)
