"""The ``kernels/ops.hash_partition_ids`` seam's share of its roofline: the
least bytes its function needs at the shapes it was called with (each
valid row's key columns read once, the (n,) int32 destinations written
once) over the memory's peak, against the device time of everything
launched under the seam."""
from bench import peaks

# a seam's device time comes from a card's trace
CPU_SILENT = True

SEAM = "hash_partition_ids"


def meter(columns, row_count, num_partitions, seed=0):
    return {"n": columns[0].shape[0],
            "row_bytes": sum(c.element_size() for c in columns),
            "valid": row_count}


def least_bytes(rec: dict) -> float:
    valid = min(int(rec["valid"]), rec["n"])
    return valid * rec["row_bytes"] + 4 * rec["n"]


def read(run):
    return peaks.seam_share(run.trace, SEAM, least_bytes)
