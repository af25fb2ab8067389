"""MiB a traced call's exchanges put on the wire: the sum of ``wire_bytes``
over the program's shuffle records (``report=``), which are the dense
``(workers, workers, bucket)`` buffers the exchange sizes."""


def read(run):
    t = run.trace
    if t is None or not any(t.reports):
        return None
    per_call = [sum(r.get("wire_bytes", 0) for r in rep) for rep in t.reports]
    return sum(per_call) / len(per_call) / 2**20
