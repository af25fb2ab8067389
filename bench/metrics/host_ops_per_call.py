"""``aten::`` operators the host dispatched inside no other ``aten::``
operator, a traced call: the entry and plan layers' host work."""


def read(run):
    t = run.trace
    if t is None or t.calls == 0 or t.host_ops == 0:
        return None
    return t.host_ops / t.calls
