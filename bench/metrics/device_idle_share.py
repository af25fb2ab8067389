"""Share of the traced window in which no operation ran on the device:
one minus the union of the device's operation intervals over the
window's length."""
from bench import profiling

# the CPU gives no device operations
CPU_SILENT = True


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - profiling.busy_seconds(t.device_ops) / t.window_s)
