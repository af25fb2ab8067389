"""The traced calls' share of the card's float32 peak: the map's 2 x rows x
hidden^2 operations a call over the traced window."""

# the window's operations are read against a card's peak
CPU_SILENT = True
# NVIDIA's H100 SXM data sheet: float32 outside the tensor cores, at 700 W
FLOP_PER_S = 67e12


def read(run):
    t = run.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    d = int(run.cell.config["hidden_size"])
    flop = 2 * run.calls[-1]["rows"] * d * d * t.calls
    return 100.0 * flop / FLOP_PER_S / t.window_s
