"""The device memory the program held at its most during the window
(``torch.cuda.max_memory_allocated``, reset as the window opens), resident
tables included, in GiB."""

# the CPU keeps no device memory count
CPU_SILENT = True


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
