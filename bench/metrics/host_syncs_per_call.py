"""Host synchronisations a call makes, counted by
``torch.cuda.set_sync_debug_mode("warn")``'s warnings."""

# the sync counter counts only a card's synchronisations
CPU_SILENT = True


def read(run):
    t = run.trace
    if t is None or t.syncs is None or t.sync_calls == 0:
        return None
    return t.syncs / t.sync_calls
