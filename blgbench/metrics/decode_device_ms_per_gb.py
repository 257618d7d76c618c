"""The card's time a GB of decoded output costs, in ms: the union of
every device interval (kernels, copies, sets) inside the window, over
the uncompressed GB (1e9 bytes) of every call the window completed.
A renderer that decodes textures while it draws gives up this much of
the card's time a GB. Read from the device trace, which the harness
takes in every run of a cell that reports this metric."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    done = sum(len(run.items[r.item].data) for r in run.records if r.ok)
    return run.trace.busy_s * 1e3 / (done / 1e9) if done else None
