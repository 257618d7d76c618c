"""Decoded bytes (1e9) a second: the uncompressed bytes of every call
the window completed over the window's seconds."""


def read(run):
    done = sum(len(run.items[r.item].data) for r in run.records if r.ok)
    return done / run.window_s / 1e9
