"""The device: the share, in %, of the traced window in which no
operation ran on the card (decode cells)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
