"""API layer (brotlig_tpu_torch.decode): the 95th percentile, in ms, of
the benchmark's host clock around each call of the window."""
import numpy as np


def read(run):
    ms = [(r.t1 - r.t0) * 1e3 for r in run.records if r.ok]
    return float(np.percentile(ms, 95)) if ms else None
