"""Texture postprocess (csrc/precondition.cu's postprocess_kernel): the
share, in %, of the least time its bytes take at the card's peak (the
decoded plane read once, the texture written once) in its device time."""
from blgbench import roofline


def read(run):
    if run.trace is None:
        return None
    nbytes = sum(roofline.precond_bytes(run.items[r.item].blob)
                 for r in run.records if r.ok)
    return roofline.share_pct(nbytes, run.trace.time_of(
        ("postprocess_kernel",)))
