"""Decode kernels (csrc/tables.cu, csrc/decode.cu; on the two-phase
route csrc/phase_a.cu and csrc/sweep.cu): the share, in %, of the least
time their bytes take at the card's peak (each compressed page read
once, its decoded bytes written once) in their summed device time."""
from blgbench import roofline

KERNELS = ("tables_kernel", "decode_kernel", "phase_a_kernel",
           "sweep_kernel")


def read(run):
    if run.trace is None:
        return None
    per_item = {}
    for r in run.records:
        if r.ok and r.item not in per_item:
            per_item[r.item] = roofline.decode_kernel_bytes(
                run.items[r.item].blob)
    nbytes = sum(per_item[r.item] for r in run.records if r.ok)
    return roofline.share_pct(nbytes, run.trace.time_of(KERNELS))
