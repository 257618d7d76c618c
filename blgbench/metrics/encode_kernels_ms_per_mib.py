"""Encode kernels (csrc/match.cu, csrc/cost_model.cu, csrc/dp_parse.cu,
csrc/pack.cu): their summed device time, in ms, per MiB of input the
window encoded."""

KERNELS = ("sort_probe_kernel", "finish_kernel", "cost_tables_kernel",
           "cost_positions_kernel", "dp_parse_kernel", "pack_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.time_of(KERNELS)
    mib = sum(len(run.items[r.item].data) for r in run.records if r.ok) \
        / (1 << 20)
    return seconds * 1e3 / mib if seconds and mib else None
