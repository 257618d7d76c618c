#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA device and
nvcc:

    python3 chip_smoke.py

It builds the port's kernels from brotlig_tpu_torch/csrc with nvcc and
holds each to its plain torch version on a real 256-page batch (exact
equality: the format is lossless): the tables kernel, the fused decode
kernel, the phase-A kernel and the sweep kernel at every group width.
Kernel times are of raw launches (operands packed and outputs allocated
once, CUDA events), so they hold no wrapper work. It times the fused and
phase-A kernels on each page of that batch alone, prints the batch's
chain lengths (commands, literals and rounds per page, and those of the
page each kernel is slowest on), times both kernels at 256 and 512 pages
a launch and at 32 and 128 KiB pages.

Then it drives the main path, brotlig_tpu_torch.decode(..., device=
"cuda"), byte-exactly: on mixed-corpus containers through the fused
route and the two-phase route (sweep_cw 128 and 2048 on every container,
512 and 1024 on the 16 MiB one), and on four BCn textures built with the
port's own code (the BASELINE config-3 BC1 texture among them) through
the fused route and the two-phase route at sweep_cw 1024; the launch
counts, set to 0 before each set of runs and read after it, show that
every kernel of a route launched once a batch and each texture's
postprocess once a decode. The texture kernels (csrc/precondition.cu:
the postprocess, delta decode and decondition, and the preprocess,
condition and delta encode, with closed-form addresses, a persistent grid
of row-pair tiles) are held to their plain versions on the card
(tolerance 0, outputs poisoned beforehand) on each texture, and timed
beside their first design's time, a device copy of the same bytes, the
map path they replaced (the JAX package's form, its planes built for the
yardstick) and their bound, with the slowest CTA's clock cycles by
phase; the first texture preprocess and decode in the process are split
by stage and timed apart from warm ones. The 64 MiB container is decoded five times in a row,
and the pipeline's batch loop is run under torch's sync debug mode. A
pool of 68 archives is decoded in shared batches (decode_archives_batched)
and one by one. End to end: both routes in turns, the pipeline against
the serial order it replaced, a per-stage host breakdown, and the
config-3 texture to host bytes and kept on the card.

Then the pages split over devices and the gathers across processes: the
16 MiB container through decode_stream_sharded over every card and over
two shares of cuda:0, each equal to the input with the tables and fused
decode kernels launched once a batch of each share, timed in turns beside
decode(); entry.dryrun_multichip over every card; the pool of archives
through decode_archives_gather and 8 corpus inputs through
encode_archives_gather in two gloo worker processes that both run on
cuda:0, then in a one-rank NCCL group, every rank's lists equal to the
inputs; and both profile tools (brotlig_tpu_torch/tools) once, small.

Then it encodes on the card (the matcher is the hand-written kernels of
csrc/match.cu, two launches a call, the serializer the hand-written
kernel csrc/pack.cu, one launch a batch): the
full-device q1 path, encode_pages_device(quality=1), on 32 pages of the
corpus, its matcher, serializer and host stages timed, its aten ops,
CUDA kernels, serializer launches and peak memory counted, and every
4th page's commands and bytes held to the plain CPU run (tolerance 0),
each figure beside the eager serializer's run; the hybrid,
brotlig_tpu_torch.encode, on the 16 MiB corpus beside the native q11
ratio; the config-3 texture by both encode routes (the full route at q1
and at q11, in 64-page batches, with its peak memory and DP launches); a
round trip through python -m brotlig_tpu_torch.cli --device cuda; and
the q11 path,
encode_pages_device(quality=11), on 8 corpus pages: its windowed-DP
kernel (csrc/dp_parse.cu) held to its plain version on the card (at R
16, 1 and 2) and timed beside it and its bound, with its rounds a block
and its time a page there and on the texture's 64-page batch,
find_candidates and the cost model held
to the CPU run, the entry point timed, its kernels, peak memory and DP
kernel launches counted, its stages timed on a copy of its steps, and
its ratio beside q1 and the native q11 encoder. Last, the serializer
kernel is held to its plain version on the card (tolerance 0, bytes and
sizes) on the q1 batch, both q11 packs and the texture's first q1 and
q11 batches, timed beside its plain version, its bound and its first
design's time, with its clock cycles by phase, the size cases its
pages took and its build's registers, spills and shared memory. Then the
matcher's kernels are held to their plain versions on the card
(tolerance 0) on the q1 batch (fast tier), the q11 batch (exact tier and
find_candidates), the texture's first q1 and q11 batches and corpus
pages of 32 and 128 KiB (each tier and find_candidates), their two
raw launches timed beside the first design's six, the plain version, the bound
(bytes, and the probes the data needs), the bytes the design moves and,
beside the sort phase, a torch.sort of the same keys, and their
launches on the q1, hybrid, q11 and texture paths checked (two a call).
Then the preconditioned host encode, brotlig_tpu_torch.encode(backend=
"native", dc_params=..., device="cuda"), on the four textures, with the
launch counts set to 0 before and read after (the preprocess once an
encode, the parse's three kernels of csrc/ref_parse.cu once a group of
64 pages): the random BC5 and the BC1 at 32 KiB pages equal the CPU
route's streams, every stream decodes to its texture on the card and by
decode_cpu, and config-3's encode is split by stage (preprocess, parse
kernels, the parse's copy back, host serialization, assembly) beside
the hybrid's and the full route's ratios. The parse kernels are held to
the plain parse (tolerance 0) on 8 pages of each texture's delta form
and on corpus pages (text, zero, four symbols, random, a short last
page) at 32, 64 and 128 KiB and max_chain 1, 64 and 200 and on the rows
that are hard for the walk's join at 64 and 128 KiB (max_chain 0, 1 and
64; tests/test_torch_ref_parse.py's join_rows, whose numpy model of the
split walk must find on them, at max_chain 1 and 64, continuations that
meet a walker's mark, one that meets none and walkers the true walk
skips), their raw launches timed together and each of sort, walk and
join alone, beside the plain parse's host time and the bound (bytes
read and commands written; operations: the chain candidates the walk
compares).
Every
stream encoded on the card is decoded on
the card on both routes, with the launch counts checked, and those
launches join the kernels line.

Progress goes to earlier lines; the line before the last is the card's
name and power limit, the last line a JSON verdict. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero before
printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PAGE = 64 * 1024
BATCH = 256
REPS = 10
HOLD_CYCLES = 2_000_000     # time_ms's spin before the timed launches
SWEEP_CWS = (128, 512, 1024, 2048)
# H100 SXM datasheet peaks: HBM bytes/s, and the float32
# rate outside the tensor cores, used as an upper bound on the integer
# operation rate of these kernels (so the operations bound is a lower one)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# operations a decoded symbol needs at least: its 15-level range search
OPS_PER_SYMBOL = 16
# the texture kernels' first design (8 slices a page): raw launches,
# ms, postprocess and preprocess, on this script's textures (NVIDIA H100
# 80GB HBM3, 700.00 W), and the redesign's targets on config-3
PRECOND_FIRST_MS = {"config-3": (0.0464, 0.0475), "BC3": (0.0177, 0.0140),
                    "random BC5": (0.0117, 0.0143), "BC1 2048": (0.0124,
                                                                 0.0095)}
PRECOND_TARGET_MS = {"config-3": (0.020, 0.030)}


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps runs, by CUDA events. The card
    first spins for about a millisecond, so the launches queue up behind
    it: a kernel shorter than the host's launch interval is timed, not
    the interval."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def raw_launch(fn, args: list, dev):
    """A function of no arguments that launches a kernel through its C
    entry point, fn(*args, stream), with the tensors of args passed as
    device pointers: no operand packing, allocation or check is left in a
    timed launch. Raises on a launch error."""
    import torch
    from brotlig_tpu_torch import _kernels
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args] + [_kernels.stream_ptr(dev)]

    def run():
        rc = fn(*ptrs)
        if rc != 0:
            raise RuntimeError(f"{fn.__name__} failed (cudaError {rc})")
    run.operands = args     # the tensors live as long as the launcher
    return run


def tables_launch(buf):
    """The tables kernel's raw launch on a staged batch."""
    import torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import tables_kernel as tk
    wc, P, _ = buf.shape
    outs = [torch.empty_like(t) for t in tk.load_tables(buf)]
    return raw_launch(_kernels.library().blg_load_tables,
                      [buf, wc, P, *outs], buf.device)


def round_launch(kernel: str, st, tabs, page: int):
    """The raw launch of the fused decode kernel (kernel "decode") or the
    phase-A kernel ("phase_a") on a staged batch and its tables, checked
    once to flag no page."""
    import torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import decode as D
    from brotlig_tpu_torch.ops import decode_kernel as dk
    ops = dk.kernel_operands(st.buf, st.npd, tabs, page)
    wc, P, _ = st.buf.shape
    dev = st.buf.device
    mc = D.max_cmds_for(page)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)
    if kernel == "decode":
        fn, outs = _kernels.library().blg_decode_pages, \
            [empty(P, page, dtype=torch.uint8)]
    else:
        fn, outs = _kernels.library().blg_phase_a, \
            [empty(P, mc), empty(P, mc), empty(P, mc),
             empty(P, page + dk.LIT_PAD, dtype=torch.uint8)]
    status = empty(P)
    run = raw_launch(fn, [ops[0], wc, P, *ops[1:], page, mc // 32, *outs,
                          empty(P), status], dev)
    run()
    torch.cuda.synchronize()
    if int(status.abs().sum()):
        raise AssertionError(f"{kernel} kernel flagged a page of a "
                             f"{P} x {page} B batch")
    return run


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes moved over the memory
    rate or operations over the peak rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def check_pages(out, data: bytes, group, page: int, what: str) -> None:
    import numpy as np
    out = out.cpu().numpy()
    expect = np.frombuffer(data, np.uint8)
    for row, i in enumerate(group):
        n = min(page, len(data) - i * page)
        if not np.array_equal(out[row, :n], expect[i * page: i * page + n]):
            raise AssertionError(f"{what}: page {i} wrong")


def first_batch(blob: bytes, dev):
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops.decode import staged_batches
    return next(staged_batches(blob, parse_container(blob), BATCH, dev))


def batch_counts(a, tabs, blob: bytes, group) -> dict:
    """What one batch's data makes the kernels move: its compressed bytes,
    the stream words its tables occupy, its commands and literals (from
    the phase-A result a and the tables tabs)."""
    import torch
    from brotlig_tpu_torch.format.headers import parse_container
    info = parse_container(blob)
    ncmds = a.ncmds.long()
    cid = torch.arange(a.ins.shape[1], device=ncmds.device)[None, :]
    return {"pages": len(group),
            "compressed": sum(int(info.sizes[i]) for i in group),
            "table_words": int(((tabs.bp + 31) // 32).sum()),
            "cmds": int(ncmds.sum()),
            "lits": int((a.ins.long() * (cid < ncmds[:, None])).sum())}


def tables_errors(buf) -> int:
    """The tables kernel against its plain version on a staged batch:
    the largest difference over the packed operands (meta, dicts, trivs,
    bp)."""
    import torch
    from brotlig_tpu_torch.ops import tables_kernel as tk
    got = tk.load_tables(buf)
    torch.cuda.synchronize()
    return max_abs_err(got, tk.tables_plain(buf))


def tables_phase(staged, n: dict) -> dict:
    """Tables kernel vs its plain version on one staged batch; beside it,
    the torch table build the kernel took over (build_search on the three
    codes and the pack, on the card, from lengths already there)."""
    from brotlig_tpu_torch.ops import tables_kernel as tk
    from brotlig_tpu_torch.state import pack_tables, tables_from_lengths
    err = tables_errors(staged.buf)
    if err != 0:
        raise AssertionError(f"tables kernel disagrees with plain: {err}")
    out_bytes = sum(g.numel() * 4 for g in tk.load_tables(staged.buf))
    lengths = tk.load_tables_plain(staged.buf)
    return {"max_abs_err": err,
            "ms": time_ms(tables_launch(staged.buf), REPS),
            "plain_ms": time_ms(lambda: tk.tables_plain(staged.buf), 1),
            "torch_build_ms": time_ms(
                lambda: pack_tables(tables_from_lengths(*lengths)), REPS),
            **bound(n["table_words"] * 4 + out_bytes, 0)}


def decode_phase(staged, tabs, data: bytes, group, n: dict) -> dict:
    """Fused decode kernel vs its plain version on one staged batch, and
    both against the input bytes."""
    import torch
    from brotlig_tpu_torch.ops import decode_kernel as dk
    got = dk.decode_fused(staged.buf, staged.npd, tabs, PAGE)
    torch.cuda.synchronize()
    want = dk.decode_fused_plain(staged.buf, staged.npd, tabs, PAGE)
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"decode kernel disagrees with plain: {err}")
    if int(got[2].abs().sum()) != 0:
        raise AssertionError("decode kernel flagged a valid page")
    check_pages(got[0], data, group, PAGE, "decode kernel")
    return {"max_abs_err": err,
            "ms": time_ms(round_launch("decode", staged, tabs, PAGE), REPS),
            "plain_ms": time_ms(lambda: dk.decode_fused_plain(
                staged.buf, staged.npd, tabs, PAGE), 1),
            **bound(n["compressed"] + n["pages"] * PAGE,
                    OPS_PER_SYMBOL * (n["cmds"] + n["lits"])
                    + n["pages"] * PAGE)}


def phase_a_errors(got, want) -> int:
    """Largest difference between two PhaseA results where they are
    defined: ncmds and status; commands below ncmds; the literal queue up
    to each page's literal count."""
    import torch
    err = max_abs_err((got.ncmds, got.status), (want.ncmds, want.status))
    if err:
        return err
    ncmds = want.ncmds.long()
    cid = torch.arange(want.ins.shape[1], device=ncmds.device)[None, :]
    valid = cid < ncmds[:, None]
    for g, w in ((got.ins, want.ins), (got.cpy, want.cpy),
                 (got.dist, want.dist)):
        err = max(err, int(((g.long() - w.long()) * valid).abs().max()))
    nlit = (want.ins.long() * valid).sum(dim=1)
    pos = torch.arange(want.litq.shape[1], device=ncmds.device)[None, :]
    lit_diff = (got.litq.long() - want.litq.long()) * (pos < nlit[:, None])
    return max(err, int(lit_diff.abs().max()))


def phase_a_phase(staged, tabs):
    """Phase-A kernel vs its plain version on one staged batch; returns
    (result, the kernel's PhaseA)."""
    import torch
    from brotlig_tpu_torch.ops import phase_a_kernel as pk
    got = pk.phase_a(staged.buf, staged.npd, tabs, PAGE)
    torch.cuda.synchronize()
    want = pk.phase_a_plain(staged.buf, staged.npd, tabs, PAGE)
    err = phase_a_errors(got, want)
    if err != 0:
        raise AssertionError(f"phase-A kernel disagrees with plain: {err}")
    if int(got.status.abs().sum()) != 0:
        raise AssertionError("phase-A kernel flagged a valid page")
    return {"max_abs_err": err,
            "ms": time_ms(round_launch("phase_a", staged, tabs, PAGE),
                          REPS),
            "plain_ms": time_ms(lambda: pk.phase_a_plain(
                staged.buf, staged.npd, tabs, PAGE), 1)}, got


def sweep_launch(a, cw: int):
    """The sweep kernel's raw launch at group width cw on phase-A fields
    (a PhaseA, or some of its rows)."""
    import torch
    from brotlig_tpu_torch import _kernels
    P, nc = a.ins.shape
    dev = a.ins.device
    out = torch.empty((P, PAGE), dtype=torch.uint8, device=dev)
    scratch = torch.empty((P, nc, 4), dtype=torch.int32, device=dev)
    return raw_launch(_kernels.library().blg_sweep,
                      [a.ncmds, a.ins, a.cpy, a.dist, a.litq,
                       a.litq.shape[1], P, nc, PAGE, cw, scratch, out], dev)


def sweep_phases(a, data: bytes, group, n: dict) -> dict:
    """The sweep kernel at every group width vs its plain version, on the
    phase-A kernel's output of one batch (raw launches, the kernel's
    prologue included); beside it, the torch middle stage the prologue
    took over, timed on its own."""
    import torch
    from brotlig_tpu_torch.ops import sweep_kernel as sk
    want = sk.sweep_plain(a.ncmds, a.litq, a.ins, a.cpy, a.dist, PAGE)
    torch.cuda.synchronize()
    check_pages(want, data, group, PAGE, "plain sweep")
    plain_ms = time_ms(lambda: sk.sweep_plain(a.ncmds, a.litq, a.ins,
                                              a.cpy, a.dist, PAGE), 1)
    middle_ms = time_ms(lambda: sk.middle_stage(a.ncmds, a.litq, a.ins,
                                                a.cpy, a.dist, PAGE), REPS)
    res = {"middle_ms": middle_ms}
    P = a.ins.shape[0]
    for cw in SWEEP_CWS:
        got = sk.sweep(a.ncmds, a.litq, a.ins, a.cpy, a.dist, PAGE, cw)
        torch.cuda.synchronize()
        err = max_abs_err((got,), (want,))
        if err != 0:
            raise AssertionError(f"sweep kernel cw {cw} disagrees with "
                                 f"plain: {err}")
        res[cw] = {"max_abs_err": err, "plain_ms": plain_ms,
                   "ms": time_ms(sweep_launch(a, cw), REPS),
                   **bound(4 * P + 12 * n["cmds"] + n["lits"]
                           + n["pages"] * PAGE, n["pages"] * PAGE)}
    return res


def chain_lengths(a, slowest: dict) -> dict:
    """What makes a page's decode chain long, from one batch's phase-A
    result: commands, literals and rounds per page, and those of the page
    each kernel took longest on alone (slowest: kernel -> batch row)."""
    import torch
    ncmds = a.ncmds.long()
    cid = torch.arange(a.ins.shape[1], device=ncmds.device)[None, :]
    lits = (a.ins.long() * (cid < ncmds[:, None])).sum(dim=1)
    rounds = ncmds // 32 + 1
    return {"ncmds_max": int(ncmds.max()),
            "ncmds_mean": float(ncmds.double().mean()),
            "lits_max": int(lits.max()),
            "lits_mean": float(lits.double().mean()),
            "rounds_max": int(rounds.max()),
            "rounds_mean": float(rounds.double().mean()),
            "slowest_page": {k: {"row": i, "rounds": int(rounds[i]),
                                 "cmds": int(ncmds[i]), "lits": int(lits[i]),
                                 "lit_decodes_per_lane":
                                     int((lits[i] + 31) // 32)}
                             for k, i in slowest.items()}}


def pages_alone(staged, a) -> dict:
    """The tables, fused decode and phase-A kernels and the sweep (cw 128
    and 1024, on the phase-A result a) timed on a batch and on each of its
    pages alone, raw launches: per kernel the batch's time, the slowest
    page's row and time, and the median page's time. A batch that takes
    as long as its slowest page alone is bound by that page's serial
    chain, not by the card's throughput."""
    from brotlig_tpu_torch.ops import tables_kernel as tk
    from brotlig_tpu_torch.state import Staged

    def tables(st):
        return tables_launch(st.buf)

    def rounds(kernel):
        return lambda st: round_launch(kernel, st, tk.load_tables(st.buf),
                                       PAGE)

    def sweep(cw):
        return lambda rows: sweep_launch(rows, cw)
    P = staged.buf.shape[1]
    pages = [Staged(staged.buf[:, i:i + 1].contiguous(),
                    staged.npd[i:i + 1].contiguous()) for i in range(P)]
    rows = [type(a)(*[x[i:i + 1] for x in a]) for i in range(P)]
    res = {}
    for kernel, launch, whole, parts in (
            ("tables", tables, staged, pages),
            ("decode", rounds("decode"), staged, pages),
            ("phase_a", rounds("phase_a"), staged, pages),
            ("sweep_cw128", sweep(128), a, rows),
            ("sweep_cw1024", sweep(1024), a, rows)):
        alone = [time_ms(launch(one), REPS) for one in parts]
        row = max(range(P), key=alone.__getitem__)
        res[kernel] = {"batch_ms": time_ms(launch(whole), REPS),
                       "slowest_row": row, "slowest_ms": alone[row],
                       "median_ms": sorted(alone)[P // 2]}
    return res


def round_kernels_ms(blob: bytes, page: int, batch: int, dev,
                     copies: int = 1) -> tuple:
    """K2 and K4 timed on the first staged batch of `batch` pages of a
    container, that batch repeated `copies` times in one launch: (pages,
    K2 ms, K4 ms), raw launches. A measurement only; the main path keeps
    batches of 256. Batches are size-sorted, so a larger batch holds other
    pages; repeating one batch keeps the pages and changes only their
    number."""
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops import tables_kernel as tk
    from brotlig_tpu_torch.ops.decode import staged_batches
    from brotlig_tpu_torch.state import Staged
    group, st = next(staged_batches(blob, parse_container(blob), batch, dev))
    st = Staged(st.buf.repeat(1, copies, 1), st.npd.repeat(copies, 1))
    tabs = tk.load_tables(st.buf)
    return (copies * len(group),
            time_ms(round_launch("decode", st, tabs, page), REPS),
            time_ms(round_launch("phase_a", st, tabs, page), REPS))


def batches_of(blob: bytes) -> int:
    from brotlig_tpu_torch.format.headers import parse_container
    n = len(parse_container(blob).compressed_page_indices())
    return (n + BATCH - 1) // BATCH


def preconditioned(blob: bytes) -> int:
    """1 for a preconditioned container of at least one page, else 0."""
    from brotlig_tpu_torch.format.headers import parse_container
    info = parse_container(blob)
    return int(info.dc_params is not None and info.header.num_pages > 0)


def want_launches(cases, runs) -> tuple:
    """The launch counts a list of (container, options) runs makes when
    every kernel of its route launches once a batch and a texture's
    postprocess once a decode: (counts, sweep counts by width)."""
    counts = {"tables": 0, "decode": 0, "phase_a": 0, "sweep": 0,
              "dp_parse": 0, "pack": 0, "match": 0, "cost": 0, "precond": 0,
              "ref_parse": 0}
    by_cw = dict.fromkeys(SWEEP_CWS, 0)
    for name, opts in runs:
        nb = batches_of(cases[name][1])
        # a texture's postprocess: one launch a decode
        counts["precond"] += preconditioned(cases[name][1])
        counts["tables"] += nb
        if opts.get("variant") == "two_phase":
            counts["phase_a"] += nb
            counts["sweep"] += nb
            by_cw[opts["sweep_cw"]] += nb
        else:
            counts["decode"] += nb
    return counts, by_cw


def drive(cases, runs, what: str) -> tuple:
    """The main path: decode every (container, options) pair of runs on
    the card byte-exactly, with the launch counts set to 0 just before and
    read just after. Returns (counts, sweep counts by width, calls of the
    torch work the kernels took over: the middle stage and the search
    build, which the CUDA routes must not make)."""
    import brotlig_tpu_torch
    from brotlig_tpu_torch import _kernels, state
    from brotlig_tpu_torch.ops import sweep_kernel as sk
    calls = {"middle_stage": 0, "build_search": 0}
    saved = {"middle_stage": (sk, sk.middle_stage),
             "build_search": (state, state.build_search)}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run
    for name, (mod, fn) in saved.items():
        setattr(mod, name, counted(name, fn))
    try:
        _kernels.reset_launches()
        for name, opts in runs:
            data, blob = cases[name]
            if brotlig_tpu_torch.decode(blob, device="cuda", **opts) != data:
                raise AssertionError(f"{name} {opts}: decode differs from "
                                     "the input")
            print(f"[smoke] {what} decode ok: {name} {opts} "
                  f"({batches_of(blob)} batches)", flush=True)
        launches = dict(_kernels.LAUNCHES), dict(_kernels.SWEEP_LAUNCHES)
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, name, fn)
    return (*launches, calls)


# ---------------------------------------------------------------------------
# Preconditioned (BCn texture) containers, built with the port's own code
# ---------------------------------------------------------------------------

def make_bc1(w: int, h: int) -> bytes:
    """bench.py's BASELINE config-3 texture generator (_make_bc1), seeded
    the same: correlated endpoint colors and low-entropy index rows."""
    import numpy as np
    r = np.random.default_rng(7)
    nblocks = (w // 4) * (h // 4)
    c0 = (r.integers(0, 64, nblocks) * 1024 +
          np.arange(nblocks) % 1024).astype("<u2")
    c1 = (c0.astype(np.uint32) * 3 // 4).astype("<u2")
    idx = r.integers(0, 4, (nblocks, 4)).astype(np.uint8) * 0x55
    blocks = np.zeros((nblocks, 8), np.uint8)
    blocks[:, 0:2] = c0.view(np.uint8).reshape(-1, 2)
    blocks[:, 2:4] = c1.view(np.uint8).reshape(-1, 2)
    blocks[:, 4:8] = idx
    return blocks.tobytes()


def make_bc3(size: int, seed: int) -> bytes:
    """BC3 blocks of `size` bytes whose endpoints are smooth and whose
    index bytes are random: the conditioned index sub-streams do not
    compress and are stored as raw pages, the rest compresses."""
    import numpy as np
    r = np.random.default_rng(seed)
    nblocks = size // 16
    ramp = (np.arange(nblocks) // 37) % 256
    blocks = r.integers(0, 256, (nblocks, 16)).astype(np.uint8)
    for col in (0, 1, 8, 9, 10, 11):
        blocks[:, col] = (ramp + r.integers(0, 4, nblocks) + col) % 256
    return blocks.tobytes()


def texture_params(fmt: int, w: int, h: int, mips: int, swizzle: bool,
                   delta: bool, size: int):
    from brotlig_tpu_torch.format.precondition import DataConditionParams
    p = DataConditionParams(precondition=True, swizzle=swizzle,
                            delta_encode=delta, format=fmt,
                            width_in_pixels=w, height_in_pixels=h,
                            num_mip_levels=mips)
    if not p.initialize(size):
        raise AssertionError(f"texture geometry does not match {size} B")
    return p


def texture_size(fmt: int, w: int, h: int, mips: int) -> int:
    from brotlig_tpu_torch.format.precondition import DataConditionParams
    p = DataConditionParams(precondition=True, format=fmt,
                            width_in_pixels=w, height_in_pixels=h,
                            num_mip_levels=mips)
    p.initialize(0)          # fills the geometry; the size check fails
    return p.mip_offsets_bytes[p.num_mip_levels]


def texture_container(tex: bytes, params, page: int, dev) -> bytes:
    """A preconditioned container of `tex`, built with the port's code:
    the condition gather and delta encode on the card
    (ops.precondition.preprocess_device), each page's q1 commands and
    serialisation by the native encoder in threads, stored raw (the
    conditioned non-delta bytes, as the decoder expects) where it does
    not compress, then the port's header and page-table packers."""
    from concurrent.futures import ThreadPoolExecutor
    from brotlig_tpu_torch import native
    from brotlig_tpu_torch.format.headers import (PreconditionHeader,
                                                  StreamHeader,
                                                  pack_page_table)
    from brotlig_tpu_torch.ops.precondition import preprocess_device
    cond, work, flags = preprocess_device(tex, params, page, dev)
    n_pages = -(-len(tex) // page)

    def pack(i):
        w = work[i * page:(i + 1) * page]
        ins, cpy, dist, _ = native.parse_page(w, quality=1)
        comp = native.encode_page_cmds(w, i == n_pages - 1, ins, cpy, dist,
                                       isdelta=flags[i])
        return cond[i * page: i * page + len(w)] if len(comp) == len(w) \
            else comp
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        pages = list(ex.map(pack, range(n_pages)))
    ph = PreconditionHeader(
        params.swizzle, params.pitch_d3d12_aligned,
        params.width_in_blocks[0], params.height_in_blocks[0],
        params.format, params.num_mip_levels, params.pitch_in_bytes[0])
    return (StreamHeader.for_input(len(tex), page, True).pack() + ph.pack()
            + pack_page_table([len(c) for c in pages]) + b"".join(pages))


def textures(dev) -> dict:
    """{name: (texture, container, params, page size)}: BASELINE config 3
    (bench.py:547-583: a 4096 x 8192 BC1 texture, 16 MiB, 64 KiB pages,
    swizzle and delta), a BC3 texture with mips and no swizzle (raw pages
    among compressed ones), a random BC5 texture (raw pages only) and a
    BC1 texture at 32 KiB pages. The first texture's preprocess is timed
    on its first call in the process and warm."""
    import numpy as np
    import torch
    from brotlig_tpu_torch.format import constants as FC
    specs = [
        ("config-3 BC1 4096x8192, swizzle+delta, 64 KiB pages",
         FC.DATA_FORMAT_BC1, 4096, 8192, 1, True, True, PAGE,
         lambda n: make_bc1(4096, 8192)),
        ("BC3 2048x1024, 4 mips, delta, no swizzle, raw index pages",
         FC.DATA_FORMAT_BC3, 2048, 1024, 4, False, True, PAGE,
         lambda n: make_bc3(n, 3)),
        ("random BC5 1024x1024, swizzle+delta, raw pages only",
         FC.DATA_FORMAT_BC5, 1024, 1024, 1, True, True, PAGE,
         lambda n: np.random.default_rng(5).integers(
             0, 256, n, dtype=np.uint8).tobytes()),
        ("BC1 2048x2048, swizzle+delta, 32 KiB pages",
         FC.DATA_FORMAT_BC1, 2048, 2048, 1, True, True, 32768,
         lambda n: make_bc1(2048, 2048)),
    ]
    from brotlig_tpu_torch.ops.precondition import preprocess_device
    out = {}
    for name, fmt, w, h, mips, swz, delta, page, gen in specs:
        size = texture_size(fmt, w, h, mips)
        tex = gen(size)
        params = texture_params(fmt, w, h, mips, swz, delta, size)
        if not out:     # the process's first texture preprocess, then warm
            runs = [preprocess_stages(tex, params, page, dev)
                    for _ in range(4)]
            if any(r[0] != preprocess_device(tex, params, page, dev)
                   for r in runs):
                raise AssertionError("the staged preprocess differs from "
                                     "preprocess_device")
            ms = [sum(r[1].values()) for r in runs]
            first = {k: round(v, 3) for k, v in runs[0][1].items()}
            warm = {k: round(float(np.median([r[1][k] for r in runs[1:]])),
                             3) for k in runs[0][1]}
            print(f"[smoke] {name}: preprocess_device (bytes to bytes, on "
                  f"the card), its steps timed apart with the card "
                  f"synchronised after each: first call {ms[0]:.3f} ms "
                  f"{json.dumps(first)}, warm {[round(t, 3) for t in ms[1:]]}"
                  f" ms (median by stage {json.dumps(warm)}) "
                  f"[{gpu_line()}]", flush=True)
        out[name] = (tex, texture_container(tex, params, page, dev), params,
                     page)
    return out


def preprocess_stages(tex: bytes, params, page: int, dev) -> tuple:
    """ops.precondition.preprocess_device's steps, each timed on the host
    clock with the card synchronised after it (ms): upload (bytes to a
    tensor on the card), kernel (geometry, flags and the wrapper's
    launch), readback (both streams to the host) and to bytes. Returns
    (its result, the stage times)."""
    import numpy as np
    import torch
    from brotlig_tpu_torch.ops import precondition_kernel as PK
    clock = time.perf_counter
    torch.cuda.synchronize()
    t0 = clock()
    x = torch.from_numpy(np.frombuffer(tex, np.uint8).copy()).to(dev)
    torch.cuda.synchronize()
    t1 = clock()
    geom = PK.pack_geometry(params, len(tex), page)
    isdelta = PK.span_pages(geom) & bool(params.delta_encode)
    flags = torch.from_numpy(isdelta.astype(np.uint8))
    cond, delta = PK.preprocess_cuda(x, geom, flags)
    torch.cuda.synchronize()
    t2 = clock()
    hc, hd = cond.cpu(), delta.cpu()
    t3 = clock()
    res = (hc.numpy().tobytes(), hd.numpy().tobytes(), isdelta.tolist())
    t4 = clock()
    return res, {k: (b - a) * 1e3 for k, a, b in (
        ("upload", t0, t1), ("kernel", t1, t2), ("readback", t2, t3),
        ("to bytes", t3, t4))}


def texture_decode_stages(blob: bytes, dev) -> tuple:
    """brotlig_tpu_torch.decode's steps for a preconditioned container
    (fused route), each timed on the host clock with the card
    synchronised after it (ms): parse, the plane and its raw pages, the
    compressed pages' decode into the plane (decode_batches), the
    postprocess (wrapper and kernel), the readback into page-locked
    memory and the copy to bytes. Returns (the texture, the stage
    times)."""
    import numpy as np
    import torch
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops.decode import compressed_jobs, decode_batches
    from brotlig_tpu_torch.ops.precondition import postprocess_flat_device
    clock = time.perf_counter
    torch.cuda.synchronize()
    stamps = [("start", clock())]

    def mark(name):
        torch.cuda.synchronize()
        stamps.append((name, clock()))
    info = parse_container(blob)
    ps = info.header.page_size
    comp, offs, szs = compressed_jobs(info)
    mark("parse")
    plane = torch.zeros((info.header.num_pages, ps), dtype=torch.uint8,
                        device=dev)
    raw_idx = info.raw_page_indices()
    if raw_idx:
        rows = np.zeros((len(raw_idx), ps), np.uint8)
        for r, i in enumerate(raw_idx):
            n = info.page_out_sizes[i]
            rows[r, :n] = np.frombuffer(blob, np.uint8, n,
                                        int(info.offsets[i]))
        plane.index_copy_(0, torch.tensor(raw_idx, device=dev),
                          torch.from_numpy(rows).to(dev))
    mark("plane and raw pages")
    flagged = set()
    decode_batches(blob, comp, offs, szs, ps, dev,
                   lambda keys, _, isdelta: flagged.update(
                       int(k) for k in keys[isdelta]), BATCH, plane=plane)
    mark("page decode")
    res = postprocess_flat_device(plane.reshape(-1)[: info.out_size],
                                  info.dc_params, ps, flagged)
    mark("postprocess")
    host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
    host.copy_(res)
    mark("readback")
    out = host.numpy().tobytes()
    mark("to bytes")
    return out, {name: round((t - stamps[k][1]) * 1e3, 3)
                 for k, (name, t) in enumerate(stamps[1:])}


def texture_plane(blob: bytes, dev):
    """A preconditioned container's decoded (still conditioned) pages in
    a [num_pages, page size] plane on `dev`, through the pipeline: (the
    plane's first out-size bytes, flat; the compressed pages flagged as
    delta-encoded; the page size)."""
    import numpy as np
    import torch
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops.decode import compressed_jobs, decode_batches
    info = parse_container(blob)
    ps = info.header.page_size
    plane = torch.zeros((info.header.num_pages, ps), dtype=torch.uint8,
                        device=dev)
    for i in info.raw_page_indices():
        n = info.page_out_sizes[i]
        row = np.frombuffer(blob, np.uint8, n, int(info.offsets[i]))
        plane[i, :n] = torch.from_numpy(row.copy()).to(dev)
    flagged = set()
    decode_batches(blob, *compressed_jobs(info), ps, dev,
                   lambda keys, _, isdelta: flagged.update(
                       int(k) for k in keys[isdelta]), BATCH, plane=plane)
    return plane.reshape(-1)[: info.out_size], flagged, ps


def poisoned(n: int, dev):
    """A uint8 [n] tensor on dev whose every byte is 0xA5."""
    import torch
    return torch.full((n,), 0xA5, dtype=torch.uint8, device=dev)


def map_bytes_of(maps) -> int:
    return sum(t.numel() * t.element_size() for t in maps)


def drop_maps(before: set) -> None:
    """Free the yardstick's map planes: the cache entries made since
    `before` (the keys it held then)."""
    from brotlig_tpu_torch.ops import precondition as pre
    for key in set(pre._MAP_CACHE) - before:
        del pre._MAP_CACHE[key]


def first_design_ms(name: str) -> tuple:
    """The first design's (postprocess, preprocess) times of a texture and
    the redesign's targets (the first design's times where none is set)."""
    key = next(k for k in PRECOND_FIRST_MS if name.startswith(k))
    return PRECOND_FIRST_MS[key], PRECOND_TARGET_MS.get(
        key, PRECOND_FIRST_MS[key])


def precond_record(rec) -> str:
    """The slowest CTA of a texture kernel's per-CTA record: its kcycles
    by phase, its tiles and its total, and the grid."""
    from brotlig_tpu_torch.ops import precondition_kernel as PK
    rec = rec.cpu()
    r = rec[int(rec[:, PK.REC_TOTAL].argmax())].tolist()
    parts = ", ".join(f"{ph} {r[k] / 1e3:.1f}"
                      for k, ph in enumerate(PK.PHASES))
    return (f"slowest of {rec.shape[0]} CTAs: {parts}; {r[PK.REC_TILES]} "
            f"tiles, {r[PK.REC_TOTAL] / 1e3:.1f} kcycles in all (tiles a "
            f"CTA {int(rec[:, PK.REC_TILES].min())}-"
            f"{int(rec[:, PK.REC_TILES].max())})")


def postprocess_phase(name, tex, blob, params, gpu) -> dict:
    """The texture postprocess (delta decode and decondition,
    csrc/precondition.cu) of a texture's decoded plane on the card: the
    entry point's result, the device bytes it leaves beside its output
    and its map cache (none); the kernel into a poisoned output against
    its plain version on the card (tolerance 0) and the texture; the
    kernel's raw launches timed (CUDA events; the look-back's words made
    once, which the kernel leaves zeroed) beside its first design's time,
    a device copy of the same n bytes, the plain version's one run, the
    JAX package's map path (its planes built here and cached, the PyTorch
    yardstick) and the bound without maps (the plane read once, the
    texture written once); the slowest CTA's cycles by phase."""
    import torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import precondition as pre
    from brotlig_tpu_torch.ops import precondition_kernel as PK
    dev = torch.device("cuda")
    flat, flagged, ps = texture_plane(blob, dev)
    n = int(flat.shape[0])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    got = pre.postprocess_flat_device(flat, params, ps, flagged)
    torch.cuda.synchronize()
    left = (torch.cuda.memory_allocated(dev) - held
            - got.untyped_storage().nbytes())
    cached = [k for k in pre._MAP_CACHE if k[0] in ("inv", "fwd", "delta")]
    if left != 0 or cached:
        raise AssertionError(f"{name}: the postprocess left {left} B on the "
                             f"card beside its output, maps {cached}")
    geom = PK.pack_geometry(params, n, ps)
    flags = PK.page_flags(flagged, -(-n // ps))
    out = PK.postprocess_cuda(flat, geom, flags, out=poisoned(n, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = PK.postprocess_plain(flat, geom, flags)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err((out, got), (want, want))
    if err != 0 or got.cpu().numpy().tobytes() != tex:
        raise AssertionError(f"{name}: postprocess kernel differs from its "
                             f"plain version ({err}) or from the texture")
    fl = None if flags is None else flags.to(dev)
    work = PK.lookback_words(geom, dev)
    run = raw_launch(_kernels.library().blg_postprocess,
                     [geom, flat, fl, out, work, None], dev)
    ms = time_ms(run, REPS)
    torch.cuda.synchronize()
    if int(work.abs().sum()) or not torch.equal(out, want):
        raise AssertionError(f"{name}: the timed postprocess launches left "
                             "look-back words set or a wrong texture")
    dst = torch.empty_like(flat)
    copy_ms = time_ms(lambda: dst.copy_(flat), REPS)
    _, rec = PK.postprocess_cuda(flat, geom, flags, out=poisoned(n, dev),
                                 return_record=True)
    before = set(pre._MAP_CACHE)
    masks = pre._delta_masks(params, n, ps, dev, flagged)
    inv, valid = pre._inv_maps(params, n, dev)
    maps = [inv, valid] + ([] if masks is None else list(masks[:2]))

    def map_path():
        x = flat if masks is None else pre._delta_decode_device(
            flat, masks[0], masks[1])
        return pre._gather_u8(x, inv, valid)
    if not torch.equal(map_path(), want):
        raise AssertionError(f"{name}: the map path differs")
    map_ms = time_ms(map_path, REPS)
    nmap = map_bytes_of(maps)
    drop_maps(before)
    b = bound(2 * n, 0)
    (first, _), (target, _) = first_design_ms(name)
    print(f"[smoke] postprocess kernel == plain == texture (tolerance 0, "
          f"output poisoned), {name}: kernel {ms:.4f} ms (first design "
          f"{first:.4f}; target {target:.4f}: "
          f"{'met' if ms <= target else 'missed'}), copy_ of the {n} B "
          f"{copy_ms:.4f} ms, plain {plain_ms:.1f} ms (one run on the "
          f"card), the map path {map_ms:.4f} ms (maps cached), bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {2 * n} B, no maps), "
          f"{b['bound_ms'] / ms:.1%} of it (copy_ "
          f"{b['bound_ms'] / copy_ms:.1%}); resident: plane "
          f"{flat.untyped_storage().nbytes()} B, beside the output {left} B,"
          f" maps 0 B (the map path's: {nmap} B); {precond_record(rec)} "
          f"[{gpu}]", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": map_ms,
            "max_abs_err": err, "map_bytes": nmap, "left_bytes": left,
            "copy_ms": copy_ms}


def preprocess_phase(name, tex, params, page, gpu) -> dict:
    """The texture preprocess (condition and delta encode,
    csrc/precondition.cu) of a texture on the card: the kernel into two
    poisoned outputs against its plain version on the card (tolerance 0)
    and the map path's bytes; its raw launches timed beside its first
    design's time, a device copy of the same n bytes, the plain version's
    one run, the map path (planes cached) and the bound without maps (the
    texture read once, two streams written); the slowest CTA's cycles by
    phase."""
    import numpy as np
    import torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import precondition as pre
    from brotlig_tpu_torch.ops import precondition_kernel as PK
    dev = torch.device("cuda")
    x = torch.from_numpy(np.frombuffer(tex, np.uint8).copy()).to(dev)
    n = len(tex)
    geom = PK.pack_geometry(params, n, page)
    flags = torch.from_numpy(
        (PK.span_pages(geom) & bool(params.delta_encode)).astype(np.uint8))
    cond, delta = PK.preprocess_cuda(x, geom, flags,
                                     out=(poisoned(n, dev), poisoned(n, dev)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = PK.preprocess_plain(x, geom, flags)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err((cond, delta), want)
    before = set(pre._MAP_CACHE)
    idx, valid = pre._fwd_maps(params, n, dev)
    masks = pre._delta_masks(params, n, page, dev) \
        if params.delta_encode else None
    maps = [idx, valid] + ([] if masks is None else list(masks[:2]))

    def map_path():
        c = pre._gather_u8(x, idx, valid)
        return c, (c if masks is None else
                   pre._delta_encode_device(c, masks[0], masks[1]))
    if err != 0 or any(not torch.equal(a, b) for a, b in
                       zip(map_path(), want)):
        raise AssertionError(f"{name}: preprocess kernel differs from its "
                             f"plain version ({err}) or the map path")
    map_ms = time_ms(map_path, REPS)
    nmap = map_bytes_of(maps)
    drop_maps(before)
    writes_delta = delta is not cond
    fl = flags.to(dev)
    run = raw_launch(_kernels.library().blg_preprocess,
                     [geom, x, fl, cond, delta if writes_delta else None,
                      None], dev)
    ms = time_ms(run, REPS)
    torch.cuda.synchronize()
    if max_abs_err((cond, delta), want) != 0:
        raise AssertionError(f"{name}: the timed preprocess launches wrote "
                             "wrong streams")
    dst = torch.empty_like(x)
    copy_ms = time_ms(lambda: dst.copy_(x), REPS)
    *_, rec = PK.preprocess_cuda(x, geom, flags, return_record=True)
    b = bound((3 if writes_delta else 2) * n, 0)
    (_, first), (_, target) = first_design_ms(name)
    print(f"[smoke] preprocess kernel == plain == the map path (tolerance 0, "
          f"outputs poisoned), {name}: kernel {ms:.4f} ms (first design "
          f"{first:.4f}; target {target:.4f}: "
          f"{'met' if ms <= target else 'missed'}), copy_ of the {n} B "
          f"{copy_ms:.4f} ms, plain {plain_ms:.1f} ms (one run on the "
          f"card), the map path {map_ms:.4f} ms (maps cached, {nmap} B), "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
          f"{b['bound_ms'] / ms:.1%} of it; {int(flags.sum())} of "
          f"{len(flags)} pages delta-coded; {precond_record(rec)} [{gpu}]",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": map_ms,
            "max_abs_err": err, "copy_ms": copy_ms}


# ---------------------------------------------------------------------------
# The pipeline against the serial order, and where a decode's host time goes
# ---------------------------------------------------------------------------

def decode_serial(blob: bytes, dev) -> bytes:
    """The stream decode in the serial order used before the pipeline,
    rebuilt from the package's parts: each batch staged in pageable
    memory, uploaded blocking, decoded, checked and read back page by
    page before the next batch is staged."""
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops.decode import decode_batch, staged_batches
    info = parse_container(blob)
    ps = info.header.page_size
    out = bytearray(info.out_size)
    for i in info.raw_page_indices():
        off, n = int(info.offsets[i]), info.page_out_sizes[i]
        out[i * ps: i * ps + n] = blob[off: off + n]
    for group, staged in staged_batches(blob, info, BATCH, dev):
        pages, _, status = decode_batch(staged, ps)
        if bool((status != 0).any()):
            raise ValueError("corrupt stream")
        pages_np = pages.cpu().numpy()
        for row, i in enumerate(group):
            n = info.page_out_sizes[i]
            out[i * ps: i * ps + n] = pages_np[row, :n].tobytes()
    return bytes(out)


def host_breakdown(blob: bytes, dev) -> dict:
    """One decode of a container through the pipeline's parts, each stage
    timed alone on the host clock with the card synchronised after it,
    summed over the batches (ms): parse and hints, staging (into
    page-locked memory), upload, kernels (tables and fused decode),
    readback (into page-locked memory), assembly, and the final copy to
    bytes."""
    import numpy as np
    import torch
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops.decode import (batch_plan, compressed_jobs,
                                              decode_batch)
    from brotlig_tpu_torch.state import StagingBuffers, Streams
    t = {k: 0.0 for k in ("parse and hints", "staging", "upload", "kernels",
                          "readback", "assembly", "to bytes")}
    clock = time.perf_counter
    torch.cuda.synchronize()
    t0 = clock()
    info = parse_container(blob)
    ps = info.header.page_size
    comp, offs, szs = compressed_jobs(info)
    wl, batches = batch_plan(blob, offs, szs, BATCH)
    out = bytearray(info.out_size)
    out_np = np.frombuffer(out, np.uint8)
    t["parse and hints"] += clock() - t0
    st = Streams(dev)
    bufs = StagingBuffers(st, wl * 32 // 128, BATCH)
    back = st.host_empty(BATCH * ps, torch.uint8)
    for b in batches:
        t0 = clock()
        buf3, npd = bufs.stage(blob, offs[b], szs[b], wl)
        t1 = clock()
        staged, _ = bufs.upload(buf3, npd)
        torch.cuda.synchronize()
        t2 = clock()
        pages, _, status = decode_batch(staged, ps)
        torch.cuda.synchronize()
        t3 = clock()
        host = back[: len(b) * ps].view(len(b), ps)
        host.copy_(pages, non_blocking=True)
        if bool((status != 0).any()):
            raise ValueError("corrupt stream")
        torch.cuda.synchronize()
        t4 = clock()
        rows = host.numpy()
        for row, i in enumerate(comp[b]):
            n = info.page_out_sizes[i]
            out_np[i * ps: i * ps + n] = rows[row, :n]
        t5 = clock()
        for k, dt in zip(("staging", "upload", "kernels", "readback",
                          "assembly"), (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                        t5 - t4)):
            t[k] += dt
    t0 = clock()
    res = bytes(out)
    t["to bytes"] += clock() - t0
    if len(res) != info.out_size:
        raise AssertionError("breakdown decode lost bytes")
    return {k: round(v * 1e3, 3) for k, v in t.items()}


def pipeline_never_syncs(blob: bytes, dev) -> None:
    """decode_batches over a container with torch's sync debug mode set
    to raise: the batch loop makes no synchronising torch call (it waits
    only on its readback events, in the drain)."""
    import torch
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops.decode import compressed_jobs, decode_batches
    info = parse_container(blob)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_batches(blob, *compressed_jobs(info), info.header.page_size,
                       dev, lambda *a: None, BATCH)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def archive_pool(data: bytes, dev):
    """64 small archives cut from the mixed corpus (20 KiB to 1.5 MiB, a
    quarter at 32 KiB pages, q1) and four preconditioned textures, for
    the pooled decode. Returns (datas, blobs)."""
    import numpy as np
    from brotlig_tpu_torch import native
    from brotlig_tpu_torch.format import constants as FC
    r = np.random.default_rng(11)
    datas, blobs, pos = [], [], 0
    for i in range(64):
        n = int(r.integers(20 << 10, 3 << 19))
        if pos + n > len(data):
            pos = 0
        datas.append(data[pos: pos + n])
        pos += n
        blobs.append(native.encode(datas[-1], quality=1,
                                   page_size=32768 if i % 4 == 3 else PAGE))
    for i, (w, h) in enumerate(((512, 512), (1024, 256), (256, 256),
                                (1024, 1024))):
        size = texture_size(FC.DATA_FORMAT_BC1, w, h, 1)
        tex = make_bc1(w, h)
        p = texture_params(FC.DATA_FORMAT_BC1, w, h, 1, i % 2 == 0, True,
                           size)
        datas.append(tex)
        blobs.append(texture_container(tex, p, PAGE if i % 2 else 32768,
                                       dev))
    return datas, blobs


def pool_batches(blobs) -> int:
    """Batches the pooled decode must run: per page size, the compressed
    pages over 256, rounded up."""
    from brotlig_tpu_torch.format.headers import parse_container
    by_ps: dict = {}
    for b in blobs:
        info = parse_container(b)
        ps = info.header.page_size
        by_ps[ps] = by_ps.get(ps, 0) + len(info.compressed_page_indices())
    return sum(-(-n // BATCH) for n in by_ps.values())


# ---------------------------------------------------------------------------
# Sharded and distributed: the pages of one stream split over devices
# (decode_stream_sharded), the dry run of entry.py, the gathers across
# processes on torch.distributed, and the profile tools
# ---------------------------------------------------------------------------

GATHER_WORKER = r"""
import hashlib, json, pickle, sys, time
import torch
import torch.distributed as dist
rank, world, backend, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group(backend, init_method=f"file://{tmp}/{backend}.store",
                        world_size=world, rank=rank)
from brotlig_tpu_torch import _kernels, native
from brotlig_tpu_torch.parallel import runtime
with open(f"{tmp}/inputs.pkl", "rb") as f:
    blobs, datas, enc_in = pickle.load(f)
res = {"rank": rank, "backend": backend, "world": world}
for run in range(2):                # the first run warms, the second is timed
    dist.barrier()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    outs = runtime.decode_archives_gather(blobs)
    res["decode_ms"] = (time.perf_counter() - t0) * 1e3
    res["launches"] = dict(_kernels.LAUNCHES)
    res["decode_ok"] = outs == datas
    dist.barrier()
    t0 = time.perf_counter()
    encs = runtime.encode_archives_gather(enc_in)
    res["encode_ms"] = (time.perf_counter() - t0) * 1e3
res["encode_ok"] = all(native.decode(b) == d for b, d in zip(encs, enc_in))
res["encoded"] = hashlib.sha256(b"".join(encs)).hexdigest()
res["encoded_bytes"] = sum(map(len, encs))
dist.destroy_process_group()
print(json.dumps(res))
"""


def sharded_phase(data: bytes, blob: bytes, gpu) -> dict:
    """decode_stream_sharded of the 16 MiB container over device_list()
    (every card) and over [cuda:0, cuda:0] (two shares of one card), each
    equal to the input with the tables and fused decode kernels launched
    once a batch of each share; then all of them timed in turns beside
    decode() on the same container. Returns the launches of the checked
    runs."""
    import numpy as np
    import torch
    from brotlig_tpu_torch import _kernels, decode
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.parallel.sharding import (decode_stream_sharded,
                                                     device_list,
                                                     shard_bounds)
    n_comp = len(parse_container(blob).compressed_page_indices())
    lists = {"device_list()": None, "[cuda:0, cuda:0]": ["cuda:0", "cuda:0"]}
    total = {"tables": 0, "decode": 0, "precond": 0}
    for name, devs in lists.items():
        shares = [hi - lo for lo, hi in
                  shard_bounds(n_comp, len(device_list(devs)))]
        want = sum(-(-n // BATCH) for n in shares)
        _kernels.reset_launches()
        got = decode_stream_sharded(blob, devs)
        counts = dict(_kernels.LAUNCHES)
        if got != data:
            raise AssertionError(f"decode_stream_sharded over {name} "
                                 "differs from the input")
        if counts != {"tables": want, "decode": want, "phase_a": 0,
                      "sweep": 0, "dp_parse": 0, "pack": 0, "match": 0,
                      "cost": 0, "precond": 0, "ref_parse": 0}:
            raise AssertionError(f"decode_stream_sharded over {name} "
                                 f"launched {counts}, want {want} each")
        for k in total:
            total[k] += counts[k]
        print(f"[smoke] decode_stream_sharded, 16 MiB q11 container over "
              f"{name} = {[str(d) for d in device_list(devs)]}: == input; "
              f"shares of {shares} pages, launches {counts} (K1 and K2 "
              f"once a batch of each share)", flush=True)
    runs = {"decode()": lambda: decode(blob, device="cuda"),
            **{f"sharded {name}": (lambda d=devs: decode_stream_sharded(
                blob, d)) for name, devs in lists.items()}}
    times = {name: [] for name in runs}
    for r in range(5):
        for name in (list(runs) if r % 2 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = runs[name]()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if got != data:
                raise AssertionError(f"timed {name} differs")
    print("[smoke] end to end, 16 MiB q11 container, fused route, in "
          "turns: " + "; ".join(
              f"{name} {[round(t, 3) for t in ts]} ms (median of warm "
              f"runs {float(np.median(ts[1:])):.3f} ms)"
              for name, ts in times.items()) + f" [{gpu}]", flush=True)
    return total


def dryrun_phase(gpu) -> dict:
    """entry.dryrun_multichip over every card: the launches of the tables
    and fused decode kernels, once a batch of each share of the BC1
    container and once a device for the one-page-a-device step. Returns
    them."""
    import torch
    from brotlig_tpu_torch import _kernels, entry
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops import match_kernel as MK
    from brotlig_tpu_torch.parallel.sharding import shard_bounds
    n = torch.cuda.device_count()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    entry.dryrun_multichip(n)
    secs = time.perf_counter() - t0
    counts = dict(_kernels.LAUNCHES)
    _, blob = entry.bc1_container(64 * 1024, max(n, 4), "cuda")
    n_comp = len(parse_container(blob).compressed_page_indices())
    want = sum(hi > lo for lo, hi in shard_bounds(n_comp, n)) + n
    # the BC1 container is encoded by the full route at q1: one batch,
    # its preprocess; then its postprocess; then find_commands once a
    # device
    match = MK.LAUNCHES_PER_CALL * (1 + n)
    if counts != {"tables": want, "decode": want, "phase_a": 0, "sweep": 0,
                  "dp_parse": 0, "pack": 1, "match": match, "cost": 0,
                  "precond": 2, "ref_parse": 0}:
        raise AssertionError(f"dryrun_multichip({n}) launched {counts}, "
                             f"want {want} each, one pack, {match} "
                             "matcher and two precond launches")
    print(f"[smoke] dryrun_multichip({n}): {secs:.1f} s, launches {counts} "
          f"[{gpu}]", flush=True)
    return {k: counts[k] for k in ("tables", "decode", "precond")}


def gather_phase(blobs, datas, enc_in, gpu) -> None:
    """decode_archives_gather of the archive pool and encode_archives_gather
    (the hybrid on the card) of enc_in, in two gloo worker processes that
    both decode on cuda:0, then in a one-rank NCCL group: every rank's
    lists equal the inputs (the encoded ones through the native decoder,
    and the same on every rank). Each worker runs both gathers twice and
    times the second run (the first builds the texture maps and warms
    the card)."""
    import pickle
    import tempfile
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump((blobs, datas, enc_in), f)
        for backend, world in (("gloo", 2), ("nccl", 1)):
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", GATHER_WORKER, str(r), str(world),
                 backend, tmp], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for r in range(world)]
            try:
                outs = [p.communicate(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for p, (out, err) in zip(procs, outs):
                if p.returncode != 0:
                    raise AssertionError(f"{backend} gather worker failed "
                                         f"({p.returncode}):\n{err[-3000:]}")
            res = [json.loads(out.strip().splitlines()[-1])
                   for out, _ in outs]
            for r in res:
                if not (r["decode_ok"] and r["encode_ok"]) or \
                        r["launches"]["tables"] < 1 or \
                        r["launches"]["decode"] < 1 or \
                        r["launches"]["precond"] < 1:
                    raise AssertionError(f"{backend} gather: {r}")
            if len({r["encoded"] for r in res}) != 1:
                raise AssertionError(f"{backend} gather: the ranks hold "
                                     "different encoded archives")
            print(f"[smoke] gathers, {backend}, {world} process(es) on "
                  f"cuda:0 ({time.perf_counter() - t0:.1f} s with start-up):"
                  f" every rank == inputs; " + "; ".join(
                      f"rank {r['rank']}: decode_archives_gather of "
                      f"{len(blobs)} archives {r['decode_ms']:.3f} ms "
                      f"(launches {r['launches']}), encode_archives_gather "
                      f"of {len(enc_in)} inputs {r['encode_ms']:.3f} ms"
                      for r in res) + f" [{gpu}]", flush=True)


def profile_phase(gpu) -> None:
    """Both profile tools once on the card, at a small size: each one's
    JSON line, printed after a tag."""
    import contextlib
    import io
    from brotlig_tpu_torch.tools import profile_decode, profile_encode
    for tool, pages in ((profile_decode, "16"), (profile_encode, "8")):
        env = {"BENCH_PAGES": pages, "PROF_REPS": "2"}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                tool.main(["--device", "cuda"])
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        print(f"[smoke] {tool.__name__.rsplit('.', 1)[1]} (BENCH_PAGES "
              f"{pages}, PROF_REPS 2): {buf.getvalue().strip()} [{gpu}]",
              flush=True)


# ---------------------------------------------------------------------------
# Encode on the card: the device matcher and serializer (the q1 tier), the
# hybrid route, preconditioned textures and the command line
# ---------------------------------------------------------------------------

ENC_STRIDE = 8       # bench.py's encode subset (bench.py:622-645): every
ENC_PAGES = 32       # 8th page of the 256-page corpus, 32 pages
ENC_CHECK = 4        # every 4th of those pages is also encoded on the CPU
ENC_REPS = 3


def container_of(blobs, page: int) -> bytes:
    """A non-preconditioned container of full pages from their blobs."""
    from brotlig_tpu_torch.format.headers import StreamHeader, pack_page_table
    return (StreamHeader.for_input(len(blobs) * page, page, False).pack()
            + pack_page_table([len(b) for b in blobs]) + b"".join(blobs))


def decode_on_card(blob: bytes, data: bytes, what: str) -> dict:
    """Decode blob on the card on the fused route and the two-phase route
    (sweep_cw 1024), each equal to data and launching every kernel of its
    route once a batch (and a texture's postprocess once); returns the
    launch counts by route."""
    import brotlig_tpu_torch
    from brotlig_tpu_torch import _kernels
    nb = batches_of(blob)
    pc = preconditioned(blob)
    counts = {}
    for route, opts, want in (
            ("fused", {},
             {"tables": nb, "decode": nb, "phase_a": 0, "sweep": 0,
              "dp_parse": 0, "pack": 0, "match": 0, "cost": 0,
              "precond": pc, "ref_parse": 0}),
            ("two_phase", {"variant": "two_phase", "sweep_cw": 1024},
             {"tables": nb, "decode": 0, "phase_a": nb, "sweep": nb,
              "dp_parse": 0, "pack": 0, "match": 0, "cost": 0,
              "precond": pc, "ref_parse": 0})):
        _kernels.reset_launches()
        if brotlig_tpu_torch.decode(blob, device="cuda", **opts) != data:
            raise AssertionError(f"{what}: decode on the card {opts} "
                                 "differs from the input")
        counts[route] = dict(_kernels.LAUNCHES)
        if counts[route] != want:
            raise AssertionError(f"{what}: decode {opts} launched "
                                 f"{counts[route]}, want {want}")
    print(f"[smoke] {what}: decodes on the card on both routes == input, "
          f"launches {counts} ({nb} batches)", flush=True)
    return counts


def encode_q1_phase(data: bytes, dev, gpu) -> dict:
    """The full-device q1 path, encode_pages_device(quality=1), on 32 pages
    of the corpus: its stages timed (CUDA events around the matcher and
    the serializer, the host clock around the whole), the commands and
    page bytes of every 4th page held to the plain CPU run (tolerance 0),
    every blob decoded by the native decoder, and the pages as a
    container decoded on the card. Returns the decode launches."""
    import numpy as np
    import torch
    from brotlig_tpu_torch import _kernels, native
    from brotlig_tpu_torch.ops.encode import find_commands
    from brotlig_tpu_torch.ops import match_kernel as MK
    from brotlig_tpu_torch.ops.encode_pack import (command_bucket,
                                                   encode_pages_device,
                                                   pack_partitioned,
                                                   page_blobs)
    from brotlig_tpu_torch.tools.profile_decode import device_work
    idx = list(range(0, len(data) // PAGE, ENC_STRIDE))[:ENC_PAGES]
    arr = np.stack([np.frombuffer(data[i * PAGE:(i + 1) * PAGE], np.uint8)
                    for i in idx])
    sizes = np.full(len(idx), PAGE, np.int64)
    isdelta = np.zeros(len(idx), np.int64)
    max_cmds = PAGE // 4 + 16

    def run():
        """encode_pages_device's steps on the card, timed by stage."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pages = torch.from_numpy(arr).to(dev)
        in_sizes = torch.from_numpy(sizes).to(dev)
        flags = torch.from_numpy(isdelta).to(dev)
        ev[0].record()
        cmds = find_commands(pages, in_sizes, max_cmds, fast=True)
        ev[1].record()
        out, out_sizes = pack_partitioned(pages, in_sizes, PAGE, max_cmds,
                                          *cmds, flags)
        ev[2].record()
        blobs = page_blobs(out.cpu().numpy(), out_sizes.cpu().numpy(),
                           sizes, arr)
        total = (time.perf_counter() - t0) * 1e3
        ms = {"matcher": ev[0].elapsed_time(ev[1]),
              "serializer": ev[1].elapsed_time(ev[2])}
        ms["host"] = total - ms["matcher"] - ms["serializer"]
        ms["total"] = total
        return blobs, cmds, ms

    _kernels.reset_launches()
    blobs, cmds, _ = run()                                   # warm
    if encode_pages_device(arr, sizes, PAGE, isdelta, quality=1,
                           device="cuda") != blobs:
        raise AssertionError("encode_pages_device differs from its steps")
    runs = [run()[2] for _ in range(ENC_REPS)]
    packs = _kernels.LAUNCHES["pack"]
    matches = _kernels.LAUNCHES["match"]
    if packs != ENC_REPS + 2 or matches != MK.LAUNCHES_PER_CALL * packs:
        raise AssertionError(f"full-device q1: {packs} pack and {matches} "
                             f"matcher kernel launches for {ENC_REPS + 2} "
                             "batches")
    med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    torch.cuda.reset_peak_memory_stats(dev)
    work = device_work(run)
    peak = torch.cuda.max_memory_allocated(dev)
    pages = torch.from_numpy(arr).to(dev)
    in_sizes = torch.from_numpy(sizes).to(dev)
    flags = torch.from_numpy(isdelta).to(dev)
    stage = {"matcher": device_work(
        lambda: find_commands(pages, in_sizes, max_cmds, fast=True))}
    stage["serializer"] = device_work(
        lambda: pack_partitioned(pages, in_sizes, PAGE, max_cmds,
                                 *[c.to(dev) for c in cmds], flags))
    nbytes = len(idx) * PAGE
    ratio = nbytes / sum(map(len, blobs))
    buckets: dict = {}
    for n in cmds[3].tolist():
        b = command_bucket(n, max_cmds)
        buckets[b] = buckets.get(b, 0) + 1
    print(f"[smoke] full-device q1 encode (encode_pages_device, quality=1) "
          f"of {len(idx)} x 64 KiB corpus pages (every {ENC_STRIDE}th) on "
          f"the card, median of {ENC_REPS} warm runs: matcher "
          f"{med['matcher']:.3f} ms, serializer {med['serializer']:.3f} ms, "
          f"host {med['host']:.3f} ms, total {med['total']:.3f} ms -> "
          f"{nbytes / med['total'] / 1e6:.4f} GB/s of input, ratio "
          f"{ratio:.4f}; pages by command bucket "
          f"{dict(sorted(buckets.items()))}; per batch {work['aten_ops']} "
          f"aten ops, "
          f"{work['kernels'] or 'not measured'} CUDA kernels "
          f"({work['kernel_ms'] or 0:.3f} ms of kernel time); peak "
          f"{peak / 2**20:.1f} MiB allocated [{gpu}]", flush=True)
    print(f"[smoke] full-device q1 beside the eager serializer's run "
          f"(NVIDIA H100 80GB HBM3, 700.00 W): serializer "
          f"{med['serializer']:.3f} ms (eager: {EAGER['q1 serializer']}), "
          f"total {med['total']:.3f} ms (eager: {EAGER['q1 total']}), CUDA "
          f"kernels a batch {work['kernels'] or 'not measured'} (eager: "
          f"{EAGER['q1 kernels']}, {EAGER['q1 serializer kernels']} of them "
          f"the serializer's) [{gpu}]", flush=True)
    print(f"[smoke] full-device q1 matcher stage beside its eager run "
          f"(NVIDIA H100 80GB HBM3, 700.00 W): matcher {med['matcher']:.3f} "
          f"ms (eager: {EAGER['q1 matcher']}), total {med['total']:.3f} ms "
          f"(eager: {EAGER['q1 total, eager matcher']}), CUDA kernels a "
          f"batch {work['kernels'] or 'not measured'} (eager: "
          f"{EAGER['q1 kernels, eager matcher']}); matcher kernel launches "
          f"{matches} ({MK.LAUNCHES_PER_CALL} a batch) [{gpu}]",
          flush=True)
    for name, w in stage.items():
        busy = (f"{w['kernel_ms']:.3f} ms of kernel time in "
                f"{med[name]:.3f} ms, device idle "
                f"{1 - w['kernel_ms'] / med[name]:.1%}"
                if w["kernels"] else "kernel time not measured")
        print(f"[smoke] full-device q1 {name} alone: {w['aten_ops']} aten "
              f"ops, {w['kernels'] or 'not measured'} CUDA kernels, {busy} "
              f"[{gpu}]", flush=True)
    print(f"[smoke] full-device q1 runs (ms): "
          f"{json.dumps([{k: round(v, 3) for k, v in r.items()} for r in runs])}"
          f" [{gpu}]", flush=True)

    # the plain run on the CPU, every 4th page (tolerance 0)
    chk = list(range(0, len(idx), ENC_CHECK))
    want = find_commands(torch.from_numpy(arr[chk]),
                         torch.from_numpy(sizes[chk]), max_cmds, fast=True)
    err = max_abs_err([c[chk].cpu() for c in cmds], want)
    plain = encode_pages_device(arr[chk], sizes[chk], PAGE, isdelta[chk],
                                quality=1, device="cpu")
    if err != 0 or plain != [blobs[i] for i in chk]:
        raise AssertionError(f"full-device q1: the card differs from the "
                             f"plain CPU run (commands {err})")
    for blob, page in zip(blobs, arr):
        got = (page.tobytes() if len(blob) == PAGE
               else native.decode_page(blob, PAGE))
        if got != page.tobytes():
            raise AssertionError("full-device q1: a blob does not decode")
    print(f"[smoke] full-device q1: commands and page bytes of {len(chk)} "
          f"pages == the plain CPU run (tolerance 0); all {len(idx)} blobs "
          f"decode with the native decoder", flush=True)
    sub = arr.tobytes()
    return {"launches": decode_on_card(container_of(blobs, PAGE), sub,
                                       "full-device q1 container"),
            "matcher_ms": med["matcher"], "serializer_ms": med["serializer"],
            "host_ms": med["host"], "total_ms": med["total"],
            "gbps": nbytes / med["total"] / 1e6, "ratio": ratio,
            "peak_mib": peak / 2**20, "stage": stage, "packs": packs,
            "matches": matches,
            "pack_in": (pages, in_sizes, PAGE, max_cmds,
                        *[c.to(dev) for c in cmds], flags),
            **work}


def hybrid_phase(data: bytes, native_blob: bytes, gpu) -> dict:
    """brotlig_tpu_torch.encode (the hybrid: the matcher's exact tier on
    the card, the native packer) on the 16 MiB corpus, timed, against the
    native q11 blob's ratio; its stream decoded on the card."""
    import numpy as np
    import torch
    import brotlig_tpu_torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import match_kernel as MK
    times, blobs = [], []
    _kernels.reset_launches()
    for _ in range(ENC_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blobs.append(brotlig_tpu_torch.encode(data, device="cuda"))
        times.append((time.perf_counter() - t0) * 1e3)
    matches = _kernels.LAUNCHES["match"]
    want = MK.LAUNCHES_PER_CALL * -(-len(data) // PAGE // 64) * (ENC_REPS + 1)
    if any(b != blobs[0] for b in blobs):
        raise AssertionError("hybrid encode is not deterministic")
    if matches != want:
        raise AssertionError(f"hybrid encode: {matches} matcher kernel "
                             f"launches, want {want}")
    med = float(np.median(times[1:]))
    ratio = len(data) / len(blobs[0])
    print(f"[smoke] hybrid encode (brotlig_tpu_torch.encode, device "
          f"'cuda') of the 16 MiB corpus: {[round(t, 3) for t in times]} "
          f"ms -> {len(data) / med / 1e6:.4f} GB/s (median of warm runs), "
          f"ratio {ratio:.4f}; native q11 ratio "
          f"{len(data) / len(native_blob):.4f}; matcher kernel launches "
          f"{matches} [{gpu}]", flush=True)
    return {"launches": decode_on_card(blobs[0], data, "hybrid stream"),
            "ms": med, "ratio": ratio, "matches": matches}


def texture_encode_phase(name: str, tex: bytes, params, gpu) -> dict:
    """The config-3 texture encoded on the card by the hybrid and by the
    full route at q1 and at q11 (conditioned and delta-encoded on the
    card by the preprocess kernel, one launch an encode; the full route
    in its default 64-page batches), each timed with its peak device
    memory and DP kernel launches (iterations x batches at q11, none
    otherwise) and matcher kernel launches (a call a batch, two at q11)
    and decoded on the card back to the texture; first, the hybrid and
    the full route at q1 each timed on their first call in the process
    and again.
    Returns (the decode launches, the DP inputs of the q11 route's first
    batch and iteration: litq, cand_len, dpackq, jointEq, jointLq, and
    the serializer's first-batch arguments: the q1 route's greedy pack and
    the q11 route's DP pack, with the pack kernel launches of both, the
    matcher kernel launches of all three routes, the preprocess kernel
    launches, and the q11 route's first cost-model arguments and cost
    kernel launches, iterations x batches x 2)."""
    import torch
    import brotlig_tpu_torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import (cost_kernel, encode_pack,
                                       match_kernel, parse_dp)
    iters = int(os.environ.get("BLG_DP_ITERS", "3"))
    nbatch = -(-len(tex) // PAGE // 64)
    launches, first, packs, model_in = [], [], {}, []
    dp_parse = parse_dp.dp_parse
    build_cost_model = parse_dp.build_cost_model
    pack_partitioned = encode_pack.pack_partitioned
    # the texture's first encode by each route in the process, then warm
    for backend, quality in (("hybrid", 11), ("full", 1)):
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            brotlig_tpu_torch.encode(tex, dc_params=params, backend=backend,
                                     quality=quality, device="cuda")
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[smoke] {name}, {backend} encode (q{quality}) on the card: "
              f"first call {ms[0]:.1f} ms, then {ms[1]:.1f} ms [{gpu}]",
              flush=True)

    def recorded(*args):
        if not first:
            first.extend(args[:5])
        return dp_parse(*args)

    def model_recorded(*args):
        if not model_in:
            model_in.extend(args)
        return build_cost_model(*args)

    def pack_recorded(*args):
        calls.append(args)
        return pack_partitioned(*args)
    for backend, quality in (("hybrid", 11), ("full", 1), ("full", 11)):
        calls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        parse_dp.dp_parse = recorded
        parse_dp.build_cost_model = model_recorded
        encode_pack.pack_partitioned = pack_recorded
        try:
            blob = brotlig_tpu_torch.encode(tex, dc_params=params,
                                            backend=backend, quality=quality,
                                            device="cuda")
        finally:
            parse_dp.dp_parse = dp_parse
            parse_dp.build_cost_model = build_cost_model
            encode_pack.pack_partitioned = pack_partitioned
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        dp = _kernels.LAUNCHES["dp_parse"]
        pk = _kernels.LAUNCHES["pack"]
        mt = _kernels.LAUNCHES["match"]
        ct = _kernels.LAUNCHES["cost"]
        pc = _kernels.LAUNCHES["precond"]
        full = backend == "full"
        want = iters * nbatch if (backend, quality) == ("full", 11) else 0
        want_ct = want * cost_kernel.LAUNCHES_PER_CALL
        want_pk = full * nbatch * (1 + (quality >= 10))
        # the greedy cover a batch, and the DP's candidates at q11
        want_mt = (match_kernel.LAUNCHES_PER_CALL * nbatch
                   * (1 + (full and quality >= 10)))
        if dp != want or pk != want_pk or mt != want_mt or ct != want_ct \
                or pc != 1:
            raise AssertionError(f"{name}, {backend} q{quality}: {dp} DP, "
                                 f"{pk} pack, {mt} matcher, {ct} cost and "
                                 f"{pc} preprocess kernel launches, want "
                                 f"{want}, {want_pk}, {want_mt}, {want_ct} "
                                 "and 1")
        packs["match launches"] = packs.get("match launches", 0) + mt
        packs["precond launches"] = packs.get("precond launches", 0) + pc
        packs["cost launches"] = packs.get("cost launches", 0) + ct
        packs.setdefault("ratios", {})[f"{backend} q{quality}"] = \
            len(tex) / len(blob)
        if full:    # the first batch's pack: greedy at q1, the DP's at q11
            packs[f"q{quality}"] = calls[quality >= 10]
            packs["launches"] = packs.get("launches", 0) + pk
        print(f"[smoke] {name}, {backend} encode (q{quality}) on the card: "
              f"{ms:.1f} ms, ratio {len(tex) / len(blob):.4f}, peak "
              f"{peak / 2**20:.1f} MiB allocated, DP kernel launches {dp}, "
              f"pack kernel launches {pk}, matcher kernel launches {mt}, "
              f"cost kernel launches {ct}, preprocess kernel launches {pc} "
              f"[{gpu}]", flush=True)
        launches.append(decode_on_card(blob, tex, f"{name}, {backend} "
                                       f"encode (q{quality})"))
    packs["cost in"] = tuple(model_in)
    return launches, tuple(first), packs


def cli_phase(data: bytes, gpu) -> None:
    """Compress and decompress a file with python -m brotlig_tpu_torch.cli
    --device cuda in subprocesses, in a directory of the checkout that is
    removed after."""
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        with open(os.path.join(tmp, "in.bin"), "wb") as f:
            f.write(data)
        for args in (["in.bin"], ["in.bin.brotlig"]):
            res = subprocess.run(
                [sys.executable, "-m", "brotlig_tpu_torch.cli", *args,
                 "--device", "cuda"], cwd=tmp, env=env, capture_output=True,
                text=True, timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"cli {args} exited {res.returncode}: "
                                     f"{res.stderr[-2000:]}")
            print("[smoke] cli " + " ".join(args) + ": "
                  + "; ".join(res.stdout.strip().splitlines())
                  + f" [{gpu}]", flush=True)
        with open(os.path.join(tmp, "in.bin.out"), "rb") as f:
            if f.read() != data:
                raise AssertionError("cli round trip differs")
    print(f"[smoke] cli round trip of {len(data)} B on the card == input",
          flush=True)


# ---------------------------------------------------------------------------
# The serializer kernel (csrc/pack.cu) against its plain version
# ---------------------------------------------------------------------------

# the encode path's figures when a stage ran as eager torch ops (this
# script's encode phases on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# sections 5 and 6): the serializer's (before its kernel), and the
# matcher's (the last run before its kernels, with the serializer kernel)
EAGER = {"q1 serializer": 180.203, "q1 total": 226.768, "q1 kernels": 16768,
         "q1 serializer kernels": 13403, "q11 entry": 809.0,
         "q11 greedy pack": 65.704, "q11 DP pack": 127.907,
         "q11 total": 776.076,
         "q1 matcher": 61.691, "q1 total, eager matcher": 63.326,
         "q1 kernels, eager matcher": 3369, "q11 greedy matcher": 126.607,
         "q11 find_candidates": 135.063, "q11 entry, eager matcher": 578.175,
         "q11 kernels, eager matcher": 28983}


# the q11 cost model's stage (three iterations) when it ran as eager torch
# ops, and the q11 entry point's CUDA kernels a call then (this script's
# q11 phase, its last run before the cost kernels, on an NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md section 5)
EAGER_COST_MODEL_MS = 160.150
EAGER_Q11_KERNELS = 9505
# the serializer kernel's raw launch on the q1 batch before its statistics
# phases moved into csrc/page_tables.cuh (the same card; PERF.md section 6)
PACK_BEFORE_SHARED_MS = {"q1": 0.3069}


# the kernel's first design (one block a page whose bit packing ran in
# one warp: this script's raw launch on an NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 6), by batch
PACK_FIRST = {"q1": 1.0667, "q11 greedy": 1.0102, "q11 DP": 0.9824,
             "texture q1": 1.2150, "texture q11 DP": 1.2359}


def pack_kernel_report() -> str:
    """ptxas's registers, barriers, stack, spills and static shared
    memory of the serializer kernel, from the build log."""
    from brotlig_tpu_torch import _kernels
    found, inside = [], False
    for line in _kernels.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            inside = "pack_kernel" in line
        elif inside and ("spill" in line or "registers" in line):
            found.append(line.split(":", 1)[-1].strip())
    return "; ".join(found) or "not in the build log"


def pack_bytes(pages, ncmds) -> int:
    """The bytes the serializer must move: each page read once, the three
    int32 fields of each command and each page's size and count, the
    output pages and sizes written once."""
    P, S = pages.shape
    return 2 * P * S + 12 * int(ncmds.sum()) + 16 * P


def pack_launch(args):
    """The serializer's raw launch on pack_partitioned's arguments
    (pages, in_sizes, page size, bound, ins, cpy, dist, ncmds, isdelta):
    operands converted and outputs allocated once."""
    import torch
    from brotlig_tpu_torch import _kernels
    pages, in_sizes, page, max_cmds, ins, cpy, dist, ncmds, flags = args
    P, S = pages.shape
    N = ins.shape[1]
    dev = pages.device
    i32 = [x.to(torch.int32).contiguous()
           for x in (in_sizes, ins, cpy, dist, ncmds, flags)]
    lib = _kernels.library()
    out = torch.empty((P, page), dtype=torch.uint8, device=dev)
    sizes = torch.empty(P, dtype=torch.int32, device=dev)
    scratch = torch.empty((P, lib.blg_pack_scratch_ints(N, S, page)),
                          dtype=torch.int32, device=dev)
    return raw_launch(lib.blg_pack_pages,
                      [pages.contiguous(), *i32, P, S, N, page, max_cmds,
                       out, sizes, scratch], dev)


def pack_diagnosis(args, got, want) -> str:
    """Where the kernel departs from the plain version on a batch: the
    first differing page, and the kernel's per-page record (grid choice,
    table modes and lengths, stream bits) beside the plain version's."""
    import torch
    from brotlig_tpu_torch.ops import encode_pack as TP
    from brotlig_tpu_torch.ops import pack_kernel as PK
    pages, in_sizes, page, max_cmds, ins, cpy, dist, ncmds, flags = args
    bad = [i for i in range(pages.shape[0])
           if int(got[1][i]) != int(want[1][i])
           or not torch.equal(got[0][i], want[0][i])]
    i = bad[0]
    one = [x[i:i + 1] for x in (pages, in_sizes, ins, cpy, dist, ncmds,
                                flags)]
    info = PK.pack_cuda(*one[:6], page, max_cmds, one[6],
                        return_info=True)[2][0].cpu()
    nb, vv, h_np, h_nd = TP._slot_planes(*one[:6], page, max_cmds)
    _, bits = TP._stream_words(nb, vv, TP.stream_budget(page))
    hists = TP.page_histograms(*[x.to(torch.int64) for x in one[:6]])[6]
    lines = [f"pages differing: {bad[:16]} ({len(bad)}); page {i}: sizes "
             f"{int(got[1][i])} vs {int(want[1][i])}, bytes differ at "
             f"{torch.nonzero(got[0][i] != want[0][i])[:8, 0].tolist()}",
             f"npostfix, ndist: kernel {int(info[PK.INFO_NPOSTFIX])}, "
             f"{int(info[PK.INFO_NDIST])}; plain {int(h_np[0])}, "
             f"{int(h_nd[0])}; kernel ntotal {int(info[PK.INFO_NTOTAL])}, "
             f"grid keys {int(info[PK.INFO_NKEYS])}, offset codes "
             f"{int(info[PK.INFO_OFFSET_CODES])}, literals "
             f"{int(info[PK.INFO_NLITS])} (plain {int(hists[2].sum())}), "
             f"most frequent {int(info[PK.INFO_MOST_FREQ])}"]
    at = PK.INFO_LENS
    for T, (h, A) in enumerate(zip(hists, (TP.A_CMD, TP.A_DST, TP.A_LIT))):
        lens, mode, _, tsel, count = TP._choose_table(h, h.sum(1), A)
        k = info[at:at + A].to(torch.int64)
        at += A
        diff = torch.nonzero(k != lens[0].cpu())[:8, 0].tolist()
        lines.append(f"table {T}: mode {int(info[PK.INFO_MODE + T])} vs "
                     f"{int(mode[0])}, count {int(info[PK.INFO_COUNT + T])} "
                     f"vs {int(count[0])}, tsel {int(info[PK.INFO_TSEL + T])}"
                     f" vs {int(tsel[0])}, lengths differ at {diff}")
    kb = info[PK.INFO_BITS:PK.INFO_BITS + 32].tolist()
    lines.append(f"stream bits: kernel {kb}; plain {bits[0].tolist()}")
    return "\n".join("[smoke]   " + x for x in lines)


def pack_phase(batches: dict, gpu) -> dict:
    """The serializer kernel held to its plain version on the card
    (tolerance 0, bytes and sizes) on each batch of pack_partitioned
    arguments, its raw launch timed by CUDA events beside the plain
    version's one run, its bound and its first design's time; its phases
    from the per-page record, the size cases the pages took and the
    build's registers, spills and shared memory. Returns the measures by
    batch."""
    import torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops.encode_pack import pack_partitioned_plain
    from brotlig_tpu_torch.ops.pack_kernel import (BRANCH_KEYS, BRANCH_LQ,
                                                   BRANCH_WORDS, INFO_BRANCH,
                                                   INFO_CLOCKS, PHASES,
                                                   pack_cuda)
    print(f"[smoke] pack kernel build: {pack_kernel_report()} [{gpu}]",
          flush=True)
    res = {}
    for name, args in batches.items():
        pages, in_sizes, page, max_cmds, ins, cpy, dist, ncmds, flags = args
        got = pack_cuda(pages, in_sizes, ins, cpy, dist, ncmds, page,
                        max_cmds, flags)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pack_partitioned_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, want)
        if err != 0:
            print(pack_diagnosis(args, got, want), flush=True)
            raise AssertionError(f"pack kernel disagrees with plain on the "
                                 f"{name} batch: {err}")
        ms = time_ms(pack_launch(args), REPS)
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound(pack_bytes(pages, ncmds), 0)}
        info = pack_cuda(pages, in_sizes, ins, cpy, dist, ncmds, page,
                         max_cmds, flags, return_info=True)[2]
        clocks = info[:, INFO_CLOCKS:INFO_CLOCKS + len(PHASES)].double()
        per_page = clocks.sum(1)
        slow = int(per_page.argmax())
        raw = int((got[1] >= in_sizes.to(torch.int64)).sum())
        branch = info[:, INFO_BRANCH]
        cases = {k: int(((branch & bit) != 0).sum()) for k, bit in (
            ("words", BRANCH_WORDS), ("keys in the scratch", BRANCH_KEYS),
            ("literal queue in shared memory", BRANCH_LQ))}
        smem = _kernels.library().blg_pack_smem(ins.shape[1], page, page)
        before = (f"; before the shared statistics phases: "
                  f"{PACK_BEFORE_SHARED_MS[name]} ms"
                  if name in PACK_BEFORE_SHARED_MS else "")
        print(f"[smoke] pack kernel == plain (tolerance 0, bytes and sizes) "
              f"on the {name} batch ({pages.shape[0]} pages, "
              f"{int(ncmds.sum())} commands, {raw} stored raw); kernel "
              f"{ms:.4f} ms (mean of {REPS} raw launches, "
              f"{ms / pages.shape[0]:.4f} ms a page; first design: "
              f"{PACK_FIRST[name]} ms{before}), plain {plain_ms:.1f} ms (one "
              f"run on the card), bound {res[name]['bound_ms']:.5f} ms by "
              f"bytes; dynamic shared memory {smem} B a block; pages by size "
              f"case {cases} [{gpu}]", flush=True)
        print(f"[smoke] pack kernel phases on the {name} batch (thread 0's "
              f"clock, kcycles a page: mean over the pages / the slowest "
              f"page, row {slow}, {per_page[slow] / 1e3:.1f} kcycles in "
              f"all): " + "; ".join(
                  f"{ph} {clocks[:, k].mean() / 1e3:.1f} / "
                  f"{clocks[slow, k] / 1e3:.1f}"
                  for k, ph in enumerate(PHASES)) + f" [{gpu}]", flush=True)
    return res


# ---------------------------------------------------------------------------
# The matcher's kernels (csrc/match.cu) against their plain versions
# ---------------------------------------------------------------------------

# operations a probe needs at least (load its pair, compare the key, load
# and compare a word of each suffix, fold into the best), and a position a
# key family (its hash and two counting passes of the sort)
OPS_PER_PROBE = 6
OPS_PER_KEY = 8
# the matcher's first design (six launches: a tiled sort's four, probe,
# finish) on the same batches, ms by phase, sort / probe / finish (this
# script's raw launches on an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 6)
MATCH_FIRST = {"q1": (0.2358, 0.2123, 0.1156),
              "q11 greedy": (0.0770, 0.1713, 0.1051),
              "q11 candidates": (0.1000, 0.1907, 0.0365),
              "texture q1": (0.4233, 0.1901, 0.1252),
              "texture q11 candidates": (0.6186, 0.3982, 0.1048)}


def match_kernel_report() -> str:
    """ptxas's registers, stack and spills of the matcher's kernels (each
    instance: uint16 slots up to 64 KiB pages, uint32 past them), the
    finish kernel's dynamic shared memory at 64 and 128 KiB pages, and for
    each sort_probe cluster size its shared memory a CTA and the clusters
    the card holds at once."""
    from brotlig_tpu_torch import _kernels
    lib = _kernels.library()
    found, name = [], None
    for line in _kernels.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            name = next((f"{k}<{w}>" for k in ("sort_probe", "finish")
                         for w, m in (("uint16", "t"), ("uint32", "j"))
                         if f"{k}_kernelI{m}" in line and "blg_match" in line),
                        None)
        elif name and ("registers" in line or "spill" in line):
            found.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    clusters = "; ".join(
        f"{nc} CTAs: {lib.blg_match_sort_probe_smem(PAGE, nc)} B a CTA, "
        f"{lib.blg_match_max_clusters(PAGE, nc)} clusters at once at 64 KiB "
        f"pages ({lib.blg_match_sort_probe_smem(2 * PAGE, nc)} B, "
        f"{lib.blg_match_max_clusters(2 * PAGE, nc)} at 128 KiB)"
        for nc in (2, 4, 8))
    return ("; ".join(found) or "not in the build log") + (
        f"; finish dynamic shared memory {lib.blg_match_finish_smem(PAGE)} "
        f"B a block at 64 KiB pages, {lib.blg_match_finish_smem(2 * PAGE)} "
        f"at 128 KiB; sort_probe clusters of {clusters}")


def match_keys(pages, nfam: int) -> list:
    """Each key family's 16-bit keys at every position [P, S] (int64, on
    the pages' device), with the bytes a key covers and its probes."""
    from brotlig_tpu_torch.ops import encode as TE
    q = TE._quads(pages)
    hq = TE._mul32(q, TE.HASH_MUL)
    b = pages.long()
    tri = b | (TE._shift_left(b, 1) << 8) | (TE._shift_left(b, 2) << 16)
    return [(hq >> 16, 4, TE.NUM_CANDIDATES),
            ((hq ^ TE._mul32(TE._shift_left(q, 4), TE.HASH_MUL_8)) >> 16, 8,
             TE.NUM_CANDIDATES_8),
            (TE._mul32(tri, TE.HASH_MUL_8) >> 16, 3, 2)][:nfam]


def match_work(pages, in_sizes, nfam: int) -> tuple:
    """(probes, operations) these pages ask of the matcher: each position
    a family keys inside its page probes min(family's probes, earlier
    positions with its key), as the plain version's stable sort ranks them
    (computed on the card)."""
    import torch
    P, S = pages.shape
    limit = in_sizes.long()[:, None]
    iota = torch.arange(S, device=pages.device)[None, :].expand(P, S)
    probes = keyed = 0
    for key, nbytes, nprobe in match_keys(pages, nfam):
        inside = iota + nbytes <= limit
        ks, _ = torch.sort(torch.where(inside, key, -1 - iota), dim=1,
                           stable=True)
        idx = iota
        new = torch.ones_like(inside)
        new[:, 1:] = ks[:, 1:] != ks[:, :-1]
        start = torch.cummax(torch.where(new, idx, 0), dim=1).values
        probes += int(torch.where(ks >= 0, (idx - start).clamp(max=nprobe),
                                  0).sum())
        keyed += int(inside.sum())
    return probes, OPS_PER_PROBE * probes + OPS_PER_KEY * keyed


def match_design_bytes(P: int, S: int, nfam: int, nc: int, parts: int,
                       cands: bool, max_cmds: int) -> int:
    """The device-memory bytes a call of the kernels moves at most,
    reckoned from the shapes, each array read or written once: sort_probe
    reads the page into each of its cluster's nc CTAs, clears and stores
    the families' words (4 B a position, families 0 and 1) and, for the
    candidates, stores the near rows' parts (32 B a position) with their
    presence bits; finish reads the page and the words (each of a page's
    `parts` blocks) and the near rows, and writes the commands or the
    candidate rows. Past 64 KiB pages the sort's slots, their keys, the
    lengths and the node lists go through device scratch too."""
    pos = P * S
    nbytes = nc * nfam * pos + 2 * 2 * 4 * pos        # sort_probe
    nbytes += parts * (pos + 2 * 4 * pos)             # finish
    if cands:
        nbytes += 2 * 32 * pos + 2 * 3 * pos // 8 + 2 * 4 * pos * 8
    else:
        nbytes += 3 * 4 * P * max_cmds + 4 * P
    if S > 65536:   # slots, keys (written and read), lengths, nodes
        nbytes += 3 * 2 * 4 * nfam * pos + 2 * 4 * pos
    return nbytes


def match_launches(pages, in_sizes, kind: str, param: int) -> tuple:
    """The matcher's raw launches on a batch, as two functions: sort_probe
    and finish; kind "fast" or "exact" (the cover; param = max_cmds) or
    "candidates" (param = cap), with operands and scratch allocated
    once."""
    import torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import match_kernel as MK
    lib = _kernels.library()
    P, S = pages.shape
    dev = pages.device
    cands = kind == "candidates"
    nfam = MK.FAMILIES_CANDIDATES if cands else MK.FAMILIES_COVER
    words = MK.FAST_WORDS if kind == "fast" else MK.EXACT_WORDS
    sizes = in_sizes.to(torch.int32).contiguous()
    pages = pages.contiguous()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)
    scratch = empty(lib.blg_match_scratch_ints(P, S, nfam))
    if cands:
        fin = [1, param, words, scratch, None, None, None, None,
               empty(P, S, 8), empty(P, S, 8)]
    else:
        fin = [param, 0, words, scratch,
               *[empty(P, param) for _ in range(3)], empty(P), None, None]
    common = [pages, sizes, P, S, nfam]
    return (raw_launch(lib.blg_match_sort_probe,
                       [*common, words, scratch], dev),
            raw_launch(lib.blg_match_finish, [*common, *fin], dev))


def match_phase(batches: dict, gpu) -> dict:
    """The matcher's kernels held to their plain versions on the card
    (tolerance 0: commands and counts, or candidates) on each batch of
    (pages, in_sizes, kind), the two raw launches timed by CUDA events
    (sort_probe alone, then with finish: the difference is finish's)
    beside the first design's six, the plain version's one run, the bound,
    the bytes the design moves and, beside sort_probe's time as the sort
    phase's yardstick, one torch.sort(keys, dim=1, stable=True) of the
    batch's [P F, S] int32 keys, which the port never calls (no library
    call computes the whole matcher: library_ms is null). Returns the
    measures by batch."""
    import torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import encode as TE
    from brotlig_tpu_torch.ops import match_kernel as MK
    from brotlig_tpu_torch.ops import parse_dp
    print(f"[smoke] match kernels build: {match_kernel_report()} [{gpu}]",
          flush=True)
    res = {}
    for name, (pages, in_sizes, kind) in batches.items():
        P, S = pages.shape
        cands = kind == "candidates"
        nfam = MK.FAMILIES_CANDIDATES if cands else MK.FAMILIES_COVER
        param = parse_dp.WINDOW if cands else S // 4 + 16
        if cands:
            got = MK.find_candidates_cuda(pages, in_sizes, param)
            plain = (lambda: TE.find_candidates_plain(pages, in_sizes,
                                                      param))
            nbytes = P * S + 4 * P + 2 * 4 * P * S * 8
        else:
            got = MK.find_commands_cuda(pages, in_sizes, param,
                                        kind == "fast")
            plain = (lambda: TE.find_commands_plain(pages, in_sizes, param,
                                                    kind == "fast"))
            nbytes = P * S + 4 * P + 3 * 4 * P * param + 4 * P
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"match kernels disagree with plain on the "
                                 f"{name} batch: {err}")
        sort_probe, finish = match_launches(pages, in_sizes, kind, param)
        t_sort = time_ms(sort_probe, REPS)
        ms = time_ms(lambda: (sort_probe(), finish()), REPS)
        keys = torch.stack([k for k, _, _ in match_keys(pages, nfam)],
                           dim=1).to(torch.int32).reshape(P * nfam, S)
        sort_ms = time_ms(
            lambda: torch.sort(keys, dim=1, stable=True), REPS)
        del keys
        probes, ops = match_work(pages, in_sizes, nfam)
        lib = _kernels.library()
        nc = lib.blg_match_cluster_size(P, S, nfam)
        moved = match_design_bytes(P, S, nfam, nc,
                                   lib.blg_match_finish_parts(P, S, cands),
                                   cands, 1 if cands else param)
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, ops), "library_ms": None}
        extra = ("" if cands else
                 f", {int(got[3].sum())} commands")
        before = MATCH_FIRST.get(name)
        was = (f"; the first design's six launches {sum(before):.4f} ms "
               f"(sort {before[0]}, probe {before[1]}, finish {before[2]})"
               if before else "")
        print(f"[smoke] match kernels == plain (tolerance 0) on the {name} "
              f"batch ({P} x {S // 1024} KiB pages, {kind}{extra}, clusters "
              f"of {nc} CTAs); kernels "
              f"{ms:.4f} ms (mean of {REPS} runs of the two raw launches: "
              f"sort_probe {t_sort:.4f}, finish {ms - t_sort:.4f}){was}; "
              f"the sort phase's yardstick, torch.sort of the "
              f"[{P * nfam}, {S}] int32 keys, {sort_ms:.4f} ms beside "
              f"sort_probe's {t_sort:.4f}; plain "
              f"{plain_ms:.1f} ms (one run on the card); bound "
              f"{res[name]['bound_ms'] * 1e3:.3f} us by "
              f"{res[name]['bound_by']} ({nbytes} B, {probes} probes, {ops} "
              f"operations); the design moves at most {moved} B a call "
              f"[{gpu}]",
              flush=True)
    return res

# ---------------------------------------------------------------------------
# The q11 cost model's kernels (csrc/cost_model.cu) against their plain
# version
# ---------------------------------------------------------------------------

# operations a candidate slot needs at least (its distance symbol and extra
# bits, a table read, the ring compares, the min and the pack), and a ring
# probe a byte it compares
OPS_PER_SLOT = 12
OPS_PER_PROBE_BYTE = 3


def cost_kernel_report() -> str:
    """ptxas's registers, stack and spills of the cost model's two kernels,
    from the build log."""
    from brotlig_tpu_torch import _kernels
    found, name = [], None
    for line in _kernels.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in ("tables", "positions")
                         if f"cost_{k}_kernel" in line), None)
        elif name and ("registers" in line or "spill" in line):
            found.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return "; ".join(found) or "not in the build log"


def cost_bytes(args) -> int:
    """The bytes the cost model must move: each page, its size and command
    count, its commands' three fields and its base candidates read once;
    litq, the two joint tables and the three [P, S, 12] outputs written
    once."""
    pages, ncmds = args[0], args[5]
    P, S = pages.shape
    return (P * S + 8 * P + 12 * int(ncmds.sum()) + 2 * 4 * P * S * 8
            + 4 * P * S + 2 * 4 * P * 576 + 3 * 4 * P * S * 12)


def cost_launches(args) -> tuple:
    """The cost model's two raw launches on build_cost_model's arguments
    (operands converted and outputs and scratch allocated once): (the
    table kernel, the position kernel)."""
    import torch
    from brotlig_tpu_torch import _kernels
    pages, in_sizes, ins, cpy, dist, ncmds, base_len, base_dist = args
    P, S = pages.shape
    N = ins.shape[1]
    dev = pages.device
    lib = _kernels.library()
    i32 = [x.to(torch.int32).contiguous()
           for x in (in_sizes, ins, cpy, dist, ncmds)]
    base = [x.to(torch.int32).contiguous() for x in (base_len, base_dist)]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)
    scratch = empty(P, lib.blg_cost_scratch_ints(P, N, S))
    pages = pages.contiguous()
    tables = raw_launch(lib.blg_cost_tables,
                        [pages, *i32, P, S, N, empty(P, 576), empty(P, 576),
                         scratch, None], dev)
    positions = raw_launch(lib.blg_cost_positions,
                           [pages, i32[0], *base, P, S, N, scratch,
                            empty(P, S), *(empty(P, S, 12) for _ in range(3))],
                           dev)
    return tables, positions


def cost_record(rec) -> str:
    """The table kernel's clock record (int32 [P, REC_INTS], its clock
    cycles by phase first): each phase's kcycles on the slowest page (by
    the sum) and the mean over pages."""
    from brotlig_tpu_torch.ops import cost_kernel as CK
    cyc = rec[:, :len(CK.PHASES)].double().cpu()
    slow = int(cyc.sum(1).argmax())
    return (f"slowest page (row {slow}) {float(cyc[slow].sum()) / 1e3:.1f} "
            f"kcycles, mean {float(cyc.sum(1).mean()) / 1e3:.1f}; by phase "
            f"(slowest / mean): " + ", ".join(
                f"{ph} {float(cyc[slow, k]) / 1e3:.1f} / "
                f"{float(cyc[:, k].mean()) / 1e3:.1f}"
                for k, ph in enumerate(CK.PHASES)))


def corpus_pages(data: bytes, page: int, npages: int, dev) -> tuple:
    """(pages uint8 [npages, page], in_sizes int64) of the corpus's first
    npages pages of `page` bytes, on dev."""
    import numpy as np
    import torch
    arr = np.frombuffer(data[:npages * page], np.uint8).reshape(npages, page)
    return (torch.from_numpy(arr.copy()).to(dev),
            torch.full((npages,), page, dtype=torch.int64, device=dev))


def cost_batch(pages, sizes) -> tuple:
    """build_cost_model's arguments on corpus pages: the exact-tier greedy
    commands and the candidates (W 512), from the matcher's kernels."""
    from brotlig_tpu_torch.ops import parse_dp
    from brotlig_tpu_torch.ops.encode import find_candidates, find_commands
    page = pages.shape[1]
    return (pages, sizes, *find_commands(pages, sizes, page // 4 + 16),
            *find_candidates(pages, sizes, parse_dp.WINDOW))


def cost_position_bytes(P: int, S: int) -> int:
    """The bytes the position kernel must move: each page byte and base
    candidate read once, litq and the three [P, S, 12] outputs written
    once."""
    return P * S + 2 * 4 * P * S * 8 + 4 * P * S + 3 * 4 * P * S * 12


def cost_phase(batches: dict, gpu) -> dict:
    """The cost model's kernels held to their plain version on the card
    (tolerance 0, all six outputs) on each batch of build_cost_model
    arguments, the two raw launches timed by CUDA events (the table kernel
    alone, then both: the difference is the position kernel's) beside the
    plain version's one run on the card and the bound (bytes, and the
    operations of the slots and of the probes' compared bytes), the
    position kernel beside its own bytes bound, the wrapper's host time a
    call, each batch's cluster and shared memory, and the table kernel's
    clock record by phase. Returns the measures by batch."""
    import torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import cost_kernel as CK
    from brotlig_tpu_torch.ops import parse_dp
    lib = _kernels.library()
    print(f"[smoke] cost kernels build: {cost_kernel_report()}; the "
          f"position kernel's dynamic shared memory "
          f"{lib.blg_cost_positions_smem()} B a block [{gpu}]", flush=True)
    res = {}
    for name, args in batches.items():
        pages, ncmds = args[0], args[5]
        P, S = pages.shape
        N = args[2].shape[1]
        plan = [lib.blg_cost_plan(P, N, S, k) for k in range(3)]
        *got, rec = CK.build_cost_model_cuda(*args, return_record=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = parse_dp.build_cost_model_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, want)
        if err != 0:
            bad = [k for k, g, w in zip(
                ("litq", "jointEq", "jointLq", "cand_len", "cand_dist",
                 "dpackq"), got, want) if not torch.equal(g, w)]
            raise AssertionError(f"cost kernels disagree with plain on the "
                                 f"{name} batch: {err} in {bad}")
        tables, positions = cost_launches(args)
        t_tab = time_ms(tables, REPS)
        ms = time_ms(lambda: (tables(), positions()), REPS)
        t_pos = ms - t_tab
        nbytes = cost_bytes(args)
        probed = int(got[3][..., CK.BASE_SLOTS:].long().sum())
        ops = (P * S * (CK.SLOTS * OPS_PER_SLOT + 4 * OPS_PER_PROBE_BYTE)
               + OPS_PER_PROBE_BYTE * probed)
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, ops)}
        pos_bound = cost_position_bytes(P, S) / HBM_BYTES_PER_S * 1e3
        host = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            CK.build_cost_model_cuda(*args)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        print(f"[smoke] cost kernels == plain (tolerance 0, six outputs) on "
              f"the {name} batch ({P} x {S // 1024} KiB pages, "
              f"{int(ncmds.sum())} commands; clusters of {plan[0]} CTAs a "
              f"page, {plan[1]} B of dynamic shared memory a CTA, distance "
              f"counts in {'shared memory' if plan[2] else 'the scratch'}); "
              f"kernels {ms:.4f} ms (mean of {REPS} runs of the two raw "
              f"launches: tables {t_tab:.4f}, positions {t_pos:.4f}, "
              f"{pos_bound / t_pos:.1%} of the positions' own bytes bound "
              f"{pos_bound:.5f} ms), plain {plain_ms:.1f} ms (one run on "
              f"the card), bound {res[name]['bound_ms']:.5f} ms by "
              f"{res[name]['bound_by']} ({nbytes} B, {ops} operations), "
              f"{res[name]['bound_ms'] / ms:.1%} of it; the wrapper's host "
              f"time a call {sorted(host)[REPS // 2]:.4f} ms (median of "
              f"{REPS}, no synchronisation inside) [{gpu}]", flush=True)
        print(f"[smoke] cost table kernel's clock on the {name} batch: "
              f"{cost_record(rec)} [{gpu}]", flush=True)
    return res


def kernel_names(fn) -> dict:
    """The CUDA kernels one call of fn runs on the card, counted by name
    (torch.profiler; a name is its function's, without namespaces,
    template arguments or parameters)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))):
            name = e.name.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            short = re.split(r"[(<\[]", name)[0].split("::")[-1]
            names[short] = names.get(short, 0) + 1
    return dict(sorted(names.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# Encode at q11 on the card: the windowed-DP parse and its kernel
# ---------------------------------------------------------------------------

Q11_PAGES = 8        # bench.py's encode_ratio_q11 cell (bench.py:612-648):
                     # 8 pages at stride len(pages) // 8
MODEL_CHECK = Q11_PAGES  # pages whose candidates and cost model the CPU
                         # repeats
# operations a DP relax edge needs at least (two table reads, four adds,
# two mins, the pack, the min into its target), and a closure a cell
OPS_PER_EDGE = 10
OPS_PER_CLOSURE_CELL = 10


def dp_bound(ins, B: int, W: int, R: int) -> dict:
    """The DP kernel's bound on these inputs: each input read once and the
    output written once; the relaxes this data needs (each round, every
    bucket-base edge whose source has a candidate that long and every
    candidate's full-length edge, both inside the page) and the literal
    closures (R + 1 a block)."""
    import torch
    from brotlig_tpu_torch.ops import parse_dp
    litq, cand_len = ins[0], ins[1].long()
    P, S = litq.shape
    nbytes = sum(x.numel() * 4 for x in ins) + P * S * 4
    node = torch.arange(S, device=litq.device)[None, :, None]
    longest = cand_len.max(dim=2).values
    pairs = sum(int(((longest >= L) & (node[:, :, 0] + L <= S)).sum())
                for L in parse_dp.CPY_BASE if L <= W)
    edges = int(((cand_len >= 2) & (node + cand_len <= S)).sum())
    ops = (R * (pairs + edges) * OPS_PER_EDGE
           + (R + 1) * P * S * OPS_PER_CLOSURE_CELL)
    return {**bound(nbytes, ops), "edges": pairs + edges}


def dp_launch(ins, B: int, W: int, R: int, rounds: bool = False):
    """The DP kernel's raw launch on (litq, cand_len, dpackq, jointEq,
    jointLq); with rounds, it also writes the rounds each page ran
    (run.rounds, int32 [P])."""
    import torch
    from brotlig_tpu_torch import _kernels
    P, S, K = ins[1].shape
    dev = ins[0].device
    out = torch.empty((P, S), dtype=torch.int32, device=dev)
    ran = torch.zeros(P, dtype=torch.int32, device=dev) if rounds else None
    run = raw_launch(_kernels.library().blg_dp_parse,
                     [*ins, P, S, K, B, W, R, out, ran], dev)
    run.out, run.rounds = out, ran
    return run


def dp_kernel_report() -> str:
    """ptxas's registers and barriers of each instance of the DP kernel
    (one for blocks of at most 32 cells, one for more) from the build
    log."""
    from brotlig_tpu_torch import _kernels
    found, name = [], None
    for line in _kernels.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and "dp_parse_kernel" in name and "registers" in line:
            found.append(f"{'B > 32' if 'ILi2E' in name else 'B <= 32'}: "
                         + line.split(":", 1)[1].strip())
            name = None
    return "; ".join(found) or "not in the build log"


def q11_steps(arr, sizes, dev, iters: int):
    """A copy of encode_pages_device(quality=11)'s steps on the card,
    timed by stage (CUDA events around the device stages; the host clock
    around the backtracks, which copy to the host, and around the whole):
    the stage breakdown only, printed beside the entry point's own total
    so that a gap between the two shows. Returns (blobs, ms by stage, the
    first iteration's DP inputs, the two packs' arguments: greedy and
    DP, each iteration's cost-model arguments)."""
    import numpy as np
    import torch
    from brotlig_tpu_torch.ops import parse_dp
    from brotlig_tpu_torch.ops.encode import find_candidates, find_commands
    from brotlig_tpu_torch.ops.encode_pack import pack_partitioned, page_blobs
    max_cmds = PAGE // 4 + 16
    marks, host = [], {"backtrack": 0.0}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pages = torch.from_numpy(arr).to(dev)
    in_sizes = torch.from_numpy(sizes).to(dev)
    flags = torch.zeros(len(arr), dtype=torch.int64, device=dev)
    mark(None)
    greedy = find_commands(pages, in_sizes, max_cmds)
    mark("greedy matcher")
    out, out_sizes = pack_partitioned(pages, in_sizes, PAGE, max_cmds,
                                      *greedy, flags)
    mark("greedy pack")
    cand = find_candidates(pages, in_sizes, parse_dp.WINDOW)
    mark("find_candidates")
    cmds, first, model_in = greedy, None, []
    sizes_np = in_sizes.cpu().numpy()
    for _ in range(iters):
        model_in.append((pages, in_sizes, *cmds, *cand))
        mark(None)
        model = parse_dp.build_cost_model(pages, in_sizes, *cmds, *cand)
        mark("cost model")
        litq, jointEq, jointLq, cand_len, cand_dist, dpackq = model
        first = first or (litq, cand_len, dpackq, jointEq, jointLq)
        combined = parse_dp.dp_parse(litq, cand_len, dpackq, jointEq, jointLq,
                                     parse_dp.BLOCK, parse_dp.WINDOW,
                                     parse_dp.ROUNDS)
        mark("kernel")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = parse_dp.backtrack(combined.cpu().numpy(),
                                 cand_len.cpu().numpy(),
                                 cand_dist.cpu().numpy(),
                                 dpackq.cpu().numpy(), sizes_np, max_cmds)
        for p in np.nonzero(got[3] < 0)[0]:
            for new, old in zip(got, greedy):
                new[p] = old[p].cpu().numpy()
        cmds = tuple(torch.from_numpy(x).to(dev) for x in got)
        host["backtrack"] += (time.perf_counter() - t1) * 1e3
    mark(None)
    out2, sizes2 = pack_partitioned(pages, in_sizes, PAGE, max_cmds, *cmds,
                                    flags)
    mark("DP pack")
    win = sizes2 < out_sizes
    blobs = page_blobs(torch.where(win[:, None], out2, out).cpu().numpy(),
                       torch.where(win, sizes2, out_sizes).cpu().numpy(),
                       sizes, arr)
    total = (time.perf_counter() - t0) * 1e3
    ms = dict.fromkeys(["greedy matcher", "greedy pack", "find_candidates",
                        "cost model", "kernel", "DP pack"], 0.0)
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if name is not None:
            ms[name] += a.elapsed_time(b)
    ms.update(host)
    ms["host"] = total - sum(ms.values())
    ms["total"] = total
    packs = {"greedy": (pages, in_sizes, PAGE, max_cmds, *greedy, flags),
             "DP": (pages, in_sizes, PAGE, max_cmds, *cmds, flags)}
    return blobs, ms, first, packs, model_in


# the DP kernel's first design (one thread block a page, every block 16
# rounds and a final closure) on this phase's batch, a launch (NVIDIA H100
# 80GB HBM3, 700 W; chip_smoke.py's q11 phase)
DP_FIRST_DESIGN_MS = 102.211


def dp_rounds_mean(ins, B: int, W: int, R: int) -> list:
    """The rounds a block each page of the DP inputs ran in the kernel
    (every block stops at its first round in which no dp value fell, else
    after R)."""
    import torch
    run = dp_launch(ins, B, W, R, rounds=True)
    run()
    torch.cuda.synchronize()
    blocks = ins[0].shape[1] // B
    return [round(int(x) / blocks, 4) for x in run.rounds.cpu()]


def q11_phase(data: bytes, dev, gpu, tex_dp) -> dict:
    """The full-device q11 path, encode_pages_device(quality=11), on 8
    corpus pages: the DP kernel held to its plain version on the card
    (tolerance 0) and timed beside it and its bound; find_candidates and
    build_cost_model on 2 pages held to the CPU run (tolerance 0); the
    entry point timed over warm runs, with its DP kernel launches counted
    (iterations x runs, no plain dp_parse), its CUDA kernels and its peak
    memory; the stage breakdown from q11_steps; its ratio against q1
    and the native q11 encoder; every blob decoded by the native decoder
    and, as a container, on the card on both routes. The DP kernel is also
    held to its plain version at R 1 and 2 on the same inputs, its rounds
    a block are read from its rounds output, and it is timed on tex_dp, the
    config-3 texture's first 64-page q11 batch, for its time a page."""
    import numpy as np
    import torch
    from brotlig_tpu_torch import _kernels, native
    from brotlig_tpu_torch.ops import cost_kernel as CK
    from brotlig_tpu_torch.ops import match_kernel as MK
    from brotlig_tpu_torch.ops import parse_dp
    from brotlig_tpu_torch.ops.encode import find_candidates, find_commands
    from brotlig_tpu_torch.ops.encode_pack import encode_pages_device
    from brotlig_tpu_torch.tools.profile_decode import device_work
    npages = len(data) // PAGE
    idx = list(range(0, npages, max(1, npages // Q11_PAGES)))[:Q11_PAGES]
    arr = np.stack([np.frombuffer(data[i * PAGE:(i + 1) * PAGE], np.uint8)
                    for i in idx])
    sizes = np.full(len(idx), PAGE, np.int64)
    iters = int(os.environ.get("BLG_DP_ITERS", "3"))
    B, W, R = parse_dp.BLOCK, parse_dp.WINDOW, parse_dp.ROUNDS

    # the float32 unseen-symbol cost: the card's log2 against the CPU's,
    # in torch and in the cost model's kernels
    total = torch.arange(1, 1 << 18)
    for pad in (2.0, 4.0):
        want = torch.round(2 * parse_dp.unseen_bits(total, pad))
        if not torch.equal(
                torch.round(2 * parse_dp.unseen_bits(total.to(dev), pad))
                .cpu(), want):
            raise AssertionError(f"unseen cost (pad {pad}): the card's "
                                 "float32 log2 differs from the CPU's")
        if not torch.equal(CK.unseen_half_bits_cuda(total.numel(), pad, dev)
                           .cpu(), want.to(torch.int32)):
            raise AssertionError(f"unseen cost (pad {pad}): the cost "
                                 "kernels' half-bits differ from the CPU's")

    # ---- the main path: encode_pages_device itself, launches counted ----
    plain_calls = []
    plain = parse_dp.dp_parse_plain
    plain_model = parse_dp.build_cost_model_plain

    def counted(*args, **kwargs):
        plain_calls.append(1)
        return plain(*args, **kwargs)

    def counted_model(*args, **kwargs):
        plain_calls.append(1)
        return plain_model(*args, **kwargs)

    def entry():
        return encode_pages_device(arr, sizes, PAGE, quality=11,
                                   device="cuda")
    nruns = ENC_REPS + 1                 # the first run is the warm-up
    parse_dp.dp_parse_plain = counted
    parse_dp.build_cost_model_plain = counted_model
    try:
        _kernels.reset_launches()
        times, outs = [], []
        for _ in range(nruns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(entry())
            times.append((time.perf_counter() - t0) * 1e3)
        counts = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        outs.append(entry())
        peak = torch.cuda.max_memory_allocated(dev)
        work = device_work(entry)
        left = kernel_names(entry)
        # the stage breakdown, from chip_smoke's copy of the route's steps
        runs = [q11_steps(arr, sizes, dev, iters) for _ in range(ENC_REPS)]
    finally:
        parse_dp.dp_parse_plain = plain
        parse_dp.build_cost_model_plain = plain_model
    launches = counts["dp_parse"]
    # a run: the greedy cover and the DP's candidates, two launches each;
    # the cost model, two launches an iteration
    want = {**dict.fromkeys(counts, 0), "dp_parse": iters * nruns,
            "pack": 2 * nruns, "match": 2 * MK.LAUNCHES_PER_CALL * nruns,
            "cost": iters * CK.LAUNCHES_PER_CALL * nruns}
    if counts != want or plain_calls:
        raise AssertionError(f"q11: encode_pages_device launched {counts} "
                             f"(want {want}) and {len(plain_calls)} plain "
                             "dp_parse or build_cost_model calls (want 0)")
    blobs = outs[0]
    if any(o != blobs for o in outs):
        raise AssertionError("q11 encode is not deterministic")
    if any(r[0] != blobs for r in runs):
        raise AssertionError("encode_pages_device(quality=11) differs from "
                             "its steps")
    total = float(np.median(times[1:]))
    med = {k: float(np.median([r[1][k] for r in runs])) for k in runs[0][1]}
    nbytes = len(idx) * PAGE
    q1 = encode_pages_device(arr, sizes, PAGE, quality=1, device="cuda")
    native_blob = native.encode(arr.tobytes(), page_size=PAGE, quality=11)
    ratio = nbytes / sum(map(len, blobs))
    print(f"[smoke] full-device q11 encode (encode_pages_device, quality=11, "
          f"{iters} DP iterations, B {B} W {W} R {R}) of {len(idx)} x 64 "
          f"KiB corpus pages (every {idx[1] - idx[0]}th) on the card: runs "
          f"{[round(t, 3) for t in times]} ms, median of {ENC_REPS} warm "
          f"runs {total:.3f} ms -> {nbytes / total / 1e6:.6f} GB/s of input; "
          f"per call {work['aten_ops']} aten ops, "
          f"{work['kernels'] or 'not measured'} CUDA kernels "
          f"({work['kernel_ms'] or 0:.3f} ms of kernel time); peak "
          f"{peak / 2**20:.1f} MiB allocated; DP kernel launches {launches} "
          f"({iters} x {nruns} runs), plain dp_parse calls 0 [{gpu}]",
          flush=True)
    print(f"[smoke] full-device q11 beside the eager serializer's run "
          f"(NVIDIA H100 80GB HBM3, 700.00 W): entry point {total:.3f} ms "
          f"(eager: {EAGER['q11 entry']}); greedy pack "
          f"{med['greedy pack']:.3f} ms (eager: {EAGER['q11 greedy pack']}), "
          f"DP pack {med['DP pack']:.3f} ms (eager: {EAGER['q11 DP pack']}), "
          f"stage total {med['total']:.3f} ms (eager: {EAGER['q11 total']}); "
          f"pack kernel launches {counts['pack']} ({nruns} runs x 2 packs) "
          f"[{gpu}]", flush=True)
    print(f"[smoke] full-device q11 matcher stages beside their eager run "
          f"(NVIDIA H100 80GB HBM3, 700.00 W): greedy matcher "
          f"{med['greedy matcher']:.3f} ms (eager: "
          f"{EAGER['q11 greedy matcher']}), find_candidates "
          f"{med['find_candidates']:.3f} ms (eager: "
          f"{EAGER['q11 find_candidates']}), entry point {total:.3f} ms "
          f"(eager: {EAGER['q11 entry, eager matcher']}), CUDA kernels a "
          f"call {work['kernels'] or 'not measured'} (eager: "
          f"{EAGER['q11 kernels, eager matcher']}); matcher kernel launches "
          f"{counts['match']} ({nruns} runs x 2 calls x "
          f"{MK.LAUNCHES_PER_CALL}) [{gpu}]", flush=True)
    print(f"[smoke] full-device q11 stage breakdown (chip_smoke's copy of "
          f"encode_pages_device's steps, CUDA events per device stage), "
          f"median of {ENC_REPS} runs (ms): "
          f"{json.dumps({k: round(v, 3) for k, v in med.items()})}; its "
          f"total {med['total']:.3f} ms beside encode_pages_device's "
          f"{total:.3f} ms [{gpu}]", flush=True)
    print(f"[smoke] q11 ratio {ratio:.4f}; q1 on the same pages "
          f"{nbytes / sum(map(len, q1)):.4f} (q11/q1 "
          f"{sum(map(len, q1)) / sum(map(len, blobs)):.4f}); native q11 "
          f"{nbytes / len(native_blob):.4f} [{gpu}]", flush=True)
    print(f"[smoke] full-device q11 cost model (csrc/cost_model.cu) beside "
          f"its eager run (NVIDIA H100 80GB HBM3, 700.00 W): stage "
          f"{med['cost model']:.3f} ms for {iters} iterations (eager: "
          f"{EAGER_COST_MODEL_MS}); CUDA kernels a call "
          f"{work['kernels'] or 'not measured'} (eager: {EAGER_Q11_KERNELS})"
          f"; cost kernel launches {counts['cost']} ({nruns} runs x {iters} "
          f"iterations x {CK.LAUNCHES_PER_CALL}), plain build_cost_model "
          f"calls 0; the kernels of a call by name: {json.dumps(left)} "
          f"[{gpu}]", flush=True)
    print("[smoke] full-device q11 stage breakdown runs (ms): " + json.dumps(
        [{k: round(v, 3) for k, v in r[1].items()} for r in runs])
        + f" [{gpu}]", flush=True)
    for blob, page in zip(blobs, arr):
        got = (page.tobytes() if len(blob) == PAGE
               else native.decode_page(blob, PAGE))
        if got != page.tobytes():
            raise AssertionError("full-device q11: a blob does not decode")

    # ---- the kernel against its plain version, first iteration ----
    ins = runs[0][2]
    kernel = dp_launch(ins, B, W, R)
    kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = parse_dp.dp_parse_plain(*ins, B, W, R)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err([kernel.out], [want])
    for r in (1, 2):
        short = dp_launch(ins, B, W, r)
        short()
        torch.cuda.synchronize()
        err = max(err, max_abs_err(
            [short.out], [parse_dp.dp_parse_plain(*ins, B, W, r)]))
    if err != 0:
        raise AssertionError(f"DP kernel disagrees with plain: {err}")
    k_dp = {"max_abs_err": err, "ms": time_ms(kernel, ENC_REPS),
            "plain_ms": plain_ms, **dp_bound(ins, B, W, R)}
    print(f"[smoke] DP kernel == plain (tolerance 0) on the first cost-model "
          f"iteration of the {len(idx)} pages at R {R}, 1 and 2; kernel "
          f"{k_dp['ms']:.3f} ms (mean of {ENC_REPS} raw launches), plain "
          f"{plain_ms:.1f} ms (one run on the card, R {R}), bound "
          f"{k_dp['bound_ms']:.5f} ms by {k_dp['bound_by']} "
          f"({k_dp.pop('edges')} relax edges a round summed over the pages) "
          f"[{gpu}]", flush=True)
    # a block that stops runs no final closure: a mean below R rounds is a
    # mean below the first design's R + 1 passes
    rounds = dp_rounds_mean(ins, B, W, R)
    if not sum(rounds) / len(rounds) < R:
        raise AssertionError(f"DP kernel: {rounds} rounds a block, want a "
                             f"mean below {R}")
    tex_ms = time_ms(dp_launch(tex_dp, B, W, R), ENC_REPS)
    tex_rounds = dp_rounds_mean(tex_dp, B, W, R)
    ntex = tex_dp[0].shape[0]
    print(f"[smoke] DP kernel: {k_dp['ms']:.3f} ms a launch on the "
          f"{len(idx)}-page batch ({k_dp['ms'] / len(idx):.4f} ms a page; "
          f"the first design took {DP_FIRST_DESIGN_MS} ms there), "
          f"{tex_ms:.3f} ms on the config-3 texture's first {ntex}-page "
          f"batch ({tex_ms / ntex:.4f} ms a page); rounds a block (R {R}) "
          f"by page {rounds}, mean {sum(rounds) / len(rounds):.4f}; "
          f"texture batch mean {sum(tex_rounds) / ntex:.4f}, max "
          f"{max(tex_rounds)}; ptxas {dp_kernel_report()}; dynamic shared "
          f"memory {_kernels.library().blg_dp_smem(W, B, ins[1].shape[2])} "
          f"B a block [{gpu}]", flush=True)

    # ---- candidates and cost model, card against CPU, 2 pages ----
    got, want = [], []
    for d, out in ((dev, got), ("cpu", want)):
        pages = torch.from_numpy(arr[:MODEL_CHECK]).to(d)
        in_sizes = torch.from_numpy(sizes[:MODEL_CHECK]).to(d)
        cand = find_candidates(pages, in_sizes, W)
        greedy = find_commands(pages, in_sizes, PAGE // 4 + 16)
        out += [t.cpu() for t in cand + parse_dp.build_cost_model(
            pages, in_sizes, *greedy, *cand)]
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"find_candidates / build_cost_model: the card "
                             f"differs from the CPU run: {err}")
    print(f"[smoke] find_candidates and build_cost_model (kernels) on "
          f"{MODEL_CHECK} pages == the CPU run (tolerance 0); unseen cost on "
          f"the card (torch and the cost kernels) == the CPU's for every "
          f"total in [1, 2^18)", flush=True)
    return {"launches": decode_on_card(container_of(blobs, PAGE),
                                       arr.tobytes(),
                                       "full-device q11 container"),
            "dp": {**k_dp, "launches": launches}, "packs": counts["pack"],
            "matches": counts["match"], "pack_in": runs[0][3],
            "costs": counts["cost"], "cost_in": runs[0][4]}


# ---------------------------------------------------------------------------
# The preconditioned host encode: encode(backend="native", dc_params=...)
# ---------------------------------------------------------------------------

REF_CHAINS = (1, 64, 200)
REF_SIZES = (32768, 65536, 131072)
REF_SAMPLE = 8       # pages of each texture's delta form held to the plain


def ref_rows(datas, S: int):
    """(pages uint8 [P, S], in_sizes int32 [P]) on the CPU from byte
    strings of at most S bytes."""
    import numpy as np
    import torch
    arr = np.zeros((len(datas), S), np.uint8)
    for r, d in enumerate(datas):
        arr[r, :len(d)] = np.frombuffer(d, np.uint8)
    return (torch.from_numpy(arr),
            torch.tensor([len(d) for d in datas], dtype=torch.int32))


def ref_corpus_rows(data: bytes, S: int):
    """A corpus text page, a zero page, a four-symbol page, a random page
    and a short last page (corpus bytes, 1000 short)."""
    import numpy as np
    r = np.random.default_rng(S)
    return ref_rows([data[:S], bytes(S),
                     (r.integers(0, 4, S) * 0x55).astype(np.uint8).tobytes(),
                     r.integers(0, 256, S, dtype=np.uint8).tobytes(),
                     data[S: 2 * S - 1000]], S)


def ref_parse_launch(pages, sizes, chain: int):
    """The parse kernels' raw launches on CUDA operands, from the wrapper's
    launch plan: (run, {stage: its launch}, the outputs ins, cpy, dist,
    ncmds, tail)."""
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import ref_parse_kernel as RK
    outs, plan = RK.launch_plan(pages, sizes, chain)
    lib = _kernels.library()
    stages = {stage: raw_launch(getattr(lib, entry), args, pages.device)
              for stage, entry, args in plan}

    def run():
        for launch in stages.values():
            launch()
    return run, stages, outs


def parse_ops(pages, sizes, chain: int, want) -> int:
    """The operations bound's count: the chain candidates the walk's best
    calls compare, one operation each, every position's call counted once
    (the lazy test's call at pos + 1 and that position's own). From the
    plain parse's commands (want): best is called at every position of an
    insert run, at each command's position and the one after it, and over
    the tail; at q it compares min(max_chain, the positions before q with
    q's hash) candidates, none where q + 4 > n."""
    import numpy as np
    ops = 0
    arr = pages.numpy()
    ins, cpy, ncmds = (t.numpy() for t in (want[0], want[1], want[3]))
    for row, n in enumerate(sizes.tolist()):
        if n < 4 or chain <= 0:
            continue
        v = arr[row, :n].astype(np.uint32)
        quad = v[:-3] | (v[1:-2] << 8) | (v[2:-1] << 16) | (v[3:] << 24)
        h = (quad * np.uint32(0x1E35A7BD)) >> np.uint32(15)
        order = np.argsort(h, kind="stable")
        hs = h[order]
        first = np.r_[0, np.flatnonzero(hs[1:] != hs[:-1]) + 1]
        lead = np.repeat(first, np.diff(np.r_[first, len(hs)]))
        rank = np.empty(len(h), np.int64)
        rank[order] = np.arange(len(h)) - lead
        called = np.zeros(n + 1, bool)
        anchor = 0
        for i, c in zip(ins[row, :ncmds[row]], cpy[row, :ncmds[row]]):
            p = anchor + int(i)
            called[anchor:p + 2] = True
            anchor = p + int(c)
        called[anchor:n] = True
        ops += int(np.minimum(rank, chain)[called[:len(h)]].sum())
    return ops


def ref_parse_check(pages, sizes, chain: int, dev) -> dict:
    """The parse kernels (raw launches, outputs poisoned) against the plain
    parse on the same rows, tolerance 0 on every command and count; the
    launches timed by CUDA events, together and stage by stage, beside the
    plain parse's host time and the bound (bytes: the pages read once, the
    commands written once; operations: parse_ops)."""
    import torch
    from brotlig_tpu_torch.ops import ref_parse_kernel as RK
    t0 = time.perf_counter()
    want = RK.find_matches_plain(pages, sizes, chain)
    plain_ms = (time.perf_counter() - t0) * 1e3
    run, stages, got = ref_parse_launch(pages.to(dev), sizes.to(dev), chain)
    for t in got:
        t.fill_(-7)
    run()
    torch.cuda.synchronize()
    nc = want[3]
    cols = torch.arange(want[0].shape[1])[None, :] < nc[:, None]
    err = max_abs_err([g.cpu()[cols] for g in got[:3]] + [g.cpu() for g in
                                                          got[3:]],
                      [w[cols] for w in want[:3]] + list(want[3:]))
    ms = time_ms(run, REPS)
    split = {stage: time_ms(launch, REPS) for stage, launch in stages.items()}
    nbytes = int(sizes.sum()) + 12 * int(nc.sum()) + 8 * len(nc)
    ops = parse_ops(pages, sizes, chain, want)
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes, ops)}
    out.update(pages=len(nc), cmds=int(nc.sum()), split=split, ops=ops)
    return out


def ref_stage_timers(codec, torch) -> tuple:
    """Wrap refimpl.codec's steps to time them on the host clock (the parse
    kernels' call synchronised): (timings, undo)."""
    timings = {k: 0.0 for k in ("preprocess", "parse kernel", "parse copy "
                                "and lists", "host serialization",
                                "assembly")}
    saved = {n: getattr(codec, n) for n in ("stream_setup",
                                            "find_matches_pages",
                                            "parse_group", "serialize_group",
                                            "assemble")}
    stage = {"stream_setup": "preprocess",
             "find_matches_pages": "parse kernel",
             "parse_group": "parse copy and lists",
             "serialize_group": "host serialization",
             "assemble": "assembly"}

    def timed(name):
        fn = saved[name]

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if name in ("stream_setup", "find_matches_pages"):
                torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            timings[stage[name]] += dt
            if name == "find_matches_pages":   # inside parse_group
                timings["parse copy and lists"] -= dt
            return out
        return run
    for name in saved:
        setattr(codec, name, timed(name))

    def undo():
        for name, fn in saved.items():
            setattr(codec, name, fn)
    return timings, undo


def ref_join_cases(datas, chain: int) -> dict:
    """The join's cases over rows (byte strings) at max_chain chain, by the
    numpy model of the split walk (tests/test_torch_ref_parse.py::
    split_parse, segments of the kernels' length): continuations that meet
    a walker's mark ("joined"), that meet none ("lost"), and walkers the
    true walk never takes ("skipped")."""
    from brotlig_tpu_torch.ops import ref_parse_kernel as RK
    from test_torch_ref_parse import split_parse
    seen = {"joined": 0, "lost": 0, "skipped": 0}
    for d in datas:
        st = {}
        split_parse(d, chain, RK.SEGMENT, st)
        for key in seen:
            seen[key] += st[key]
    return seen


def parse_checks(texs: dict, data: bytes, dev, gpu) -> dict:
    """The parse kernels held to the plain parse (tolerance 0) on 8 pages
    of each texture's delta form, on corpus rows at 32, 64 and 128 KiB and
    max_chain 1, 64 and 200, and on the join's hard rows at 64 and 128 KiB;
    each timed, together and stage by stage, beside the plain parse and
    the bound; then the route's own launch, config-3's first group of 64
    pages, timed. Returns {row: its check} with the group's time under
    "group"."""
    import numpy as np
    import torch
    from brotlig_tpu_torch.ops import ref_parse_kernel as RK
    from brotlig_tpu_torch.ops.precondition import preprocess_device
    from brotlig_tpu_torch.refimpl import codec
    names = list(texs)
    checks = {}
    for name in names:
        tex, _, params, page = texs[name]
        _, work, _ = preprocess_device(tex, params, page, dev)
        n_pages = -(-len(work) // page)
        pick = np.unique(np.linspace(0, n_pages - 1, REF_SAMPLE).astype(int))
        rows = ref_rows([work[i * page:(i + 1) * page] for i in pick], page)
        checks[f"{name}, {len(pick)} pages"] = ref_parse_check(*rows, 64, dev)
    for S in REF_SIZES:
        rows = ref_corpus_rows(data, S)
        for chain in REF_CHAINS:
            checks[f"corpus {S // 1024} KiB, max_chain {chain}"] = \
                ref_parse_check(*rows, chain, dev)
    from test_torch_ref_parse import join_rows
    for S in REF_SIZES[1:]:
        datas = list(join_rows(RK.SEGMENT, S).values())
        rows = ref_rows(datas, S)
        for chain in (0, 1, 64):
            what = (f"join rows {S // 1024} KiB ({RK.SEGMENT}-byte segments), "
                    f"max_chain {chain}")
            cases = ref_join_cases(datas, chain)
            print(f"[smoke] the join's cases on {what} (numpy model): "
                  f"{json.dumps(cases)}", flush=True)
            if chain > 0 and not all(cases.values()):
                raise AssertionError(f"{what}: a case of the join is not "
                                     f"reached: {cases}")
            checks[what] = ref_parse_check(*rows, chain, dev)
    for what, r in checks.items():
        print(f"[smoke] parse kernels == plain (tolerance 0, max_abs_err "
              f"{r['max_abs_err']}) on {what}: {r['pages']} pages, "
              f"{r['cmds']} commands; kernels {r['ms']:.4f} ms ("
              f"{r['ms'] / r['pages']:.4f} a page; by stage alone "
              f"{json.dumps({k: round(v, 4) for k, v in r['split'].items()})}"
              f"), plain parse {r['plain_ms']:.1f} ms ("
              f"{r['plain_ms'] / r['pages']:.1f} a page, host), bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']} ("
              f"{r['ops']} candidates compared), "
              f"{100 * r['bound_ms'] / r['ms']:.4f}% of it [{gpu}]",
              flush=True)
        if r["max_abs_err"] != 0:
            raise AssertionError(f"parse kernels differ from the plain parse "
                                 f"on {what}")
    # the route's own launch: config-3's first group of 64 pages
    tex, _, params, page = texs[names[0]]
    _, work, _ = preprocess_device(tex, params, page, dev)
    arr, sizes = codec.page_rows(work, range(codec.BATCH_PAGES), page)
    run, stages, _ = ref_parse_launch(torch.from_numpy(arr).to(dev),
                                      torch.from_numpy(sizes).to(dev), 64)
    group_ms = time_ms(run, REPS)
    split = {stage: round(time_ms(launch, REPS), 4)
             for stage, launch in stages.items()}
    print(f"[smoke] parse kernels on {names[0]}'s first group of "
          f"{codec.BATCH_PAGES} pages (the route's launch): {group_ms:.4f} "
          f"ms; by stage alone {json.dumps(split)} [{gpu}]", flush=True)
    checks["group"] = group_ms
    return checks


def refimpl_phase(texs: dict, data: bytes, ratios: dict, gpu) -> dict:
    """brotlig_tpu_torch.encode(backend="native", dc_params=...,
    device="cuda") on the four textures, with the launch counts set to 0
    before and read after: preprocess once an encode, the parse's three
    kernels once a group of 64 pages, nothing else. The random BC5 and
    the BC1 at 32 KiB pages equal the CPU route's streams; every stream
    decodes to its texture on the card (both routes) and by decode_cpu.
    config-3's encode is split by stage. Then parse_checks. Returns the kernels line's row (config-3's 8 pages),
    its launches on the main path and the decode launches."""
    import numpy as np
    import torch
    import brotlig_tpu_torch
    from brotlig_tpu_torch import _kernels
    from brotlig_tpu_torch.ops import ref_parse_kernel as RK
    from brotlig_tpu_torch.ops.precondition import preprocess_device
    from brotlig_tpu_torch.refimpl import codec
    dev = torch.device("cuda")
    names = list(texs)
    blobs, ms = {}, {}
    timings, undo = ref_stage_timers(codec, torch)
    _kernels.reset_launches()
    try:
        for name in names:
            tex, _, params, page = texs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blobs[name] = brotlig_tpu_torch.encode(
                tex, page_size=page, dc_params=params, backend="native",
                device="cuda")
            ms[name] = (time.perf_counter() - t0) * 1e3
            if name == names[0]:
                undo()
    finally:
        undo()
    counts = dict(_kernels.LAUNCHES)
    groups = sum(-(-len(texs[n][0]) // texs[n][3] // codec.BATCH_PAGES)
                 for n in names)
    want = {k: 0 for k in counts}
    want["ref_parse"] = RK.LAUNCHES_PER_CALL * groups
    want["precond"] = len(names)
    if counts != want:
        raise AssertionError(f"the native preconditioned encodes launched "
                             f"{counts}, want {want}")
    for name in names:
        tex = texs[name][0]
        print(f"[smoke] {name}, encode(backend='native', dc_params, "
              f"device='cuda'): {ms[name]:.1f} ms, ratio "
              f"{len(tex) / len(blobs[name]):.4f} [{gpu}]", flush=True)
    print(f"[smoke] native preconditioned encodes' launches {counts} ("
          f"{RK.LAUNCHES_PER_CALL} a group of {codec.BATCH_PAGES} pages, "
          f"{groups} groups; one "
          f"preprocess an encode)", flush=True)
    c3 = len(texs[names[0]][0])
    print(f"[smoke] {names[0]}, the native preconditioned encode by stage "
          f"(ms, host clock, the card synchronised after the preprocess "
          f"and each parse): "
          f"{json.dumps({k: round(v, 3) for k, v in timings.items()})}; "
          f"{c3 / ms[names[0]] / 1e3:.4f} MB/s; ratio "
          f"{c3 / len(blobs[names[0]]):.4f} beside the hybrid's "
          f"{ratios.get('hybrid q11', float('nan')):.4f}, full q1's "
          f"{ratios.get('full q1', float('nan')):.4f} and full q11's "
          f"{ratios.get('full q11', float('nan')):.4f} [{gpu}]", flush=True)
    for name in names[2:]:
        tex, _, params, page = texs[name]
        t0 = time.perf_counter()
        cpu = brotlig_tpu_torch.encode(tex, page_size=page, dc_params=params,
                                       backend="native", device="cpu")
        if cpu != blobs[name]:
            raise AssertionError(f"{name}: the native preconditioned stream "
                                 "on the card differs from the CPU route's")
        print(f"[smoke] {name}: the card's stream == the CPU route's "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms on the CPU)",
              flush=True)
    dec = []
    for name in names:
        tex = texs[name][0]
        dec.append(decode_on_card(blobs[name], tex, f"{name}, native "
                                  "preconditioned encode"))
        if brotlig_tpu_torch.decode_cpu(blobs[name]) != tex:
            raise AssertionError(f"{name}: decode_cpu of the native "
                                 "preconditioned stream differs")
    checks = parse_checks(texs, data, dev, gpu)
    checks.pop("group")
    row = dict(checks[f"{names[0]}, {REF_SAMPLE} pages"])
    row["max_abs_err"] = max(r["max_abs_err"] for r in checks.values())
    for k in ("pages", "cmds", "split", "ops"):
        row.pop(k)
    return {"row": row, "launches": counts["ref_parse"],
            "precond": counts["precond"], "decodes": dec}


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    sys.path.append(os.path.join(ROOT, "tests"))   # the join's rows
    import brotlig_tpu_torch
    from brotlig_tpu_torch import _kernels, native
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops import tables_kernel as tk
    from brotlig_tpu_torch.ops.decode import staged_batches
    from brotlig_tpu_torch.state import tables_from_lengths
    from brotlig_tpu_torch.utils.corpus import corpus

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gpu = gpu_line()
    print(f"[smoke] gpu: {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)

    secs = _kernels.build()
    print(f"[smoke] nvcc build of {', '.join(_kernels.SOURCES)}: "
          f"{secs:.2f} s", flush=True)
    for line in _kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[smoke]   {line.strip()}")
    t0 = time.perf_counter()
    data16 = corpus(BATCH)
    blob16 = native.encode(data16, page_size=PAGE, quality=11)
    print(f"[smoke] corpus {len(data16)} B -> {len(blob16)} B (q11, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- kernels against their plain versions on one 256-page batch ----
    group, staged = first_batch(blob16, dev)
    tabs = tables_from_lengths(*tk.load_tables_plain(staged.buf))
    k4, a = phase_a_phase(staged, tabs)
    print(f"[smoke] phase-A kernel == plain (tolerance 0) on {len(group)} "
          f"pages; kernel {k4['ms']:.4f} ms, plain {k4['plain_ms']:.1f} ms "
          f"[{gpu}]", flush=True)
    n = batch_counts(a, tabs, blob16, group)
    print(f"[smoke] batch: {n}", flush=True)
    alone = pages_alone(staged, a)
    for kernel, r in alone.items():
        print(f"[smoke] {kernel} kernel, {len(group)}-page batch "
              f"{r['batch_ms']:.4f} ms; each page alone: slowest (row "
              f"{r['slowest_row']}) {r['slowest_ms']:.4f} ms, median "
              f"{r['median_ms']:.4f} ms [{gpu}]", flush=True)
    slowest = {k: r["slowest_row"] for k, r in alone.items()}
    print(f"[smoke] chain lengths: {json.dumps(chain_lengths(a, slowest))}",
          flush=True)
    k4.update(bound(n["compressed"] + 12 * n["cmds"] + n["lits"],
                    OPS_PER_SYMBOL * (n["cmds"] + n["lits"])))
    k1 = tables_phase(staged, n)
    print(f"[smoke] tables kernel == plain (tolerance 0) on {len(group)} "
          f"pages; kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.2f} ms "
          f"[{gpu}]", flush=True)
    print(f"[smoke] torch table build the kernel took over (build_search "
          f"x 3 + pack, on the card): {k1.pop('torch_build_ms'):.4f} ms "
          f"[{gpu}]", flush=True)
    k2 = decode_phase(staged, tabs, data16, group, n)
    print(f"[smoke] decode kernel == plain == input (tolerance 0) on "
          f"{len(group)} pages; kernel {k2['ms']:.3f} ms, plain "
          f"{k2['plain_ms']:.1f} ms [{gpu}]", flush=True)
    k5 = sweep_phases(a, data16, group, n)
    for cw in SWEEP_CWS:
        print(f"[smoke] sweep kernel cw {cw} == plain == input (tolerance "
              f"0); kernel {k5[cw]['ms']:.4f} ms, plain "
              f"{k5[cw]['plain_ms']:.2f} ms [{gpu}]", flush=True)
    print(f"[smoke] torch middle stage the sweep's prologue took over "
          f"{k5['middle_ms']:.4f} ms [{gpu}]", flush=True)
    route = {"fused": k1["ms"] + k2["ms"],
             **{f"two_phase cw {cw}": k1["ms"] + k4["ms"] + k5[cw]["ms"]
                for cw in SWEEP_CWS}}
    print(f"[smoke] device time a {len(group)}-page batch by route (raw "
          f"launches, tables kernel included): "
          f"{json.dumps({k: round(v, 4) for k, v in route.items()})} "
          f"[{gpu}]", flush=True)
    del a

    # ---- the main path: decode(..., device="cuda") on every container ----
    t0 = time.perf_counter()
    data64 = corpus(1024)
    cases = {
        "16 MiB mixed, q11, 64 KiB pages": (data16, blob16),
        "64 MiB mixed, q1, 64 KiB pages": (
            data64, native.encode(data64, page_size=PAGE, quality=1)),
        "300 pages, q1, short last batch": (
            data64[:300 * PAGE],
            native.encode(data64[:300 * PAGE], page_size=PAGE, quality=1)),
        "32 KiB pages, q11": (
            data16[:8 << 20],
            native.encode(data16[:8 << 20], page_size=32768, quality=11)),
        "128 KiB pages, q11": (
            data16, native.encode(data16, page_size=131072, quality=11)),
    }
    print(f"[smoke] containers encoded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    names = list(cases)
    if batches_of(cases[names[1]][1]) < 3 or \
            batches_of(cases[names[2]][1]) != 2:
        raise AssertionError("the 64 MiB and 300-page containers must fill "
                             "several batches, and two")

    # ---- K2 and K4 at 256 and 512 pages a launch; K2 at 32/128 KiB ----
    for batch, copies, what in ((BATCH, 1, "its first batch"),
                                (BATCH, 2, "that batch twice"),
                                (2 * BATCH, 1, "its first 512 pages")):
        pages, k2_ms, k4_ms = round_kernels_ms(cases[names[1]][1], PAGE,
                                               batch, dev, copies)
        print(f"[smoke] 64 MiB q1 container, {what}, {pages} pages a "
              f"launch: decode kernel {k2_ms:.4f} ms, phase-A kernel "
              f"{k4_ms:.4f} ms [{gpu}]", flush=True)
    for name, page in ((names[3], 32768), (names[4], 131072)):
        err = tables_errors(first_batch(cases[name][1], dev)[1].buf)
        if err != 0:
            raise AssertionError(f"tables kernel disagrees with plain on "
                                 f"{name}: {err}")
        print(f"[smoke] tables kernel == plain (tolerance 0) on {name}",
              flush=True)
        pages, k2_ms, k4_ms = round_kernels_ms(cases[name][1], page, BATCH,
                                               dev)
        print(f"[smoke] {name}, {pages} pages a launch: decode kernel "
              f"{k2_ms:.4f} ms, phase-A kernel {k4_ms:.4f} ms [{gpu}]",
              flush=True)

    # ---- preconditioned textures, built with the port's own code ----
    t0 = time.perf_counter()
    texs = textures(dev)
    for name, (tex, blob, _, _) in texs.items():
        info = parse_container(blob)
        cases[name] = (tex, blob)
        print(f"[smoke] texture {name}: {len(tex)} B -> {len(blob)} B, "
              f"{len(info.compressed_page_indices())} compressed and "
              f"{len(info.raw_page_indices())} raw pages", flush=True)
    print(f"[smoke] textures built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    tex_names = list(texs)
    # the process's first texture decode (its postprocess's first call),
    # split by stage, then warm ones
    tex, blob = cases[tex_names[0]]
    tex_stages = [texture_decode_stages(blob, dev) for _ in range(4)]
    if any(got != tex for got, _ in tex_stages):
        raise AssertionError("a staged texture decode differs")
    first_tex_ms = sum(tex_stages[0][1].values())
    warm = {k: round(float(np.median([st[k] for _, st in tex_stages[1:]])),
                     3) for k in tex_stages[0][1]}
    print(f"[smoke] {tex_names[0]}: the process's first texture decode by "
          f"stage (the card synchronised after each), {first_tex_ms:.3f} "
          f"ms: {json.dumps(tex_stages[0][1])}; warm, median by stage of 3,"
          f" {sum(warm.values()):.3f} ms: {json.dumps(warm)} [{gpu}]",
          flush=True)

    # ---- the main path, each route, launch counts checked ----
    launched = {}
    for what, runs in (
            ("fused", [(nm, {}) for nm in names]),
            ("two-phase",
             [(nm, {"variant": "two_phase", "sweep_cw": cw})
              for cw in (128, 2048) for nm in names]
             + [(names[0], {"variant": "two_phase", "sweep_cw": cw})
                for cw in (512, 1024)]),
            ("texture fused", [(nm, {}) for nm in tex_names]),
            ("texture two-phase",
             [(nm, {"variant": "two_phase", "sweep_cw": 1024})
              for nm in tex_names])):
        counts, by_cw, torch_calls = drive(cases, runs, what)
        want, want_cw = want_launches(cases, runs)
        print(f"[smoke] launches on the {what} runs: {counts}, sweep by "
              f"width {by_cw} (once a batch: {want}, {want_cw}); torch "
              f"calls {torch_calls}", flush=True)
        if counts != want or by_cw != want_cw:
            raise AssertionError(f"the {what} runs did not launch their "
                                 "kernels once a batch")
        if any(torch_calls.values()):
            raise AssertionError(f"the {what} runs ran torch table work or "
                                 f"the middle stage: {torch_calls}")
        launched[what] = (counts, by_cw)
    fused = {k: launched["fused"][0][k] + launched["texture fused"][0][k]
             for k in launched["fused"][0]}
    two = {k: launched["two-phase"][0][k]
           + launched["texture two-phase"][0][k]
           for k in launched["two-phase"][0]}
    by_cw = {cw: launched["two-phase"][1][cw]
             + launched["texture two-phase"][1][cw] for cw in SWEEP_CWS}
    if native.decode(blob16) != data16:
        raise AssertionError("native CPU decoder disagrees with the input")

    # ---- the texture kernels against their plain versions ----
    post = {name: postprocess_phase(name, tex, blob, params, gpu)
            for name, (tex, blob, params, _) in texs.items()}
    prep = {name: preprocess_phase(name, tex, params, page, gpu)
            for name, (tex, _, params, page) in texs.items()}

    # ---- the pipeline: one container five times in a row, no sync ----
    data64, blob64 = cases[names[1]]
    _kernels.reset_launches()
    for r in range(5):
        if brotlig_tpu_torch.decode(blob64, device="cuda") != data64:
            raise AssertionError(f"64 MiB q1 decode {r} differs")
    counts = dict(_kernels.LAUNCHES)
    nb = 5 * batches_of(blob64)
    print(f"[smoke] 64 MiB q1 container decoded 5 times in a row, every "
          f"run equal to the input; launches {counts} (once a batch: "
          f"{nb})", flush=True)
    if counts != {"tables": nb, "decode": nb, "phase_a": 0, "sweep": 0,
                  "dp_parse": 0, "pack": 0, "match": 0, "cost": 0,
                  "precond": 0, "ref_parse": 0}:
        raise AssertionError("the repeated decodes did not launch their "
                             "kernels once a batch")
    pipeline_never_syncs(blob64, dev)
    print("[smoke] decode_batches over the 64 MiB q1 container under "
          "torch.cuda.set_sync_debug_mode('error'): no synchronising call "
          "in the batch loop", flush=True)

    # ---- pooled archives ----
    from brotlig_tpu_torch.parallel.runtime import decode_archives_batched
    t0 = time.perf_counter()
    datas, blobs = archive_pool(data64, dev)
    print(f"[smoke] pool of {len(blobs)} archives ({sum(map(len, datas))} "
          f"B, {len(blobs) - 64} preconditioned) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    nb = pool_batches(blobs)
    n_tex = sum(map(preconditioned, blobs))
    precond_pool = 0
    pool_ms = []
    for r in range(3):
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = decode_archives_batched(blobs, device="cuda")
        pool_ms.append((time.perf_counter() - t0) * 1e3)
        pool = dict(_kernels.LAUNCHES)
        if outs != datas:
            raise AssertionError(f"pooled decode {r} differs from the "
                                 "inputs")
        if pool != {"tables": nb, "decode": nb, "phase_a": 0, "sweep": 0,
                    "dp_parse": 0, "pack": 0, "match": 0, "cost": 0,
                    "precond": n_tex, "ref_parse": 0}:
            raise AssertionError(f"pooled decode launched {pool}, want "
                                 f"{nb} batches and {n_tex} postprocesses")
        precond_pool += pool["precond"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for blob, d in zip(blobs, datas):
        if brotlig_tpu_torch.decode(blob, device="cuda") != d:
            raise AssertionError("archive decoded alone differs")
    each_ms = (time.perf_counter() - t0) * 1e3
    print(f"[smoke] pooled decode of {len(blobs)} archives == inputs: "
          f"{nb} batches (compressed pages per page size over {BATCH}, "
          f"rounded up), launches {pool}; "
          f"{[round(t, 3) for t in pool_ms]} ms; the archives one by one "
          f"{each_ms:.3f} ms [{gpu}]", flush=True)

    # ---- end to end, both routes in turns, and staging on its own ----
    e2e = {"fused": [], "two_phase": []}
    for _ in range(4):
        for variant in e2e:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = brotlig_tpu_torch.decode(blob16, device="cuda",
                                           variant=variant)
            e2e[variant].append(time.perf_counter() - t0)
            if got != data16:
                raise AssertionError(f"timed {variant} decode differs")
    info = parse_container(blob16)
    stage = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in staged_batches(blob16, info, BATCH, "cpu"):
            pass
        stage.append(time.perf_counter() - t0)
    for variant, times in e2e.items():
        med = float(np.median(times[1:]))
        print(f"[smoke] end to end, {variant} (sweep_cw 1024), 16 MiB q11 "
              f"container: {[round(t * 1e3, 3) for t in times]} ms -> "
              f"{len(data16) / med / 1e9:.4f} GB/s (median of warm runs) "
              f"[{gpu}]", flush=True)
    print(f"[smoke] host staging alone {min(stage) * 1e3:.3f} ms [{gpu}]",
          flush=True)

    # ---- the pipeline against the serial order, in turns ----
    for name in names[:2]:
        data, blob = cases[name]
        times = {"pipelined": [], "serial": []}
        for r in range(5):
            for mode in (("pipelined", "serial") if r % 2 else
                         ("serial", "pipelined")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = (brotlig_tpu_torch.decode(blob, device="cuda")
                       if mode == "pipelined" else decode_serial(blob, dev))
                times[mode].append((time.perf_counter() - t0) * 1e3)
                if got != data:
                    raise AssertionError(f"{mode} decode of {name} differs")
        meds = {m: float(np.median(t[1:])) for m, t in times.items()}
        print(f"[smoke] end to end, fused route, {name} "
              f"({batches_of(blob)} batches), in turns: "
              + "; ".join(f"{m} {[round(t, 3) for t in ts]} ms (median of "
                          f"warm runs {meds[m]:.3f} ms, "
                          f"{len(data) / meds[m] / 1e6:.4f} GB/s)"
                          for m, ts in times.items()) + f" [{gpu}]",
              flush=True)
        host_breakdown(blob, dev)
        print(f"[smoke] host breakdown of one decode, {name}, stages alone "
              f"with the card synchronised after each (ms): "
              f"{json.dumps(host_breakdown(blob, dev))} [{gpu}]", flush=True)

    # ---- the config-3 texture: bytes back, and kept on the card ----
    name = tex_names[0]
    tex, blob = cases[name]
    times = {"host bytes": [], "device-resident": []}
    for _ in range(4):
        for mode in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = brotlig_tpu_torch.decode(
                blob, device="cuda", return_device=mode != "host bytes")
            if mode != "host bytes":
                torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3)
            if mode != "host bytes":
                got = got.cpu().numpy().tobytes()
            if got != tex:
                raise AssertionError(f"timed texture decode ({mode}) "
                                     "differs")
    print(f"[smoke] {name}, fused route, end to end: the process's first "
          f"texture decode {first_tex_ms:.3f} ms (staged); " + "; ".join(
              f"{m} {[round(t, 3) for t in ts]} ms (median of warm runs "
              f"{float(np.median(ts[1:])):.3f} ms) -> "
              f"{len(tex) / float(np.median(ts[1:])) / 1e6:.4f} GB/s"
              for m, ts in times.items())
          + f"; postprocess alone {post[name]['ms']:.4f} ms, bound "
          f"{post[name]['bound_ms']:.4f} ms [{gpu}]", flush=True)

    # ---- sharded and distributed ----
    t0 = time.perf_counter()
    sharded = sharded_phase(data16, blob16, gpu)
    for k, v in dryrun_phase(gpu).items():
        sharded[k] += v
    for k in sharded:
        fused[k] += sharded[k]
    gather_phase(blobs, datas,
                 [data16[i << 20: (i + 1) << 20] for i in range(8)], gpu)
    profile_phase(gpu)
    print(f"[smoke] sharded and distributed phase "
          f"{time.perf_counter() - t0:.1f} s [{gpu}]", flush=True)

    # ---- encode on the card: full-device q1, hybrid, textures, the cli ----
    t0 = time.perf_counter()
    enc = encode_q1_phase(data16, dev, gpu)
    hyb = hybrid_phase(data16, blob16, gpu)
    name = tex_names[0]
    tex, _, params, _ = texs[name]
    tex_launches, tex_dp, tex_packs = texture_encode_phase(name, tex,
                                                           params, gpu)
    cli_phase(data16[:1 << 20], gpu)
    t1 = time.perf_counter()
    q11 = q11_phase(data16, dev, gpu, tex_dp)
    del tex_dp
    print(f"[smoke] q11 phase {time.perf_counter() - t1:.1f} s [{gpu}]",
          flush=True)
    t1 = time.perf_counter()
    k_pack_in = enc["pack_in"], q11["pack_in"]["greedy"]
    k_pack = pack_phase({"q1": enc.pop("pack_in"),
                         "q11 greedy": q11["pack_in"]["greedy"],
                         "q11 DP": q11.pop("pack_in")["DP"],
                         "texture q1": tex_packs["q1"],
                         "texture q11 DP": tex_packs["q11"]}, gpu)
    pack_launches = enc["packs"] + q11["packs"] + tex_packs["launches"]
    print(f"[smoke] pack phase {time.perf_counter() - t1:.1f} s; pack "
          f"kernel launches on the encode main paths {pack_launches} "
          f"(q1 {enc['packs']}, q11 {q11['packs']}, texture "
          f"{tex_packs['launches']}) [{gpu}]", flush=True)
    t1 = time.perf_counter()
    q1_in, q11_in = k_pack_in
    sized = {k: corpus_pages(data16, 1024 * k, n, dev)
             for k, n in ((32, 8), (128, 4))}
    k_match = match_phase({
        "q1": (*q1_in[:2], "fast"),
        "q11 greedy": (*q11_in[:2], "exact"),
        "q11 candidates": (*q11_in[:2], "candidates"),
        "texture q1": (*tex_packs["q1"][:2], "fast"),
        "texture q11 greedy": (*tex_packs["q11"][:2], "exact"),
        "texture q11 candidates": (*tex_packs["q11"][:2], "candidates"),
        **{f"{k} KiB {tier}": (*sized[k], kind) for k in sized
           for tier, kind in (("q1", "fast"), ("greedy", "exact"),
                              ("candidates", "candidates"))}}, gpu)
    match_launches_main = (enc["matches"] + hyb["matches"] + q11["matches"]
                           + tex_packs["match launches"])
    print(f"[smoke] match phase {time.perf_counter() - t1:.1f} s; matcher "
          f"kernel launches on the encode main paths {match_launches_main} "
          f"(q1 {enc['matches']}, hybrid {hyb['matches']}, q11 "
          f"{q11['matches']}, texture {tex_packs['match launches']}) "
          f"[{gpu}]", flush=True)
    t1 = time.perf_counter()
    cost_in = q11.pop("cost_in")
    k_cost = cost_phase({
        **{f"q11 iteration {i + 1}": a for i, a in enumerate(cost_in)},
        "texture q11": tex_packs["cost in"],
        **{f"{k} KiB": cost_batch(*sized[k]) for k in sized}}, gpu)
    cost_launches_main = q11["costs"] + tex_packs["cost launches"]
    print(f"[smoke] cost phase {time.perf_counter() - t1:.1f} s; cost "
          f"kernel launches on the encode main paths {cost_launches_main} "
          f"(q11 {q11['costs']}, texture {tex_packs['cost launches']}) "
          f"[{gpu}]", flush=True)
    t1 = time.perf_counter()
    ref = refimpl_phase(texs, data16, tex_packs["ratios"], gpu)
    print(f"[smoke] native preconditioned encode phase "
          f"{time.perf_counter() - t1:.1f} s; parse kernel launches on its "
          f"main path {ref['launches']} [{gpu}]", flush=True)
    precond_enc = tex_packs["precond launches"] + ref["precond"]
    del tex_packs, q1_in, q11_in, cost_in, sized
    for got in [enc["launches"], hyb["launches"], q11["launches"]] \
            + tex_launches + ref["decodes"]:
        for k in fused:
            fused[k] += got["fused"][k]
            two[k] += got["two_phase"][k]
        by_cw[1024] += got["two_phase"]["sweep"]
    print(f"[smoke] encode phases {time.perf_counter() - t0:.1f} s [{gpu}]",
          flush=True)
    # the texture kernels' launches on the main paths: the postprocess of
    # every checked decode (the dry run's among them), the pool's, and
    # the preprocess of the texture encodes
    precond_main = fused["precond"] + two["precond"] + precond_pool + \
        precond_enc
    print(f"[smoke] texture kernel launches on the main paths "
          f"{precond_main} (decodes {fused['precond'] + two['precond']}, "
          f"pool {precond_pool}, texture encodes {precond_enc}) [{gpu}]",
          flush=True)

    src = "brotlig_tpu_torch/csrc/"
    pallas = "brotlig_tpu/ops/pallas_decode.py"
    kernels = [
        {"name": "tables", "route": "cuda", "source": src + "tables.cu",
         "replaces": "brotlig_tpu/ops/pallas_tables.py:45",
         "launches": fused["tables"], **k1},
        {"name": "decode", "route": "cuda", "source": src + "decode.cu",
         "replaces": f"{pallas}:1595", "launches": fused["decode"], **k2},
        {"name": "phase_a", "route": "cuda", "source": src + "phase_a.cu",
         "replaces": f"{pallas}:311", "launches": two["phase_a"], **k4},
    ] + [
        {"name": f"sweep_cw{cw}", "route": "cuda", "source": src + "sweep.cu",
         "replaces": f"{pallas}:{1149 if cw == 128 else 886}",
         "launches": by_cw[cw], **k5[cw]}
        for cw in SWEEP_CWS] + [
        {"name": "dp_parse", "route": "cuda", "source": src + "dp_parse.cu",
         "replaces": "brotlig_tpu/ops/parse_dp.py:234", **q11["dp"]},
        {"name": "pack", "route": "cuda", "source": src + "pack.cu",
         "replaces": "brotlig_tpu/ops/encode_pack.py:985",
         "launches": pack_launches, **k_pack["q1"]},
        {"name": "match", "route": "cuda", "source": src + "match.cu",
         "replaces": "brotlig_tpu/ops/encode.py:142",
         "launches": match_launches_main,
         **{**k_match["q1"], "max_abs_err": max(
             r["max_abs_err"] for r in k_match.values())}},
        {"name": "cost", "route": "cuda", "source": src + "cost_model.cu",
         "replaces": "brotlig_tpu/ops/parse_dp.py:71",
         "launches": cost_launches_main,
         **{**k_cost["q11 iteration 1"], "max_abs_err": max(
             r["max_abs_err"] for r in k_cost.values())}},
        {"name": "precond", "route": "cuda",
         "source": src + "precondition.cu",
         "replaces": "brotlig_tpu/ops/precondition.py:109",
         "launches": precond_main,
         **{k: v for k, v in post[tex_names[0]].items()
            if k not in ("map_bytes", "left_bytes", "copy_ms")},
         "max_abs_err": max(r["max_abs_err"] for r in
                            list(post.values()) + list(prep.values()))},
        {"name": "ref_parse", "route": "cuda",
         "source": src + "ref_parse.cu",
         "replaces": "brotlig_tpu/refimpl/page_encoder.py:45",
         "launches": ref["launches"], **ref["row"]}]
    print(f"[smoke] whole run {time.perf_counter() - t_start:.1f} s, "
          "builds included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
