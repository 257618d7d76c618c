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
a launch and at 32 and 128 KiB pages, then drives the main path,
brotlig_tpu_torch.decode(..., device="cuda"), on mixed-corpus containers
through the fused route and through the two-phase route (sweep_cw 128
and 2048 on every container, 512 and 1024 on the 16 MiB one),
byte-exactly, checks from the launch counts that each route went through
its kernels, and times the kernels against their plain versions and both
routes end to end. Progress goes to earlier lines; the
line before the last is the card's name and power limit, the last line a
JSON verdict. Any failure raises and exits non-zero; without a CUDA device
it exits non-zero before printing any result.
"""
from __future__ import annotations

import glob
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


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Corpus: the recipe of bench.py (make_corpus_pages), half real files and
# half synthetic text / structured / repetitive pages
# ---------------------------------------------------------------------------

def real_bytes(min_len: int) -> bytes:
    picks = (sorted(glob.glob(os.path.join(ROOT, "brotlig_tpu", "**", "*.py"),
                              recursive=True))
             + sorted(glob.glob(os.path.join(ROOT, "brotlig_tpu", "native",
                                             "*.cpp")))
             + [os.path.join(ROOT, "SURVEY.md"), os.path.join(ROOT, "PERF.md")]
             + sorted(glob.glob("/usr/bin/*"))[:40]
             + sorted(glob.glob("/usr/lib/x86_64-linux-gnu/*.so*"))[:40])
    buf = bytearray()
    for f in picks:
        try:
            with open(f, "rb") as fh:
                buf += fh.read(2 << 20)
        except OSError:
            continue
        if len(buf) >= min_len:
            break
    if not buf:
        buf = bytearray(b"fallback " * 8)
    while len(buf) < min_len:
        buf += buf[: min_len - len(buf)]
    return bytes(buf)


def corpus(n_pages: int, page: int = PAGE) -> bytes:
    import numpy as np
    words = [b"the ", b"of ", b"and ", b"compression ", b"stream ",
             b"page ", b"huffman ", b"entropy ", b"decode ", b"brotli "]
    real = real_bytes(((n_pages + 1) // 2) * page)
    nextreal = 0
    pages = []
    for i in range(n_pages):
        r = np.random.default_rng(i)
        kind = i % 6
        if kind in (0, 2, 4):
            pages.append(real[nextreal * page:(nextreal + 1) * page])
            nextreal += 1
        elif kind == 1:
            buf = bytearray()
            while len(buf) < page:
                buf += words[int(r.integers(0, len(words)))]
            pages.append(bytes(buf[:page]))
        elif kind == 3:
            a = (r.integers(0, 16, page) + (np.arange(page) // 256) % 64) % 256
            pages.append(a.astype(np.uint8).tobytes())
        else:
            pat = r.integers(0, 256, 173, dtype=np.uint8).tobytes()
            pages.append((pat * (page // len(pat) + 1))[:page])
    return b"".join(pages)


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


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import brotlig_tpu_torch
    from brotlig_tpu_torch import _kernels, native
    from brotlig_tpu_torch.format.headers import parse_container
    from brotlig_tpu_torch.ops import tables_kernel as tk
    from brotlig_tpu_torch.ops.decode import staged_batches
    from brotlig_tpu_torch.state import tables_from_lengths

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
    all_batches = sum(batches_of(b) for _, b in cases.values())

    fused, _, torch_calls = drive(cases, [(nm, {}) for nm in names],
                                  "fused")
    print(f"[smoke] launches on the fused route: {fused} "
          f"(once a batch: {all_batches} batches); torch calls "
          f"{torch_calls}", flush=True)
    if fused != {"tables": all_batches, "decode": all_batches,
                 "phase_a": 0, "sweep": 0} or any(torch_calls.values()):
        raise AssertionError("the fused route did not launch its kernels "
                             "once a batch, or ran torch table work")

    runs = [(nm, {"variant": "two_phase", "sweep_cw": cw})
            for cw in (128, 2048) for nm in names]
    runs += [(names[0], {"variant": "two_phase", "sweep_cw": cw})
             for cw in (512, 1024)]
    two, by_cw, torch_calls = drive(cases, runs, "two-phase")
    want_cw = {cw: all_batches if cw in (128, 2048)
               else batches_of(blob16) for cw in SWEEP_CWS}
    two_batches = sum(want_cw.values())
    print(f"[smoke] launches on the two-phase route: {two}, sweep by "
          f"width {by_cw} (once a batch: {two_batches} batches, by width "
          f"{want_cw}); torch calls {torch_calls}", flush=True)
    if two != {"tables": two_batches, "decode": 0, "phase_a": two_batches,
               "sweep": two_batches} or by_cw != want_cw:
        raise AssertionError("the two-phase route did not launch its "
                             "kernels once a batch")
    if any(torch_calls.values()):
        raise AssertionError(f"the two-phase route ran torch table work or "
                             f"the middle stage: {torch_calls}")
    if native.decode(blob16) != data16:
        raise AssertionError("native CPU decoder disagrees with the input")

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
        for cw in SWEEP_CWS]
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
