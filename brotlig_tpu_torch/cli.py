"""Brotli-G command line of the PyTorch/CUDA port (mirrors brotlig_tpu.cli
and the reference sample CLI, sample/brotlig_cli.cpp): compress to
.brotlig, decompress from .brotlig, and report sizes, time, bandwidth
(GiB/s) and compression ratio.

    python -m brotlig_tpu_torch.cli INPUT [OUTPUT] [--device cuda|cpu]
        [--encode-backend hybrid|full|native] [--quality Q] ...

An input that ends in .brotlig is decompressed, any other compressed.
Encode and decode run on --device (default "cuda", which raises without a
CUDA device); the "native" encode backend runs on the host, and with
--precondition it is the scalar page coder, whose texture preprocess and
page parse run on --device and whose serializer runs on the host.
"""
from __future__ import annotations

import argparse
import sys
import time

from .format import constants as C
from .format.errors import Aborted
from .format.precondition import DataConditionParams

FORMATS = {"bc1": C.DATA_FORMAT_BC1, "bc2": C.DATA_FORMAT_BC2,
           "bc3": C.DATA_FORMAT_BC3, "bc4": C.DATA_FORMAT_BC4,
           "bc5": C.DATA_FORMAT_BC5}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="brotlig", description="Brotli-G codec (PyTorch/CUDA)")
    p.add_argument("input")
    p.add_argument("output", nargs="?")
    p.add_argument("--page-size", type=int, default=C.DEFAULT_PAGE_SIZE,
                   help="page size in bytes (32768/65536/131072)")
    p.add_argument("--device", default="cuda",
                   help="torch device for encode and decode (cuda, cpu)")
    p.add_argument("--encode-backend", choices=["hybrid", "full", "native"],
                   default="hybrid",
                   help="hybrid: device match finding + native packer "
                        "(greedy); full: device match finding + device "
                        "serialization; native: the host C++ encoder, or "
                        "with --precondition the scalar page coder (its "
                        "parse on --device, the JAX package's bytes)")
    p.add_argument("--quality", type=int, default=11,
                   help="encode quality (>= 10: the optimal parse, on the "
                        "device for full, on the host for native; the "
                        "hybrid is always greedy; not read by native with "
                        "--precondition)")
    p.add_argument("--num-repeat", type=int, default=1,
                   help="repeat codec N times and report the best")
    p.add_argument("--compare-brotli", action="store_true",
                   help="also run plain brotli q11/lgwin24 on the input "
                        "and report its size/time beside Brotli-G "
                        "(reference brotlig_cli.cpp:532-624)")
    p.add_argument("--no-abort-key", action="store_true",
                   help="disable the ESC abort watcher on TTYs "
                        "(reference brotlig_cli.cpp:329-365)")
    # preconditioning (encode only)
    p.add_argument("--precondition", action="store_true")
    p.add_argument("--data-format", choices=sorted(FORMATS), default=None)
    p.add_argument("--width", type=int, default=0, help="texture width px")
    p.add_argument("--height", type=int, default=0, help="texture height px")
    p.add_argument("--mips", type=int, default=1)
    p.add_argument("--pitch", type=int, default=0)
    p.add_argument("--swizzle", action="store_true")
    p.add_argument("--delta-encode", action="store_true")
    return p


def _start_esc_watcher(flag: dict):
    """Raw-mode stdin reader that flags ESC; returns a stop() restoring
    the terminal. Mirrors the reference's keyboard poll during long
    encodes (brotlig_cli.cpp:329-365)."""
    import select
    import termios
    import threading
    import tty

    fd = sys.stdin.fileno()
    saved = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    stop_evt = threading.Event()

    def _reader():
        while not stop_evt.is_set():
            r, _, _ = select.select([fd], [], [], 0.1)
            if r and sys.stdin.read(1) == "\x1b":
                flag["esc"] = True
                return

    th = threading.Thread(target=_reader, daemon=True)
    th.start()

    def stop():
        stop_evt.set()
        th.join(timeout=0.5)
        termios.tcsetattr(fd, termios.TCSADRAIN, saved)

    return stop


def _compare_brotli(data: bytes, compressing: bool, reps: int) -> None:
    """Run plain brotli q11/lgwin24 beside Brotli-G and print its line
    (reference brotlig_cli.cpp:532-624)."""
    from .utils import brotli_codec as B

    if not B.available():
        print("brotli:  (system libbrotli not available, skipped)")
        return
    best = None
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        comp = B.compress(data)
        if not compressing:  # time the decode side too
            B.decompress(comp, len(data))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    big = max(len(data), len(comp))
    print(f"brotli:  {len(comp)} bytes, {best:.4f} s, "
          f"{big / best / (1 << 30):.3f} GiB/s, "
          f"ratio {len(data) / max(len(comp), 1):.3f}x "
          f"(q{B.QUALITY}/lgwin{B.LGWIN})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import api

    with open(args.input, "rb") as f:
        data = f.read()
    compressing = not args.input.endswith(".brotlig")

    dc = None
    if compressing and args.precondition:
        if not args.data_format:
            print("error: --precondition requires --data-format",
                  file=sys.stderr)
            return 2
        dc = DataConditionParams(
            precondition=True, swizzle=args.swizzle,
            delta_encode=args.delta_encode,
            format=FORMATS[args.data_format],
            width_in_pixels=args.width, height_in_pixels=args.height,
            num_mip_levels=args.mips, row_pitch_in_bytes=args.pitch)
        dc.check()

    # ESC abort watcher: on a TTY, a raw-mode reader thread flags ESC and
    # the feedback hook aborts, on the encode and the decode side
    # (BrotligDecoder.cpp:318-325)
    abort_flag = {"esc": False}
    watcher = None
    if not args.no_abort_key and sys.stdin.isatty():
        watcher = _start_esc_watcher(abort_flag)
    feedback = ((lambda _mt, _msg: abort_flag["esc"])
                if watcher is not None else None)
    dec_feedback = ((lambda _progress: abort_flag["esc"])
                    if watcher is not None else None)

    best = None
    try:
        for _ in range(max(args.num_repeat, 1)):
            t0 = time.perf_counter()
            if compressing:
                out = api.encode(data, page_size=args.page_size,
                                 dc_params=dc, backend=args.encode_backend,
                                 quality=args.quality, feedback=feedback,
                                 device=args.device)
            else:
                out = api.decode(data, device=args.device,
                                 feedback=dec_feedback)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
    except Aborted:
        print("aborted (ESC)", file=sys.stderr)
        return 130
    except (NotImplementedError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if watcher is not None:
            watcher()

    outfile = args.output or (
        args.input + ".brotlig" if compressing
        else args.input[: -len(".brotlig")] + ".out")
    with open(outfile, "wb") as f:
        f.write(out)

    big = max(len(data), len(out))
    print(f"input:  {len(data)} bytes")
    print(f"output: {len(out)} bytes -> {outfile}")
    print(f"time:   {best:.4f} s")
    print(f"bandwidth: {big / best / (1 << 30):.3f} GiB/s")
    if compressing:
        print(f"ratio:  {len(data) / max(len(out), 1):.3f}x")
    if args.compare_brotli:
        # compare on the raw side: when decompressing, measure brotli's
        # roundtrip of the decoded output so sizes are comparable
        raw = data if compressing else out
        _compare_brotli(raw, compressing, args.num_repeat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
