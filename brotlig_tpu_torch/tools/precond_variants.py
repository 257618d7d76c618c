"""Edited builds of the texture kernels (csrc/precondition.cu) timed on the
card.

Builds, with the flags of _kernels, the source as it stands ("committed")
and edited copies of it:

  width N      every launch at N threads a block (N = 128 ... 1024) in
               place of the launch rule (launch_threads)
  no stores    the postprocess computes every piece's address and value
               but stores none
  linear       the postprocess stores each piece at its conditioned
               position, so that its writes are coalesced

and times each build's raw launches (CUDA events over REPS launches behind
a ~1 ms device spin) on chip_smoke.py's four texture geometries, a random
stream of each: the postprocess with every page flagged ("post") and with
none ("post0"), the preprocess with every page flagged ("pre"). One JSON
line a build, with the card's name and power limit.

Usage (a CUDA device and nvcc):
    python -m brotlig_tpu_torch.tools.precond_variants
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import torch

from .. import _kernels
from ..format import constants as C
from ..format.precondition import DataConditionParams
from ..ops import precondition_kernel as PK

REPS = 20
# chip_smoke.py's textures: format, width and height in pixels, mips,
# swizzle, page size
TEXTURES = {
    "config-3 BC1 4096x8192": (C.DATA_FORMAT_BC1, 4096, 8192, 1, True, 65536),
    "BC3 2048x1024 4 mips": (C.DATA_FORMAT_BC3, 2048, 1024, 4, False, 65536),
    "BC5 1024x1024": (C.DATA_FORMAT_BC5, 1024, 1024, 1, True, 65536),
    "BC1 2048x2048 32 KiB": (C.DATA_FORMAT_BC1, 2048, 2048, 1, True, 32768),
}
LAUNCH = "launch_threads(grid, g.v[G_PAGE] / kSlices)"
STORE = "store_piece(dst[u], v[u], len);"
VARIANTS = {
    "committed": [],
    **{f"width {t}": [(LAUNCH, str(t))] for t in (128, 256, 512, 1024)},
    "no stores": [(STORE, "if (dst[u] == nullptr) " + STORE)],
    "linear": [("dst[u] = out + addr;",
                "dst[u] = out + at0 + at + (addr & 0);")],
}


def build_all(tmp: str) -> dict:
    """{variant: its loaded library}, one nvcc a variant, in parallel."""
    with open(os.path.join(_kernels.CSRC, "precondition.cu")) as f:
        src = f.read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        stem = os.path.join(tmp, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[name] = (stem, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o",
             stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(stem + ".so")
        lib.blg_postprocess.argtypes = [ctypes.c_void_p] * 5
        lib.blg_preprocess.argtypes = [ctypes.c_void_p] * 6
        libs[name] = lib
    return libs


def time_ms(entry, *args) -> float:
    """Mean device ms of REPS calls of a C entry point (raises on a launch
    error)."""
    def fn():
        rc = entry(*args)
        if rc != 0:
            raise RuntimeError(f"launch failed (cudaError {rc})")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> None:
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for name, (fmt, w, h, mips, swz, page) in TEXTURES.items():
        kw = dict(precondition=True, swizzle=swz, delta_encode=True,
                  format=fmt, width_in_pixels=w, height_in_pixels=h,
                  num_mip_levels=mips)
        probe = DataConditionParams(**kw)
        probe.initialize(-1)        # fills the geometry; the size check fails
        n = probe.mip_offsets_bytes[mips]
        params = DataConditionParams(**kw)
        if not params.initialize(n):
            raise AssertionError(f"{name}: geometry does not fit {n} B")
        x = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                          generator=gen)
        none = torch.zeros(-(-n // page), dtype=torch.uint8, device=dev)
        cases.append((name, PK.pack_geometry(params, n, page), x, none,
                      torch.empty_like(x), torch.empty_like(x)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        for variant, lib in libs.items():
            res = {}
            for name, geom, x, none, a, b in cases:
                g, xp = geom.data_ptr(), x.data_ptr()
                res[name] = {
                    "post": time_ms(lib.blg_postprocess, g, xp, None,
                                    a.data_ptr(), stream),
                    "post0": time_ms(lib.blg_postprocess, g, xp,
                                     none.data_ptr(), a.data_ptr(), stream),
                    "pre": time_ms(lib.blg_preprocess, g, xp, None,
                                   a.data_ptr(), b.data_ptr(), stream),
                }
            print(json.dumps({"variant": variant, "ms": res, "gpu": gpu}),
                  flush=True)


if __name__ == "__main__":
    main()
