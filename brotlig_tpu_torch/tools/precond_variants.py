"""Builds of the texture kernels (csrc/precondition.cu) at other design
choices, timed on the card.

The kernels' choices are macros with defaults (BLG_PRECOND_TILE, the
texture bytes of a tile; BLG_PRECOND_RING, tile buffers in shared memory;
BLG_PRECOND_THREADS, threads a CTA; BLG_PRECOND_CTAS, CTAs an SM at
most). This builds the source with the flags of _kernels, once as it
stands ("committed") and once a variant with one macro set otherwise,
one nvcc a build, all started together; holds each build's outputs to
the committed build's (and those to the plain versions, tolerance 0);
and times each build's raw launches (CUDA events over REPS launches
behind a ~1 ms device spin) on chip_smoke.py's four texture geometries,
a random stream of each: the postprocess with every page flagged
("post") and with none ("post0"), the preprocess with every page flagged
("pre"). One JSON line a build, with the card's name and power limit;
before them a device copy of each texture's bytes (dst.copy_(src)) and
the committed build's slowest CTA a texture and kernel, in kcycles by
phase (ops/precondition_kernel.py PHASES).

Usage (a CUDA device and nvcc; names of VARIANTS pick some, default all):
    python -m brotlig_tpu_torch.tools.precond_variants ["threads 128" ...]
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
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
VARIANTS = {
    "committed": {},
    **{f"tile {t}": {"BLG_PRECOND_TILE": t} for t in (8192, 32768)},
    **{f"ring {r}": {"BLG_PRECOND_RING": r} for r in (1, 3)},
    **{f"threads {t}": {"BLG_PRECOND_THREADS": t} for t in (128, 512)},
    **{f"ctas {c}": {"BLG_PRECOND_CTAS": c} for c in (1, 2, 3)},
}


def build_all(tmp: str, names) -> dict:
    """{variant: its loaded library} for the variants named, one nvcc a
    variant, in parallel."""
    src = os.path.join(_kernels.CSRC, "precondition.cu")
    procs = {}
    for name in names:
        macros = VARIANTS[name]
        so = os.path.join(tmp, name.replace(" ", "_") + ".so")
        procs[name] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS,
             *[f"-D{k}={v}" for k, v in macros.items()], "-shared", "-o",
             so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp = ctypes.c_void_p
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.blg_postprocess.argtypes = [vp] * 7
        lib.blg_preprocess.argtypes = [vp] * 7
        lib.blg_precond_tiles.restype = ctypes.c_longlong
        lib.blg_precond_tiles.argtypes = [vp]
        lib.blg_precond_grid.argtypes = [vp, ctypes.c_int]
        libs[name] = lib
    return libs


def time_ms(fn) -> float:
    """Mean device ms of REPS calls of fn, after one."""
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


def checked(entry, *args):
    """A launcher of a C entry point that raises on a launch error."""
    def fn():
        rc = entry(*args)
        if rc != 0:
            raise RuntimeError(f"launch failed (cudaError {rc})")
    return fn


def slowest(rec: torch.Tensor) -> dict:
    r = rec[int(rec[:, PK.REC_TOTAL].argmax())].tolist()
    return {**{ph: round(r[k] / 1e3, 1) for k, ph in enumerate(PK.PHASES)},
            "tiles": r[PK.REC_TILES], "kcycles": round(r[PK.REC_TOTAL] / 1e3,
                                                       1),
            "ctas": rec.shape[0]}


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
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
        geom = PK.pack_geometry(params, n, page)
        none = torch.zeros(-(-n // page), dtype=torch.uint8, device=dev)
        post = PK.postprocess_plain(x, geom)
        post0 = PK.postprocess_plain(x, geom, none.cpu())
        pre = PK.preprocess_plain(x, geom)
        cases.append((name, geom, x, none, post, post0, pre))
        dst = torch.empty_like(x)
        rec = PK.postprocess_cuda(x, geom, return_record=True)[1]
        rec_pre = PK.preprocess_cuda(x, geom, return_record=True)[2]
        print(json.dumps({"texture": name, "bytes": n, "copy_ms": time_ms(
            lambda: dst.copy_(x)), "post slowest CTA": slowest(rec.cpu()),
            "pre slowest CTA": slowest(rec_pre.cpu()), "gpu": gpu}),
            flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp, names)
        for variant, lib in libs.items():
            res = {}
            for name, geom, x, none, post, post0, pre in cases:
                g, xp = geom.data_ptr(), x.data_ptr()
                work = torch.zeros(2 + lib.blg_precond_tiles(g) * int(
                    geom[PK.G_NCOLOR]), dtype=torch.int32, device=dev)
                a, b = torch.empty_like(x), torch.empty_like(x)
                runs = {
                    "post": (checked(lib.blg_postprocess, g, xp, None,
                                     a.data_ptr(), work.data_ptr(), None,
                                     stream), [(a, post)]),
                    "post0": (checked(lib.blg_postprocess, g, xp,
                                      none.data_ptr(), a.data_ptr(),
                                      work.data_ptr(), None, stream),
                              [(a, post0)]),
                    "pre": (checked(lib.blg_preprocess, g, xp, None,
                                    a.data_ptr(), b.data_ptr(), None,
                                    stream), [(a, pre[0]), (b, pre[1])]),
                }
                res[name] = {}
                for kind, (fn, outs) in runs.items():
                    for t, _ in outs:
                        t.fill_(0xA5)
                    res[name][kind] = time_ms(fn)
                    if any(not torch.equal(t, want) for t, want in outs):
                        raise AssertionError(f"{variant}: {kind} of {name} "
                                             "differs from the plain "
                                             "version")
            print(json.dumps({"variant": variant, "macros":
                              VARIANTS[variant], "ms": res, "gpu": gpu}),
                  flush=True)


if __name__ == "__main__":
    main()
