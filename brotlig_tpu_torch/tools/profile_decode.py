"""Stage profile of the device decode path (port of tools/profile_decode.py).

Times, on one device, over one batch of the mixed corpus
(utils/corpus.py) encoded by the native q11 encoder:

  tables     the tables kernel alone (tables_kernel.load_tables)
  fused      the fused route: tables kernel, then the fused decode kernel
  two_phase  the two-phase route: tables, phase-A and sweep kernels
  plain      the plain torch route on the device (variant "xla")
  e2e        decode() of the whole container, host bytes to host bytes,
             on the route BLG_VARIANT/BLG_PALLAS/BLG_FUSED pick

Each stage runs PROF_REPS times, the device synchronised around each
run; its ms is the median host time of the runs after the first, the
warm one (of the first alone at PROF_REPS=1). The route the environment
picks is also run once under torch.profiler (device_work): its aten ops,
CUDA kernels and their device ms. One JSON line is printed.

Usage: [BENCH_PAGES=256] [PROF_REPS=4] [BLG_VARIANT=fused]
[BLG_SWEEP_CW=2048] python -m brotlig_tpu_torch.tools.profile_decode
[--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from .. import native
from ..api import decode
from ..format.headers import parse_container
from ..ops import tables_kernel
from ..ops.decode import (decode_batch, env_decode_opts, resolve_device,
                          staged_batches)
from ..utils.corpus import PAGE, corpus


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stage_ms(fn, reps: int, dev: torch.device) -> float:
    """Host ms of fn run reps times, the device synchronised before and
    after each run: the median of the runs after the first (the warm
    one), or the first alone when reps is 1."""
    times = []
    for _ in range(max(reps, 1)):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:] or times)


def device_work(fn, device="cuda") -> dict:
    """What one call of fn asks of `device`: the aten ops it dispatches,
    and on a card the CUDA kernels torch.profiler traces (None where the
    trace holds no device event) and those kernels' summed device ms (None
    on the CPU)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.n += 1
            return func(*args, **(kwargs or {}))
    dev = torch.device(device)
    if dev.type != "cuda":
        with Ops():
            fn()
        return {"aten_ops": Ops.n, "kernels": None, "kernel_ms": None}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with Ops():
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return {"aten_ops": Ops.n, "kernels": len(kernels) or None,
            "kernel_ms": (sum(e.device_time_total for e in kernels) / 1e3
                          if kernels else None)}


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    n_pages = int(os.environ.get("BENCH_PAGES", "256"))
    reps = int(os.environ.get("PROF_REPS", "4"))
    variant, cw = env_decode_opts()
    data = corpus(n_pages)
    blob = native.encode(data, page_size=PAGE, quality=11)
    info = parse_container(blob)
    n_comp = len(info.compressed_page_indices())
    _, staged = next(staged_batches(blob, info, n_comp, dev))

    def e2e():
        if decode(blob, dev, variant=variant, sweep_cw=cw) != data:
            raise AssertionError("decode differs from the input")
    ms = {
        "tables": stage_ms(lambda: tables_kernel.load_tables(staged.buf),
                           reps, dev),
        "fused": stage_ms(lambda: decode_batch(staged, PAGE, "fused"),
                          reps, dev),
        "two_phase": stage_ms(
            lambda: decode_batch(staged, PAGE, "two_phase", cw), reps, dev),
        "plain": stage_ms(lambda: decode_batch(staged, PAGE, "xla"), reps,
                          dev),
        "e2e": stage_ms(e2e, reps, dev),
    }
    work = device_work(lambda: decode_batch(staged, PAGE, variant, cw), dev)
    res = {"tool": "profile_decode", "device": device_name(dev),
           "pages": n_pages, "compressed_pages": n_comp, "bytes": len(data),
           "variant": variant, "sweep_cw": cw, "reps": reps, "ms": ms,
           "e2e_gbps": len(data) / ms["e2e"] / 1e6, **work}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
