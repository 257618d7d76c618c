"""Stage profile of the device encode path (port of tools/profile_encode.py).

Times, on one device, over BENCH_PAGES pages of the mixed corpus
(utils/corpus.py):

  matcher       ops/encode.find_commands, exact tier (greedy LZ77)
  matcher_fast  the same at the q1 tier
  dp            ops/parse_dp.find_commands_dp (the windowed-DP parse,
                seeded with the matcher's commands)
  pack          ops/encode_pack.pack_partitioned of the greedy commands
  e2e_q1        encode_pages_device(quality=1): matcher and pack
  e2e_q11       encode_pages_device(quality=11): matcher, DP, both packs

Each stage runs PROF_REPS times, the device synchronised around each
run; its ms is the median host time of the runs after the first, the
warm one (of the first alone at PROF_REPS=1). The q1 path is also run
once under torch.profiler (device_work): its aten ops, CUDA kernels and
their device ms. One JSON line is printed.

Usage: [BENCH_PAGES=64] [PROF_REPS=4] [BLG_DP_ITERS=3]
python -m brotlig_tpu_torch.tools.profile_encode [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..ops.decode import resolve_device
from ..ops.encode import find_commands
from ..ops.encode_pack import encode_pages_device, pack_partitioned
from ..ops.parse_dp import find_commands_dp
from ..utils.corpus import PAGE, corpus
from .profile_decode import device_name, device_work, stage_ms


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    n_pages = int(os.environ.get("BENCH_PAGES", "64"))
    reps = int(os.environ.get("PROF_REPS", "4"))
    data = corpus(n_pages)
    arr = np.frombuffer(data, np.uint8).reshape(n_pages, PAGE).copy()
    sizes = np.full(n_pages, PAGE, np.int64)
    pages = torch.from_numpy(arr).to(dev)
    in_sizes = torch.from_numpy(sizes).to(dev)
    isdelta = torch.zeros(n_pages, dtype=torch.int64, device=dev)
    max_cmds = PAGE // 4 + 16
    greedy = find_commands(pages, in_sizes, max_cmds)
    blobs = {}

    def e2e(q):
        blobs[q] = encode_pages_device(arr, sizes, PAGE, quality=q,
                                       device=dev)
    ms = {
        "matcher": stage_ms(
            lambda: find_commands(pages, in_sizes, max_cmds), reps, dev),
        "matcher_fast": stage_ms(
            lambda: find_commands(pages, in_sizes, max_cmds, fast=True),
            reps, dev),
        "dp": stage_ms(lambda: find_commands_dp(
            pages, in_sizes, max_cmds, greedy_cmds=greedy), reps, dev),
        "pack": stage_ms(lambda: pack_partitioned(
            pages, in_sizes, PAGE, max_cmds, *greedy, isdelta), reps, dev),
        "e2e_q1": stage_ms(lambda: e2e(1), reps, dev),
        "e2e_q11": stage_ms(lambda: e2e(11), reps, dev),
    }
    work = device_work(lambda: e2e(1), dev)
    res = {"tool": "profile_encode", "device": device_name(dev),
           "pages": n_pages, "bytes": len(data), "reps": reps, "ms": ms,
           "q1_gbps": len(data) / ms["e2e_q1"] / 1e6,
           "q11_gbps": len(data) / ms["e2e_q11"] / 1e6,
           "ratio_q1": len(data) / sum(map(len, blobs[1])),
           "ratio_q11": len(data) / sum(map(len, blobs[11])), **work}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
