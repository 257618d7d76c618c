"""The q11 route at its default shapes held to the JAX package's on the
CPU, with tolerance 0: find_commands_dp (BLG_DP_ITERS iterations, default
3; B 32, W 512, R 16; the plain DP) and the page bytes of
encode_pages_device(quality=11), on two 64 KiB pages of chip_smoke.py's
corpus (the first two of the eight its q11 phase encodes).

tests/test_torch_parse_dp.py holds each module to the JAX package at
TestParseDP's small shapes. This script covers the shapes the route runs,
which take minutes on the CPU (the plain DP is a Python loop of torch ops
over 2048 blocks of 16 rounds an iteration), too long for the suite. Run
from the repository root:

    JAX_PLATFORMS=cpu python tests/q11_defaults_vs_jax.py [--pages 0,32]

It prints one JSON line (commands, bytes, ratios and times on each side)
and exits 1 on any difference.
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from brotlig_tpu.ops import encode_pack as JP  # noqa: E402
from brotlig_tpu.ops import parse_dp as JD  # noqa: E402
from brotlig_tpu_torch.ops import encode_pack as TP  # noqa: E402
from brotlig_tpu_torch.ops import parse_dp as TD  # noqa: E402

PAGE = chip_smoke.PAGE


def recorded(module):
    """Replace module.find_commands_dp by a wrapper that keeps its output,
    so one encode_pages_device run yields both the DP commands and the
    page bytes. Returns the list the output lands in."""
    seen = []
    inner = module.find_commands_dp

    def run(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append([np.asarray(x) for x in out])
        return out
    module.find_commands_dp = run
    return seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pages", default="0,32",
                    help="indices into chip_smoke.corpus(256)")
    args = ap.parse_args(argv)
    idx = [int(i) for i in args.pages.split(",")]
    data = chip_smoke.corpus(max(idx) + 1)
    arr = np.stack([np.frombuffer(data[i * PAGE:(i + 1) * PAGE], np.uint8)
                    for i in idx])
    sizes = np.full(len(idx), PAGE, np.int32)
    torch.set_num_threads(1)
    res = {"pages": idx, "iters": int(os.environ.get("BLG_DP_ITERS", "3")),
           "B_W_R": [TD.BLOCK, TD.WINDOW, TD.ROUNDS]}
    out = {}
    for side, module, encode, kw in (
            ("jax", JD, JP.encode_pages_device, {}),
            ("port", TD, TP.encode_pages_device, {"device": "cpu"})):
        seen = recorded(module)
        t0 = time.perf_counter()
        blobs = encode(arr, sizes, PAGE, quality=11, **kw)
        res[f"{side}_s"] = time.perf_counter() - t0
        res[f"{side}_ratio"] = arr.size / sum(map(len, blobs))
        res[f"{side}_ncmds"] = seen[0][3].tolist()
        out[side] = (seen[0], blobs)
    (jc, jb), (tc, tb) = out["jax"], out["port"]
    res["commands_equal"] = all(np.array_equal(a, b) for a, b in zip(jc, tc))
    res["bytes_equal"] = jb == tb
    print(json.dumps(res), flush=True)
    return 0 if res["commands_equal"] and res["bytes_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
