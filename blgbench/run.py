"""Run one cell of BENCHMARK.json and print its result line.

    python3 blgbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--fault lossy|alter|half]

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, then the checks, each
number compared beside its limit); the checks are also the last lines of
standard error. The run exits with another code than 0, and prints no
result, when the card the cell needs is missing, when the cell cannot be
found or set up, or when jax, jaxlib, flax or brotlig_tpu was imported.
--fault plants a fault in the timed path (check.py): the control and its
tests use it; the benchmark's own runs never do.
"""
import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this folder heads sys.path; its module names must not
# shadow others' (the package is imported from ROOT)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        from blgbench import harness
        spec = harness.benchmark()
        cell = harness.find(spec["workloads"], a.workload, "workload")
        result = harness.run_cell(cell, spec, a.seed, a.seconds,
                                  bool(a.trace), a.fault, t_begin=T_BEGIN)
    except Exception as e:  # noqa: BLE001 -- any failure: no result line
        import traceback
        traceback.print_exc()
        print(f"blgbench: no result: {e}", file=sys.stderr)
        return 1
    from blgbench.roofline import power_limit
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        bound = f"max {c['max']}" if "max" in c else f"min {c['min']}"
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
