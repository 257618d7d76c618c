"""Runs one cell of BENCHMARK.json: set-up, the measured window, the
check, and the result line.

A cell names a configuration (configs/<name>.json: what is loaded or
built) and a traffic mix (traffic/<name>.json: which public call of
brotlig_tpu_torch the window drives, with which arguments, over which
entries). The window is a closed loop with one caller: the entries in
file order, over and over, each call started when the one before
returned. It closes when the pass over the entries that is in flight at
`seconds` ends, so every run does whole passes, the same work in the
same mix; every rate divides all the work completed by the time from the
window's start to that last return. Every metric, end-to-end or
per-layer, is read by metrics/<name>.py from a `Run`. The profiler
traces the window of a `--trace 1` run, and of every run of a cell with
an end-to-end metric whose source is the device trace.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np

from . import check, inputs

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "brotlig_tpu")
KEEP_EVERY = 17             # a decode's output is judged 1 call in KEEP_EVERY
KEEP_BYTES = 4 << 30        # ... while the judged outputs stay under this


class Refused(RuntimeError):
    """The cell cannot run here; no result is printed."""


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load(os.path.join(ROOT, "BENCHMARK.json"))


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise Refused(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, section: str) -> list:
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def metric_reader(name: str):
    """read(run) of metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    mod_name = "blgbench.metrics._" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Record:
    item: int           # index into the run's items
    t0: float           # host clock at the call and at its return
    t1: float
    ok: bool
    size: int = 0       # bytes of its answer: the output or the container


@dataclass
class Run:
    """What a metric reader sees: the entries, one record a timed call,
    the window's and the set-up's seconds, and the trace of a run that
    took the device trace (else None)."""
    items: list
    records: list
    window_s: float
    setup_s: float
    trace: object = None


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_call(traffic: dict, config: dict, device: str):
    """The timed call the traffic names: decode of an item's container,
    or encode of its bytes; synchronised where the traffic asks."""
    import torch
    import brotlig_tpu_torch as blg
    args = dict(traffic["args"], device=device)
    sync = traffic.get("sync", False) and device == "cuda"
    if traffic["op"] == "decode":
        def call(it):
            out = blg.decode(it.blob, **args)
            if sync:
                torch.cuda.synchronize()
            return out
    elif traffic["op"] == "encode":
        def call(it):
            return blg.encode(it.data, page_size=config["page_size"],
                              **args)
    else:
        raise ValueError(f"traffic op {traffic['op']!r}")
    return call


def answer_size(out) -> int:
    if out is None:
        return 0
    return len(out) if isinstance(out, (bytes, bytearray)) else out.numel()


def window(items, call, seconds: float, keep, traced: bool):
    """The closed loop, closed by the first pass of the entries to end at
    or after `seconds`; returns (records, kept outputs by call number,
    window seconds)."""
    from torch.profiler import record_function
    records, kept = [], {}
    kept_bytes = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    k = 0
    while True:
        i = k % len(items)
        t0 = time.perf_counter()
        with (record_function(f"call: {items[i].name}") if traced
              else nullcontext()):
            try:
                out, ok = call(items[i]), True
            except Exception as e:          # counted, and not correct
                print(f"call {k} ({items[i].name}) raised {e!r}",
                      file=sys.stderr)
                out, ok = None, False
        t1 = time.perf_counter()
        records.append(Record(i, t0, t1, ok, answer_size(out)))
        if ok and keep(k) and kept_bytes < KEEP_BYTES:
            kept[k] = out
            kept_bytes += len(items[i].data)
        k += 1
        if t1 >= deadline and k % len(items) == 0:
            return records, kept, t1 - t_start


def run_cell(cell: dict, spec: dict, seed: int, seconds: float,
             traced: bool, fault: str | None = None, device: str = "cuda",
             config: dict | None = None, traffic: dict | None = None,
             t_begin: float | None = None) -> dict:
    """One run of `cell`; returns the result line's object. `config` and
    `traffic` replace the files the cell names (tests run small ones on
    the CPU with device="cpu")."""
    t_begin = time.perf_counter() if t_begin is None else t_begin
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        raise Refused(f"cell {cell['name']} needs {cell['chips']} CUDA "
                      f"device(s); torch sees "
                      f"{torch.cuda.device_count()}")
    config = config or load(os.path.join(BENCH, "configs",
                                         f"{cell['config']}.json"))
    traffic = traffic or load(os.path.join(BENCH, "traffic",
                                           f"{cell['traffic']}.json"))
    seed = int(seed) % (1 << 64)
    marks = [("start", time.perf_counter())]
    items = inputs.make_items(config, seed, traffic.get("max_asset_bytes"))
    marks.append(("inputs", time.perf_counter()))
    if traffic["op"] == "decode":
        digest = inputs.make_containers(items, config, device)
        print(f"containers sha256 {digest}", file=sys.stderr)
        marks.append(("containers", time.perf_counter()))
    call = check.with_fault(make_call(traffic, config, device),
                            traffic["op"], fault)
    for _ in range(traffic.get("warmup_passes", 1)):
        for it in items:
            call(it)
    if device == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(
        f"{n} {t - marks[i][1]:.3f} s" for i, (n, t) in enumerate(marks[1:])),
        f"(before: {marks[0][1] - t_begin:.3f} s)", file=sys.stderr)
    # the judged calls: every encode; of the decodes the window's first
    # pass, then every KEEP_EVERY-th call from an offset drawn from the
    # seed. KEEP_EVERY is prime to the entry counts, so every seed keeps
    # each entry as often, and the holding costs every seed alike.
    offset = int(np.random.default_rng([seed, 1 << 40]).integers(
        KEEP_EVERY))

    def keep(k):
        return (traffic["op"] == "encode" or k < len(items)
                or k % KEEP_EVERY == offset)
    if device == "cuda":
        if traffic["args"].get("return_device"):
            # held outputs come from a pool reserved here, not from
            # cudaMalloc inside the window
            pool = torch.empty(KEEP_BYTES + (512 << 20), dtype=torch.uint8,
                               device=device)
            del pool
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_begin

    # the device trace: in a traced run, and in every run of a cell
    # whose end-to-end metrics read it
    e2e = cell_metrics(spec, cell["name"], "end_to_end")
    device_trace = traced or any(m["source"] == "device_trace" for m in e2e)
    prof = None
    if device_trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    records, kept, window_s = window(items, call, seconds, keep,
                                     device_trace)
    if device == "cuda":
        torch.cuda.synchronize()
    print("window: %d calls in %.3f s; MB/s by quarter: %s" % (
        len(records), window_s, " ".join(
            "%.3f" % q for q in quarter_rates(records, items))),
        file=sys.stderr)
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from .tracing import summarize
        t_read = time.perf_counter()
        trace = summarize(prof)
        print(f"trace: {trace.events} events read in "
              f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr)
        del prof
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {', '.join(found)}")

    if traffic["op"] == "decode":
        verdict = check.judge_outputs(kept, items, records)
    else:
        verdict = check.judge_containers(kept, items, records)
    del kept
    failed_calls = sum(not r.ok for r in records)
    checks = {"bad_bytes": {"value": verdict["bad_bytes"], "max": 0},
              "failed_calls": {"value": failed_calls, "max": 0},
              "judged_calls": {"value": verdict["compared"], "min": 1}}
    correct = all(c["value"] <= c.get("max", c["value"])
                  and c["value"] >= c.get("min", c["value"])
                  for c in checks.values())

    run = Run(items, records, window_s, setup_s, trace)
    metrics = {}
    for m in (cell_metrics(spec, cell["name"], "per_layer") if traced
              else e2e):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": failed_calls + verdict["bad_calls"],
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    return result


def quarter_rates(records, items) -> list:
    """Input MB a second of the calls that ended in each quarter of the
    window: a rate that drifts across quarters is noise a longer window
    averages out; one steady within a run but not across runs is not."""
    t0, t1 = records[0].t0, records[-1].t1
    q = (t1 - t0) / 4
    done = [0.0] * 4
    for r in records:
        if r.ok:
            done[min(3, int((r.t1 - t0) / q))] += len(items[r.item].data)
    return [d / q / 1e6 for d in done]
