"""Reading a torch.profiler trace of the measured window.

The traced run wraps every timed call in `record_function("call: ...")`.
From the profiler's events (CPU and CUDA activity) this module takes:
- the window: the first call's start to the last call's end;
- the device's busy time: the union of every device interval (kernels,
  copies, sets) inside the window;
- device time by operation, kernels by their function's name;
- the longest idle gaps, each named by what the host was doing at its
  middle: the call, and the innermost host operation under it.
The events are read straight from the profiler's results, without
building its tree of function events, which is slow on a long window.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

CALL = "call: "
TOP = 10


def short_name(name: str) -> str:
    """A kernel's function name without namespace, template arguments or
    parameters ("void (anonymous namespace)::decode_kernel<1>(int
    const*, ...)" -> "decode_kernel"); copies and sets keep their name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    s = name.replace("(anonymous namespace)::", "")
    s = re.split(r"[(<]", s, maxsplit=1)[0].strip()
    return s.rsplit("::", 1)[-1].rsplit(" ", 1)[-1] or name


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict = field(default_factory=dict)   # short name -> seconds
    gaps: list = field(default_factory=list)       # [label, seconds]
    events: int = 0

    def time_of(self, names) -> float | None:
        """Device seconds of the operations named, None if none ran."""
        found = [self.device_s[n] for n in names if n in self.device_s]
        return sum(found) if found else None

    def idle_pct(self) -> float | None:
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": self.gaps[:TOP]}


def _events(prof):
    """(host events, device events) as (start_ns, end_ns, name) lists."""
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (s, s + e.duration_ns(), e.name())
        if not str(e.device_type()).endswith("CUDA"):
            host.append(item)
        elif not (e.is_user_annotation() or item[2].startswith(CALL)):
            # a call's range as the card saw it is no operation of its own
            dev.append(item)
    return host, dev


def _union(intervals, lo: int, hi: int) -> list:
    """Merged [start, end] intervals, clipped to [lo, hi]."""
    out: list = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if s >= e:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(host, t: int) -> str:
    """What the host was doing at time t: the call and the innermost
    operation under it."""
    cover = [ev for ev in host if ev[0] <= t < ev[1]]
    call = next((n[len(CALL):] for _, _, n in cover if n.startswith(CALL)),
                "between calls")
    inner = [ev for ev in cover if not ev[2].startswith(CALL)]
    op = max(inner, key=lambda ev: ev[0])[2] if inner else "host"
    return f"{call}: {op}"


def summarize(prof) -> Trace:
    host, dev = _events(prof)
    calls = [ev for ev in host if ev[2].startswith(CALL)]
    if not calls:
        return Trace(0.0, 0.0, events=len(host) + len(dev))
    lo = min(ev[0] for ev in calls)
    hi = max(ev[1] for ev in calls)
    busy = _union([(s, e) for s, e, _ in dev], lo, hi)
    device_s: dict = {}
    for s, e, n in dev:
        k = short_name(n)
        device_s[k] = device_s.get(k, 0.0) + (e - s) * 1e-9
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    gaps = [[_label(host, s + d // 2), d * 1e-9] for d, s in idle]
    return Trace((hi - lo) * 1e-9, sum(e - s for s, e in busy) * 1e-9,
                 device_s, gaps, len(host) + len(dev))
