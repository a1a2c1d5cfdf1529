"""What the profiler's trace of a window says: device busy time, idle gaps
and the harness spans the host was in.

The trace is torch.profiler's Chrome trace, read back as JSON. Device
activity is every kernel, copy and set on the card; its union over the
window (the `portbench.window` span) is the busy time. An idle gap is
named by the innermost harness span (`portbench.*`) around its middle and
the outermost operator the host was running there ("python" where none).
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Times in seconds, on the trace's own clock."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        dev, spans, ops = [], defaultdict(list), []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, a = e.get("cat", ""), float(e["ts"]) * 1e-6
            b = a + float(e.get("dur", 0)) * 1e-6
            if cat in DEVICE_CATS:
                dev.append((a, b, e["name"]))
            elif cat == "user_annotation" and e["name"].startswith("portbench."):
                spans[e["name"]].append((a, b))
            elif cat == "cpu_op":
                ops.append((a, b, e["name"]))
        if len(spans.get("portbench.window", [])) != 1:
            raise RuntimeError("the trace holds no single portbench.window span")
        self.t0, self.t1 = spans["portbench.window"][0]
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self._span_starts = {k: [a for a, _ in v] for k, v in self.spans.items()}
        self.device = [(max(a, self.t0), min(b, self.t1), n) for a, b, n in dev
                       if b > self.t0 and a < self.t1]
        self.busy = _merge([(a, b) for a, b, _ in self.device])
        self._starts = [a for a, _ in self.busy]
        ops.sort()
        self._ops, self._op_starts = ops, [a for a, _, _ in ops]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def busy_within(self, a: float, b: float) -> float:
        """Device busy seconds inside [a, b]."""
        i = max(0, bisect.bisect_right(self._starts, a) - 1)
        total = 0.0
        for s, e in self.busy[i:]:
            if s >= b:
                break
            total += max(0.0, min(e, b) - max(s, a))
        return total

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [name, seconds]."""
        by = defaultdict(float)
        for a, b, n in self.device:
            by[n] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t: float) -> str:
        around = []
        for name, ivs in self.spans.items():
            i = bisect.bisect_right(self._span_starts[name], t) - 1
            if i >= 0 and ivs[i][0] <= t < ivs[i][1]:
                around.append((ivs[i][1] - ivs[i][0], name))
        span = min(around)[1] if around else "portbench.window"
        i = bisect.bisect_right(self._op_starts, t)
        op = "python"
        for a, b, n in reversed(self._ops[max(0, i - 64):i]):
            if a <= t < b:
                op = n  # the earliest start that covers t: the outermost
        return f"{span}/{op}"

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time by what the host was doing: [label, seconds]."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        by = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                by[self._host_at(0.5 * (a + b))] += b - a
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
