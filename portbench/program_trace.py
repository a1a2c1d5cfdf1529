"""The program's own spans in the profiler's trace, beside the harness's.

`lws_torch` marks some of its stages with `torch.profiler` ranges named
`lws_torch.*` (the mel vocoder's `lws_torch.mel_to_linear` and
`lws_torch.run_lws`). `ProgramTrace` is `trace.Trace` with those spans
kept apart, in `program_spans`, and every device operation (kernel, copy,
set) tied to the spans it was launched from: the profiler gives each launch
on the host (a CUDA runtime or driver call) and the device operation it
started one correlation id, and a launch inside a span launched its
operation from that span, whenever the operation ran. Everything `Trace`
reads (`spans`, `busy_s`, `idle_gaps`, ...) reads the same.

The harness builds its trace through `portbench.trace.Trace`; a runner
whose cells read program spans puts `ProgramTrace` there while it lives
(`swap_in` / `swap_out`). A trace without `lws_torch.*` spans, as of a
program that has none, gives no program spans and None for each reading.

`Least` is the least time of a run's traced calls as the harness's readers
take it (a float), with its share for each program span.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

from . import trace

PREFIX = "lws_torch."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class ProgramTrace(trace.Trace):

    def __init__(self, path: str):
        super().__init__(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans, launches, ops = defaultdict(list), {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, corr = e.get("cat", ""), e.get("args", {}).get("correlation")
            a = float(e["ts"]) * 1e-6
            b = a + float(e.get("dur", 0)) * 1e-6
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                spans[e["name"]].append((a, b))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = a
            elif cat in trace.DEVICE_CATS and corr is not None:
                ops.append((max(a, self.t0), min(b, self.t1), corr))
        self.program_spans = {k: sorted(v) for k, v in spans.items()}
        starts = {k: [a for a, _ in v] for k, v in self.program_spans.items()}
        self.launched = defaultdict(float)
        for a, b, corr in ops:
            t = launches.get(corr)
            if t is None or b <= a:
                continue
            for name, ivs in self.program_spans.items():
                i = bisect.bisect_right(starts[name], t) - 1
                if i >= 0 and ivs[i][0] <= t < ivs[i][1]:
                    self.launched[name] += b - a

    def span_s(self, name: str) -> float | None:
        """Wall seconds of the program span `name` inside the window."""
        if name not in self.program_spans:
            return None
        return sum(max(0.0, min(b, self.t1) - max(a, self.t0))
                   for a, b in self.program_spans[name])

    def launched_s(self, name: str) -> float | None:
        """Device seconds, inside the window, of the operations launched
        from the program span `name` (or a span nested in it)."""
        if name not in self.program_spans:
            return None
        return self.launched[name]


def swap_in():
    """Make the harness build ProgramTraces; returns what to swap back."""
    was, trace.Trace = trace.Trace, ProgramTrace
    return was


def swap_out(was) -> None:
    trace.Trace = was


class Least(float):
    """Least seconds (their sum) with `by_span`: the least seconds of the
    work each program span does."""

    def __new__(cls, by_span: dict):
        least = super().__new__(cls, sum(by_span.values()))
        least.by_span = dict(by_span)
        return least
