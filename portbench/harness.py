"""One run of one cell: set-up, warm-up, the measured (or traced) window,
then the comparison with the plain reference and the result's line.

Everything a cell is comes from files found by name: its configuration
(`configs/<name>.json`, whose `program` object is handed whole to
`lws_torch.LWS`), its traffic mix (`traffic/<name>.json`, data whose
`kind` names the runner `kinds/<kind>.py`), its limits
(`limits/<workload>.json`) and each metric's reader (`metrics/<name>.py`,
or `metrics/<stem>.py` for a name `<stem>.<cells>`). A runner builds the
program, makes the inputs from the seed (`generate.py`) and makes one call
at a time; calls run back to back, one caller, until the window's seconds
have passed.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

from . import generate

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lws_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def span(name):
    from torch.profiler import record_function
    return record_function(name)


def program(lws_torch, cfg: dict, device):
    """lws_torch.LWS(fsize, fshift, **rest) of the configuration's
    `program` object: every key goes to the program."""
    args = dict(cfg["program"])
    return lws_torch.LWS(args.pop("fsize"), args.pop("fshift"), device=device, **args)


def kind(name: str):
    """kinds/<name>.py: the runner of a traffic kind."""
    return importlib.import_module(f"{__package__}.kinds.{name}")


class Run:
    """What the metric readers read: the window's calls on the host clock,
    and in a traced run the trace and the least time of the traced work."""

    def __init__(self, setup_s, t0, ends, audio_s, trace=None, least_s=None):
        self.setup_s, self.t0, self.ends, self.audio_s = setup_s, t0, ends, audio_s
        self.trace, self.least_s = trace, least_s


def reader(name: str):
    """The read(run) of metrics/<name>.py, or of metrics/<stem>.py for a
    name <stem>.<cells> that has no file of its own."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists():
        path = ROOT / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _traced(prof):
    """The Trace of a finished profiler."""
    from .trace import Trace
    fd, path = tempfile.mkstemp(suffix=".json", dir=tempfile.gettempdir())
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = Trace(path)
    finally:
        os.remove(path)
    if not tr.busy:
        raise RuntimeError("the profiler's trace holds no device activity")
    return tr


def run_cell(cfg, traffic, limits, metrics, seed, seconds, trace, device, t_start,
             log=sys.stderr, numbers_out=None):
    """One run; returns the result's dict (its last key: the checks).
    `numbers_out` (a dict) receives every number compared or not."""
    import torch
    import lws_torch
    torch.set_num_threads(1)  # one host thread: the benchmark's load is one caller
    drv = kind(traffic["kind"]).Driver(lws_torch, cfg, traffic, seed, device)
    for k in range(int(traffic["warm_calls"])):
        drv.call(k)
    if device != "cpu":
        torch.cuda.synchronize()
    drv.start_window()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    ends, audio = [], 0.0
    with span("portbench.window"):
        t0 = time.perf_counter()
        k = 0
        while True:
            audio += drv.call(k)
            ends.append(time.perf_counter())
            k += 1
            if ends[-1] - t0 >= seconds and drv.ready():
                break
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        tr = _traced(prof)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    least = drv.least_s(k) if trace else None

    drv.release()
    if device != "cpu":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    numbers = drv.numbers(device)
    print(f"reference and comparison: {time.perf_counter() - t_ref:.2f} s", file=log)
    if numbers_out is not None:
        numbers_out.update(numbers)

    run = Run(setup_s, t0, ends, audio, tr, least)
    values = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    ok, checks = _judge(numbers, limits)
    for name, v in numbers.items():
        if name not in checks:
            print(f"not compared: {name} {v:.6g}", file=log)
    result = {"correct": ok, "attempted": k, "failed": 0, "metrics": values,
              "device": {"platform": "gpu" if device != "cpu" else "cpu",
                         "kind": torch.cuda.get_device_name() if device != "cpu" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g} "
              f"{'ok' if _within(c) else 'FAIL'}", file=log)
    return result


def _within(c) -> bool:
    return math.isfinite(c["value"]) and c["value"] <= c["limit"]


def _judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}}) for the
    numbers that have a limit; a number that is not finite fails, and so
    does a cell with no limit at all."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return bool(checks) and all(_within(c) for c in checks.values()), checks


def cell_files(workload: str):
    """(cell, configuration, traffic, limits, end-to-end metrics, per-layer
    metrics) of a workload named in BENCHMARK.json; the limits are empty
    until its limits file is written (portbench.control's readings)."""
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT.parent / cfg_file).read_text())
    traffic = generate.load("traffic", cell["traffic"])
    lim = ROOT / "limits" / f"{workload}.json"
    limits = json.loads(lim.read_text())["limits"] if lim.exists() else {}

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]

    return cell, cfg, traffic, limits, mine(bench["end_to_end"]), mine(bench["per_layer"])
