"""What a run loads: no module of JAX or of the JAX package (top-level
names compared whole), and nothing of lws_torch in the reference or the
roofline."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "lws_tpu"}

RUN = """
import json, sys, time
import torch
from portbench import control, generate, harness, run, trace
bench = json.load(open("BENCHMARK.json"))
for w in bench["workloads"]:
    _, cfg, tr, limits, e2e, per_layer = harness.cell_files(w["name"])
    cfg = dict(cfg, program=dict(cfg["program"], batch_iterations=3, online_iterations=1))
    tr = dict(tr, items=1, seconds=0.1, pool=1, checked=1, warm_calls=1)
    harness.run_cell(cfg, tr, limits, e2e, 7, 0.05, False, "cpu", time.perf_counter())
    for m in per_layer:
        harness.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
from portbench import roofline
from portbench.reference import compare, lws_ref, windows
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _loaded(RUN)
    assert "lws_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE)
    assert not loaded & (FORBIDDEN | {"lws_torch"})


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "lws_tpu_like", sys)
    assert harness.forbidden_modules() == sorted(FORBIDDEN & set(sys.modules))
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
