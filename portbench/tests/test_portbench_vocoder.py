"""The mel vocoder cell on the CPU at a small size: the program against the
plain reference (reference/mel.py for the front end, lws_ref for LWS and
the iSTFT), the comparison that decides `correct` through a whole run (the
program passes; the control and each planted fault fail), the program's
spans in the trace, the new readers, the front end's counts, and what the
front end's reference imports. The music pipeline's waveform cell, which
the iSTFT repair brings back, runs its planted faults here too."""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import lws_torch
from lws_torch import mel as tmel
from portbench import generate, harness, program_trace, roofline, trace
from portbench.reference import config as C
from portbench.reference import lws_ref as R
from portbench.reference import mel as RM
from portbench.roofline import mel as roofline_mel

ROOT = Path(__file__).resolve().parents[2]
VOCODER = "tts22k.vocoder128"
# 2 seeded items of 0.3 s at LWS(2048, 256), a few sweeps
SMALL = dict(items=2, seconds=0.3, pool=2, checked=2, warm_calls=1)
FEW = dict(batch_iterations=3, online_iterations=1)
# float32 rounding of the front end, relative to an item's peak: 80 terms
# of a product a bin, each rounded at 2**-24 of its size
F32_PEAK = 1e-5


def _cell(workload):
    _, cfg, traffic, limits, _, _ = harness.cell_files(workload)
    return dict(cfg, program=dict(cfg["program"], **FEW)), dict(traffic, **SMALL), limits


def _run(workload, seed=11, numbers=None):
    cfg, traffic, limits = _cell(workload)
    return harness.run_cell(cfg, traffic, limits, [], seed, 0.05, False, "cpu",
                            time.perf_counter(), numbers_out=numbers)


# -- the front end and the whole path against the reference ---------------

def test_the_front_end_matches_the_reference():
    """The program's filterbank and its pinv projection against the plain
    reference's: float64 to 1e-13 of the peak, float32 within its rounding
    of each item's peak."""
    cfg, _, _ = _cell(VOCODER)
    m, fsize, sr = cfg["mel"], cfg["program"]["fsize"], cfg["sample_rate"]
    fb = tmel.mel_filterbank(m["n_mels"], fsize, sr, fmin=m["fmin"], fmax=m["fmax"],
                             htk=m["htk"], norm=m["norm"])
    fb_ref = RM.filterbank(m, fsize, sr, "cpu", torch.float64)
    assert np.abs(fb - fb_ref.numpy()).max() <= 1e-13 * fb.max()
    x = generate.signals(5, dict(SMALL, pool=1), cfg)[0]
    tb = R.Tables(C.Program(cfg), "cpu", torch.float64, stencils=False)
    mel = RM.to_mel(torch.linalg.vector_norm(R.stft(torch.as_tensor(x).double(), tb), dim=2),
                    fb_ref)
    want = RM.to_linear(mel, RM.pinv(fb_ref), m["eps"])
    assert RM.peak_error(tmel.mel_to_linear(mel, fb), want) <= 1e-13
    assert RM.peak_error(tmel.mel_to_linear(mel.float(), fb).double(), want) <= F32_PEAK
    assert float(want.min()) == m["eps"]  # the clamp is reached


def test_the_vocoder_matches_the_reference():
    """The cell's float32 program, mel to waveform, against the float64
    reference on the same mels: the magnitudes within float32 rounding of
    each item's peak, the LWS result and the waveform within the cell's
    limits."""
    nums = {}
    res = _run(VOCODER, numbers=nums)
    assert res["correct"] is True, res["checks"]
    assert nums["lin"] <= F32_PEAK
    assert nums["wave"] <= 1e-6


# -- the comparison through a whole run -----------------------------------

def test_the_control_fails():
    """The bfloat16 reference (front end, LWS and iSTFT) in the program's
    place."""
    cfg, _, _ = _cell(VOCODER)
    tb = R.Tables(C.Program(cfg), "cpu", torch.bfloat16)
    low = torch.bfloat16

    def pipeline(mel, proc, fb=None, return_spec=False):
        inv = RM.pinv(RM.filterbank(cfg["mel"], tb.fsize, cfg["sample_rate"], "cpu", low))
        out = R.offline(RM.to_linear(mel.to(low), inv, cfg["mel"]["eps"]), tb, "run_lws")
        return out[:, :, 0].float(), out[:, :, 1].float()

    def istft(self, pair):
        return R.istft(torch.stack(pair, dim=2).to(low), tb).float()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lws_torch, "mel_vocoder_pipeline", pipeline)
        mp.setattr(lws_torch.LWS, "istft", istft)
        res = _run(VOCODER)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _faults(monkeypatch, fault, entry):
    real_istft, real_entry = lws_torch.LWS.istft, getattr(lws_torch.LWS, entry)
    real_front = tmel.mel_to_linear

    def magnitudes_altered(mel, fb, eps=1e-10, device=None):
        lin = real_front(mel, fb, eps, device).clone()
        lin[0] *= 1.01
        return lin

    def frame_altered(self, pair):
        sr, si = (t.clone() for t in real_entry(self, pair))
        sr[0, 5], si[0, 5] = -sr[0, 5], -si[0, 5]
        return sr, si

    def wave_altered(self, pair):
        y = real_istft(self, pair).clone()
        y[0, 1000:1100] *= 0.99
        return y

    if fault == "magnitudes_altered":
        monkeypatch.setattr(tmel, "mel_to_linear", magnitudes_altered)
    elif fault == "frame_altered":
        monkeypatch.setattr(lws_torch.LWS, entry, frame_altered)
    else:
        monkeypatch.setattr(lws_torch.LWS, "istft", wave_altered)


@pytest.mark.parametrize("workload,fault", [
    (VOCODER, "magnitudes_altered"), (VOCODER, "frame_altered"), (VOCODER, "wave_altered"),
    ("music16k.pipeline32", "frame_altered"), ("music16k.pipeline32", "wave_altered")])
def test_faults_fail(monkeypatch, workload, fault):
    _faults(monkeypatch, fault, "run_lws")
    assert _run(workload)["correct"] is False


def test_the_music_waveform_cell_passes():
    assert _run("music16k.pipeline32")["correct"] is True


# -- the program's spans in the trace -------------------------------------

def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _chrome(tmp_path, with_program):
    """A window with two calls: each a harness span, a launch on the host
    and the kernel it started; with_program adds the program's spans
    around the launches (and one launch outside any program span)."""
    ev = [_event("portbench.window", "user_annotation", 0, 1000)]
    for k, t in enumerate((100, 500)):
        ev += [_event("portbench.mel_vocoder_pipeline", "user_annotation", t, 150),
               _event("cudaLaunchKernel", "cuda_runtime", t + 20, 5, correlation=k),
               _event("lws_sweeps_kernel", "kernel", t + 30, 300, correlation=k),
               _event("aten::matmul", "cpu_op", t + 5, 10)]
        if with_program:
            ev += [_event("lws_torch.mel_to_linear", "user_annotation", t + 2, 15),
                   _event("lws_torch.run_lws", "user_annotation", t + 18, 100)]
    ev += [_event("cudaMemcpyAsync", "cuda_runtime", 900, 5, correlation=9),
           _event("Memcpy DtoH", "gpu_memcpy", 905, 50, correlation=9)]
    path = tmp_path / f"trace_{with_program}.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_program_spans_leave_the_harness_readings_alone(tmp_path):
    """A trace with and without lws_torch.* events gives equal spans, busy
    time and idle gaps, read as a Trace or a ProgramTrace; the program's
    spans and the device time launched from them are kept apart."""
    plain, marked = (_chrome(tmp_path, w) for w in (False, True))
    reads = [cls(p) for cls in (trace.Trace, program_trace.ProgramTrace)
             for p in (plain, marked)]
    for tr in reads[1:]:
        assert tr.spans == reads[0].spans
        assert tr.busy_s == reads[0].busy_s and tr.window_s == reads[0].window_s
        assert tr.idle_gaps() == reads[0].idle_gaps()
        assert tr.device_ops() == reads[0].device_ops()
    bare, prog = reads[2], reads[3]
    assert bare.program_spans == {} and bare.launched_s("lws_torch.run_lws") is None
    assert prog.launched_s("lws_torch.run_lws") == pytest.approx(600e-6)
    assert prog.launched_s("lws_torch.mel_to_linear") == 0.0
    assert prog.span_s("lws_torch.mel_to_linear") == pytest.approx(30e-6)
    assert prog.span_s("lws_torch.istft") is None


def test_the_swap_is_undone_by_release():
    cfg, traffic, _ = _cell(VOCODER)
    before = trace.Trace
    drv = harness.kind("vocoder").Driver(lws_torch, cfg, dict(traffic, pool=1, checked=1),
                                         3, "cpu")
    assert trace.Trace is program_trace.ProgramTrace
    drv.release()
    assert trace.Trace is before


def test_the_readers_find_nothing_without_program_spans(tmp_path):
    """What a program without the spans gives (the readers leave their
    metrics out), and what one with them gives."""
    plain = trace.Trace(_chrome(tmp_path, False))
    marked = program_trace.ProgramTrace(_chrome(tmp_path, True))
    least = program_trace.Least({"lws_torch.mel_to_linear": 1e-6, "lws_torch.run_lws": 3e-4})
    assert float(least) == pytest.approx(3.01e-4)
    sweeps, front = harness.reader("sweeps_roofline.vocoder"), harness.reader("mel_front_pct.vocoder")
    for tr, lst in ((plain, least), (plain, 3.01e-4), (marked, 3.01e-4)):
        assert sweeps(harness.Run(1, 0, [1], 1, tr, lst)) is None
    assert front(harness.Run(1, 0, [1], 1, plain, least)) is None
    run = harness.Run(1, 0, [1], 1, marked, least)
    assert sweeps(run) == pytest.approx(50.0)
    assert front(run) == pytest.approx(100 * 30e-6 / 1e-3)
    assert harness.reader("lws_roofline.vocoder")(run) == pytest.approx(100 * 3.01e-4 / 650e-6)


# -- the front end's counts and the least time ------------------------------

def test_the_projection_counts():
    """At the cell's shape: (128 x 223) frames of 80 mels onto 1,025 bins."""
    flops, nbytes = roofline_mel.projection_counts(128, 223, 80, 1025)
    assert flops == 2 * 128 * 223 * 80 * 1025 + 128 * 223 * 1025
    assert nbytes == 4 * (128 * 223 * 80 + 80 * 1025 + 128 * 223 * 1025)


def test_least_splits_by_span():
    """Each call's least time, split by the program span doing the work,
    summed over the calls (the pool cycled)."""
    cfg, traffic, _ = _cell(VOCODER)
    drv = harness.kind("vocoder").Driver(lws_torch, cfg, traffic, 3, "cpu")
    drv.release()
    wk, inv = roofline.Work(cfg), RM.pinv(drv._fb("cpu", torch.float64))
    sweeps = []
    for mel in drv.mel:
        A = RM.to_linear(mel.double(), inv, cfg["mel"]["eps"])
        lws = wk.offline("run_lws", A.amax(dim=(1, 2)).numpy(), A.mean(dim=(1, 2)).numpy(),
                         A.shape[1])
        sweeps.append(sum(roofline.least_seconds(*c) for c in lws.values()))
    front = roofline.least_seconds(*roofline_mel.projection_counts(*A.shape[:2], 80, A.shape[2]))
    least = drv.least_s(3)
    assert least.by_span["lws_torch.run_lws"] == pytest.approx(2 * sweeps[0] + sweeps[1])
    assert least.by_span["lws_torch.mel_to_linear"] == pytest.approx(3 * front)
    assert float(least) == pytest.approx(sum(least.by_span.values()))
    assert sweeps[0] > 0


def test_the_front_end_reference_loads_nothing_of_the_program():
    code = ("import json, sys\nfrom portbench.reference import mel\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "lws_tpu", "lws_torch"}
