"""The comparison that decides `correct`, driven through a whole run on the
CPU at a small size (the harness's look for a card skipped): the program
passes; the control (the reference computed in bfloat16, one step below
the configurations' float32, put in the program's place) fails; and so
does a run with the timed path broken underneath, once for each fault a
cell can have. The cells run on one card, so none has an exchange between
cards to leave out."""
import time

import pytest
import torch

import lws_torch
from portbench import harness
from portbench.reference import config as C
from portbench.reference import lws_ref as R

SMALL = dict(items=2, seconds=0.25, pool=2, checked=2, warm_calls=1)
WORKLOADS = ["speech16k.batch32", "music16k.pipeline32_spec"]


def _run(workload, seed=11):
    _, cfg, traffic, limits, _, _ = harness.cell_files(workload)
    traffic = dict(traffic, **SMALL)
    return harness.run_cell(cfg, traffic, limits, [], seed, 0.05, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_program_passes(workload):
    assert _run(workload)["correct"] is True


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails(monkeypatch, workload):
    """The bfloat16 reference in the program's place."""
    _, cfg, traffic, _, _, _ = harness.cell_files(workload)
    tb = R.Tables(C.Program(cfg), "cpu", torch.bfloat16)

    def entry(self, pair):
        out = R.offline(pair[0].to(torch.bfloat16), tb, traffic["entry"]).float()
        return out[:, :, 0], out[:, :, 1]

    def istft(self, pair):
        return R.istft(torch.stack(pair, dim=2).to(torch.bfloat16), tb).float()

    monkeypatch.setattr(lws_torch.LWS, traffic["entry"], entry)
    monkeypatch.setattr(lws_torch.LWS, "istft", istft)
    res = _run(workload)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


# -- faults: the processor's entry and its iSTFT ---------------------------

def _fault(monkeypatch, workload, fault):
    _, _, traffic, _, _, _ = harness.cell_files(workload)
    name = traffic["entry"]
    real, real_istft = getattr(lws_torch.LWS, name), lws_torch.LWS.istft

    def unchanged(self, pair):
        return pair

    def half(self, pair):
        h = pair[0].shape[0] // 2
        done = real(self, (pair[0][:h], pair[1][:h]))
        return tuple(torch.cat([d, p[h:]]) for d, p in zip(done, pair))

    def frame_altered(self, pair):
        sr, si = (t.clone() for t in real(self, pair))
        sr[0, 5], si[0, 5] = -sr[0, 5], -si[0, 5]
        return sr, si

    def wave_altered(self, pair):
        y = real_istft(self, pair).clone()
        y[0, 1000:1100] *= 0.99
        return y

    if fault == "wave_altered":
        monkeypatch.setattr(lws_torch.LWS, "istft", wave_altered)
    else:
        monkeypatch.setattr(lws_torch.LWS, name, {"unchanged": unchanged, "half": half,
                                                  "frame_altered": frame_altered}[fault])


CASES = [(w, f) for w in WORKLOADS for f in ("unchanged", "half", "frame_altered")]
CASES.append(("speech16k.batch32", "wave_altered"))  # the cell that returns a waveform


@pytest.mark.parametrize("workload,fault", CASES)
def test_faults_fail(monkeypatch, workload, fault):
    _fault(monkeypatch, workload, fault)
    assert _run(workload)["correct"] is False
