"""The sweep kernel K1's launch plan and gate, the Q=32 geometry it now
takes, and the free functions' backend= and dtype rule, on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); port_tools/cuda_on_cpu.py holds its CUDA source, built for
the CPU, to the plain version and to the previous K1 bit for bit.
"""
import types

import numpy as np
import pytest
import torch

import lws_torch
import lws_tpu
from lws_torch import functional
from lws_torch.ops import lws_sweeps as sweeps_mod
from lws_tpu import oracle

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)


# (F, Q, L) -> (bins per thread, threads, window ring in shared memory,
# staged tap planes, fixed kernel, bytes), then the stencil's period P and
# live taps G (None: P = F, every tap live) and whether the table kernel
# runs. Rows are (re, im) pairs of width = F + 2L floats; two ping-pong
# rows, then the 2Q-row ring where it fits beside them, then as many whole
# rows of taps (2L + 1 planes of re, im, F floats each: 8F bytes a plane)
# as the rest of 232,448 B holds, centre row first; or, for the table
# kernel, the G x P table of (re, im) pairs and the tap lists (3 ints per
# row of taps, one per live tap).
_PLAN_ROWS = [
    # batch path: 4 x 267 + 16 x 267 floats of rows, all 7 rows of taps
    (257, 4, 5, 1, 288, True, 77, True, 21_360 + 77 * 2_056, None, None, False),
    # music batch stage: 4 of 7 rows (45,144 B each) fit beside 41,840 B
    (513, 4, 5, 1, 544, True, 44, True, 41_840 + 44 * 4_104, None, None, False),
    # longform: 3 bins on 704 threads (not 1024, 1024, 1); no row of taps
    # (180,312 B) fits beside the 164,720 B of rows
    (2049, 4, 5, 3, 704, True, 0, True, 164_720, None, None, False),
    # LWS(256, 8, L=3): the run-time path, no Q cap (4 + 128 rows of 135),
    # 22 of 63 rows of taps
    (129, 32, 3, 1, 160, True, 154, False, 71_280 + 154 * 1_032, None, None, False),
    # past the ring's fit: the window read from device memory
    (3073, 4, 5, 4, 800, False, 0, False, 49_328, None, None, False),
    # LWS(2048, 256)'s batch stencil (the vocoder): 4 + 32 rows of 1,035
    # pairs, the 148 x 8 table and 45 + 148 ints of lists; no tap planes
    (1025, 8, 5, 2, 544, True, 0, True, 149_040 + 9_472 + 772, 8, 148, True),
    # the same geometry with per-bin weights (P = F): the run-time kernel,
    # no row of taps (90,200 B) beside the rows
    (1025, 8, 5, 2, 544, True, 0, False, 149_040, 1025, 148, False),
    # LWS(4096, 512): the ring (263,552 B) does not fit; run-time, the window
    # in device memory, 1 of 15 rows of taps (180,312 B each)
    (2049, 8, 5, 3, 704, False, 11, False, 32_944 + 11 * 16_392, 8, 148, False),
]


def _plan_id(row):
    """The row's values joined by '-' (pytest's own name for them), the
    period, taps and table columns only where a period is given."""
    return "-".join(map(str, row if row[9] is not None else row[:9]))


@pytest.mark.parametrize("F,Q,L,bins,threads,ring,staged,fixed,nbytes,period,taps,table",
                         _PLAN_ROWS, ids=[_plan_id(r) for r in _PLAN_ROWS])
def test_sweep_plan_table(F, Q, L, bins, threads, ring, staged, fixed, nbytes, period, taps,
                          table):
    plan = sweeps_mod.sweep_plan(F, Q, L, period, taps)
    assert (plan.bins, plan.threads, plan.ring, plan.staged, plan.fixed, plan.bytes) == (
        bins, threads, ring, staged, fixed, nbytes)
    assert plan.table == table
    assert plan.taps == (2 * Q - 1) * (2 * L + 1) and plan.fits
    assert plan.width == F + 2 * L and plan.threads * plan.bins >= F and plan.staged % (2 * L + 1) == 0


def test_sweep_plan_past_one_block():
    """F = 16385 needs 17 bins per thread, and its two ping-pong rows alone
    262,320 B: no plan fits."""
    plan = sweeps_mod.sweep_plan(16385, 4, 5)
    assert plan.bins == 17 and not plan.ring and plan.bytes > sweeps_mod.SMEM_LIMIT
    assert not plan.fits


def _random_phase(F, T, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 1.0, (2, T, F))
    ph = rng.uniform(0, 2 * np.pi, A.shape)
    return (torch.tensor(A * np.cos(ph), dtype=torch.float32),
            torch.tensor(A * np.sin(ph), dtype=torch.float32))


def test_k1_gate_takes_q32_and_rejects_tpu_knobs(monkeypatch):
    """The wrapper's launch path at Q=32 (no cap any more), with the library
    and the stream stubbed: it builds the padded state and launches once
    with Q=32; a plan past the shared-memory limit raises naming
    backend='torch'; the TPU launch knobs still raise (micro is not one:
    micro > 1 runs the grouped sweeps, tests/test_torch_packed_plan.py)."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    fake = types.SimpleNamespace(lws_sweeps_launch=launch,
                                 lws_sweeps_error_string=lambda err: b"")
    monkeypatch.setattr(sweeps_mod, "_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    own = lws_torch.LWS(256, 8, L=3, device="cpu")
    st = own._st_batch
    assert st.Q == 32 > sweeps_mod.MAX_Q
    sr, si = _random_phase(129, 40, 0)
    thr = torch.tensor([0.1, 0.05], dtype=torch.float32)
    before = sweeps_mod.LAUNCHES
    out = sweeps_mod._launch(sr, si, st, thr, 1, "jacobi", None, None)
    assert sweeps_mod.LAUNCHES == before + 1 and len(calls) == 1
    assert calls[0][10:16] == (2, 40, 129, 32, 3, 2)  # B, T, F, Q, L, iters
    # the stub leaves the state as built: the interior is the input
    assert torch.equal(out[0], sr) and torch.equal(out[1], si)

    monkeypatch.setattr(sweeps_mod, "SMEM_LIMIT", 2_000)  # under the two 1,080 B rows
    with pytest.raises(ValueError, match="backend='torch'"):
        sweeps_mod._launch(sr, si, st, thr, 1, "jacobi", None, None)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="TPU launch knobs"):
        sweeps_mod.tiled_lws_sweeps(sr, si, st, thr, lane_fold=2)


def test_plain_q32_batch_matches_lws_tpu():
    """LWS(256, 8, L=3) (Q=32) at tests/test_oracle.py's input (2400 samples,
    seed 13), float64: the port's weights are lws_tpu's, and its plain
    batch_lws, 5 sweeps at alpha=1 from the magnitudes, reaches lws_tpu's
    float64 reference oracle within 0.1 dB of consistency (measured 0.0008
    dB; the oracle updates a frame's bins one by one, the port in one jacobi
    pass). lws_tpu's own Gauss-Seidel path at Q=32 costs ~35 s of XLA compile
    on the CPU; port_tools/port_vs_reference.py (section q32) holds the two
    bin by bin."""
    tp = lws_tpu.LWS(256, 8, L=3)
    own = lws_torch.LWS(256, 8, L=3, dtype=torch.float64, device="cpu")
    assert tp._Qi == own._Qi == 32
    np.testing.assert_array_equal(own.W, np.asarray(tp.W))
    x = np.random.default_rng(13).standard_normal(2400)
    A = np.abs(own.stft(x)).astype(np.complex128)
    thr = lws_torch.get_thresholds(5, 1, 0.1, 1)
    out = own.batch_lws(A, thresholds=thr)
    ref = oracle.oracle_sweeps(A, np.asarray(tp.W), thr)
    c_in, c_out, c_ref = (float(own.get_consistency(v)) for v in (A, out, ref))
    assert c_out > c_in + 5
    assert abs(c_out - c_ref) < 0.1, (c_out, c_ref)
    np.testing.assert_allclose(np.abs(out), np.abs(A), rtol=1e-12, atol=1e-12)


def test_free_functions_backend_and_dtype_rule():
    """backend= on the free functions: other values raise; on the CPU a
    complex128 input keeps float64 under either backend (the same result
    as before backend= existed: the plain path), complex64 stays float32;
    on CUDA, backend="auto" runs complex128 in float32 (the kernels) and
    backend="torch" in float64."""
    own = lws_torch.LWS(512, 128, device="cpu", dtype=torch.float64, inner_passes=1)
    rng = np.random.default_rng(4)
    S = rng.uniform(0.1, 1.0, (1, 24, 257)) * np.exp(2j * np.pi * rng.random((1, 24, 257)))
    thr = lws_torch.get_thresholds(2, 1, 0.1, 1)
    for fn, args in ((lws_torch.batch_lws, (own.W, thr)),
                     (lws_torch.nofuture_lws, (own.W_ai, thr)),
                     (lws_torch.online_lws, (own.W, own.W_ai, own.W_af, thr, 1))):
        with pytest.raises(ValueError, match="backend"):
            fn(S, *args, device="cpu", backend="cuda")
        auto = fn(S, *args, device="cpu")
        plain = fn(S, *args, device="cpu", backend="torch")
        assert auto.dtype == plain.dtype == np.complex128
        np.testing.assert_array_equal(auto, plain)
        assert fn(S.astype(np.complex64), *args, device="cpu").dtype == np.complex64
    np.testing.assert_array_equal(lws_torch.batch_lws(S, own.W, thr, device="cpu"),
                                  own.batch_lws(S, thresholds=thr))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert functional._work_dtype(np.complex128, cuda, "auto") == torch.float32
    assert functional._work_dtype(np.complex128, cuda, "torch") == torch.float64
    assert functional._work_dtype(np.complex128, cpu, "auto") == torch.float64
    assert functional._work_dtype(np.complex64, cuda, "torch") == torch.float32
