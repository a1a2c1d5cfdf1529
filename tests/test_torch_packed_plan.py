"""The grouped sweeps on the CPU: the launch plan of the grouped sweep
kernel K5 (the Python mirror `ops.packed.packed_plan`) at the geometries
chip_smoke.py runs, the weight table K5 reads against the per-bin weight
planes, the arguments its wrapper launches it with (library stubbed), and
lws_tpu's entry points at micro > 1 (tiled_lws_sweeps, segmented_lws_sweeps)
against the port's, whose plain version runs here. The kernel itself runs
on the card (tests/test_torch_cuda.py, chip_smoke.py) and, rehearsed on the
CPU, in port_tools/cuda_on_cpu.py, which holds it bit for bit to the K5 of
revision b1968d1 (--old-packed) and the built library's plan to this
mirror.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lws_torch
import lws_tpu
from lws_torch.ops import lws_sweeps as sweeps_mod
from lws_torch.ops import online as online_mod
from lws_torch.ops import packed as packed_mod
from lws_torch.ops import segmented as seg_mod
from lws_tpu.ops.pallas_packed import segmented_lws_sweeps as jax_segmented
from lws_tpu.ops.pallas_packed import tiled_lws_sweeps as jax_tiled

# One torch thread: these small CPU ops gain nothing from more, and idle
# OpenMP threads spinning beside the other test processes slow them all.
torch.set_num_threads(1)

# (label, LWS arguments, micro, live taps G, period P, plan: elements per
# thread, threads, element stride, width, ring slots, ring, table, centre
# buffers, sums in shared memory, fixed kernel, elements sharing a bin,
# bytes, scratch). Shared memory: the tap lists
# 4 x (3 (2Q - 1) + G) bytes; the ring 8 x slots x width; the centre
# buffers 8 x 2 micro x width; the table 8 x G x P; the run-time kernel's
# sums 8 x micro x F. The scratch counts (re, im) pairs in device memory.
PLANS = [
    ("batch path input, micro 4", (512, 128), 4, 60, 4,
     (2, 544, 514, 267, 14, True, True, True, False, True, True, 49236, 0)),
    ("batch path input, micro 2", (512, 128), 2, 60, 4,
     (1, 544, 544, 267, 10, True, True, True, False, True, False, 32148, 0)),
    ("music batch stage, micro 4", (1024, 256), 4, 60, 4,
     (3, 704, 704, 523, 14, True, True, True, False, True, False, 94292, 0)),
    ("music batch stage, micro 2", (1024, 256), 2, 60, 4,
     (2, 544, 513, 523, 10, True, True, True, False, True, True, 60820, 0)),
    ("F = 2049, micro 5: ring in device memory", (4096, 1024), 5, 60, 4,
     (14, 736, 736, 2059, 16, False, True, True, False, False, False, 166964, 43189)),
    ("Q = 16, micro 2", (1024, 64), 2, 324, 16,
     (2, 544, 544, 523, 34, True, True, True, True, False, False, 210340, 0)),
    ("F = 8193, micro 2: ring and centre buffers in device memory", (16384, 4096), 2, 60, 4,
     (22, 768, 768, 8203, 10, False, True, False, True, False, False, 133332, 114842)),
    ("fractional weights (P = F): table in device memory", (576, 128), 2, 98, 289,
     (1, 608, 608, 299, 12, True, False, True, True, False, False, 43396, 0)),
]


@pytest.mark.parametrize("label,args,micro,taps,period,plan", PLANS, ids=[p[0] for p in PLANS])
def test_packed_plan(label, args, micro, taps, period, plan):
    p = lws_torch.LWS(*args, device="cpu")
    st = p._st_batch
    wt = packed_mod.packed_weights(st)
    assert (int(wt.dks.numel()), wt.period) == (taps, period)
    F = p.fftsize // 2 + 1
    got = packed_mod.packed_plan(F, st.Q, st.L, micro, taps, period)
    assert tuple(got) == plan
    assert got.fits and packed_mod.packed_supported(100, F, st.Q, st.L, micro)


def test_packed_supported_bounds():
    """Any micro at Q <= 16 and L + 1 <= F <= 16384; T and micro do not
    limit the plan (a group past T holds T frames)."""
    assert packed_mod.packed_supported(5000, 257, 4, 5, 1000)
    assert packed_mod.packed_supported(3, 16384, 16, 5, 2)
    assert not packed_mod.packed_supported(3, 16385, 4, 5, 2)
    assert not packed_mod.packed_supported(0, 257, 4, 5, 2)
    assert not packed_mod.packed_supported(100, 257, 4, 5, 0)


@pytest.mark.parametrize("args,stage", [((512, 128), "batch"), ((512, 128), "nofuture"),
                                        ((576, 128), "batch")])
def test_weight_table_reproduces_the_planes(args, stage):
    """K5's table (ops.online.weight_table of one set) holds, for every live
    tap and bin n, the per-bin plane's W[dr, dk, n] at column n mod P, bit
    for bit: P = Q for LWS(512, 128)'s summarized weights, P = F for
    LWS(576, 128)'s fractional ones; the dead taps are zero in every bin,
    and the rows list the live taps off-centre rows first, then the
    centre row, each in dk order."""
    p = lws_torch.LWS(*args, device="cpu")
    st = p._st_batch if stage == "batch" else p._st_nofuture
    wt = packed_mod.packed_weights(st)
    assert wt is packed_mod.packed_weights(st)  # cached with the stencil
    Q, L, F = st.Q, st.L, st.n_bins
    assert wt.period == (Q if args == (512, 128) else F)
    cols = torch.arange(F) % wt.period
    rows = wt.rows[0].numpy()
    order = [r for r in range(2 * Q - 1) if r != Q - 1] + [Q - 1]
    g = 0
    for dr in order:
        live = [dk for dk in range(2 * L + 1) if st.nz[dr, dk]]
        assert rows[dr, 1:].tolist() == [g, len(live)]
        assert rows[dr, 0] == sum(1 << dk for dk in live)
        for dk in live:
            assert int(wt.dks[g]) == dk
            for part, plane in ((0, st.Wr), (1, st.Wi)):
                got = wt.table[g, cols, part]
                assert torch.equal(got.view(torch.int32), plane[dr, dk].view(torch.int32))
            g += 1
        for dk in set(range(2 * L + 1)) - set(live):
            assert not bool(st.Wr[dr, dk].any()) and not bool(st.Wi[dr, dk].any())
    assert g == wt.dks.numel() == wt.table.shape[0]
    same = online_mod.weight_table([st])
    assert torch.equal(same.table, wt.table) and torch.equal(same.rows, wt.rows)


def test_grouped_launch_arguments(monkeypatch):
    """launch_grouped with the library and the stream stubbed: one launch
    of lws_packed_launch with the padded state, the table and its tap
    lists, a scratch of the plan's size (F = 2049 at micro 5 keeps its ring
    there), and (B, T, F, Q, L, iters, micro, passes, has_centre, G, P),
    counted in LAUNCHES; a geometry past K5 raises naming backend='torch'."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    fake = types.SimpleNamespace(lws_packed_launch=launch,
                                 lws_sweeps_error_string=lambda err: b"")
    monkeypatch.setattr(sweeps_mod, "_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    p = lws_torch.LWS(4096, 1024, device="cpu")
    st = p._st_batch
    rng = np.random.default_rng(0)
    sr = torch.tensor(rng.standard_normal((2, 12, 2049)), dtype=torch.float32)
    si = torch.tensor(rng.standard_normal((2, 12, 2049)), dtype=torch.float32)
    thr = torch.tensor([0.1, 0.05], dtype=torch.float32)
    before = packed_mod.LAUNCHES
    out = packed_mod.launch_grouped(sr, si, st, thr, 5, 3)
    assert packed_mod.LAUNCHES == before + 1 and len(calls) == 1
    args = calls[0]
    wt = packed_mod.packed_weights(st)
    assert args[3:6] == (wt.table.data_ptr(), wt.rows.data_ptr(), wt.dks.data_ptr())
    assert args[8] is not None  # the scratch: 43,189 pairs per CTA
    assert args[9:20] == (2, 12, 2049, 4, 5, 2, 5, 3, 1, 60, 4)
    assert torch.equal(out[0], sr) and torch.equal(out[1], si)  # the stub leaves the state
    st32 = lws_torch.LWS(256, 8, L=3, device="cpu")._st_batch  # Q = 32 > MAX_Q
    with pytest.raises(ValueError, match="backend='torch'"):
        packed_mod.launch_grouped(sr[..., :129], si[..., :129], st32, thr, 2, 1)
    assert len(calls) == 1


def _lws128(seed):
    """LWS(128, 32) (Q = 4, F = 65) in float64 for both packages, two items
    of 33 frames (micro 2 leaves a one-frame last group) from seeded random
    phases, 2 sweeps at alpha = 1."""
    tp = lws_tpu.LWS(128, 32, dtype=jnp.float64)
    own = lws_torch.LWS(128, 32, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 1.0, (2, 33, 65))
    S = A * np.exp(2j * np.pi * rng.random(A.shape))
    thr = lws_torch.get_thresholds(2, 1, 0.1, 1)
    return tp, own, S, thr, rng


@pytest.mark.parametrize("edges", [False, True], ids=["edge halos", "halo= mean_amp="])
def test_tiled_micro2_matches_lws_tpu(edges):
    """The port's tiled_lws_sweeps(micro=2) (C4: it raised) against
    lws_tpu's in interpret mode, 3 jacobi passes, float64: held at 1e-9;
    with halo= and mean_amp= given in the second case. It also equals the
    port's packed_lws_sweeps(micro=2) bit for bit without them."""
    tp, own, S, thr, rng = _lws128(3)
    halo = mean = None
    if edges:
        halo = tuple(rng.standard_normal((2, 3, 65)) * 0.5 for _ in range(4))
        mean = rng.uniform(0.3, 0.8, 2)
    jr, ji = jax_tiled(jnp.asarray(S.real), jnp.asarray(S.imag), tp._st_batch,
                       jnp.asarray(thr), micro=2, tile=8, inner_passes=3, interpret=True,
                       halo=None if halo is None else tuple(map(jnp.asarray, halo)),
                       mean_amp=None if mean is None else jnp.asarray(mean))
    kw = dict(micro=2, halo=None if halo is None else tuple(map(torch.tensor, halo)),
              mean_amp=None if mean is None else torch.tensor(mean))
    tr, ti = sweeps_mod.tiled_lws_sweeps(torch.tensor(S.real), torch.tensor(S.imag),
                                         own._st_batch, torch.tensor(thr), 3, "jacobi", **kw)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-9)
    if not edges:
        pr, pi = packed_mod.packed_lws_sweeps(torch.tensor(S.real), torch.tensor(S.imag),
                                              own._st_batch, torch.tensor(thr), 2, 3)
        assert torch.equal(tr, pr) and torch.equal(ti, pi)


def test_segmented_micro2_matches_lws_tpu():
    """The port's segmented_lws_sweeps(segments=2, micro=2) (C4: it raised)
    against lws_tpu's in interpret mode, float64, an exchange every sweep:
    held at 1e-9."""
    tp, own, S, thr, _ = _lws128(4)
    jr, ji = jax_segmented(jnp.asarray(S.real), jnp.asarray(S.imag), tp._st_batch,
                           jnp.asarray(thr), segments=2, micro=2, inner_passes=3,
                           interpret=True)
    tr, ti = seg_mod.segmented_lws_sweeps(torch.tensor(S.real), torch.tensor(S.imag),
                                          own._st_batch, torch.tensor(thr), segments=2,
                                          micro=2, inner_passes=3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-9)
