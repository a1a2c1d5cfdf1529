"""The plain reference against lws_torch's plain backend, in float64 at tiny
sizes, and its CUDA graph against its eager run on a card.

From the same inputs the two are two summation orders of one algorithm:
float64 leaves them within 1e-9 of the peak magnitude (the batch sweeps:
a handful of live sweeps, before the two orders' rounding grows)."""
import numpy as np
import pytest
import torch

from portbench import generate, harness
from portbench.reference import config as C
from portbench.reference import lws_ref as R
from portbench.reference import windows as W

TOL = 1e-9


def _cfg(name, **kw):
    cfg = generate.load("configs", name)
    return dict(cfg, program=dict(cfg["program"], **kw))


def _signals(n=4000, B=2, seed=3):
    return generate.make_batch(B, n, 16000, np.random.default_rng(seed)).astype(np.float64)


def _proc(cfg):
    """The program of the configuration, in float64 on the CPU."""
    import lws_torch
    return harness.program(lws_torch, dict(cfg, program=dict(cfg["program"], dtype="float64")),
                           "cpu")


def _tables(cfg, dtype=torch.float64, device="cpu", **kw):
    return R.Tables(C.Program(dict(cfg, program=dict(cfg["program"], dtype="float64"))),
                    device, dtype, **kw)


@pytest.mark.parametrize("name", ["speech16k", "music16k"])
def test_windows_and_weights_match_the_port(name):
    cfg = _cfg(name)
    p, prog = _proc(cfg), cfg["program"]
    awin = W.default_window(prog["fsize"], prog["fshift"])
    assert np.array_equal(awin, p.awin)
    assert np.array_equal(W.synthwin(awin, prog["fshift"]), p.swin)
    st = C.Program(cfg).stencils()["batch"]
    assert np.allclose(st.real, p._st_batch.Wr.numpy(), rtol=0, atol=1e-15)
    assert np.allclose(st.imag, p._st_batch.Wi.numpy(), rtol=0, atol=1e-15)


@pytest.mark.parametrize("name", ["speech16k", "music16k"])
def test_stft_istft_consistency(name):
    cfg = _cfg(name)
    p, tb = _proc(cfg), _tables(cfg)
    x = _signals()
    S = R.stft(torch.as_tensor(x), tb)
    sr, si = p.stft_ri(x)
    assert torch.equal(S[:, :, 0], sr) and torch.equal(S[:, :, 1], si)
    assert torch.allclose(R.istft(S, tb), p.istft((sr, si)), rtol=0, atol=1e-12)
    assert torch.allclose(R.consistency(S, tb), p.get_consistency((sr, si)), rtol=1e-9)


def test_istft_drops_the_imaginary_parts_of_dc_and_nyquist():
    """numpy's irfft, which the library synthesises with, ignores them."""
    cfg = _cfg("speech16k")
    tb = _tables(cfg, stencils=False)
    rng = np.random.default_rng(0)
    S = torch.as_tensor(rng.standard_normal((1, 6, 2, tb.F)))
    spec = S[0, :, 0].numpy() + 1j * S[0, :, 1].numpy()
    frames = np.fft.irfft(spec, n=tb.fsize) * tb.swin.numpy()
    assert np.allclose(R.synth_frames(S, tb)[0].numpy(), frames, rtol=0, atol=1e-14)


@pytest.mark.parametrize("entry,name,order", [("batch_lws", "speech16k", "gs"),
                                              ("run_lws", "music16k", "gs"),
                                              ("batch_lws", "speech16k", "jacobi"),
                                              ("batch_lws", "speech16k", "jacobi_mxu")])
def test_offline_paths(entry, name, order):
    cfg = _cfg(name, batch_iterations=4, batch_alpha=0.3, order=order)
    p, tb = _proc(cfg), _tables(cfg)
    if order == "gs":  # the Jacobi orders ignore the in-frame passes
        assert (tb.batch_passes, tb.online_passes) == (p.batch_inner_passes, p.inner_passes)
    sr, si = p.stft_ri(_signals(2400))
    A = torch.sqrt(sr * sr + si * si)
    out = getattr(p, entry)((A, torch.zeros_like(A)))
    ref = R.offline(A, tb, entry)
    assert not torch.equal(ref[:, :, 1], torch.zeros_like(A))
    d = max(float((ref[:, :, k] - out[k]).abs().max()) for k in (0, 1))
    assert d <= TOL * float(A.max())


def test_unknown_program_keys_raise():
    """A key the reference does not model would hold the program to
    another algorithm: the reference and the roofline refuse it."""
    for kw in ({"inner_scheme": "color2x3"}, {"order": "red_black"}, {"mode": "music"},
               {"order": "jacobi_mxu", "precision": "high"}):
        with pytest.raises(ValueError):
            C.Program(_cfg("speech16k", **kw))


@pytest.mark.cuda
def test_cuda_graph_equals_eager(cuda):
    cfg = _cfg("speech16k")
    tb = _tables(cfg, device=cuda)
    x = torch.as_tensor(_signals(8000), device=cuda)
    A = torch.linalg.vector_norm(R.stft(x, tb), dim=2)
    X = torch.stack([A, torch.zeros_like(A)], dim=2)
    runs = [R.gs_sweeps(X, tb.mats["batch"], tb.thr["batch"], 3, graphs=g) for g in (False, True)]
    assert torch.equal(*runs)
