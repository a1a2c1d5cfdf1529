"""Gradients through lws_torch's plain sweeps against jax.grad of lws_tpu,
on the CPU in float64 (the gradient contract of tests/test_grad.py).

The port's kernels have no backward, as lws_tpu's Pallas kernels have none;
autograd differentiates the plain PyTorch versions (backend="torch", and
the CPU), magnitude in, recovered phase out. The hazard is the square root
at exactly-zero bins (silence, padding): d(sqrt)/dx at 0 is inf, and a
masked branch turns it into NaN. So the magnitudes go through `safe_sqrt`
and the phase update keeps its double-`where` guard, and every gradient
below must be finite, nonzero, and within 1e-8 x max|g| of lws_tpu's on
lws_tpu's zero-bin fixture. The online stage and gs with color2x3 x 3
passes: tests/test_torch_grad_online.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lws_torch
import lws_tpu
from lws_torch.core.stencil import phase_update, safe_sqrt
from lws_torch.ops import lws_sweeps as sweeps_mod
from lws_torch.ops import online as online_mod

torch.set_num_threads(1)

REL_TOL = 1e-8


def mag_with_zeros(B=2, secs=0.35, sr_hz=8000):
    """tests/test_grad.py's fixture: signals that start and end in exact
    silence, so the spectrograms hold exactly-zero bins."""
    rng = np.random.default_rng(11)
    n = int(secs * sr_hz)
    x = np.zeros((B, n))
    t = np.arange(n // 2) / sr_hz
    x[:, n // 4:n // 4 + n // 2] = (
        np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal((B, n // 2)))
    sr, si = lws_tpu.LWS(128, 32).stft_ri(x)
    sq = np.asarray(sr * sr + si * si)
    amp = np.where(sq > 0, np.sqrt(np.where(sq > 0, sq, 1)), 0.0)
    assert (amp == 0).sum() > 0, "fixture must contain zero bins"
    return amp


def grads(stage, iters, alpha, **kw):
    """(port's gradient, lws_tpu's) of sum|out|^2 + <out, w> (w a seeded
    random projection, so the gradient sees the phases) with respect to the
    magnitudes, zero phase in."""
    amp = mag_with_zeros()
    rng = np.random.default_rng(5)
    wr, wi = rng.standard_normal(amp.shape), rng.standard_normal(amp.shape)
    thr = lws_tpu.get_thresholds(iters, alpha, 0.1, 1)
    j = lws_tpu.LWS(128, 32, backend="xla", **kw)
    fn_j = j._batch_fn if stage == "batch" else j._online_fn

    def loss_j(a):
        o = fn_j(a, jnp.zeros_like(a), thresholds=jnp.asarray(thr))
        return jnp.sum(o[0] ** 2 + o[1] ** 2) + jnp.sum(o[0] * wr + o[1] * wi)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(amp)))
    t = lws_torch.LWS(128, 32, backend="torch", dtype=torch.float64, device="cpu", **kw)
    a = torch.tensor(amp, requires_grad=True)
    o = getattr(t, f"{stage}_lws")((a, torch.zeros_like(a)), thresholds=thr)
    loss = (o[0] ** 2 + o[1] ** 2).sum() + (o[0] * torch.tensor(wr) + o[1] * torch.tensor(wi)).sum()
    loss.backward()
    return a.grad.numpy(), g_j


def check(g_t, g_j):
    assert np.isfinite(g_t).all()
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=REL_TOL * scale)


@pytest.mark.parametrize("order", ["jacobi", "jacobi_mxu", "gs"])
def test_batch_grad_matches_lws_tpu(order):
    """3 sweeps at alpha=1 (the sweeps update most bins; at alpha=100 most
    sweeps are dead and the gradient is the identity's)."""
    check(*grads("batch", 3, 1.0, order=order,
                 **({"precision": "highest"} if order == "jacobi_mxu" else {})))


def test_grad_to_waveform_loss():
    """d(time-domain L2)/d(magnitude) through the Jacobi sweeps and the
    iSTFT, the shape of a vocoder's training loss (tests/test_grad.py's
    waveform test), against lws_tpu's."""
    n = 2000
    x = np.zeros((1, n))
    x[:, 400:1600] = np.sin(2 * np.pi * 330 * np.arange(1200) / 8000)
    thr = lws_tpu.get_thresholds(2, 100, 0.1, 1)
    j = lws_tpu.LWS(128, 32, backend="xla", order="jacobi")
    sr, si = j.stft_ri(x)
    target = j.istft((sr, si))
    amp = np.asarray(jnp.sqrt(jnp.maximum(sr * sr + si * si, 1e-30)))

    def loss_j(a):
        o = j._batch_fn(a, jnp.zeros_like(a), thresholds=jnp.asarray(thr))
        y = j.istft(o)
        m = min(y.shape[-1], target.shape[-1])
        return jnp.mean((y[..., :m] - target[..., :m]) ** 2)

    v_j, g_j = jax.value_and_grad(loss_j)(jnp.asarray(amp))
    t = lws_torch.LWS(128, 32, backend="torch", order="jacobi", dtype=torch.float64,
                      device="cpu")
    tgt = torch.tensor(np.asarray(target))
    a = torch.tensor(amp, requires_grad=True)
    y = t.istft(t.batch_lws((a, torch.zeros_like(a)), thresholds=thr))
    m = min(y.shape[-1], tgt.shape[-1])
    loss = ((y[..., :m] - tgt[..., :m]) ** 2).mean()
    loss.backward()
    v_t = float(loss.detach())
    assert np.isfinite(v_t) and abs(v_t - float(v_j)) <= 1e-12 * abs(float(v_j))
    check(a.grad.numpy(), np.asarray(g_j))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_safe_sqrt_forward_is_sqrt(dtype):
    rng = np.random.default_rng(7)
    x = torch.tensor(np.abs(rng.standard_normal(4096)) ** 3, dtype=dtype)
    x[::7] = 0
    x[1::11] = torch.finfo(dtype).tiny
    y = safe_sqrt(x)
    assert torch.equal(y, torch.sqrt(x)) and y.dtype == dtype


def test_safe_sqrt_gradient():
    """0 where x == 0; 1 / (2 sqrt x) elsewhere (torch.sqrt's)."""
    x = torch.tensor([0.0, 0.25, 4.0, 0.0, 1e-300], dtype=torch.float64, requires_grad=True)
    safe_sqrt(x).sum().backward()
    want = torch.tensor([0.0, 1.0, 0.25, 0.0, 0.5e150], dtype=torch.float64)
    torch.testing.assert_close(x.grad, want, rtol=1e-15, atol=0)
    x2 = x.detach().clone().requires_grad_()
    torch.sqrt(x2).sum().backward()
    assert not torch.isfinite(x2.grad[0])  # the hazard safe_sqrt removes


def test_phase_update_guard_forward_identity_and_grad():
    """The double-where guard changes no forward value (against the
    unguarded rsqrt form on positive sums), keeps the old value bit for bit
    at a zero sum, and gives that bin a finite (zero) gradient."""
    rng = np.random.default_rng(5)
    tr, ti, old_r, old_i = (torch.tensor(rng.standard_normal((4, 8))) for _ in range(4))
    amp = torch.tensor(np.abs(rng.standard_normal((4, 8))) + 0.1)
    out_r, out_i = phase_update(tr, ti, amp, old_r, old_i, 0.0)
    scale = amp * torch.rsqrt(tr * tr + ti * ti)
    assert torch.equal(out_r, tr * scale) and torch.equal(out_i, ti * scale)
    zr = torch.zeros_like(tr, requires_grad=True)
    zi = torch.zeros_like(ti, requires_grad=True)
    a = amp.clone().requires_grad_()
    r, i = phase_update(zr, zi, a, old_r, old_i, 0.0)
    assert torch.equal(r, old_r) and torch.equal(i, old_i)
    (r.sum() + i.sum()).backward()
    for g in (zr.grad, zi.grad, a.grad):
        assert torch.isfinite(g).all() and not g.any()


def test_kernel_wrappers_refuse_grad():
    """A tensor that requires grad must not reach a CUDA kernel, which
    returns no grad_fn: K1 / K5's launcher and K3 / K4's checks raise a
    ValueError naming backend='torch' before anything else (so CPU tensors
    show it here; on a card chip_smoke.py shows it through the processor).
    Under torch.no_grad() no gradient is lost, and nothing is refused."""
    t = lws_torch.LWS(512, 128, device="cpu")
    sr = torch.ones(1, 8, 257, requires_grad=True)
    si = torch.zeros(1, 8, 257)
    thr = torch.ones(2)
    with pytest.raises(ValueError, match="backend='torch'"):
        sweeps_mod.launch_padded("lws_sweeps_launch", sr, si, t._st_batch, thr, None, None,
                                 (t._st_batch.Wr, t._st_batch.Wi), (1, 0, 1, 1))
    with pytest.raises(ValueError, match="backend='torch'"):
        online_mod._check(sr, si, t._st_la, t._st_nofuture, t._st_af, [], chunk=False)
    halo = tuple(torch.zeros(1, 3, 257, requires_grad=k == 2) for k in range(4))
    with pytest.raises(ValueError, match="backend='torch'"):
        sweeps_mod.refuse_grad("entry", sr.detach(), halo)
    with torch.no_grad():
        sweeps_mod.refuse_grad("entry", sr, halo)
    sweeps_mod.refuse_grad("entry", sr.detach(), None, halo[:2])
