"""The gs gradient on chip_smoke.py's gradient input, port against lws_tpu.

    JAX_PLATFORMS=cpu python port_tools/gs_grad_witness.py

Not a test: a reading on the CPU (about two minutes). chip_smoke.py's
gradient phase backpropagates a waveform L2 loss through 3 sweeps to the
magnitudes of 4 utterances (5 s at 16 kHz, 0.25 s of silence at each end).
Under order "gs" one utterance's gradient reaches 1e9-1e17 where the
Jacobi orders stay near 3e-3. This prints, per utterance and for "gs" and
"jacobi": max|g| from the port (backend="torch") and from lws_tpu's jax.grad
(backend="xla"), each in float32 and float64; the port's float32 against
float64 forward and gradient; and the port's float64 forward against
lws_tpu's. Where the float64 forwards of the two packages part by O(max
amp), the forward itself is ill-conditioned (a frame-after-frame chain
through a near-zero tap sum), and its gradient is large in both packages.
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import lws_torch  # noqa: E402

ORDERS = ("gs", "jacobi")


def gradient_input():
    x = cs.make_batch(cs.GRAD_B, int(cs.MAIN_SECONDS * cs.SAMPLE_RATE), cs.SAMPLE_RATE,
                      np.random.default_rng(0))
    quiet = int(cs.GRAD_SILENCE * cs.SAMPLE_RATE)
    x[:, :quiet] = 0
    x[:, -quiet:] = 0
    return x, lws_torch.get_thresholds(cs.GRAD_SWEEPS, 1, 0.1, 1)


def port(x, thr, order, dtype):
    """(gradient, recovered (sr, si)) of the port on the CPU, as numpy."""
    p = lws_torch.LWS(512, 128, order=order, backend="torch", dtype=dtype, device="cpu")
    sr, si = p.stft_ri(x.astype(np.float64) if dtype == torch.float64 else x)
    a = torch.sqrt(sr * sr + si * si).requires_grad_()
    out = p.batch_lws((a, torch.zeros_like(a)), thresholds=thr)
    y = p.istft(out)
    loss = ((y[:, :x.shape[-1]] - torch.as_tensor(x, dtype=y.dtype)) ** 2).mean()
    loss.backward()
    return (a.grad.double().numpy(),
            tuple(o.detach().double().numpy() for o in out), a.detach().double().numpy())


def reference(x, thr, order):
    """(gradient, recovered (sr, si)) of lws_tpu's XLA path, numpy; the
    precision is jax's (float64 once x64 is on)."""
    import jax.numpy as jnp

    import lws_tpu
    p = lws_tpu.LWS(512, 128, order=order, backend="xla")
    sr, si = p.stft_ri(x)
    sq = sr * sr + si * si
    a0 = jnp.where(sq > 0, jnp.sqrt(jnp.where(sq > 0, sq, 1)), 0.0)
    target = jnp.asarray(x, dtype=a0.dtype)
    thr = jnp.asarray(thr, dtype=a0.dtype)

    def loss(a):
        y = p.istft(p._batch_fn(a, jnp.zeros_like(a), thresholds=thr))
        return jnp.mean((y[:, :x.shape[-1]] - target) ** 2)

    import jax
    g = np.asarray(jax.grad(loss)(a0), dtype=np.float64)
    out = p._batch_fn(a0, jnp.zeros_like(a0), thresholds=thr)
    return g, tuple(np.asarray(o, dtype=np.float64) for o in out)


def per_utt(f, *arrays):
    return ", ".join(f"{f(*(a[b] for a in arrays)):.3e}" for b in range(arrays[0].shape[0]))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    x, thr = gradient_input()
    gmax = lambda g: np.abs(g).max()  # noqa: E731
    rows = {}
    for order in ORDERS:
        g32, o32, _ = port(x, thr, order, torch.float32)
        g64, o64, amp = port(x, thr, order, torch.float64)
        rows[order] = dict(g32=g32, g64=g64, o32=o32, o64=o64, amp=amp,
                           j32=reference(x, thr, order)[0])
    jax.config.update("jax_enable_x64", True)
    for order in ORDERS:
        j64, jo64 = reference(x.astype(np.float64), thr, order)
        r = rows[order]
        amp = r["amp"]
        fwd = lambda a, b, c, d, m: max(np.abs(a - c).max(), np.abs(b - d).max()) / m.max()  # noqa: E731
        print(f"order {order!r}, {cs.GRAD_B} utterances, {cs.GRAD_SWEEPS} sweeps, "
              f"per utterance:")
        print(f"  max|g| port float32:      {per_utt(gmax, r['g32'])}")
        print(f"  max|g| port float64:      {per_utt(gmax, r['g64'])}")
        print(f"  max|g| lws_tpu float32:   {per_utt(gmax, r['j32'])}")
        print(f"  max|g| lws_tpu float64:   {per_utt(gmax, j64)}")
        print(f"  port float32 vs float64, forward max|d|/max amp: "
              f"{per_utt(fwd, r['o32'][0], r['o32'][1], r['o64'][0], r['o64'][1], amp)}")
        print(f"  port float32 vs float64, max|dg|/max|g64|: "
              f"{per_utt(lambda a, b: np.abs(a - b).max() / np.abs(b).max(), r['g32'], r['g64'])}")
        print(f"  float64 port vs lws_tpu, forward max|d|/max amp: "
              f"{per_utt(fwd, r['o64'][0], r['o64'][1], jo64[0], jo64[1], amp)}")


if __name__ == "__main__":
    main()
