"""The masked-dense LWS stencil update, split-complex, in plain PyTorch.

Counterpart of lws_tpu/core/stencil.py. For every bin (m, n) of a
Hermitian-extended spectrogram:

    temp(m, n) = sum_{dr, dk} Wst[dr, dk, n] * S(m+dr, n+dk)
    S(m, n)   <- temp * amp(m, n) / |temp|     if amp > threshold and |temp| > 0

Spectrograms are split (sr, si) real planes, as in the JAX package. The
reference's branchy accelerations are masks: pruned weights are zeros in
Wst, the sparsity threshold is a `torch.where`, and causal / look-ahead
gating zeroes every tap with dr > v ("visibility", applied on the host in
`make_stencil`): v = Q-1 batch, v = 0 asym-full, v = -1 no-future.

This module is the plain version of the sweep kernel
(lws_torch/csrc/lws_sweeps.cu): it runs on any device, in float32 or
float64, and is what the kernel is held against on the card. Each frame's
tap sum is one vectorised product over the (2Q-1, 2L+1, F) unfolded patch,
not a Python loop over the taps.

The Jacobi orders update the whole grid at once: `apply_stencil` sums the
live taps over the extended grid, `apply_stencil_mxu` does the same sum as
banded matrix products (`Stencil.band_mats`), which lws_tpu computes outside
any Pallas kernel and which here go to `torch.matmul` under a local
`matmul_precision`. `safe_sqrt` is `torch.sqrt` with a finite derivative at
0, so autograd differentiates the plain sweeps through silent bins.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from .._device import resolve_device

RI = tuple  # (sr, si)


class _SafeSqrt(torch.autograd.Function):
    """torch.sqrt whose derivative is 0, not inf, where x == 0."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        pos = x > 0
        return torch.where(pos, g / (2 * torch.where(pos, y, torch.ones_like(y))),
                           torch.zeros_like(y))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """`torch.sqrt(x)`, bit for bit, with a zero gradient where x == 0
    (lws_tpu's safe_sqrt): d(sqrt)/dx at 0 is inf, which the phase update's
    masked branches would turn into NaN; a bin of zero magnitude holds its
    value, so 0 is the right subgradient there."""
    return _SafeSqrt.apply(x)


# precision= of the banded matmuls -> torch.set_float32_matmul_precision on
# CUDA: None and "highest" are full float32 (TF32 off, PyTorch's default),
# "high" lets float32 products run in TF32 on the tensor cores.
MATMUL_PRECISIONS = {None: "highest", "highest": "highest", "high": "high"}


def check_precision(precision) -> None:
    if precision not in MATMUL_PRECISIONS:
        raise ValueError("lws_torch: precision must be None, 'highest' or 'high', "
                         f"got {precision!r}")


@contextlib.contextmanager
def matmul_precision(device: torch.device, precision):
    """Set the float32 matmul precision for `precision` while the block runs
    on a CUDA `device`, and restore the caller's setting after it. The CPU
    runs every product in full precision; float64 products are exact anyway.
    The setting is process-wide while the block runs."""
    check_precision(precision)
    if device.type != "cuda":
        yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(MATMUL_PRECISIONS[precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@dataclass(frozen=True)
class Stencil:
    """Stencil tensor on the device + host-side tap mask."""

    Wr: torch.Tensor  # (2Q-1, 2L+1, F) real part, visibility mask pre-applied
    Wi: torch.Tensor  # (2Q-1, 2L+1, F) imag part
    nz: np.ndarray = field(repr=False)  # host bool (2Q-1, 2L+1): tap is nonzero
    Q: int = 0
    L: int = 0

    @property
    def n_bins(self) -> int:
        return self.Wr.shape[-1]

    @property
    def has_centre(self) -> bool:
        return bool(self.nz[self.Q - 1].any())

    @cached_property
    def period(self) -> int:
        """The weights' period in the bin index: Q when every bin n's taps
        equal bin n mod Q's bit for bit (summarized weights, where
        fsize % fshift == 0), else F. Decided once, from the tensors."""
        Q, F = self.Q, self.n_bins
        if Q >= F:
            return F
        col = torch.arange(F, device=self.Wr.device) % Q
        for w in (self.Wr, self.Wi):
            bits = w.view(torch.int32 if w.element_size() == 4 else torch.int64)
            if not torch.equal(bits, bits[..., col]):
                return F
        return Q

    @cached_property
    def _off_centre(self):
        """(row index, Wr, Wi) of the off-centre rows holding any live tap."""
        c = self.Q - 1
        rows = [dr for dr in range(2 * self.Q - 1)
                if dr != c and self.nz[dr].any()]
        idx = torch.tensor(rows, dtype=torch.long, device=self.Wr.device)
        return idx, self.Wr[idx], self.Wi[idx]

    def band_mats(self):
        """The banded (2Q-1, F+2L, F) matmul form of each row's frequency
        taps, M[dr, n+dk, n] = W[dr, dk, n], so one row's tap sum over the
        extended bins is one (..., T, F+2L) @ (F+2L, F) product (lws_tpu's
        Stencil.band_mats). Built on the host in float64 from the stencil's
        own values, per bin (fractional Q has per-bin weights), stored in the
        stencil's dtype and device, and cached with the stencil."""
        hit = self.__dict__.get("_band")
        if hit is None:
            F, Q, L = self.n_bins, self.Q, self.L
            Wr = self.Wr.detach().cpu().double().numpy()
            Wi = self.Wi.detach().cpu().double().numpy()
            Mr = np.zeros((2 * Q - 1, F + 2 * L, F))
            Mi = np.zeros_like(Mr)
            cols = np.arange(F)
            for dr in range(2 * Q - 1):
                for dk in range(2 * L + 1):
                    if self.nz[dr, dk]:
                        Mr[dr, cols + dk, cols] = Wr[dr, dk]
                        Mi[dr, cols + dk, cols] = Wi[dr, dk]
            hit = self.__dict__["_band"] = tuple(
                torch.as_tensor(m).to(self.Wr.device, self.Wr.dtype) for m in (Mr, Mi))
        return hit


def make_stencil(Wst_np: np.ndarray, Q: int, L: int, v: int, *, device=None,
                 dtype=torch.float32) -> Stencil:
    """Apply the dr <= v visibility mask and move the stencil to `device`.

    v = Q-1 keeps everything (batch LWS); v = 0 keeps past + centre frame
    (asym-full); v = -1 keeps strictly past frames (no-future / asym-init).
    """
    dr = np.arange(-(Q - 1), Q)
    masked = np.where((dr <= v)[:, None, None], Wst_np, 0.0)
    nz = np.any(np.abs(masked) > 0, axis=-1)
    dev = resolve_device(device)
    return Stencil(
        Wr=torch.as_tensor(np.ascontiguousarray(masked.real)).to(dev, dtype),
        Wi=torch.as_tensor(np.ascontiguousarray(masked.imag)).to(dev, dtype),
        nz=nz, Q=Q, L=L,
    )


def split(S, dtype=None, device=None) -> RI:
    """Host complex array -> (sr, si) pair on `device`."""
    S = np.asarray(S)
    if dtype is None:
        dtype = torch.float64 if S.dtype == np.complex128 else torch.float32
    dev = resolve_device(device)
    return (torch.tensor(S.real).to(dev, dtype),  # copies: S may be read-only
            torch.tensor(S.imag).to(dev, dtype))


def merge(sr: torch.Tensor, si: torch.Tensor) -> np.ndarray:
    """(sr, si) pair -> host complex numpy array."""
    return torch.complex(sr, si).cpu().numpy()


def freq_extend(sr: torch.Tensor, si: torch.Tensor, L: int) -> RI:
    """(..., T, F) -> (..., T, F+2L): conjugate-reflect below DC / above Nyquist.

    The left margin holds bins L..1, the right margin bins F-2..F-1-L, both
    with the imaginary part negated (ExtendSpec, lwslib/lwslib.cpp:27-40).
    """
    if L == 0:
        return sr, si
    lr = sr[..., 1:L + 1].flip(-1)
    li = -si[..., 1:L + 1].flip(-1)
    rr = sr[..., -L - 1:-1].flip(-1)
    ri = -si[..., -L - 1:-1].flip(-1)
    return torch.cat([lr, sr, rr], dim=-1), torch.cat([li, si, ri], dim=-1)


def time_extend(x: torch.Tensor, top: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """Attach the frozen (Q-1)-frame time halos (lwslib.cpp:21-25)."""
    return torch.cat([top, x, bot], dim=-2)


def make_time_halos(x: torch.Tensor, Q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Frozen edge-frame replica halos from the stage-input extended rows."""
    reps = [1] * (x.ndim - 2) + [Q - 1, 1]
    return x[..., :1, :].repeat(reps), x[..., -1:, :].repeat(reps)


def phase_update(tr, ti, amp, old_r, old_i, thr) -> RI:
    """Magnitude-preserving phase update with threshold skip, rsqrt form.

    scale = amp * rsqrt(a2) where a2 = |temp|^2 (1 where a2 == 0, so rsqrt
    stays finite); the update is kept only where amp > thr (strict, as
    lwslib.cpp:84-85) and a2 > 0 (lwslib.cpp:133-137), else the old value.
    The same formula as lws_tpu's phase_update and its kernel epilogues.
    The guard inside the rsqrt keeps the branch `where` does not take finite,
    so its gradient is 0, not NaN, at a zero sum.
    """
    a2 = tr * tr + ti * ti
    scale = amp * torch.rsqrt(torch.where(a2 > 0, a2, torch.ones_like(a2)))
    cond = (amp > thr) & (a2 > 0)
    return torch.where(cond, tr * scale, old_r), torch.where(cond, ti * scale, old_i)


def apply_stencil(xr: torch.Tensor, xi: torch.Tensor, st: Stencil) -> RI:
    """Jacobi tap sum over the whole extended grid: (..., T+2(Q-1), F+2L)
    -> (..., T, F), the live taps summed one by one in (dr, dk) order, as
    lws_tpu's apply_stencil."""
    Q, L = st.Q, st.L
    T = xr.shape[-2] - 2 * (Q - 1)
    F = st.n_bins
    tr = xr.new_zeros(xr.shape[:-2] + (T, F))
    ti = torch.zeros_like(tr)
    for dr in range(2 * Q - 1):
        for dk in range(2 * L + 1):
            if not st.nz[dr, dk]:
                continue
            wr, wi = st.Wr[dr, dk], st.Wi[dr, dk]
            br = xr[..., dr:dr + T, dk:dk + F]
            bi = xi[..., dr:dr + T, dk:dk + F]
            tr = tr + (wr * br - wi * bi)
            ti = ti + (wr * bi + wi * br)
    return tr, ti


def apply_stencil_mxu(xr: torch.Tensor, xi: torch.Tensor, st: Stencil,
                      precision=None) -> RI:
    """`apply_stencil` as banded matrix products: for each row dr with a
    live tap, the (2L+1)-tap sum over the extended bins is one
    (..., T, F+2L) @ (F+2L, F) product with `Stencil.band_mats`, four real
    products per complex one (lws_tpu's apply_stencil_mxu). The same sum in
    another order: within 1e-9 of `apply_stencil` in float64. `precision`
    (None, "highest", "high") sets the float32 matmul precision on CUDA
    (`matmul_precision`)."""
    Q = st.Q
    T = xr.shape[-2] - 2 * (Q - 1)
    Mr, Mi = st.band_mats()
    tr = ti = 0.0
    with matmul_precision(xr.device, precision):
        for dr in range(2 * Q - 1):
            if not st.nz[dr].any():
                continue
            br = xr[..., dr:dr + T, :]
            bi = xi[..., dr:dr + T, :]
            tr = tr + (torch.matmul(br, Mr[dr]) - torch.matmul(bi, Mi[dr]))
            ti = ti + (torch.matmul(br, Mi[dr]) + torch.matmul(bi, Mr[dr]))
    return tr, ti


def _parse_colors(scheme: str) -> tuple[int, int]:
    """'twocolor' -> (2, 1); 'colorK' -> (K, 1); 'colorKxR' -> (K, R)."""
    if scheme == "twocolor":
        return 2, 1
    if scheme.startswith("color"):
        body = scheme[5:]
        k, _, r = body.partition("x")
        return int(k), int(r) if r else 1
    raise ValueError(f"unknown inner_scheme: {scheme!r}")


def _taps(rows_r, rows_i, wr, wi, F: int) -> RI:
    """sum_{r, dk} w[r, dk, n] * rows[..., r, n+dk] over extended rows
    (..., R, F+2L) and weights (R, 2L+1, F), as one vectorised product."""
    ur = rows_r.unfold(-1, F, 1)  # (..., R, 2L+1, F): ur[.., r, dk, n] = rows[.., r, n+dk]
    ui = rows_i.unfold(-1, F, 1)
    return ((wr * ur - wi * ui).sum(dim=(-3, -2)),
            (wr * ui + wi * ur).sum(dim=(-3, -2)))


def update_frame(
    xr: torch.Tensor, xi: torch.Tensor, m: int, amp_m: torch.Tensor,
    st: Stencil, thr, inner_passes: int = 1, inner_scheme: str = "jacobi",
) -> RI:
    """Gauss-Seidel update of one frame (true index m) of the extended arrays.

    Reads the (2Q-1)-frame neighbourhood of (..., T+2(Q-1), F+2L) state,
    updates all F bins of frame m in parallel and writes the
    frequency-re-extended row back IN PLACE (xr, xi are modified and
    returned), as the reference mirrors updated margin bins at once
    (lwslib.cpp:139-145).

    In-frame flow, as in lws_tpu's update_frame:
      - inner_scheme="jacobi": `inner_passes` passes; each recomputes the
        centre-row taps from the previous pass's row, and the fallback of
        the select is always the ORIGINAL centre row;
      - inner_scheme="colorKxR": R rounds of K colors; bins n % K == color
        update against the evolving row, which is also their fallback.
    The off-centre taps are summed once; the centre taps separately; then
    temp = off-centre + centre.
    """
    Q, L = st.Q, st.L
    F = st.n_bins
    c = Q - 1
    pr = xr[..., m:m + 2 * Q - 1, :]
    pi = xi[..., m:m + 2 * Q - 1, :]

    idx, wr_off, wi_off = st._off_centre
    tr, ti = _taps(pr.index_select(-2, idx), pi.index_select(-2, idx),
                   wr_off, wi_off, F)

    wr_c, wi_c = st.Wr[c], st.Wi[c]

    def centre_taps(row_r, row_i):
        return _taps(row_r[..., None, :], row_i[..., None, :],
                     wr_c[None], wi_c[None], F)

    has_centre = st.has_centre
    row_r, row_i = pr[..., c, :], pi[..., c, :]
    old_r, old_i = row_r[..., L:L + F], row_i[..., L:L + F]
    if has_centre and inner_scheme != "jacobi":
        k, rounds = _parse_colors(inner_scheme)
        sel_of = torch.arange(F, device=xr.device) % k
        cur_r, cur_i = old_r, old_i
        for _round in range(rounds):
            for color in range(k):
                cr, ci = centre_taps(row_r, row_i)
                nr, ni = phase_update(tr + cr, ti + ci, amp_m, cur_r, cur_i, thr)
                sel = sel_of == color
                cur_r = torch.where(sel, nr, cur_r)
                cur_i = torch.where(sel, ni, cur_i)
                row_r, row_i = freq_extend(cur_r, cur_i, L)
    else:
        for _ in range(inner_passes if has_centre else 1):
            if has_centre:
                cr, ci = centre_taps(row_r, row_i)
                fr, fi = tr + cr, ti + ci
            else:
                fr, fi = tr, ti
            new_r, new_i = phase_update(fr, fi, amp_m, old_r, old_i, thr)
            row_r, row_i = freq_extend(new_r, new_i, L)

    xr[..., m + c, :] = row_r
    xi[..., m + c, :] = row_i
    return xr, xi
