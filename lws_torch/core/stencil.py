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

Not ported in this slice: `apply_stencil` / `band_mats` /
`apply_stencil_mxu` (the Jacobi orders, ROADMAP A12) and the `safe_sqrt`
gradient contract (A11).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from .._device import resolve_device

RI = tuple  # (sr, si)


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
    """
    a2 = tr * tr + ti * ti
    scale = amp * torch.rsqrt(torch.where(a2 > 0, a2, torch.ones_like(a2)))
    cond = (amp > thr) & (a2 > 0)
    return torch.where(cond, tr * scale, old_r), torch.where(cond, ti * scale, old_i)


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
