"""The numbers that decide `correct`: the program's answers against the
plain reference's, on the same inputs, in float64.

From a zero-phase start many tap sums nearly cancel, so a rounding
difference anywhere picks another phase for a few bins, which the later
sweeps carry to their neighbours: two correct float64 summation orders
already part in about half a percent of the bins by more than 1% of their
magnitude. So the spectrograms are compared bin by bin as a share of the
bins that part, next to checks with no such freedom: the magnitudes the
answer must keep, and the waveform the call returns against the reference
synthesis of the program's own spectrogram.
"""
from __future__ import annotations

import math

import torch

from . import lws_ref

# a bin parts when it differs from the reference by more than this share of
# its magnitude
PART = 1e-2


def offline_numbers(A, out, y, ref, tb) -> dict:
    """A (B, T, F) magnitudes the call was given, out (B, T, 2, F) its
    spectrogram, y (B, n) the waveform it returned or None where it returns
    the spectrogram, ref (B, T, 2, F) the reference's spectrogram; all
    float64 on one device.

    mag:          largest relative error of |out| against A over bins with A > 0
    bins_off:     largest share, over items, of the bins with A > 0 where
                  out and ref part
    cons_db:      largest gap, over items, between the consistency of out
                  and that of ref (dB)
    cons_db_mean: the mean of those gaps over items (dB)
    wave:         (with y) largest error of y against the reference iSTFT
                  of out, relative to that waveform's peak, over items
    """
    names = ("mag", "bins_off", "cons_db", "cons_db_mean") + (("wave",) if y is not None else ())
    if out.shape != ref.shape or (y is not None and y.shape[0] != out.shape[0]):
        return {k: math.inf for k in names}
    live = A > 0
    mag = torch.linalg.vector_norm(out, dim=2)
    rel = ((mag - A).abs() / torch.where(live, A, 1.0))[live]
    d = torch.linalg.vector_norm(out - ref, dim=2)
    part = ((d > PART * A) & live).sum(dim=(1, 2)) / live.sum(dim=(1, 2)).clamp_min(1)
    gap = (lws_ref.consistency(out, tb) - lws_ref.consistency(ref, tb)).abs()
    numbers = {"mag": float(rel.max()), "bins_off": float(part.max()),
               "cons_db": float(gap.max()), "cons_db_mean": float(gap.mean())}
    if y is not None:
        yr = lws_ref.istft(out, tb)
        numbers["wave"] = (math.inf if yr.shape != y.shape else
                           float(((y - yr).abs().amax(dim=1) / yr.abs().amax(dim=1)).max()))
    return numbers
