"""Operations and bytes of the mel vocoder's front end: the projection of
B x T frames of n_mels mel magnitudes onto F bins by the filterbank's
pseudo-inverse, and the clamp. Worked out from the shapes alone, like the
sweeps' counts (portbench/roofline), so they read the same whatever
implements the work."""
from __future__ import annotations


def projection_counts(B: int, T: int, n_mels: int, F: int) -> tuple[float, float]:
    """(flops, bytes) in float32: a multiply-add per mel band and bin of a
    frame and one compare per bin; the mels and the pseudo-inverse read
    once, the linear magnitudes written once."""
    flops = 2.0 * B * T * n_mels * F + B * T * F
    nbytes = 4.0 * (B * T * n_mels + n_mels * F + B * T * F)
    return flops, nbytes
