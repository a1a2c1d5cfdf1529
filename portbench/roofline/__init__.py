"""Operations and bytes of the work a call needs, and the least time the
card needs for it (the larger of operations over the float32 peak and
bytes over the HBM bandwidth, `peaks.json`), stage by stage.

The counts are those of chip_smoke.py's `sweep_bound` and `online_bound`:
8 flops per live tap and bin (a complex multiply-add), the centre taps
once per in-frame pass, about 12 flops of epilogue per bin and pass, each
input and output plane touched once and each weight read once. They are
worked out from the configuration and the inputs alone (the taps from the
benchmark's own weights, the live sweeps from the magnitudes), so they
read the same whatever implements the work.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..reference import config

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS["f32_flop_s"], nbytes / PEAKS["hbm_byte_s"])


def _per_bin(n_off: int, n_cen: int, passes: int) -> int:
    if n_cen == 0:
        return 8 * n_off + 12
    return 8 * n_off + passes * (8 * n_cen + 12)


def sweep_counts(nz: np.ndarray, F: int, passes: int, live: np.ndarray, T: int
                 ) -> tuple[float, float]:
    """(flops, bytes) of the Gauss-Seidel sweeps over B items of T frames
    and F bins: live (B, iterations) marks the sweeps that change anything
    (the others are skipped); nz (2Q-1, 2L+1) the live taps."""
    R, K = nz.shape
    c = (R - 1) // 2
    n_c = int(nz[c].sum())
    n_off = int(nz.sum()) - n_c
    B = live.shape[0]
    flops = float(live.sum()) * T * F * _per_bin(n_off, n_c, passes)
    nbytes = 4.0 * (4 * B * T * F + 2 * R * K * F + live.size)
    return flops, nbytes


def online_counts(counts: np.ndarray, table: int, passes: int, T: int, F: int, B: int,
                  iters: int, LA: int) -> tuple[float, float]:
    """(flops, bytes) of RTISI-LA over T live frames: counts (2 + LA, 2)
    the live off-centre and centre taps of the sets [init, newest,
    look-ahead 1 .. LA], `table` the floats of their weights."""
    updates = {0: T, 1: iters * T}
    updates.update({1 + d: iters * max(0, T - d) for d in range(1, LA + 1)})
    flops = float(B * F * sum(n * _per_bin(int(counts[s][0]), int(counts[s][1]), passes)
                              for s, n in updates.items()))
    return flops, 4.0 * (5 * B * T * F + table + B * iters)


class Work:
    """The stencils' live taps and the thresholds of one configuration's
    program keys (reference/config.py)."""

    def __init__(self, cfg: dict):
        self.spec = spec = config.Program(cfg)
        self.nz = {k: np.any(np.abs(v) > 0, axis=-1) for k, v in spec.stencils().items()}
        online = ["ai", "af"] + [f"la{d}" for d in range(1, spec.LA + 1)]
        c = spec.Q - 1
        self.online_taps = np.array([[int(self.nz[k].sum() - self.nz[k][c].sum()),
                                      int(self.nz[k][c].sum())] for k in online])
        # the reference takes windows the hop divides: weights repeat with
        # period Q in the bin
        self.online_table = 2 * int(self.online_taps.sum()) * spec.Q

    def live(self, stage: str, amax: np.ndarray, mean: np.ndarray) -> np.ndarray:
        """(B, iterations): whether any bin of item b passes the threshold of
        sweep i, thresholds[i] * mean[b]."""
        return amax[:, None] > self.spec.thr[stage][None, :] * mean[:, None]

    def offline(self, entry: str, amax: np.ndarray, mean: np.ndarray, T: int) -> dict:
        """{stage: (flops, bytes)} of one call of `entry` on B items of T
        frames whose magnitudes have these per-item peaks and means."""
        sp, B = self.spec, amax.shape[0]
        out = {}
        for stage in sp.stages(entry):
            if stage == "online":
                out[stage] = online_counts(self.online_taps, self.online_table,
                                           sp.online_passes, T, sp.F, B,
                                           sp.iterations["online"], sp.LA)
            else:
                nz, passes = ((self.nz["ai"], 1) if stage == "nofuture"
                              else (self.nz["batch"], sp.batch_passes))
                out[stage] = sweep_counts(nz, sp.F, passes, self.live(stage, amax, mean), T)
        return out
