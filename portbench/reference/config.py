"""The program keys of a configuration, as the reference and the roofline
read them.

A configuration file's `program` object is handed whole to the program,
`lws_torch.LWS(fsize, fshift, **rest)`; the reference and the roofline
read the same object here, so the three follow one source. A key that the
reference does not model, or a value of one that it does not, raises:
the comparison would otherwise hold the program to another algorithm.
Keys left out take the library's defaults, as they do in the program.
"""
from __future__ import annotations

import numpy as np

from . import windows as W

STAGES = ("nofuture", "online", "batch")
DEFAULTS = {"L": 5, "look_ahead": 3, "nofuture_iterations": 0, "online_iterations": 0,
            "batch_iterations": 100, "batch_alpha": 100, "dtype": "float32", "order": "gs",
            "inner_passes": None,
            **{f"{s}_{k}": v for s in STAGES for k, v in (("beta", 0.1), ("gamma", 1))},
            "nofuture_alpha": 1, "online_alpha": 1}
KNOWN = {"fsize", "fshift", "precision"} | set(DEFAULTS)
# "gs": frame after frame (the library's); the Jacobi orders update every
# frame of a sweep from the last sweep, "jacobi_mxu" with banded matrix
# products that compute the same sums
ORDERS = ("gs", "jacobi", "jacobi_mxu")
DTYPES = ("float32", "float64")
# the control's precision: the nearest below the configuration's
LOWER = {"float64": "float32", "float32": "bfloat16"}

# the stages each offline entry of the processor runs, in order; a stage
# of no iterations is skipped
ENTRY_STAGES = {"batch_lws": ("batch",), "nofuture_lws": ("nofuture",),
                "online_lws": ("online",), "run_lws": STAGES}


class Program:
    """What the reference and the roofline take from `cfg["program"]`."""

    def __init__(self, cfg: dict):
        given = cfg["program"]
        unknown = sorted(set(given) - KNOWN)
        if unknown:
            raise ValueError(f"the reference does not model the program keys {unknown}")
        p = {**DEFAULTS, **given}
        if p["order"] not in ORDERS:
            raise ValueError(f"order {p['order']!r} is not one of {ORDERS}")
        if p.get("precision") not in (None, "highest"):
            # "high" runs the banded products in TF32: another precision
            raise ValueError("the reference computes at full precision: precision None "
                             "or 'highest'")
        if p["dtype"] not in DTYPES:
            raise ValueError(f"dtype {p['dtype']!r} is not one of {DTYPES}")
        self.fsize, self.fshift = int(p["fsize"]), int(p["fshift"])
        if self.fsize % self.fshift:
            raise ValueError("the reference takes windows that the hop divides")
        self.L, self.LA = int(p["L"]), int(p["look_ahead"])
        self.Q, _ = W.overlap(self.fsize, self.fshift)
        if self.Q < 4:
            # the program's in-frame scheme at Q <= 3 is red-black, which
            # the reference does not model
            raise ValueError("the reference takes an overlap Q >= 4")
        self.F = self.fsize // 2 + 1
        self.dtype, self.order = p["dtype"], p["order"]
        # in-frame passes: the program's default (lws_tpu's QUALITY.md) is
        # one pass, three in the batch sweeps at 4 <= Q <= 7; a stated
        # inner_passes holds for every stage but the no-future one. The
        # Jacobi orders sum every tap once (the online stage keeps its own)
        passes = p["inner_passes"]
        self.online_passes = 1 if passes is None else int(passes)
        self.batch_passes = (3 if 4 <= self.Q <= 7 else 1) if passes is None else int(passes)
        if self.order != "gs":
            self.batch_passes = 1
        self.iterations = {s: int(p[f"{s}_iterations"]) for s in STAGES}
        self.thr = {s: W.thresholds(self.iterations[s], p[f"{s}_alpha"], p[f"{s}_beta"],
                                    p[f"{s}_gamma"]) for s in STAGES}

    def stages(self, entry: str) -> list[str]:
        """The stages `entry` runs that have iterations."""
        if entry not in ENTRY_STAGES:
            raise ValueError(f"unknown entry {entry!r}")
        return [s for s in ENTRY_STAGES[entry] if self.iterations[s]]

    def stencils(self) -> dict:
        """The complex stencils (2Q-1, 2L+1, F) of every update: the batch
        sweeps', the no-future ('ai') and newest-frame ('af') ones, and the
        look-ahead frames' ('la1' ..)."""
        awin = W.default_window(self.fsize, self.fshift)
        swin = W.synthwin(awin, self.fshift)
        ai, af = W.asymmetric_windows(awin * swin, self.fshift)
        st = W.stencil(W.weights(awin, swin, self.fshift, self.L), self.F)
        out = {"batch": st,
               "ai": W.visible(W.stencil(W.weights(ai, swin, self.fshift, self.L), self.F), -1),
               "af": W.visible(W.stencil(W.weights(af, swin, self.fshift, self.L), self.F), 0)}
        out.update({f"la{d}": W.visible(st, min(d, self.Q - 1))
                    for d in range(1, self.LA + 1)})
        return out


def windows(fsize: int, fshift: int) -> tuple[np.ndarray, np.ndarray]:
    """(analysis, synthesis) windows of the library's default."""
    awin = W.default_window(fsize, fshift)
    return awin, W.synthwin(awin, fshift)
