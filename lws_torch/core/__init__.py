from .stencil import (
    Stencil,
    freq_extend,
    make_stencil,
    make_time_halos,
    merge,
    phase_update,
    split,
    time_extend,
    update_frame,
)
from .batch import lws_sweeps

__all__ = [
    "Stencil",
    "make_stencil",
    "freq_extend",
    "time_extend",
    "make_time_halos",
    "phase_update",
    "update_frame",
    "split",
    "merge",
    "lws_sweeps",
]
