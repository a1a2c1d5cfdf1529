"""Carry parameters across from the JAX package.

`stencil_from_numpy` turns the arrays of an lws_tpu stencil, fetched as
numpy (`np.asarray(st.Wr)`, `np.asarray(st.Wi)`, `st.nz`), into the port's
`Stencil`, so that both packages can be fed identical weights. It takes
plain arrays: lws_torch imports nothing of lws_tpu.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.stencil import Stencil


def stencil_from_numpy(Wr, Wi, nz, Q: int, L: int, *, device=None,
                       dtype=torch.float32) -> Stencil:
    """A `Stencil` on `device` from real/imag weights (2Q-1, 2L+1, F) and the
    host tap mask (2Q-1, 2L+1)."""
    Wr = np.asarray(Wr)
    Wi = np.asarray(Wi)
    nz = np.asarray(nz, dtype=bool)
    shape = (2 * Q - 1, 2 * L + 1)
    if Wr.shape != Wi.shape or Wr.shape[:2] != shape or nz.shape != shape:
        raise ValueError(f"stencil arrays {Wr.shape}/{Wi.shape}/{nz.shape} do "
                         f"not fit Q={Q}, L={L}")
    dev = resolve_device(device)
    # torch.tensor copies: arrays fetched from jax are read-only
    return Stencil(Wr=torch.tensor(Wr).to(dev, dtype),
                   Wi=torch.tensor(Wi).to(dev, dtype),
                   nz=nz.copy(), Q=int(Q), L=int(L))
