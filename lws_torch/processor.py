"""The LWS processor: the public API of the reference `lws` class.

Counterpart of lws_tpu/processor.py (reference: python/lws.pyx:378-499),
with the same constructor surface and per-Q defaults. Weights are built
once on the host in float64 (windows.py, weights.py) and moved to the
processor's device as split real/imag stencil tensors.

Device data are split (sr, si) real tensors. Every phase-recovery method
takes either a complex array (returns a host complex numpy array, as the
reference does) or an (sr, si) pair (returns a pair on the device, for
chaining). The batch and no-future stages go through the CUDA sweep kernel
for CUDA float32 data and through the plain PyTorch sweeps on the CPU or
with backend="torch" (lws_torch/ops/lws_sweeps.py); the online (RTISI-LA)
stage likewise through the CUDA online kernel or the plain frame-commit
loop (lws_torch/ops/online.py). run_lws is no-future -> online -> batch.

Long inputs, as lws_tpu (processor.py:535-651): on CUDA with
`auto_segment=True`, an utterance that leaves SMs idle runs as S time
segments (ops/segmented.py, K2 over K1), S = min(n_sm // B, 8, T // 2048)
when n_sm // B >= 2 (n_sm the card's SM count in place of lws_tpu's
sublane pack; the cap of 8 and the 2048-frame floor are lws_tpu's), with
halos exchanged every _SWEEPS_PER_EXCHANGE sweeps; past _MACRO_T frames
the sweeps run in macro chunks of about _MACRO_CHUNK frames with their
real neighbours as frozen halos and the whole signal's mean. The plan
depends on the device alone, not on the backend; on the CPU S = 1.

The Jacobi orders (order="jacobi", "jacobi_mxu"; precision= for the
latter's banded matmuls) run the plain whole-grid sweeps on every device,
as lws_tpu runs them in XLA only: no time segments (S = 1), macro chunks
past _MACRO_T as for "gs". The online stage ignores `order`, as lws_tpu's.
lws_tpu's TPU-only fallback to the Jacobi orders where its Pallas kernels
do not fit (`_xla_fallback`) has no counterpart: the sweep kernel takes
every Q its shared-memory plan fits, and a geometry it does not take
raises.

The processor runs on CUDA unless `device` names another device; without
CUDA and without `device`, construction raises. The kernels have no
backward: autograd through the stages needs backend="torch" (a CUDA tensor
that requires grad raises in the kernels' wrappers).

`batch_lws(mesh=...)` runs the batch sweeps time-sharded over the ranks
of a `lws_torch.parallel` mesh (torch.distributed), each shard on the
sweep kernel for CUDA float32 "gs" (lws_tpu.parallel's route). The TPU
launch knobs (pallas_*) are not carried over.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from . import stft as _stft
from ._device import real_dtype, resolve_device
from .core.batch import ORDERS, lws_sweeps
from .core.stencil import check_precision, make_stencil, merge, split
from .ops.lws_sweeps import sweep_plan, tiled_lws_sweeps
from .ops.online import packed_rtisi_la
from .ops.segmented import segmented_lws_sweeps
from .weights import build_stencil, create_weights
from .windows import (
    build_asymmetric_windows,
    default_window,
    get_thresholds,
    overlap_factor,
    synthwin,
)

__all__ = ["LWS", "lws"]


class LWS:
    """Fast spectrogram phase recovery using Local Weighted Sums, PyTorch.

    Constructor signature mirrors lws_tpu.LWS (python/lws.pyx:379-383);
    `mode='speech'` selects batch-only, `mode='music'` adds one no-future
    sweep and 10 online rounds before the batch sweeps. `device` (default
    CUDA) and `dtype` (float32 default, float64 supported on the plain
    path) place the processor; `backend` is "auto" (kernels on CUDA
    float32, plain PyTorch on the CPU) or "torch" (plain PyTorch anywhere).
    `order` is the batch and no-future stages' sweep order: "gs" (the
    reference's frame order, on the sweep kernel), "jacobi" or "jacobi_mxu"
    (whole-grid sweeps in plain PyTorch, the latter as banded matmuls whose
    float32 precision on CUDA `precision` sets: None or "highest" full
    float32, "high" TF32). `auto_segment` enables time segmentation and
    macro chunking of long inputs (lws_tpu's default, True).
    """

    # Macro time chunking past _MACRO_T frames, in chunks of about
    # _MACRO_CHUNK: lws_tpu's values (sized there for a 16 GB TPU), kept so
    # the seams fall where lws_tpu puts them. Instances may override them.
    _MACRO_T = 150_000
    _MACRO_CHUNK = 60_000
    # Frames per segment below which an utterance is not segmented, and the
    # most segments: lws_tpu's values. On an H100 the SM count's S = 14
    # lost 0.35 dB against S = 8 on a 630 s stream, so the cap stays.
    # Sweeps per halo exchange: lws_tpu exchanges every 10, which cost 0.17
    # dB at two segments of a 120 s stream against one; every 3 stays
    # within 0.08 dB there and, at S = 8 on 630 s, within 0.05 dB of every
    # 10, on three signals (port_tools/segment_plan_probe.py).
    _SEG_MIN_FRAMES = 2048
    _SEG_CAP = 8
    _SWEEPS_PER_EXCHANGE = 3

    def __init__(
        self,
        awin_or_fsize,
        fshift,
        L=5,
        swin=None,
        look_ahead=3,
        nofuture_iterations=0,
        nofuture_alpha=1,
        nofuture_beta=0.1,
        nofuture_gamma=1,
        online_iterations=0,
        online_alpha=1,
        online_beta=0.1,
        online_gamma=1,
        batch_iterations=100,
        batch_alpha=100,
        batch_beta=0.1,
        batch_gamma=1,
        symmetric_win=True,
        mode=None,
        fftsize=None,
        perfectrec=True,
        use_simplifications=True,
        dtype=None,
        order="gs",
        precision=None,
        inner_passes=None,
        inner_scheme=None,
        backend="auto",
        device=None,
        auto_segment=True,
    ):
        self.device = resolve_device(device)
        self.auto_segment = bool(auto_segment)
        self._n_sm = (torch.cuda.get_device_properties(self.device).multi_processor_count
                      if self.device.type == "cuda" else 0)
        if order not in ORDERS:
            raise ValueError(f"lws_torch: order must be one of {ORDERS}, got {order!r}")
        check_precision(precision)
        if order == "jacobi_mxu" and precision == "high":
            # lws_tpu warns at its reduced-precision default (bf16 passes),
            # which floored a pure tone at 19.74 dB against the elementwise
            # order's 23.67 (its PERF.md round-4); on CUDA None is full
            # float32, so only an explicit "high" reduces it
            warnings.warn(
                "lws_torch: order='jacobi_mxu' with precision='high' runs the banded "
                "matmuls in TF32 (10-bit mantissa), which can floor the consistency "
                "reachable on high-consistency material (lws_tpu's reduced-precision "
                "passes floored a pure tone near ~19 dB); pass precision='highest' or "
                "None for float32 results equal to order='jacobi'")
        if backend not in ("auto", "torch"):
            raise ValueError(f"backend must be 'auto' or 'torch', got {backend!r}")
        if isinstance(awin_or_fsize, (int, np.integer)):
            awin = default_window(int(awin_or_fsize), fshift, symmetric=symmetric_win)
        else:
            awin = np.asarray(awin_or_fsize, dtype=np.float64)
            if awin.ndim > 1:
                if awin.ndim > 2 or (awin.shape[0] > 1 and awin.shape[1] > 1):
                    raise ValueError("The analysis window should be flat")
                awin = awin.flatten()

        if fftsize is None:
            fftsize = len(awin)
        if fftsize > len(awin):
            # symmetric zero-padding of the windows (python/lws.pyx:399-410)
            if (fftsize - len(awin)) % 2 != 0:
                raise ValueError("The zero-padding should add even length to the original window.")
            warnings.warn(
                "lws_torch: fftsize exceeds the window length; the windows are "
                "symmetrically zero-padded, so samples within fftsize/2 of "
                "the signal boundaries lose perfect reconstruction "
                "(reference behaviour, python/lws.pyx:403-406)")
            pad = np.zeros((fftsize - len(awin)) // 2)
            awin = np.concatenate([pad, awin, pad])
            if swin is not None:
                swin = np.concatenate([pad, np.asarray(swin, dtype=np.float64), pad])

        if use_simplifications and not np.allclose(awin, awin[::-1]):
            # the summarized-weight simplifications assume a symmetric
            # analysis window, awin[t] == awin[T-1-t] (python/lws.pyx:452-454)
            warnings.warn(
                "lws_torch: the analysis window is not symmetric, but "
                "use_simplifications=True assumes awin[t] == awin[T-1-t]; "
                "pass use_simplifications=False for exact weights")
        self.awin = awin
        self.swin = synthwin(awin, fshift, swin=swin)
        self.fshift = int(fshift)
        self.fsize = len(awin)
        self.fftsize = int(fftsize)
        self.perfectrec = perfectrec
        self.L = int(L)
        self.look_ahead = int(look_ahead)
        self.use_simplifications = use_simplifications
        self.order = order
        self.precision = precision
        self.backend = backend
        self.rdtype = real_dtype(dtype)

        Qint, Qfloat = overlap_factor(self.fsize, self.fshift)
        self.Q = Qint if self.fsize % self.fshift == 0 else Qfloat
        self._Qi = Qint
        # per-Q in-frame defaults, as lws_tpu (QUALITY.md): red-black x3
        # rounds at Q <= 3, three in-frame jacobi re-passes in the batch
        # stage at 4 <= Q <= 7, one pass otherwise
        self.inner_scheme = inner_scheme
        if self.inner_scheme is None:
            self.inner_scheme = "color2x3" if Qint <= 3 else "jacobi"
        self.inner_passes = 1 if inner_passes is None else int(inner_passes)
        if inner_passes is None and self.inner_scheme == "jacobi" and 4 <= Qint <= 7:
            self.batch_inner_passes = 3
        else:
            self.batch_inner_passes = self.inner_passes

        if mode == "speech":
            nofuture_iterations = 0
            online_iterations = 0
        elif mode == "music":
            nofuture_iterations = 1
            online_iterations = 10

        self.batch_iterations = batch_iterations
        self.batch_alpha, self.batch_beta, self.batch_gamma = batch_alpha, batch_beta, batch_gamma
        self.online_iterations = online_iterations
        self.online_alpha, self.online_beta, self.online_gamma = online_alpha, online_beta, online_gamma
        self.nofuture_iterations = nofuture_iterations
        self.nofuture_alpha, self.nofuture_beta, self.nofuture_gamma = (
            nofuture_alpha, nofuture_beta, nofuture_gamma)

        # weight tensors (host, float64), reference-identical layout
        self.W = create_weights(self.awin, self.swin, self.fshift, self.L, use_simplifications)
        self.win_ai, self.win_af = build_asymmetric_windows(self.awin * self.swin, self.fshift)
        self.W_ai = create_weights(self.win_ai, self.swin, self.fshift, self.L, use_simplifications)
        self.W_af = create_weights(self.win_af, self.swin, self.fshift, self.L, use_simplifications)

        # stencils on the device for every visibility the pipeline needs
        nreal = self.fftsize // 2 + 1
        Q = self._Qi
        wst = build_stencil(self.W, nreal)

        def stencil(w, v):
            return make_stencil(w, Q, self.L, v=v, device=self.device, dtype=self.rdtype)

        self._st_batch = stencil(wst, Q - 1)
        self._st_nofuture = stencil(build_stencil(self.W_ai, nreal), -1)
        self._st_af = stencil(build_stencil(self.W_af, nreal), 0)
        self._st_la = [stencil(wst, min(d, Q - 1)) for d in range(1, self.look_ahead + 1)]

    # ---------------- analysis / synthesis ----------------

    def stft(self, x, framepadding=False):
        """STFT -> host complex array (reference-compatible; framepadding
        mirrors matlab/stft.m:43-46)."""
        return merge(*self.stft_ri(x, framepadding))

    def stft_ri(self, x, framepadding=False):
        """STFT -> (sr, si) pair on the processor's device."""
        return _stft.stft_ri(x, self.fsize, self.fshift, self.awin,
                             fftsize=self.fftsize, perfectrec=self.perfectrec,
                             framepadding=framepadding, device=self.device)

    def istft(self, S):
        """iSTFT: a host real array for a complex array, a tensor for a pair."""
        # swin is already normalised for perfect reconstruction at construction
        y = _stft.istft_ri(*self._as_pair(S), self.fshift, self.swin,
                           fftsize=self.fftsize, perfectrec=self.perfectrec)
        return y if self._is_pair(S) else y.cpu().numpy()

    def get_consistency(self, S):
        """Consistency in dB, one value per item: host array for a complex
        array, a tensor for a pair."""
        c = _stft.get_consistency_ri(*self._as_pair(S), self.fsize, self.fshift,
                                     self.awin, self.swin, fftsize=self.fftsize,
                                     perfectrec=self.perfectrec)
        return c if self._is_pair(S) else c.cpu().numpy()

    # ---------------- phase recovery schedules ----------------

    def _as_pair(self, S):
        if self._is_pair(S):
            pair = tuple(torch.as_tensor(s).to(self.device, self.rdtype) for s in S)
        else:
            pair = split(np.asarray(S), dtype=self.rdtype, device=self.device)
        if pair[0].shape[-1] % 2 == 0:
            raise ValueError(
                "Please only include non-negative frequencies in the input spectrogram.")
        return pair

    @staticmethod
    def _is_pair(S):
        return isinstance(S, (tuple, list)) and len(S) == 2

    def _ret(self, pair, was_pair):
        return pair if was_pair else merge(*pair)

    def _thr(self, iterations, alpha, beta, gamma, thresholds):
        if thresholds is None:
            thresholds = get_thresholds(iterations, alpha, beta, gamma)
        return torch.as_tensor(np.asarray(thresholds, dtype=np.float64)).to(
            self.device, self.rdtype)

    def _auto_segments(self, B, T):
        """Time segments for B utterances of T frames: S = min(n_sm // B, 8,
        T // 2048) when n_sm // B >= 2, else 1, with n_sm the processor's
        SM count (0 off CUDA, so S = 1 there); 1 with auto_segment=False."""
        if not self.auto_segment:
            return 1
        free = self._n_sm // max(1, B)
        if free < 2:
            return 1
        return max(1, min(free, self._SEG_CAP, T // self._SEG_MIN_FRAMES))

    def _macro_sweeps(self, pair, thr, st, inner_passes, inner_scheme):
        """The sweeps in macro chunks of about _MACRO_CHUNK frames, one after
        another, each with its real neighbour frames as frozen halos (edge
        replicas at the true edges) and the whole signal's mean magnitude,
        so a seam behaves like a segment seam that never exchanges."""
        sr, si = pair
        shape = sr.shape
        T, F = shape[-2:]
        sr, si = sr.reshape(-1, T, F), si.reshape(-1, T, F)
        B = sr.shape[0]
        Q1 = self._Qi - 1
        n = -(-T // self._MACRO_CHUNK)
        bounds = [round(i * T / n) for i in range(n + 1)]
        mean = torch.sqrt(sr * sr + si * si).mean(dim=(-2, -1))

        def edge_rows(x, lo, hi, edge):
            # rows [lo, hi) clamped to [0, T), the edge frame's replicas
            # where they fall outside
            part = x[:, max(lo, 0):min(hi, T)]
            miss = (hi - lo) - part.shape[1]
            if miss:
                pad = x[:, edge:edge + 1].expand(B, miss, F)
                part = torch.cat([pad, part] if lo < 0 else [part, pad], dim=1)
            return part

        outs_r, outs_i = [], []
        for a, b in zip(bounds[:-1], bounds[1:]):
            halo = (edge_rows(sr, a - Q1, a, 0), edge_rows(si, a - Q1, a, 0),
                    edge_rows(sr, b, b + Q1, T - 1), edge_rows(si, b, b + Q1, T - 1))
            o_r, o_i = self._sweep_fn((sr[:, a:b], si[:, a:b]), thr, st, inner_passes,
                                      inner_scheme, halo=halo, mean_amp=mean)
            outs_r.append(o_r)
            outs_i.append(o_i)
        return (torch.cat(outs_r, dim=1).reshape(shape),
                torch.cat(outs_i, dim=1).reshape(shape))

    def _sweep_fn(self, pair, thr, st, inner_passes, inner_scheme, halo=None,
                  mean_amp=None):
        """The batch / no-future dispatch: macro chunks past _MACRO_T frames
        (not inside a chunk); then the Jacobi orders' plain sweeps on the
        whole input; for "gs", segmented sweeps when the plan gives S > 1,
        else the sweep kernel (or its plain version) on the whole input."""
        sr, si = pair
        T = sr.shape[-2]
        if halo is None and self.auto_segment and T > self._MACRO_T:
            return self._macro_sweeps(pair, thr, st, inner_passes, inner_scheme)
        if self.order != "gs":
            return lws_sweeps(sr, si, st, thr, order=self.order, halo=halo,
                              mean_amp=mean_amp, precision=self.precision)
        S = self._auto_segments(sr.numel() // (T * sr.shape[-1]), T)
        kw = dict(inner_passes=inner_passes, inner_scheme=inner_scheme, halo=halo,
                  mean_amp=mean_amp, backend=self.backend)
        if S > 1:
            return segmented_lws_sweeps(sr, si, st, thr, segments=S,
                                        sweeps_per_exchange=self._SWEEPS_PER_EXCHANGE, **kw)
        return tiled_lws_sweeps(sr, si, st, thr, **kw)

    def nofuture_lws(self, S, iterations=None, thresholds=None):
        """No-future initialisation pass (strictly-past stencil, W_ai weights)."""
        if iterations is None:
            iterations = self.nofuture_iterations
        thr = self._thr(iterations, self.nofuture_alpha, self.nofuture_beta,
                        self.nofuture_gamma, thresholds)
        was_pair = self._is_pair(S)
        pair = self._as_pair(S)
        if thr.shape[0]:
            pair = self._sweep_fn(pair, thr, self._st_nofuture, 1, "jacobi")
        return self._ret(pair, was_pair)

    def online_lws(self, S, iterations=None, thresholds=None):
        """Online (TF-RTISI-LA) sliding-commit pass, look-ahead
        `look_ahead`, with the processor's inner_passes / inner_scheme
        (whatever `order` says)."""
        if iterations is None:
            iterations = self.online_iterations
        thr = self._thr(iterations, self.online_alpha, self.online_beta,
                        self.online_gamma, thresholds)
        was_pair = self._is_pair(S)
        pair = self._as_pair(S)
        if thr.shape[0]:
            pair = packed_rtisi_la(*pair, st_la=self._st_la, st_ai=self._st_nofuture,
                                   st_af=self._st_af, thresholds=thr,
                                   inner_passes=self.inner_passes,
                                   inner_scheme=self.inner_scheme, backend=self.backend)
        return self._ret(pair, was_pair)

    def batch_lws(self, S, iterations=None, thresholds=None, mesh=None, kernel=None,
                  sweeps_per_exchange=1):
        """Full batch LWS sweeps (the library default's main path).

        With `mesh` (a ('data', 'time') mesh of lws_torch.parallel), every
        rank of the mesh passes the whole S at once; the sweeps run
        time-sharded (lws_torch.parallel.sharded_lws_sweeps, halos exchanged
        between time neighbours) and every rank returns the whole result
        (all-gathered over both axes). `kernel` picks each shard's sweeps:
        None chooses "tiled" (the sweep kernel on blocks of
        `sweeps_per_exchange` sweeps) for CUDA float32 with order "gs", else
        "xla" (the plain sweeps of `order`, an exchange every sweep);
        "tiled" / "xla" force one. "tiled" on a geometry the kernel's plan
        does not fit raises, chosen or forced. With a mesh, macro chunks and
        time segments are bypassed: each shard runs whole; a mesh with one
        time shard runs the unsharded sweeps on each rank's utterances.
        """
        if iterations is None:
            iterations = self.batch_iterations
        thr = self._thr(iterations, self.batch_alpha, self.batch_beta,
                        self.batch_gamma, thresholds)
        was_pair = self._is_pair(S)
        pair = self._as_pair(S)
        if thr.shape[0] and mesh is not None:
            pair = self._sharded_sweeps(pair, thr, mesh, kernel, sweeps_per_exchange)
        elif thr.shape[0]:
            pair = self._sweep_fn(pair, thr, self._st_batch,
                                  self.batch_inner_passes, self.inner_scheme)
        return self._ret(pair, was_pair)

    def _sharded_sweeps(self, pair, thr, mesh, kernel, sweeps_per_exchange):
        """batch_lws over `mesh`: shard, sweep, gather (lws_tpu's
        processor.py:804-838 without its TPU-only VMEM plan)."""
        from .parallel import sharding

        if kernel is None:
            tiled = (self.device.type == "cuda" and self.rdtype == torch.float32
                     and self.backend == "auto" and self.order == "gs")
            kernel = "tiled" if tiled else "xla"
        if kernel == "tiled" and not sweep_plan(pair[0].shape[-1], self._Qi, self.L).fits:
            raise ValueError("tiled kernel cannot run this sharded geometry")
        local = sharding.shard_pair(pair, mesh, time_sharded=True)
        out = sharding.sharded_lws_sweeps(
            *local, st=self._st_batch, thresholds=thr, mesh=mesh, order=self.order,
            inner_passes=self.batch_inner_passes, kernel=kernel,
            sweeps_per_exchange=int(sweeps_per_exchange), inner_scheme=self.inner_scheme,
            backend=self.backend, precision=self.precision)
        return sharding.gather_pair(out, mesh)

    def run_lws(self, S):
        """The 3-stage pipeline: no-future -> online -> batch
        (python/lws.pyx:495-499); the pair stays on the device between
        stages."""
        was_pair = self._is_pair(S)
        pair = self.nofuture_lws(self._as_pair(S))
        pair = self.online_lws(pair)
        pair = self.batch_lws(pair)
        return self._ret(pair, was_pair)


# lowercase alias for drop-in compatibility with `lws.lws(...)`
lws = LWS
