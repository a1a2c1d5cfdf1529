"""Streaming (real-time chunked) online LWS, PyTorch.

Counterpart of lws_tpu/streaming.py. The reference's online mode
(TF_RTISI_LA, lwslib.cpp:1424-1492) is an offline function over a whole
spectrogram although the algorithm is a sliding frame-commit pipeline;
`StreamingLWS` exposes the pipeline as a stream: push raw audio (or
spectrogram frames, the vocoder case) in chunks of any size and receive
committed audio back with a latency of look_ahead + 1 frames plus the
analysis / synthesis overlap.

Every push runs one chunk pipeline on the stream's device (the processor's:
CUDA unless it was built with device="cpu"):

  framing and rfft of the block's samples (torch) -> the running mean of
  |frame| per stream, carried as (sum, count), or a fixed mean_amp (torch)
  -> the chunked online stage `ops.online.online_chunk` (kernel K4 for CUDA
  float32, its plain version lws_torch/core/online.py::online_chunk on the
  CPU or with backend="torch") -> irfft, synthesis window and overlap-add
  of the committed frames (torch).

State carried across pushes, per stream: the samples not yet framed (host),
the chunk state (the last LA+Q frames and LA+1 amp rows, on the device),
the mean totals, and the overlap-add tail. With an explicit mean_amp,
feeding a signal frame by frame commits the same frames as the processor's
online_lws on the whole spectrogram.

Not carried over from lws_tpu: its separate per-frame "xla" path (here one
pipeline serves both backends) and the TPU knob `interpret`.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .ops import online as _online
from .stft import c2r_spectrum, frame_signal, overlap_add
from .windows import get_thresholds

__all__ = ["StreamingLWS", "StreamStats"]


class StreamStats:
    """Serving observability: per-push latency and throughput of a stream.

    Recorded by the push entry points (a perf_counter pair per call, around
    the enqueue for emit="device"). Plays the run_lws.m tic/toc role
    (matlab/run_lws.m:85-148) for the streaming path.
    """

    def __init__(self, window: int = 8192):
        self._walls = collections.deque(maxlen=window)
        self.pushes = 0
        self.frames = 0
        self.samples = 0
        self.wall = 0.0

    def reset(self):
        """Zero the counters (e.g. after warm-up, to report steady-state
        serving latency only)."""
        self.__init__(window=self._walls.maxlen)

    def record(self, wall: float, frames: int, samples: int):
        self._walls.append(wall)
        self.pushes += 1
        self.frames += int(frames)
        self.samples += int(samples)
        self.wall += wall

    def summary(self, sample_rate: float | None = None) -> dict:
        """p50/p95/p99 push latency (s), pushes, frames, emitted samples and,
        with a sample_rate, the aggregate realtime factor per stream."""
        w = np.asarray(self._walls, dtype=np.float64)
        out = dict(pushes=self.pushes, frames=self.frames,
                   samples=self.samples, wall_s=self.wall)
        if w.size:
            out.update(p50_s=float(np.percentile(w, 50)),
                       p95_s=float(np.percentile(w, 95)),
                       p99_s=float(np.percentile(w, 99)))
        if sample_rate and self.wall > 0:
            out["realtime_factor"] = self.samples / sample_rate / self.wall
        return out


class StreamingLWS:
    """Chunked real-time online LWS around an LWS processor's weight sets.

    `streams > 1` runs that many independent streams in lockstep (one CTA
    each in the kernel, the vocoder-serving case): pushes then take and
    return arrays with a leading streams dimension.

    `block_frames` > 0: push / push_block consume whole blocks of that many
    frames (one chunk launch each) and keep the rest buffered until the next
    push or flush; 0 runs whatever a push completes as one chunk.

    `emit="host"` returns numpy audio (one device sync per push);
    `emit="device"` returns tensors on the stream's device without a sync.
    With `prefetch` (the default) each CUDA tensor a push or flush returns
    under emit="device" also starts a non-blocking copy into pinned host
    memory; `StreamingLWS.fetch(a)` waits for that copy alone and returns
    the numpy array, so a consumer that collects a few pushes behind finds
    the bytes already on the host. `a.cpu()` gives the same values.
    """

    def __init__(self, proc, iterations=None, thresholds=None, mean_amp=None,
                 streams: int = 1, keep_frames: bool = False,
                 backend: str = "auto", block_frames: int = 32, emit: str = "host",
                 prefetch: bool = True):
        if backend not in ("auto", "torch"):
            raise ValueError(f"backend must be 'auto' or 'torch', got {backend!r}")
        if emit not in ("host", "device"):
            raise ValueError(f"emit must be 'host' or 'device', got {emit!r}")
        self.proc = proc
        self.streams = int(streams)
        # committed_frames retention is opt-in: a long-running stream would
        # otherwise accumulate every committed frame on the host
        self.keep_frames = bool(keep_frames)
        self.device, self.dtype = proc.device, proc.rdtype
        if iterations is None:
            iterations = proc.online_iterations or 10
        if thresholds is None:
            thresholds = get_thresholds(iterations, proc.online_alpha,
                                        proc.online_beta, proc.online_gamma)
        self.thresholds = torch.as_tensor(np.asarray(thresholds, np.float64)).to(
            self.device, self.dtype)
        self.iters = int(self.thresholds.shape[0])
        self.mean_amp = mean_amp
        self.Q, self.L, self.LA = proc._Qi, proc.L, proc.look_ahead
        self.F = proc.fftsize // 2 + 1
        self.latency_frames = self.LA + 1
        self.backend = backend
        if backend == "auto" and self.device.type == "cuda":
            _online.check_online(self.F, self.Q, self.L, self.LA, self.dtype, chunk=True)
        self.block_frames = int(block_frames)
        self.emit = emit
        self.prefetch = bool(prefetch)
        self._awin = torch.as_tensor(proc.awin).to(self.device, self.dtype)
        self._swin = torch.as_tensor(proc.swin[:proc.fsize]).to(self.device, self.dtype)
        self._fixed = None
        if mean_amp is not None:
            fixed = np.broadcast_to(np.asarray(mean_amp, np.float64).reshape(-1),
                                    (self.streams,))
            self._fixed = torch.as_tensor(fixed.copy()).to(self.device, self.dtype)
        # cumulative across reset(): observability over a serving lifetime
        self.stats = StreamStats()
        self.reset()

    def reset(self):
        S = self.streams
        self._state = None  # ChunkState, from the first frame
        self._asum = torch.zeros(S, device=self.device, dtype=self.dtype)
        self._count = 0  # frames in the running mean (drains included)
        self._tail = torch.zeros((S, self.proc.fsize), device=self.device, dtype=self.dtype)
        self._frontier_tail = None  # unemitted overlap-add at the commit frontier
        self._frames_seen = 0
        self._live_seen = 0  # frames pushed live (drain steps excluded)
        self._sample_buf = np.zeros((S, 0))
        self.committed_frames: list = []

    # ------------------------------------------------------------------
    def _commit_range(self, n, n_live):
        """Valid rows of this chunk's committed slab: row m commits absolute
        frame frames_seen+m-LA, which must exist and have been pushed live
        (drain-padding rows past the flush tail commit dead frames)."""
        prev = self._frames_seen
        skip = max(0, self.LA - prev)
        end = min(n, self._live_seen + int(n_live) + self.LA - prev)
        return skip, end

    def _advance(self, fr, fi, n_live):
        """Advance the streams by the frames (S, n, F); frames >= n_live are
        drain steps. One chunk launch; returns the emitted audio (S, k)."""
        proc = self.proc
        fsize, fshift = proc.fsize, proc.fshift
        S, n, _ = fr.shape
        if self._state is None:
            self._state = _online.online_chunk_init(proc._st_la, proc._st_af, fr[:, 0], fi[:, 0])
        # the threshold scale (python/lws.pyx:361, over what the stream has
        # seen so far; a stream cannot see its future)
        fm = torch.sqrt(fr * fr + fi * fi).mean(dim=-1)
        if self._fixed is None:
            counts = torch.arange(self._count + 1, self._count + n + 1, device=fr.device,
                                  dtype=fr.dtype)
            means = (self._asum[:, None] + torch.cumsum(fm, dim=1)) / counts
        else:
            means = self._fixed[:, None].expand(S, n)
        self._asum = self._asum + fm.sum(dim=1)
        self._count += n

        skip, end = self._commit_range(n, n_live)
        end = max(skip, end)
        cr, ci, self._state = _online.online_chunk(
            fr, fi, self._state, means, proc._st_la, proc._st_nofuture, proc._st_af,
            self.thresholds, n_live, proc.inner_passes, proc.inner_scheme, self.backend)

        # rows outside [skip, end) are pipeline fill or flush padding: they
        # are zeroed before they reach the overlap-add
        spec = c2r_spectrum(cr, ci)
        spec[:, :skip] = 0
        spec[:, end:] = 0
        frames = torch.fft.irfft(spec, n=proc.fftsize, dim=-1)[..., :fsize] * self._swin
        ws = overlap_add(frames, fshift)
        ws[:, :fsize] += self._tail
        # the carried tail is anchored at row n; emission stops at the
        # commit frontier `end`, whose overlap flush() emits when end < n
        self._tail = ws[:, n * fshift:n * fshift + fsize]
        self._frontier_tail = ws[:, end * fshift:end * fshift + fsize]
        self._frames_seen += n
        self._live_seen += int(n_live)
        if self.keep_frames and end > skip:
            com = torch.complex(cr[:, skip:end], ci[:, skip:end]).cpu().numpy()
            self.committed_frames.extend(com[:, i] if S > 1 else com[0, i]
                                         for i in range(end - skip))
        return ws[:, skip * fshift:end * fshift]

    def _advance_samples(self, x, n_frames, n_live):
        """Advance by a raw-sample window (S, (n_frames-1)*fshift + fsize):
        framing, rfft and the threshold scale run on the stream's device."""
        proc = self.proc
        x = self._to_device(torch.as_tensor(x, dtype=self.dtype))
        frames = frame_signal(x, proc.fsize, proc.fshift, n_frames) * self._awin
        spec = torch.fft.rfft(frames, n=proc.fftsize, dim=-1)
        return self._advance(spec.real.contiguous(), spec.imag.contiguous(), n_live)

    def _ri(self, specs):
        """(n, [S,] F) frames, complex or magnitudes, numpy or torch ->
        (S, n, F) real / imag on the stream's device."""
        if not torch.is_tensor(specs):
            specs = torch.as_tensor(np.asarray(specs))
        specs = self._to_device(specs)
        specs = specs.reshape(specs.shape[0], self.streams, self.F).transpose(0, 1)
        if specs.is_complex():
            re, im = specs.real, specs.imag
        else:
            re, im = specs, torch.zeros_like(specs)
        return re.to(self.dtype).contiguous(), im.to(self.dtype).contiguous()

    def _to_device(self, t):
        """A host tensor on the stream's device. A copy to the card goes
        through pinned memory, non-blocking: from pageable memory the copy
        would wait for the stream's earlier work, and the pushes of
        emit="device" would no longer pipeline."""
        if self.device.type != "cuda" or t.is_cuda:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _samples(self, x) -> np.ndarray:
        if torch.is_tensor(x):
            x = x.detach().cpu()
        return np.asarray(x, dtype=np.float64).reshape(self.streams, -1)

    def _out(self, a):
        if self.streams == 1:
            a = a[0]
        return a if self.emit == "device" else a.cpu().numpy()

    def _empty(self):
        return self._out(self._tail.new_zeros((self.streams, 0)))

    # ------------------------------------------------------------------
    def _prefetch(self, a):
        """emit="device": start the non-blocking copy of the array the
        caller receives into pinned host memory (see fetch)."""
        if self.emit == "device" and self.prefetch and a.is_cuda and a.numel():
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            a.lws_prefetch = (host, done)
        return a

    @staticmethod
    def fetch(a) -> np.ndarray:
        """The host (numpy) copy of audio a push or flush returned: waits
        for its prefetch copy alone where one was started, else copies."""
        if isinstance(a, np.ndarray):
            return a
        pending = getattr(a, "lws_prefetch", None)
        if pending is None:
            return a.cpu().numpy()
        host, done = pending
        done.synchronize()
        return host.numpy()

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = self._prefetch(fn(*args))
        wall = time.perf_counter() - t0
        n = int(out.shape[-1])
        self.stats.record(wall, n // self.proc.fshift, n)
        return out

    def push_block(self, x):
        """Feed an audio chunk ([S,] n samples, frames at starts 0, fshift,
        ... of the stream, without perfectrec padding); returns the newly
        committed audio. Whole blocks of block_frames frames run, one chunk
        launch each; the rest stays buffered. Timed into .stats."""
        return self._timed(self._push_block, x)

    def push(self, x):
        """Feed audio samples; returns newly committed audio. The same
        pipeline as push_block (one chunk launch per whole block)."""
        return self._timed(self._push_block, x)

    def push_frame(self, spec, drain: bool = False):
        """Feed one spectrogram frame ([S,] F; complex with untrusted phase,
        or magnitudes, e.g. a streaming vocoder's output). Returns committed
        audio (empty while the look-ahead pipeline fills). drain=True shifts
        the pipeline without any update. Timed into .stats."""
        spec = spec[None] if torch.is_tensor(spec) else np.asarray(spec)[None]
        return self._timed(self._push_specs, spec, 0 if drain else 1)

    def push_frames(self, specs):
        """Feed N stacked spectrogram frames (N, [S,] F) in one chunk launch
        (the vocoder-serving entry when frames come in blocks). Timed into
        .stats."""
        return self._timed(self._push_specs, specs, None)

    def _push_specs(self, specs, n_live):
        fr, fi = self._ri(specs)
        n = fr.shape[1]
        return self._out(self._advance(fr, fi, n if n_live is None else n_live))

    def _push_block(self, x):
        proc = self.proc
        fsize, fshift = proc.fsize, proc.fshift
        self._sample_buf = np.concatenate([self._sample_buf, self._samples(x)], axis=-1)
        avail = self._sample_buf.shape[-1]
        n = (avail - fsize) // fshift + 1 if avail >= fsize else 0
        if self.block_frames:
            n = (n // self.block_frames) * self.block_frames
        if n == 0:
            return self._empty()
        nb = self.block_frames or n
        outs = []
        for i in range(0, n, nb):
            b = min(nb, n - i)
            w = self._sample_buf[:, i * fshift:i * fshift + (b - 1) * fshift + fsize]
            outs.append(self._advance_samples(w, b, b))
        self._sample_buf = self._sample_buf[:, n * fshift:]
        return self._out(torch.cat(outs, dim=-1))

    def flush(self):
        """Drain the pipeline: zero-pad so every frame holding buffered
        samples is pushed live, advance the look-ahead with LA drain steps
        (no updates: the tail frames keep their offline-final values),
        padded to whole blocks, and emit the overlap-add tail at the commit
        frontier."""
        proc = self.proc
        fsize, fshift = proc.fsize, proc.fshift
        S = self.streams
        pending = self._sample_buf.shape[-1]
        n_res = -(-pending // fshift)
        outs = []
        if self._state is not None or n_res:
            nb = self.block_frames
            total = n_res + self.LA
            total_pad = -(-total // nb) * nb if nb else max(total, 1)
            need = (total_pad - 1) * fshift + fsize
            buf = np.concatenate([self._sample_buf, np.zeros((S, need - pending))], axis=-1)
            step = nb or total_pad
            for i in range(0, total_pad, step):
                b = min(step, total_pad - i)
                w = buf[:, i * fshift:i * fshift + (b - 1) * fshift + fsize]
                outs.append(self._advance_samples(w, b, int(np.clip(n_res - i, 0, b))))
            # the commit frontier's tail, not the carried one: with
            # drain-padded blocks the true tail lies past the emitted rows
            outs.append(self._frontier_tail)
            self._tail = torch.zeros_like(self._tail)
            self._frontier_tail = None
        self._sample_buf = np.zeros((S, 0))
        if not outs:
            return self._empty()
        return self._prefetch(self._out(torch.cat(outs, dim=-1)))
