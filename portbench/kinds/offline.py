"""Offline resynthesis, closed loop, one caller.

Each call hands one set of magnitudes at zero phase to the processor's
`entry` (`batch_lws`, `run_lws`, `nofuture_lws` or `online_lws`), then
fetches what the caller asked for to the host: with `returns` "waveform"
the iSTFT of the result, with "spectrogram" the result's two planes.
Calls cycle through a pool of seeded sets, so each sees other audio.

Traffic keys: `entry`, `returns`, `items` signals of `seconds` seconds a
set, `pool` sets, `checked` of them (drawn from the seed) compared with
the reference, `warm_calls` calls of set-up.
"""
from __future__ import annotations

import torch

from .. import generate, harness, roofline
from ..reference import compare, config, lws_ref

RETURNS = ("waveform", "spectrogram")


class Driver:
    def __init__(self, lws_torch, cfg, traffic, seed, device):
        self.cfg, self.entry, self.returns = cfg, traffic["entry"], traffic["returns"]
        if self.returns not in RETURNS:
            raise ValueError(f"returns must be one of {RETURNS}, got {self.returns!r}")
        self.spec = config.Program(cfg)
        self.spec.stages(self.entry)  # an entry the reference does not know raises here
        self.proc = harness.program(lws_torch, cfg, device)
        x = generate.signals(seed, traffic, cfg)
        P, B, n = x.shape
        tb = lws_ref.Tables(self.spec, device, torch.float64, stencils=False)
        S = lws_ref.stft(torch.as_tensor(x, device=device).double().reshape(P * B, n), tb)
        A = torch.linalg.vector_norm(S, dim=2).to(getattr(torch, self.spec.dtype))
        self.A = list(A.reshape(P, B, *A.shape[1:]))
        self.zero = torch.zeros_like(self.A[0])
        self.audio_s = B * n / cfg["sample_rate"]
        self.checked = generate.checked(seed, traffic)
        self.kept = {}

    def call(self, k: int) -> float:
        """One call on set k of the pool (cycled); returns its audio seconds."""
        p = k % len(self.A)
        with harness.span(f"portbench.{self.entry}"):
            out = getattr(self.proc, self.entry)((self.A[p], self.zero))
        if self.returns == "waveform":
            with harness.span("portbench.istft"):
                y = self.proc.istft(out)
            with harness.span("portbench.fetch"):
                y = y.cpu()
            answer = {"spec": out, "wave": y}
        else:
            with harness.span("portbench.fetch"):
                answer = {"spec": tuple(t.cpu() for t in out)}
        if p in self.checked:
            self.kept[p] = answer
        return self.audio_s

    def ready(self) -> bool:
        """Whether every checked set has an answer of the window."""
        return all(p in self.kept for p in self.checked)

    def start_window(self) -> None:
        self.kept.clear()

    def release(self) -> None:
        del self.proc

    def _inputs(self, device, dtype):
        return torch.cat([self.A[p] for p in self.checked]).to(device, dtype)

    def numbers(self, device) -> dict:
        """The compared numbers of the window's answers on the checked sets,
        against the float64 reference."""
        f64 = torch.float64
        A = self._inputs(device, f64)
        out = torch.cat([torch.stack(self.kept[p]["spec"], dim=2) for p in self.checked])
        y = None
        if self.returns == "waveform":
            y = torch.cat([self.kept[p]["wave"] for p in self.checked]).to(device, f64)
        tb = lws_ref.Tables(self.spec, device, f64)
        return compare.offline_numbers(A, out.to(device, f64), y,
                                       lws_ref.offline(A, tb, self.entry), tb)

    def control_numbers(self, device) -> dict:
        """The same numbers with the control in the program's place: the
        reference computed in the precision below the configuration's."""
        low = getattr(torch, config.LOWER[self.spec.dtype])
        f64 = torch.float64
        low_tb = lws_ref.Tables(self.spec, device, low)
        out = lws_ref.offline(self._inputs(device, low), low_tb, self.entry)
        y = lws_ref.istft(out, low_tb).to(f64) if self.returns == "waveform" else None
        A = self._inputs(device, f64)
        tb = lws_ref.Tables(self.spec, device, f64)
        return compare.offline_numbers(A, out.to(f64), y, lws_ref.offline(A, tb, self.entry),
                                       tb)

    def least_s(self, calls: int) -> float:
        """The least time the card needs for the first `calls` calls, stage
        by stage (portbench/roofline)."""
        wk = roofline.Work(self.cfg)
        per = []
        for a in self.A:
            a = a.double()
            counts = wk.offline(self.entry, a.amax(dim=(1, 2)).cpu().numpy(),
                                a.mean(dim=(1, 2)).cpu().numpy(), a.shape[1])
            per.append(sum(roofline.least_seconds(*c) for c in counts.values()))
        return sum(per[k % len(per)] for k in range(calls))
