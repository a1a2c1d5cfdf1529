"""Mel vocoding, closed loop, one caller: a TTS back end's batches.

Each call hands one set of mel magnitudes to the program's vocoder path,
`lws_torch.mel_vocoder_pipeline(mel, proc, fb=..., return_spec=True)` (the
filterbank's pseudo-inverse and its clamp, then the processor's `run_lws`
from zero phase), then runs the processor's iSTFT and fetches the waveform
to the host. The mels are made from the seed's signals by the reference's
STFT and filterbank (reference/mel.py), in the configuration's dtype, as an
acoustic model would hand them over; calls cycle through a pool of seeded
sets. The filterbank the program is given is the program's own
(`lws_torch.mel_filterbank` of the configuration's `mel` object).

The comparison: `lin`, the largest error of the magnitudes of the call's
spectrogram against the reference's linear magnitudes (the reference's
pseudo-inverse of the same mels, clamped), relative to each item's peak (a
per-bin relative error means nothing at the clamped bins, where two
roundings of a projection near zero clamp or not); then the LWS result and
the waveform as the offline kind compares them, the reference's LWS run on
the reference's linear magnitudes.

Traffic keys: `items` utterances of `seconds` seconds a set, `pool` sets,
`checked` of them (drawn from the seed) compared with the reference,
`warm_calls` calls of set-up. The configuration's `mel` object: `n_mels`,
`fmin`, `fmax`, `htk`, `norm`, `eps`.

The program marks its two stages with spans (`lws_torch.mel_to_linear`,
`lws_torch.run_lws`); while a Driver lives the harness's trace keeps them
(portbench/program_trace.py), and `least_s` gives each its least time.
"""
from __future__ import annotations

import torch

from .. import generate, harness, program_trace, roofline
from ..reference import compare, config, lws_ref
from ..reference import mel as ref_mel
from ..roofline import mel as roofline_mel

ENTRY = "run_lws"
F64 = torch.float64


class Driver:
    def __init__(self, lws_torch, cfg, traffic, seed, device):
        self.cfg, self.mel_cfg = cfg, cfg["mel"]
        self.spec = config.Program(cfg)
        self.spec.stages(ENTRY)
        self.proc = harness.program(lws_torch, cfg, device)
        m = self.mel_cfg
        self.fb = lws_torch.mel_filterbank(m["n_mels"], self.spec.fsize, cfg["sample_rate"],
                                           fmin=m["fmin"], fmax=m["fmax"], htk=m["htk"],
                                           norm=m["norm"])
        self.pipeline = lws_torch.mel_vocoder_pipeline
        x = generate.signals(seed, traffic, cfg)
        P, B, n = x.shape
        tb = lws_ref.Tables(self.spec, device, F64, stencils=False)
        S = lws_ref.stft(torch.as_tensor(x, device=device).double().reshape(P * B, n), tb)
        mel = ref_mel.to_mel(torch.linalg.vector_norm(S, dim=2), self._fb(device, F64))
        mel = mel.to(getattr(torch, self.spec.dtype))
        self.mel = list(mel.reshape(P, B, *mel.shape[1:]))
        self.audio_s = B * n / cfg["sample_rate"]
        self.checked = generate.checked(seed, traffic)
        self.kept = {}
        self._trace_was = program_trace.swap_in()

    def _fb(self, device, dtype):
        return ref_mel.filterbank(self.mel_cfg, self.spec.fsize, self.cfg["sample_rate"],
                                  device, dtype)

    def call(self, k: int) -> float:
        """One call on set k of the pool (cycled); returns its audio seconds."""
        p = k % len(self.mel)
        with harness.span("portbench.mel_vocoder_pipeline"):
            out = self.pipeline(self.mel[p], self.proc, fb=self.fb, return_spec=True)
        with harness.span("portbench.istft"):
            y = self.proc.istft(out)
        with harness.span("portbench.fetch"):
            y = y.cpu()
        if p in self.checked:
            self.kept[p] = {"spec": out, "wave": y}
        return self.audio_s

    def ready(self) -> bool:
        """Whether every checked set has an answer of the window."""
        return all(p in self.kept for p in self.checked)

    def start_window(self) -> None:
        self.kept.clear()

    def release(self) -> None:
        del self.proc
        program_trace.swap_out(self._trace_was)

    def _mels(self, device, dtype):
        return torch.cat([self.mel[p] for p in self.checked]).to(device, dtype)

    def _linear(self, device, dtype):
        """The reference's linear magnitudes of the checked sets' mels."""
        inv = ref_mel.pinv(self._fb(device, dtype))
        return ref_mel.to_linear(self._mels(device, dtype), inv, self.mel_cfg["eps"])

    def _compare(self, out, y, device) -> dict:
        A = self._linear(device, F64)
        tb = lws_ref.Tables(self.spec, device, F64)
        numbers = compare.offline_numbers(A, out, y, lws_ref.offline(A, tb, ENTRY), tb)
        numbers["lin"] = ref_mel.peak_error(torch.linalg.vector_norm(out, dim=2), A)
        return numbers

    def numbers(self, device) -> dict:
        """The compared numbers of the window's answers on the checked sets,
        against the float64 reference."""
        out = torch.cat([torch.stack(self.kept[p]["spec"], dim=2) for p in self.checked])
        y = torch.cat([self.kept[p]["wave"] for p in self.checked])
        return self._compare(out.to(device, F64), y.to(device, F64), device)

    def control_numbers(self, device) -> dict:
        """The same numbers with the control in the program's place: the
        reference computed in the precision below the configuration's."""
        low = getattr(torch, config.LOWER[self.spec.dtype])
        low_tb = lws_ref.Tables(self.spec, device, low)
        out = lws_ref.offline(self._linear(device, low), low_tb, ENTRY)
        y = lws_ref.istft(out, low_tb)
        return self._compare(out.to(F64), y.to(F64), device)

    def least_s(self, calls: int) -> program_trace.Least:
        """The least time the card needs for the first `calls` calls, split
        by the program span that does the work: the projection
        (portbench/roofline/mel.py) and the LWS stages (portbench/roofline),
        from the reference's linear magnitudes of each set."""
        wk = roofline.Work(self.cfg)
        inv = ref_mel.pinv(self._fb(self.mel[0].device, F64))
        per = []
        for mel in self.mel:
            A = ref_mel.to_linear(mel.double(), inv, self.mel_cfg["eps"])
            B, T, F = A.shape
            lws = wk.offline(ENTRY, A.amax(dim=(1, 2)).cpu().numpy(),
                             A.mean(dim=(1, 2)).cpu().numpy(), T)
            per.append({
                "lws_torch.mel_to_linear": roofline.least_seconds(
                    *roofline_mel.projection_counts(B, T, mel.shape[-1], F)),
                "lws_torch.run_lws": sum(roofline.least_seconds(*c) for c in lws.values())})
        return program_trace.Least({name: sum(per[k % len(per)][name] for k in range(calls))
                                    for name in per[0]})
