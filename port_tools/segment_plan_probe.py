#!/usr/bin/env python3
"""The longform segment plan on the card: consistency and wall of batch_lws's
sweeps against the number of segments S and the exchange cadence.

    python port_tools/segment_plan_probe.py [SECONDS:S:CADENCE[:ITEM] ...]

Each run takes the first SECONDS of a longform signal (630 s at 48 kHz,
bench.py::bench_longform): item ITEM (default 0, chip_smoke.py's) of
make_batch(ITEM + 1, ...) with chip_smoke.py's seed, so items differ in
their tones and noise. |STFT| under LWS(4096, 1024) from zero phase, 100
sweeps at alpha=100 on the sweep kernel: S = 1 runs them on the whole
utterance, S > 1 through segmented_lws_sweeps with halos exchanged every
CADENCE sweeps. It prints the consistency after the sweeps and the wall
(host clock around a synchronised call). The default runs are the ones
behind the processor's _SEG_CAP and _SWEEPS_PER_EXCHANGE (PERF.md,
section 6): one segment against two on 120 s, and S = 8 (lws_tpu's cap;
lws_tpu exchanges every 10) and S = 14 (the SM count's) on 630 s, on three
items. Needs a CUDA card; about 15 minutes for the defaults on an H100.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import lws_torch  # noqa: E402
from chip_smoke import (LONG_FSHIFT, LONG_FSIZE, LONG_RATE, LONG_SECONDS,  # noqa: E402
                        LONG_SEED, card_lines, make_batch)
from lws_torch.ops import lws_sweeps as sweeps_mod  # noqa: E402
from lws_torch.ops import segmented as seg_mod  # noqa: E402

DEFAULT_RUNS = (["120:1:0", "120:2:10", "120:2:5", "120:2:4", "120:2:3", "120:2:2",
                 "120:2:1", "120:4:1", "630:8:10", "630:8:4", "630:8:3", "630:8:2", "630:8:1",
                 "630:14:10", "630:14:5", "630:14:3", "630:14:2", "630:14:1"]
                + [f"{run}:{item}" for item in (3, 6)
                   for run in ("120:1:0", "120:2:10", "120:2:3", "120:2:2", "630:8:10",
                               "630:8:3", "630:8:2")])


def main(argv):
    if not torch.cuda.is_available():
        print("segment_plan_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card_lines(torch)
    proc = lws_torch.LWS(LONG_FSIZE, LONG_FSHIFT, device=dev)
    st, ip, scheme = proc._st_batch, proc.batch_inner_passes, proc.inner_scheme
    thr = torch.as_tensor(lws_torch.get_thresholds(100, 100, 0.1, 1), dtype=torch.float32,
                          device=dev)
    signals, amps = {}, {}
    for run in argv or DEFAULT_RUNS:
        secs, S, cadence, item = (int(v) for v in (run + ":0").split(":")[:4])
        if item not in signals:
            signals[item] = make_batch(item + 1, int(LONG_SECONDS * LONG_RATE), LONG_RATE,
                                       np.random.default_rng(LONG_SEED))[item:]
        if (secs, item) not in amps:
            sr, si = proc.stft_ri(signals[item][:, :secs * LONG_RATE])
            amps[secs, item] = torch.sqrt(sr * sr + si * si)
        amp = amps[secs, item]
        pair = (amp, torch.zeros_like(amp))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if S == 1:
            out = sweeps_mod.tiled_lws_sweeps(*pair, st, thr, ip, scheme)
        else:
            out = seg_mod.segmented_lws_sweeps(*pair, st, thr, segments=S,
                                               sweeps_per_exchange=cadence,
                                               inner_passes=ip, inner_scheme=scheme)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = float(proc.get_consistency(out)[0])
        print(f"item {item}, {secs} s, T={amp.shape[1]}, S={S}, exchange every "
              f"{cadence if S > 1 else '-'}: "
              f"{c:.4f} dB, {wall:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
