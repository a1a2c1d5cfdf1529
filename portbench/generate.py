"""The one generator of the benchmark's inputs: signals from the seed.

A traffic mix is a data file in `traffic/`; this module reads its
parameters. Every seed gives the same sizes: a pool of `pool` sets of
`items` signals of `seconds` seconds each, tone + chirp + noise mixtures
(bench.py::make_batch, copied), which differ from seed to seed and from
set to set in their noise only, so every seed asks for the same work.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def make_batch(B: int, n: int, sr_hz: int, rng) -> np.ndarray:
    """B tone + chirp + noise mixtures of n samples at sr_hz, float32."""
    t = np.arange(n) / sr_hz
    xs = []
    for i in range(B):
        f0 = 120 + 40 * (i % 8)
        x = (0.5 * np.sin(2 * np.pi * f0 * 2 * t)
             + 0.3 * np.sin(2 * np.pi * (f0 * 4.7) * t + 0.3 * i)
             + 0.2 * np.sin(2 * np.pi * (300 + 3000 * t / t[-1]) * t)
             + 0.05 * rng.standard_normal(n))
        xs.append(x)
    return np.stack(xs).astype(np.float32)


def load(kind: str, name: str) -> dict:
    """configs/<name>.json or traffic/<name>.json."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def signals(seed: int, traffic: dict, cfg: dict) -> np.ndarray:
    """(pool, items, n) float32 signals of the seed."""
    rng = np.random.default_rng(seed)
    n = int(round(traffic["seconds"] * cfg["sample_rate"]))
    return np.stack([make_batch(traffic["items"], n, cfg["sample_rate"], rng)
                     for _ in range(traffic["pool"])])


def checked(seed: int, traffic: dict) -> list[int]:
    """The pool entries whose answers are compared with the reference,
    drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return sorted(int(k) for k in rng.choice(traffic["pool"], traffic["checked"],
                                             replace=False))
