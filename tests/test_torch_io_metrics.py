"""lws_torch.io (wav), lws_torch.utils (run metrics, tracing) and the
port's examples, on the CPU.

The wav reader and writer are the port's copy of lws_tpu/io.py: a file
either package writes reads back the same in both. run_with_metrics
returns the input's consistency and each stage's wall and consistency;
trace writes a torch.profiler Chrome trace into its directory. The
examples run end to end at small sizes with --device cpu.
"""
import json
import os
import wave

import numpy as np
import pytest
import torch

import lws_torch
import lws_tpu.io as jio
import lws_tpu.utils.metrics as jmetrics
from lws_torch import io as tio
from lws_torch.utils import StageMetrics, run_with_metrics, trace

torch.set_num_threads(1)


def _tone(n=4000, sr_hz=8000, channels=1):
    t = np.arange(n) / sr_hz
    x = np.stack([0.5 * np.sin(2 * np.pi * (220 + 110 * c) * t) for c in range(channels)])
    return x[0] if channels == 1 else x


@pytest.mark.parametrize("normalize", [True, False])
def test_wav_round_trip_matches_lws_tpu(tmp_path, normalize):
    x = _tone()
    p_t, p_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    tio.write_wav(p_t, x, 8000, normalize=normalize)
    jio.write_wav(p_j, x, 8000, normalize=normalize)
    with open(p_t, "rb") as a, open(p_j, "rb") as b:
        assert a.read() == b.read()
    y, sr = tio.read_wav(p_t)
    y_j, sr_j = jio.read_wav(p_t)
    assert sr == sr_j == 8000 and y.dtype == np.float64
    np.testing.assert_array_equal(y, y_j)
    peak = 0.9 if normalize else 0.5
    # 16-bit: written as trunc(x * 32767), read as n / 32768
    np.testing.assert_allclose(y, x / np.abs(x).max() * peak, atol=2.0 / 32767)


def test_wav_tensor_and_channels(tmp_path):
    x = _tone(channels=2)
    p = str(tmp_path / "st.wav")
    tio.write_wav(p, torch.tensor(x), 8000)
    mono, _ = tio.read_wav(p)
    both, _ = tio.read_wav(p, mono=False)
    assert both.shape == (2, x.shape[-1]) and mono.shape == (x.shape[-1],)
    np.testing.assert_array_equal(mono, both.mean(axis=0))
    np.testing.assert_array_equal(both, jio.read_wav(p, mono=False)[0])


@pytest.mark.parametrize("width", [1, 3, 4])
def test_wav_read_widths_match_lws_tpu(tmp_path, width):
    """8-, 24- and 32-bit PCM read as lws_tpu reads them."""
    rng = np.random.default_rng(width)
    raw = rng.integers(0, 256, size=600 * width, dtype=np.uint8).tobytes()
    p = str(tmp_path / f"w{width}.wav")
    with wave.open(p, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(width)
        f.setframerate(16000)
        f.writeframes(raw)
    y, _ = tio.read_wav(p, mono=False)
    np.testing.assert_array_equal(y, jio.read_wav(p, mono=False)[0])
    assert np.abs(y).max() <= 1.0


def test_run_with_metrics_stages():
    proc = lws_torch.LWS(128, 32, mode="music", batch_iterations=5, device="cpu")
    x = np.stack([_tone(2000), _tone(2000)[::-1].copy()])
    A = np.abs(proc.stft(x)).astype(np.complex64)
    out, m = run_with_metrics(proc, A, sample_rate=8000)
    assert [s.stage for s in m] == ["input", "no-future", "online", "batch"]
    assert all(isinstance(s, StageMetrics) for s in m) and m[0].wall_s == 0.0
    assert all(s.wall_s > 0 for s in m[1:])
    audio_s = 2 * A.shape[-2] * proc.fshift / 8000
    assert all(s.audio_seconds == audio_s for s in m)
    assert m[3].realtime_factor == pytest.approx(audio_s / m[3].wall_s)
    assert "dB" in str(m[1]) and "realtime" in str(m[1])
    # each stage's consistency is the mean over the batch after that stage
    pair = proc._as_pair(A)
    for s, fn in zip(m[1:], (proc.nofuture_lws, proc.online_lws, proc.batch_lws)):
        pair = fn(pair)
        assert s.consistency_db == pytest.approx(float(proc.get_consistency(pair).mean()),
                                                 abs=1e-9)
    assert m[0].consistency_db < m[1].consistency_db < m[3].consistency_db
    assert isinstance(out, np.ndarray) and out.shape == A.shape
    np.testing.assert_allclose(out, lws_torch.merge(*pair), atol=1e-6)
    # a pair in, a pair out; the dataclass is lws_tpu's
    out2, _ = run_with_metrics(proc, proc._as_pair(A))
    assert isinstance(out2, tuple) and torch.equal(out2[0], pair[0])
    assert [f for f in StageMetrics.__dataclass_fields__] == \
        [f for f in jmetrics.StageMetrics.__dataclass_fields__]


def test_trace_writes_a_chrome_trace(tmp_path):
    proc = lws_torch.LWS(128, 32, device="cpu")
    A = np.abs(proc.stft(_tone(1000))).astype(np.complex64)
    d = str(tmp_path / "traces")
    with trace(d):
        proc.batch_lws(A, iterations=2)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_example_run_lws(tmp_path, capsys):
    from lws_torch.examples import run_lws
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    tio.write_wav(src, _tone(2000), 8000)
    run_lws.main([src, dst, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "batch" in text and "wrote" in text
    y, sr = tio.read_wav(dst)
    assert sr == 8000 and 2000 <= y.size < 2000 + 128 and np.isfinite(y).all()


@pytest.mark.parametrize("name,args", [("streaming_vocoder", ["1", "0.3"]),
                                       ("streaming_serve", ["0.7"])])
def test_example_streaming(name, args, capsys):
    import importlib
    mod = importlib.import_module(f"lws_torch.examples.{name}")
    mod.main([*args, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "p50" in text


def test_new_modules_import_no_jax():
    """The modules this surface added import neither jax nor lws_tpu."""
    import subprocess
    import sys
    code = ("import sys, lws_torch.mel, lws_torch.checkpoint, lws_torch.io, lws_torch.utils, "
            "lws_torch.examples.run_lws, lws_torch.examples.streaming_serve, "
            "lws_torch.examples.streaming_vocoder; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lws_tpu')); print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
