"""The port's audio metrics (`utils/metrics.py`) against the JAX package's
on the CPU, and its profiling hooks (`utils/profiling.py`).

`mel_distance` (on the port's `ops/stft.py::melspectrogram`) within 1e-5
relative of JAX's, `stoi` (host-side numpy, as in JAX) within 1e-9, on
seeded signals: a tone with noise against a noisier copy, at 16 and 24 kHz,
batched and not; short inputs give NaN in both. `StepTimer` keeps JAX's
window and summary keys; `trace` writes a Chrome trace holding the
`annotate` span."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.utils import metrics as jmetrics
from audiolm_pytorch_tpu.utils.profiling import StepTimer as JStepTimer

from audiolm_pytorch_tpu_torch import mel_distance, stoi
from audiolm_pytorch_tpu_torch.utils.profiling import StepTimer, annotate, trace

import torch_port_util  # noqa: F401  (one torch thread a test worker)


def signals(sr, seconds, b=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (seconds * sr,) if b is None else (b, seconds * sr)
    tt = np.arange(seconds * sr) / sr
    ref = 0.4 * np.sin(2 * np.pi * 220 * tt) * (1 + 0.5 * np.sin(2 * np.pi * 3 * tt))
    ref = (ref + 0.05 * rng.normal(size=shape)).astype(np.float32)
    est = (ref + 0.2 * rng.normal(size=shape)).astype(np.float32)
    return est, ref


@pytest.mark.parametrize("sr,b,kw", [(16000, 2, {}), (24000, None, dict(n_fft=512, hop_length=128,
                                                                       n_mels=40))])
def test_mel_distance_matches_jax(sr, b, kw):
    est, ref = signals(sr, 1, b)
    got = mel_distance(torch.from_numpy(est), torch.from_numpy(ref), sr, **kw).item()
    want = float(jmetrics.mel_distance(jnp.asarray(est), jnp.asarray(ref), sr, **kw))
    assert got > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("sr,b", [(16000, None), (24000, 2), (10000, None)])
def test_stoi_matches_jax(sr, b):
    est, ref = signals(sr, 2, b, seed=sr)
    got = stoi(torch.from_numpy(est), torch.from_numpy(ref), sr)
    want = jmetrics.stoi(est, ref, sr)
    assert 0.2 < got < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert stoi(ref, ref, sr) == pytest.approx(1.0, abs=1e-6)
    assert np.isnan(stoi(est[..., :2000], ref[..., :2000], sr))  # fewer than 30 frames


def test_step_timer_keeps_jax_window_and_summary(monkeypatch):
    assert np.isnan(StepTimer().mean) and np.isnan(StepTimer().steps_per_sec)
    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr("time.perf_counter", lambda: float(next(clock)))  # both modules' clock
    timers = (StepTimer(window=3), JStepTimer(window=3))
    for timer in timers:
        for _ in range(5):
            with timer:
                pass
    port, jax_timer = timers
    assert len(port.times) == 3 and port.times == jax_timer.times
    assert port.last == jax_timer.last and port.summary() == jax_timer.summary()
    assert set(port.summary()) == {"step_time_s", "steps_per_sec"}
    assert port.summary() == {"step_time_s": 0.25, "steps_per_sec": 4.0}


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    x = torch.randn(64, 64)
    with trace(tmp_path / "trace") as prof:
        with annotate("port_matmul"):
            (x @ x).sum()
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "port_matmul" for e in events)
    assert any(e.key == "port_matmul" for e in prof.key_averages())
