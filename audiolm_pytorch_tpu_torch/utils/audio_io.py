"""Host-side audio file I/O, the port's copy of the JAX package's
`utils/audio_io.py`: WAV is read and written in-process (8-, 16-, 24- and
32-bit PCM in, 16-bit PCM out). FLAC and the FFmpeg formats go through the
JAX package's native C++ loader (`native/*.cpp`), which the port has not
ported yet: asking for one raises."""
from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

__all__ = ["load_audio", "save_audio", "SUPPORTED_EXTENSIONS", "NATIVE_EXTENSIONS"]

SUPPORTED_EXTENSIONS = (".wav",)
# decoded by the native loader in the JAX package, not ported yet
NATIVE_EXTENSIONS = (".flac", ".mp3", ".webm", ".ogg", ".opus", ".m4a", ".mp4", ".aac")


def load_audio(path):
    """Returns (waveform float32 (channels, T) in [-1, 1], sample_rate)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        return _load_wav(path)
    if suffix in NATIVE_EXTENSIONS:
        raise NotImplementedError(
            f"{path}: {suffix} needs the native audio loader (native/*.cpp), which the port "
            f"has not ported yet; convert the file to WAV")
    raise ValueError(f"unsupported audio format {suffix} (supported: {SUPPORTED_EXTENSIONS})")


def _load_wav(path):
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        data = ((a[:, 0].astype(np.int32)) | (a[:, 1].astype(np.int32) << 8)
                | (a[:, 2].astype(np.int32) << 16))
        data = (data - (data >> 23 << 24)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, ch).T, sr  # (channels, T)


def save_audio(path, wave_data, sample_rate: int):
    """wave_data: (T,) or (channels, T) float in [-1, 1] -> 16-bit PCM WAV."""
    wave_data = np.asarray(wave_data, np.float32)
    if wave_data.ndim == 1:
        wave_data = wave_data[None]
    ch, _ = wave_data.shape
    pcm = np.clip(wave_data.T * 32767.0, -32768, 32767).astype("<i2")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(ch)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
