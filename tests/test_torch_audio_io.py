"""The port's native audio decoders (`data/native_loader.py` over its own
copies `csrc/audioload.cpp` and `csrc/ffdecode.cpp`) and `load_audio`
against the JAX package's on the CPU.

FLAC files from the pure-Python encoder (tests/flac_writer.py) in every
subframe type, rice2 with partitions, wasted bits, the stereo modes and 8-,
16- and 24-bit depths decode to JAX's float32 arrays exactly; `load_batch`
(seeded crops, zero pads, rates, threads) equals JAX's; the port's dataset
globs and reads FLAC as JAX's does; a failed build raises, with g++'s
output, instead of falling back; the libraries are built into `build/`,
never beside the sources. The FFmpeg formats (mp3, webm) decode to JAX's
arrays where the FFmpeg libraries and headers are installed, and skip
elsewhere, as tests/test_audio_formats.py does."""
import numpy as np
import pytest

from audiolm_pytorch_tpu.data import native_loader as jnative
from audiolm_pytorch_tpu.data.dataset import SoundDataset as JSoundDataset
from audiolm_pytorch_tpu.utils import audio_io as jaudio

from audiolm_pytorch_tpu_torch.data import native_loader as pnative
from audiolm_pytorch_tpu_torch.data.dataset import SoundDataset
from audiolm_pytorch_tpu_torch.utils import audio_io as paudio

from flac_writer import write_flac
import torch_port_util  # noqa: F401  (one torch thread a test worker)

SR = 16000


def sine_i16(n, f=440.0, amp=20000, seed=None):
    x = amp * np.sin(2 * np.pi * f * np.arange(n) / SR)
    if seed is not None:
        x += np.random.default_rng(seed).normal(0, 300, n)
    return np.round(x).astype(np.int64)


def _stereo(n, seed):
    base = sine_i16(n, seed=seed)
    return np.stack([base, base + np.random.default_rng(seed).integers(-500, 500, n)])


# (samples, write_flac keywords): each subframe type and residual coding
FLACS = {
    "constant": (np.full(4096, -1234, np.int64), dict(subframe="constant")),
    "verbatim": (np.random.default_rng(1).integers(-(1 << 15), 1 << 15, 5000),
                 dict(subframe="verbatim")),
    "fixed": (sine_i16(1152 * 3 + 137), dict(subframe="fixed")),
    "lpc4": (sine_i16(3000, seed=3), dict(subframe="lpc", lpc_order=4)),
    "rice2": (sine_i16(2304, seed=4), dict(subframe="fixed", rice2=True, porder=2)),
    "escape": (sine_i16(1152, seed=5), dict(subframe="fixed", force_escape=True)),
    "wasted": (sine_i16(2000) & ~np.int64(7), dict(subframe="fixed", wasted=3)),
    "mid_side": (_stereo(2500, 7), dict(subframe="fixed", stereo_mode="mid_side")),
    "left_side": (_stereo(2500, 8), dict(subframe="fixed", stereo_mode="left_side")),
    "24bit": (sine_i16(2000, seed=8) * 200, dict(subframe="fixed", bps=24)),
    "8bit": (np.clip(sine_i16(1500, amp=100, seed=9), -128, 127), dict(subframe="fixed", bps=8)),
}


@pytest.mark.parametrize("name", sorted(FLACS))
def test_flac_decodes_to_jax_arrays(tmp_path, name):
    samples, kw = FLACS[name]
    path = tmp_path / f"{name}.flac"
    write_flac(path, samples, SR, **kw)
    got, rate = paudio.load_audio(path)
    want, jrate = jaudio.load_audio(path)
    assert rate == jrate == SR and got.dtype == np.float32
    assert got.shape == want.shape == (1, samples.shape[-1])
    np.testing.assert_array_equal(got, want)
    assert pnative.probe(path) == jnative.probe(path)


def test_load_batch_equals_jax(tmp_path):
    paths = []
    for i, n in enumerate((900, 3000, 5000, 2600)):
        p = tmp_path / f"c{i}.flac"
        write_flac(p, sine_i16(n, f=300.0 + 50 * i, seed=i), SR if i % 2 else 8000,
                   subframe="fixed")
        paths.append(p)
    wav = tmp_path / "c4.wav"
    paudio.save_audio(wav, np.random.default_rng(4).uniform(-0.5, 0.5, (2, 2200)), SR)
    paths.append(wav)
    for seed, threads in ((0, 1), (7, 3)):
        got = pnative.load_batch(paths, 2048, seed=seed, num_threads=threads)
        want = jnative.load_batch(paths, 2048, seed=seed, num_threads=threads)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(IOError, match="failed to decode"):
        pnative.load_batch([paths[0], tmp_path / "missing.flac"], 64)


def test_dataset_globs_and_reads_flac_as_jax(tmp_path):
    for i in range(3):
        write_flac(tmp_path / f"s{i}.flac", sine_i16(4000 + 400 * i, seed=i), SR)
    paudio.save_audio(tmp_path / "w.wav", np.zeros(1000), SR)
    ds = SoundDataset(tmp_path, target_sample_hz=SR, max_length=3200)
    jds = JSoundDataset(tmp_path, target_sample_hz=SR, max_length=3200)
    assert [f.name for f in ds.files] == [f.name for f in jds.files]
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i], jds[i])
    assert paudio.SUPPORTED_EXTENSIONS == jaudio.SUPPORTED_EXTENSIONS
    assert paudio.FFMPEG_EXTENSIONS == jaudio.FFMPEG_EXTENSIONS


def test_a_failed_build_raises_and_builds_land_in_build(tmp_path, monkeypatch):
    so = pnative.library_path("audioload")
    assert pnative.native_available() and so.exists()
    assert so.parent == pnative.BUILD_DIR and pnative.BUILD_DIR.parts[-2:] == ("build", "native")
    assert not list(pnative._SOURCES["audioload"][0].parent.glob("*.so"))
    bad = tmp_path / "audioload.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "_SOURCES", dict(pnative._SOURCES,
                                                  audioload=(bad, ["-lpthread"])))
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pnative, "_libs", {})
    monkeypatch.setattr(pnative, "_errors", {})
    assert not pnative.native_available()
    assert "g++ failed" in pnative.build_error("audioload")
    path = tmp_path / "x.flac"
    write_flac(path, sine_i16(1000), SR)
    with pytest.raises(RuntimeError, match="whose build failed"):
        paudio.load_audio(path)
    with pytest.raises(ValueError, match="unsupported audio format"):
        paudio.load_audio(tmp_path / "x.aiff")


@pytest.mark.skipif(not jnative.ff_available(), reason="FFmpeg dev libraries not available")
@pytest.mark.parametrize("suffix,rate", [(".mp3", SR), (".webm", 48000)])
def test_ffmpeg_formats_decode_to_jax_arrays(tmp_path, suffix, rate):
    x = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(rate) / rate)).astype(np.float32)
    path = tmp_path / f"tone{suffix}"
    pnative.ff_encode(path, x, rate)
    got, got_rate = paudio.load_audio(path)
    want, want_rate = jaudio.load_audio(path)
    assert got_rate == want_rate == rate and got.shape[0] == 1
    np.testing.assert_array_equal(got, want)
    assert abs(got.shape[1] - len(x)) < 4000 and 0.2 < np.abs(got).max() < 1.0
