"""The port's command line (`python -m audiolm_pytorch_tpu_torch.cli`)
against the JAX package's `cli.py` on the CPU (`--device cpu`).

`info` prints what JAX's prints, byte for byte (a config's lists as
tuples); `tokenize` of a WAV clip and of the same clip as FLAC
(tests/flac_writer.py) saves JAX's codes, in value, shape and dtype (int32
(G, B, N, Q)); `decode` of JAX's codes writes JAX's WAV to within one
16-bit step; `generate` on the banked chain (persist/*_r5.npz, the codec
persist/soundstream_r5.npz they are token-paired to and the corpus centres
results_quality/audiolm_r5/kmeans.npy) writes a 16 kHz WAV, its coarse
stage cut to the semantic stage's 25 frames; without a card
every subcommand refuses to start unless given `--device cpu`.

The codec of tokenize and decode is a tiny one with random weights (built
by shape, tests/test_torch_streaming.py::tiny_pair), saved by the JAX
package's `SoundStream.save`. JAX's CLI gets that built module, its
`tokenize` and `decode_from_codebook_indices` compiled once each, in place
of its loader, which would construct the codec op by op for tens of
seconds; its quantizer takes K6's formula (`pallas_vq`), as in
tests/test_torch_codec.py."""
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu import cli as jcli

from audiolm_pytorch_tpu_torch import cli as pcli
from audiolm_pytorch_tpu_torch.models.audiolm import AudioLM

from flac_writer import write_flac
from tests.test_torch_codec import pallas_vq  # noqa: F401
from tests.test_torch_streaming import tiny_pair

ROOT = Path(__file__).resolve().parents[1]
PERSIST = ROOT / "persist"
HELDOUT = ROOT / "results_quality" / "heldout_ref.wav"


class _Compiled:
    """A JAX codec whose two entry points the CLI calls run under jax.jit."""

    def __init__(self, codec):
        self.codec = codec
        self.target_sample_hz = codec.target_sample_hz
        self._tokenize = jax.jit(lambda m, x: m.tokenize(x))
        self._decode = jax.jit(lambda m, c: m.decode_from_codebook_indices(c))

    def tokenize(self, x, input_sample_hz=None):
        assert input_sample_hz == self.target_sample_hz  # no resampling on this path
        return self._tokenize(self.codec, x)

    def decode_from_codebook_indices(self, codes):
        return self._decode(self.codec, codes)


def run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["soundstream_r5_73k.npz", "semantic_r5.npz"])
def test_info_is_byte_equal_to_jax(name, capsys):
    got = run(pcli.main, ["--device", "cpu", "info", str(PERSIST / name)], capsys)
    want = run(jcli.main, ["info", str(PERSIST / name)], capsys)
    assert got == want and '"kind"' in got
    if name.startswith("soundstream"):
        assert '"strides": "(2, 4, 5, 8)"' in got


def test_tokenize_and_decode_match_jax_cli(pallas_vq, monkeypatch, tmp_path, capsys):
    jm, _ = tiny_pair("attn")
    codec = tmp_path / "tiny.npz"
    jm.save(str(codec))
    monkeypatch.setattr(jcli, "_load_codec", lambda path, key: _Compiled(jm))
    with wave.open(str(HELDOUT), "rb") as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")[4000:5600]  # 200 frames
    clip = tmp_path / "clip.wav"
    with wave.open(str(clip), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    write_flac(tmp_path / "clip.flac", pcm.astype(np.int64), 16000)

    run(jcli.main, ["tokenize", "--codec", str(codec), "--audio", str(clip),
                    "--output", str(tmp_path / "jax.npz")], capsys)
    want = np.load(tmp_path / "jax.npz")["codes"]
    for audio in ("clip.wav", "clip.flac"):
        out = tmp_path / f"{audio}.npz"
        said = run(pcli.main, ["--device", "cpu", "tokenize", "--codec", str(codec), "--audio",
                               str(tmp_path / audio), "--output", str(out)], capsys)
        assert said == f"wrote codes {want.shape} to {out}\n"
        got = np.load(out)["codes"]
        assert got.dtype == want.dtype == np.int32 and got.shape == want.shape == (1, 1, 200, 4)
        np.testing.assert_array_equal(got, want)

    waves = []
    for main, name, extra in ((jcli.main, "jax.wav", []), (pcli.main, "port.wav", ["--device",
                                                                                  "cpu"])):
        run(main, [*extra, "decode", "--codec", str(codec), "--codes", str(tmp_path / "jax.npz"),
                   "--output", str(tmp_path / name)], capsys)
        with wave.open(str(tmp_path / name), "rb") as f:
            assert f.getframerate() == 16000 and f.getnframes() == 1600
            waves.append(np.frombuffer(f.readframes(1600), "<i2").astype(np.int32))
    assert np.abs(waves[0]).max() > 100
    assert np.abs(waves[0] - waves[1]).max() <= 1


@pytest.fixture
def one_thread():
    """The samplers' per-code steps are small matmuls that gain nothing from
    more threads (8 took as long as 1 on the CPU, at 6x the CPU time); one
    keeps the test from crowding the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_generate_on_the_banked_chain_writes_a_16khz_wav(one_thread, monkeypatch, tmp_path,
                                                         capsys):
    # the command line only hands its flags to AudioLM, whose chain
    # tests/test_torch_audiolm.py holds to JAX's: the coarse stage is cut
    # from AudioLM's default 512 frames to the semantic stage's 25, which
    # also makes the fine stage's steps a twentieth
    call = AudioLM.__call__
    monkeypatch.setattr(AudioLM, "__call__",
                        lambda self, **kw: call(self, max_coarse_time_steps=25, **kw))
    out = tmp_path / "generated.wav"
    said = run(pcli.main, ["--device", "cpu", "generate",
                           "--codec", str(PERSIST / "soundstream_r5.npz"),
                           "--semantic", str(PERSIST / "semantic_r5.npz"),
                           "--coarse", str(PERSIST / "coarse_r5.npz"),
                           "--fine", str(PERSIST / "fine_r5.npz"),
                           "--hubert-kmeans",
                           str(ROOT / "results_quality" / "audiolm_r5" / "kmeans.npy"),
                           "--max-length", "25", "--seed", "0", "--output", str(out)], capsys)
    assert said == f"wrote {out}\n"
    with wave.open(str(out), "rb") as f:
        assert f.getframerate() == 16000 and f.getnchannels() == 1
        n = f.getnframes()
        pcm = np.frombuffer(f.readframes(n), "<i2")
    assert n > 0 and n % 320 == 0 and np.abs(pcm).max() > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is present")
def test_every_subcommand_needs_the_card_unless_given_the_cpu(capsys):
    ckpt = str(PERSIST / "semantic_r5.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["info", ckpt])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["decode", "--codec", ckpt, "--codes", "codes.npz"])
    assert '"kind": "semantic"' in run(pcli.main, ["--device", "cpu", "info", ckpt], capsys)
