"""The port's SoundStream training against the JAX package on the CPU: WAV
I/O, the dataset and data loader (the same batches from the same seed), the
STFT and mel spectrogram, the two discriminators (logits and
intermediates), the quantizers' training (kmeans init, EMA update with
dead-code expiry, quantizer dropout, given the same random draws), the
generator's training forward (its seven loss terms and every gradient) on
a tiny codec with random weights and on persist/soundstream_r5_73k.npz,
the discriminators' loss with and without the gradient penalty and its
gradients, the EMA, two trainer steps against the JAX trainer's own step
functions, checkpoints read by the other package, and the options that
raise.

The random draws: every draw of the port's training is made by one of the
`draw_*` functions of its `ops/quantize.py`; the tests replace them with
the JAX package's draws for the same keys (`JaxDraws` walks JAX's key
splits in the order the port draws), so both sides see the same numbers.
JAX's quantizer takes its TPU path, the Pallas nearest-code kernel (K6) in
interpret mode, as in tests/test_torch_codec.py.

Tolerances: forward values 2e-3 relative; gradients rtol 1e-2 / atol 1e-3
(the JAX package's own); quantizer state 1e-4 relative; the trainer's
steps as tests/test_torch_train.py compares them (losses 2e-3; each leaf's
update by relative norm at lr 1e-5, 5e-2, over the leaves whose JAX update
is over 1e-6 of the largest: Adam turns float32 noise into updates of +-lr).
"""
import functools
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.data import dataset as jdataset
from audiolm_pytorch_tpu.models import soundstream as jss
from audiolm_pytorch_tpu.nn.module import partition_buffers, partition_trainable_where
from audiolm_pytorch_tpu.ops import pallas as jpallas
from audiolm_pytorch_tpu.ops import quantize as jq
from audiolm_pytorch_tpu.ops import stft as jstft
from audiolm_pytorch_tpu.ops.pallas import vq as jvq
from audiolm_pytorch_tpu.training import checkpoint as jckpt
from audiolm_pytorch_tpu.training.ema import ema_init, ema_update
from audiolm_pytorch_tpu.training.trainer import SoundStreamTrainer as JTrainer, _discr_path
from audiolm_pytorch_tpu.utils import audio_io as jaudio

from audiolm_pytorch_tpu_torch import EMA, SoundStream, SoundStreamTrainer, load_soundstream
from audiolm_pytorch_tpu_torch.data import dataset as pdataset
from audiolm_pytorch_tpu_torch.ops import quantize as pq
from audiolm_pytorch_tpu_torch.ops import stft as pstft
from audiolm_pytorch_tpu_torch.ops.kernels.vq import vq_nearest_code_ref
from audiolm_pytorch_tpu_torch.training.checkpoint import load_pytree_into
from audiolm_pytorch_tpu_torch.utils import audio_io as paudio
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax, codec_state_dict_to_jax

from tests.test_soundstream import tiny_soundstream
from tests.test_torch_codec import CKPT, TINY
from torch_port_util import jax_named, jax_replace, t

FWD = dict(rtol=2e-3, atol=2e-3)
GRAD = dict(rtol=1e-2, atol=1e-3)
STATE = dict(rtol=1e-4, atol=1e-5)
LOSS_NAMES = ("recon", "multi_spectral", "multi_stft", "si_snr", "adversarial", "feature",
              "commit")


@pytest.fixture
def pallas_vq(monkeypatch):
    """JAX's quantizer on its TPU path: K6, here in interpret mode."""
    monkeypatch.setattr(jpallas, "on_tpu", lambda: True)
    monkeypatch.setattr(jvq, "vq_nearest_code",
                        functools.partial(jvq.vq_nearest_code, interpret=True))


class JaxDraws:
    """The JAX package's random draws, queued in the order the port makes
    them, and the port's draw functions patched to hand them out (each
    checked against what the port asks for)."""

    def __init__(self, monkeypatch):
        self.queue = []
        for name in ("randint", "permutation", "dropout_index", "uniform"):
            monkeypatch.setattr(pq, f"draw_{name}", functools.partial(self._take, name))

    def _take(self, kind, generator, *args):
        assert self.queue, f"the port drew {kind}{args} beyond JAX's draws"
        want_kind, want_args, value = self.queue.pop(0)
        assert (kind, tuple(args)) == (want_kind, want_args), (kind, args, want_kind, want_args)
        return value if kind == "dropout_index" else torch.from_numpy(np.array(value))

    def vq(self, key, layer, n_rows):
        """One quantizer's training call with key: kmeans init when the
        port's layer is not initialised, then the dead-code candidates."""
        k_init, k_samp, k_ema = jax.random.split(key, 3)
        if not bool(layer.initted):
            num = max(4 * layer.codebook_size, 1024)
            k1, k2 = jax.random.split(k_init)
            self.queue += [("randint", (n_rows, num), jax.random.randint(k1, (num,), 0, n_rows)),
                           ("randint", (num, num), jax.random.randint(k2, (num,), 0, num)),
                           ("permutation", (num,), jax.random.permutation(k_init, num))]
        if layer.stochastic_sample_codes:
            shape = (n_rows, layer.codebook_size)
            self.queue.append(("uniform", (shape,), jax.random.uniform(
                k_samp, shape, jnp.float32, minval=1e-20, maxval=1.0)))
        if layer.threshold_ema_dead_code > 0:
            c = layer.codebook_size
            k1, k2 = jax.random.split(k_ema)
            self.queue += [("randint", (n_rows, c), jax.random.randint(k1, (c,), 0, n_rows)),
                           ("randint", (c, c), jax.random.randint(k2, (c,), 0, c))]

    def rvq(self, key, rvq, n_rows):
        """A residual quantizer's training call with key."""
        last = rvq.num_quantizers - 1
        if rvq.quantize_dropout:
            kd, key = jax.random.split(key)
            drop = int(jax.random.randint(kd, (), rvq.quantize_dropout_cutoff_index,
                                          rvq.num_quantizers))
            self.queue.append(("dropout_index", (rvq.quantize_dropout_cutoff_index,
                                                 rvq.num_quantizers), drop))
            mult = rvq.quantize_dropout_multiple_of
            last = ((drop + mult) // mult) * mult - 1
        for qi, layer in enumerate(rvq.layers):
            key, lk = jax.random.split(key)
            if qi <= last:
                self.vq(lk, layer, n_rows)

    def codec(self, key, model, n_rows):
        """A SoundStream training forward with key (n_rows frames in all)."""
        _, key = jax.random.split(key)
        for rvq in model.rq.rvqs:
            key, lk = jax.random.split(key)
            self.rvq(lk, rvq, n_rows)


class JaxCodes:
    """The port's nearest-code searches return JAX's codes, queued one
    array a search, after each is checked against the port's own codes
    (K6's plain version): identical but for near ties, whose float64 scores
    differ by under NEAR_TIE of the score's terms (float32 sums in another
    order break such ties either way)."""

    NEAR_TIE = 1e-5

    def __init__(self, monkeypatch):
        self.queue = []
        self.near_ties = 0
        monkeypatch.setattr(pq, "vq_nearest_code", self._search)

    def _search(self, x, codebook):
        want = torch.from_numpy(np.array(self.queue.pop(0))).to(torch.int32)
        got = vq_nearest_code_ref(x, codebook)
        rows = (got != want).nonzero().flatten()
        if len(rows):
            xd, ed = x[rows].double(), codebook.double()

            def score(idx):
                e = ed[idx.long()]
                return e.square().sum(-1) - 2 * (xd * e).sum(-1), \
                    e.square().sum(-1) + 2 * xd.norm(dim=-1) * e.norm(dim=-1)

            (sa, size), (sb, _) = score(got[rows]), score(want[rows])
            gap = ((sa - sb).abs() / size).max().item()
            assert gap < self.NEAR_TIE, f"{len(rows)} codes differ, score gap {gap:.2e}"
        self.near_ties += len(rows)
        return want


def _random_weights(shapes, rng, codebook_scale=None):
    """{key path: numpy array} for every leaf of a JAX SoundStream's shape
    tree: weights uniform within 1/sqrt(fan-in), nonzero biases, norm gains
    and qk scales around 1, ModReLU offsets small; the quantizers
    initialised (random codebooks and EMA state) or, with codebook_scale
    None, not (zeros, as under kmeans init)."""
    new = {}
    for path, a in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = jax.tree_util.keystr(path)
        leaf = name.split("[<flat")[0].rsplit(".", 1)[-1]
        if leaf in ("gamma", "q_scale", "k_scale"):
            v = rng.uniform(0.5, 1.5, size=a.shape)
        elif leaf in ("weight", "wr", "wi"):
            lim = 1 / np.sqrt(np.prod(a.shape[:-1]))
            v = rng.uniform(-lim, lim, size=a.shape)
        elif leaf in ("bias", "br", "bi", "b"):
            v = 0.1 * rng.normal(size=a.shape)
        elif leaf == "initted":
            v = np.full(a.shape, codebook_scale is not None)
        elif leaf in ("codebook", "embed_avg") and codebook_scale is not None:
            v = codebook_scale * rng.normal(size=a.shape)
        elif leaf == "cluster_size" and codebook_scale is not None:
            v = rng.uniform(0.0, 3.0, size=a.shape)
        else:
            v = np.zeros(a.shape)
        new[name] = v.astype(a.dtype)
    return new


def _tiny_pair(seed=0, codebook_scale=0.5, **overrides):
    """The tiny JAX codec (tests/test_soundstream.py's sizes) with random
    weights and the port's copy of it, on the CPU."""
    shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(seed), **overrides))
    new = _random_weights(shapes, np.random.default_rng(seed), codebook_scale)
    pm = SoundStream(**dict(TINY, **overrides), device="cpu")
    pm.load_state_dict(codec_state_dict_from_jax(new))
    return jax_replace(shapes, new), pm


def _waves(rng, b=2, n=1024, scale=0.5):
    t_ = np.arange(n) / 16000.0
    f = rng.uniform(200, 800, size=(b, 1))
    return (scale * np.sin(2 * np.pi * f * t_) + 0.05 * rng.normal(size=(b, n))).astype(np.float32)


def _port_named(module):
    """{JAX key path: numpy} of a port codec's state, in the JAX layout."""
    return codec_state_dict_to_jax(module.state_dict(), [n for n, _ in module.named_buffers()])


# -- audio I/O and data --------------------------------------------------------

def test_wav_round_trip_both_ways(tmp_path):
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 300)).astype(np.float32)
    paudio.save_audio(tmp_path / "p.wav", x, 16000)
    jaudio.save_audio(tmp_path / "j.wav", x, 16000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for width in (1, 2, 3, 4):
        with wave.open(str(tmp_path / f"w{width}.wav"), "wb") as f:
            f.setnchannels(2)
            f.setsampwidth(width)
            f.setframerate(8000)
            f.writeframes(np.random.default_rng(width).integers(0, 256, 2 * 40 * width,
                                                                dtype=np.uint8).tobytes())
        got, sr = paudio.load_audio(tmp_path / f"w{width}.wav")
        want, jsr = jaudio.load_audio(tmp_path / f"w{width}.wav")
        assert sr == jsr == 8000 and got.shape == (2, 40)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="native audio loader"):
        paudio.load_audio(tmp_path / "clip.flac")


@pytest.fixture
def clip_folder(tmp_path):
    """Clips of 900-3000 samples at 16 and 8 kHz, mono and stereo, in
    nested folders."""
    rng = np.random.default_rng(1)
    for i in range(7):
        sr = 16000 if i % 3 else 8000
        n = int(rng.integers(900, 3000))
        x = rng.uniform(-0.8, 0.8, size=(1 + i % 2, n)).astype(np.float32)
        paudio.save_audio(tmp_path / f"d{i % 2}" / f"c{i}.wav", x, sr)
    return tmp_path


@pytest.mark.parametrize("rates,mults", [(16000, 320), ((16000, 8000), (320, 160))])
def test_dataset_items_match_jax(clip_folder, rates, mults):
    kw = dict(target_sample_hz=rates, max_length=2000, seq_len_multiple_of=mults, seed=5)
    pds = pdataset.SoundDataset(clip_folder, **kw)
    jds = jdataset.SoundDataset(clip_folder, exts=("flac", "wav"), **kw)
    assert [str(f) for f in pds.files] == [str(f) for f in jds.files] and len(pds) == 7
    for _ in range(2):  # twice: the crops' generator moves on
        for i in range(len(pds)):
            got, want = pds[i], jds[i]
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(g, w)


def test_dataloader_gives_jaxs_batches(clip_folder):
    kw = dict(target_sample_hz=16000, max_length=2000, seq_len_multiple_of=320, seed=3)
    pdl = pdataset.get_dataloader(pdataset.SoundDataset(clip_folder, **kw), batch_size=3,
                                  num_workers=1)
    jdl = jdataset.get_dataloader(jdataset.SoundDataset(clip_folder, exts=("flac", "wav"),
                                                        **kw), batch_size=3, num_workers=1)
    try:
        for _ in range(5):
            np.testing.assert_array_equal(next(pdl), next(jdl))
    finally:
        pdl.stop()
        jdl.stop()
    items = [(np.ones(3, np.float32), "a"), (np.ones(5, np.float32), "b")]
    for pad in (True, False):
        got = pdataset.collate_one_or_multiple_tensors(items, pad)
        want = jdataset.collate_one_or_multiple_tensors(items, pad)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


# -- spectra and discriminators ------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,win,normalized", [(128, 32, 128, False), (512, 16, 64, False),
                                                      (2048, 512, 2048, True)])
def test_stft_and_mel_match_jax(n_fft, hop, win, normalized):
    x = _waves(np.random.default_rng(n_fft), n=4000)
    spec = jstft.stft(jnp.asarray(x), n_fft, hop, win, normalized=normalized)
    re, im = pstft.stft(t(x), n_fft, hop, win, normalized=normalized)
    scale = np.abs(np.asarray(spec)).max()
    np.testing.assert_allclose(re.numpy(), np.real(spec), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(im.numpy(), np.imag(spec), rtol=0, atol=1e-5 * scale)
    want = np.asarray(jstft.melspectrogram(jnp.asarray(x), 16000, n_fft, hop, win, n_mels=64,
                                           normalized=normalized))
    got = pstft.melspectrogram(t(x), 16000, n_fft, hop, win, n_mels=64, normalized=normalized)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5 * want.max())


def test_discriminators_match_jax():
    jm, pm = _tiny_pair(seed=2)
    x = _waves(np.random.default_rng(2))
    jlog, jfeat = jax.jit(lambda m, a: m._discr_logits_and_feats(a))(jm, jnp.asarray(x))
    with torch.no_grad():
        plog, pfeat = pm._discr_logits_and_feats(t(x))
    assert len(plog) == len(jlog) == 4
    # the STFT discriminator: NCHW here, NHWC in JAX
    np.testing.assert_allclose(plog[0].permute(0, 2, 3, 1).numpy(), np.asarray(jlog[0]), **FWD)
    for g, w in zip(pfeat[0], jfeat[0]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **FWD)
    for i in range(1, 4):  # the scales: NCL here, NLC in JAX
        np.testing.assert_allclose(plog[i].transpose(1, 2).numpy(), np.asarray(jlog[i]), **FWD)
        for g, w in zip(pfeat[i], jfeat[i]):
            np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w), **FWD)
    # the logits as (re, im) pairs
    jm2, pm2 = _tiny_pair(seed=3, complex_stft_discr_logits_abs=False)
    want = jax.jit(lambda m, a: m.stft_discriminator(a))(jm2, jnp.asarray(x))
    with torch.no_grad():
        got = pm2.stft_discriminator(t(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1, 4).numpy(), np.asarray(want), **FWD)


# -- the quantizers in training ------------------------------------------------

def test_kmeans_init_and_ema_update_given_jaxs_draws(monkeypatch):
    rng = np.random.default_rng(4)
    flat = rng.normal(size=(300, 32)).astype(np.float32)
    codes = rng.integers(0, 64, 300)
    key = jax.random.PRNGKey(7)
    k_init, _, k_ema = jax.random.split(key, 3)
    # kmeans gives clusters of ~16 of the 1024 candidates: a threshold of 12
    # expires some codes at the first EMA update and keeps others
    jl = jq.VectorQuantizeEMA(32, 64, threshold_ema_dead_code=12.0, key=jax.random.PRNGKey(0))
    jinit = jax.jit(lambda m, f: m._init_codebook(k_init, f, None))(jl, jnp.asarray(flat))
    jnew = jax.jit(lambda m, f, oh: m._ema_update(k_ema, f, oh, None))(
        jinit, jnp.asarray(flat), jax.nn.one_hot(codes, 64, dtype=jnp.float32))
    pl = pq.VectorQuantizeEMA(32, 64, threshold_ema_dead_code=12.0)
    draws = JaxDraws(monkeypatch)
    draws.vq(key, pl, 300)
    pl._init_codebook(t(flat), None)
    for name in ("codebook", "embed_avg", "cluster_size"):
        np.testing.assert_allclose(getattr(pl, name).numpy(),
                                   np.asarray(getattr(jinit, name).value), **STATE, err_msg=name)
    assert bool(pl.initted) and bool(jinit.initted.value)
    pl._ema_update(t(flat), t(codes), None)
    assert not draws.queue
    expired = np.asarray(jnew.cluster_size.value) == 12.0
    assert 0 < expired.sum() < 64  # some codes expire, some do not
    for name in ("codebook", "embed_avg", "cluster_size"):
        np.testing.assert_allclose(getattr(pl, name).numpy(),
                                   np.asarray(getattr(jnew, name).value), **STATE, err_msg=name)


@pytest.mark.parametrize("stochastic", [False, True])
def test_residual_vq_training_with_dropout_given_jaxs_draws(pallas_vq, monkeypatch, stochastic):
    kw = dict(dim=32, num_quantizers=4, codebook_size=64, quantize_dropout=True,
              quantize_dropout_cutoff_index=1, threshold_ema_dead_code=0.5,
              stochastic_sample_codes=stochastic)
    jr = jq.ResidualVQ(**kw, key=jax.random.PRNGKey(0))
    pr = pq.ResidualVQ(**kw)
    rng = np.random.default_rng(5)
    draws = JaxDraws(monkeypatch)

    def jrun(m, x, w, key):
        def loss(x):
            out, idx, losses, new = m(x, key=key, train=True)
            return (out * w).sum() + losses.sum(), (out, idx, losses, new)
        (_, aux), g = jax.value_and_grad(loss, has_aux=True)(x)
        return aux, g

    codes = JaxCodes(monkeypatch)
    jrun = jax.jit(jrun)
    lasts = []
    # 20000 rows: kmeans starts from 64 of 1024 candidates drawn with
    # replacement; from few rows two starting centers are often one row, and
    # the two packages' float32 sums break that exact tie differently (the
    # runs part from there on)
    for step in range(4):  # kmeans init on the first call, then EMA; the states chain
        x = rng.normal(size=(4, 5000, 32)).astype(np.float32)
        w = rng.normal(size=(4, 5000, 32)).astype(np.float32)
        key = jax.random.PRNGKey(20 + step)
        (jout, jidx, jloss, jr), jgrad = jrun(jr, jnp.asarray(x), jnp.asarray(w), key)
        draws.rvq(key, pr, 20000)
        if not stochastic:
            jcodes = np.asarray(jidx).reshape(-1, 4)
            codes.queue += [jcodes[:, q] for q in range(4) if jcodes[0, q] >= 0]
        xt = t(x).requires_grad_()
        out, idx, losses = pr(xt, train=True, generator=torch.Generator())
        assert not draws.queue and not codes.queue
        (grad,) = torch.autograd.grad((out * t(w)).sum() + losses.sum(), xt)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        lasts.append(int((idx[0, 0] >= 0).sum()) - 1)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
        np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jloss), **FWD)
        # by relative norm: a row that is itself a kmeans center leaves the
        # next quantizer a residual of float32 noise (~1e-7), whose direction,
        # and so the rotation trick's gradient there, is noise in either package
        gap = np.linalg.norm(grad.numpy() - np.asarray(jgrad)) / np.linalg.norm(jgrad)
        assert gap < 1e-2, gap
        for pl, jl in zip(pr.layers, jr.layers):
            assert bool(pl.initted) == bool(jl.initted.value)
            for name in ("codebook", "embed_avg", "cluster_size"):
                np.testing.assert_allclose(getattr(pl, name).numpy(),
                                           np.asarray(getattr(jl, name).value), **STATE)
    assert min(lasts) < 3  # some quantizers were dropped
    assert codes.near_ties <= 0.01 * 4 * 20000 * 4


# -- the generator's and the discriminators' losses ----------------------------

# every term of the loss; the STFT loss without its log-magnitude L1, whose
# gradient is held apart (test_stft_log_magnitude_gradient_matches_jax)
ALL_TERMS = dict(recon_loss_weight=10.0, si_snr_loss_weight=1.0,
                 multi_stft_recon_loss_weight=1.0, multi_stft_term_weights=(1.0, 0.0, 1.0),
                 adversarial_loss_weight=1.0, feature_loss_weight=10.0)
RECON_ONLY = dict(recon_loss_weight=10.0, si_snr_loss_weight=1.0, adversarial_loss_weight=0.0,
                  feature_loss_weight=0.0)


def _jax_train_forward(jm, x, key):
    """JAX's training forward: the total, its seven terms, the generator's
    gradients and the quantizers' state after it."""
    params, rest = partition_trainable_where(jm, lambda p: not _discr_path(p))

    def loss(p):
        from audiolm_pytorch_tpu.nn.module import combine
        total, terms, new = combine(p, rest)(x, key=key, train=True,
                                             return_loss_breakdown=True)
        return total, (jnp.stack(terms), partition_buffers(new.rq)[0])

    (total, (terms, bufs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return total, terms, jax_named(grads), jax_named(bufs)


def _check_train_forward(jm, pm, x, key, monkeypatch, grad_tol=GRAD):
    jtotal, jterms, jgrads, jbufs = _jax_train_forward(jm, jnp.asarray(x), key)
    draws = JaxDraws(monkeypatch)
    n_rows = x.shape[0] * (x.shape[1] // pm.seq_len_multiple_of)
    draws.codec(key, pm, n_rows)
    total, terms = pm(t(x), train=True, generator=torch.Generator(), return_loss_breakdown=True)
    assert not draws.queue
    params = dict(pm.named_parameters())
    names = [n for n in params if not n.startswith(("discriminators", "stft_discriminator"))]
    grads = torch.autograd.grad(total, [params[n] for n in names], allow_unused=True)
    np.testing.assert_allclose(total.item(), float(jtotal), **FWD)
    for name, got, want in zip(LOSS_NAMES, terms, np.asarray(jterms)):
        np.testing.assert_allclose(got.item(), want, **FWD, err_msg=name)
    want_grads = codec_state_dict_from_jax(jgrads)
    assert set(want_grads) == set(names)
    for name, g in zip(names, grads):
        g = torch.zeros_like(params[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), **grad_tol, err_msg=name)
    want_bufs = codec_state_dict_from_jax({".rq" + k: v for k, v in jbufs.items()})
    for name, b in pm.state_dict().items():
        if name.startswith("rq.") and b.is_floating_point():
            np.testing.assert_allclose(b.numpy(), want_bufs[name].numpy(), **STATE, err_msg=name)
    return terms


@pytest.mark.parametrize("weights", [ALL_TERMS, RECON_ONLY], ids=["all_terms", "recon_only"])
def test_train_forward_losses_and_gradients_match_jax(pallas_vq, monkeypatch, weights):
    jm, pm = _tiny_pair(seed=6, codebook_scale=0.5, **weights)
    x = _waves(np.random.default_rng(6))
    terms = _check_train_forward(jm, pm, x, jax.random.PRNGKey(12), monkeypatch)
    assert all(v.item() != 0 for v, w in zip(terms, (10, 1e-5, weights.get(
        "multi_stft_recon_loss_weight", 0), 1, weights["adversarial_loss_weight"],
        weights["feature_loss_weight"], 1)) if w)


def test_stft_log_magnitude_gradient_matches_jax(pallas_vq, monkeypatch):
    """The STFT loss's log-magnitude L1, alone: its value within 2e-3, its
    gradient by relative norm over all the generator's leaves within 1e-2.
    Elementwise the gradient of |log(m_o + 1e-5) - log(m_r + 1e-5)| is
    sign(...) / (m_r + 1e-5): its sign flips with the rounding of bins whose
    two magnitudes agree, and faint bins scale it by up to 1e5, so a few
    elements part beyond rtol 1e-2 / atol 1e-3 in any two float32 runs."""
    weights = dict(recon_loss_weight=0.0, multi_spectral_recon_loss_weight=0.0,
                   multi_stft_recon_loss_weight=1.0, multi_stft_term_weights=(0.0, 1.0, 0.0),
                   adversarial_loss_weight=0.0, feature_loss_weight=0.0,
                   rq_commitment_weight=0.0)
    jm, pm = _tiny_pair(seed=9, codebook_scale=0.5, **weights)
    x = _waves(np.random.default_rng(9))
    key = jax.random.PRNGKey(14)
    jtotal, jterms, jgrads, _ = _jax_train_forward(jm, jnp.asarray(x), key)
    JaxDraws(monkeypatch).codec(key, pm, 256)
    total, terms = pm(t(x), train=True, generator=torch.Generator(), return_loss_breakdown=True)
    np.testing.assert_allclose(terms[2].item(), float(jterms[2]), **FWD)
    params = dict(pm.named_parameters())
    want = codec_state_dict_from_jax(jgrads)
    grads = torch.autograd.grad(total, [params[n] for n in want], allow_unused=True)
    got = np.concatenate([(torch.zeros_like(params[n]) if g is None else g).numpy().ravel()
                          for n, g in zip(want, grads)])
    ref = np.concatenate([w.numpy().ravel() for w in want.values()])
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


def test_train_forward_on_the_persisted_codec_matches_jax(pallas_vq, monkeypatch):
    ckpt = jckpt.load_checkpoint(str(CKPT))
    jm = ckpt["restore"](jax.eval_shape(lambda: jss.SoundStream(**ckpt["config"],
                                                                key=jax.random.PRNGKey(0))))
    pm = load_soundstream(CKPT, device="cpu")
    x = _waves(np.random.default_rng(7), b=2, n=3200, scale=0.3)
    _check_train_forward(jm, pm, x, jax.random.PRNGKey(13), monkeypatch)


@pytest.mark.parametrize("penalty", [False, True])
def test_discr_loss_and_gradients_match_jax(penalty):
    jm, pm = _tiny_pair(seed=8)
    rng = np.random.default_rng(8)
    real, fake = _waves(rng), _waves(rng, scale=0.3)
    params, rest = partition_trainable_where(jm, _discr_path)

    def loss(p):
        from audiolm_pytorch_tpu.nn.module import combine
        m = combine(p, rest)
        parts = m._discr_loss(real, fake, penalty, True)
        return m._discr_loss(real, fake, penalty, False), jnp.stack([v for _, v in parts])

    (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pparams = dict(pm.named_parameters())
    names = [n for n in pparams if n.startswith(("discriminators", "stft_discriminator"))]
    total = pm._discr_loss(t(real), t(fake), penalty, False)
    parts = pm._discr_loss(t(real), t(fake), penalty, True)
    assert [k for k, _ in parts] == (["stft"] + ["stft_grad_penalty"] * penalty
                                     + [x for s in (1, 0.5, 0.25) for x in
                                        [f"scale:{s}"] + [f"scale_grad_penalty:{s}"] * penalty])
    np.testing.assert_allclose([v.item() for _, v in parts], np.asarray(jparts), **FWD)
    np.testing.assert_allclose(total.item(), float(jtotal), **FWD)
    grads = torch.autograd.grad(total, [pparams[n] for n in names])
    want = codec_state_dict_from_jax(jax_named(jgrads))
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD, err_msg=name)


# -- EMA, trainer steps, checkpoints -------------------------------------------

def test_ema_matches_jax():
    shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(0)))
    rng = np.random.default_rng(10)
    # the quantizers' `initted` flips between models: a bool tracks the model
    models = [jax_replace(shapes, _random_weights(shapes, rng, 0.5 if i % 2 else None))
              for i in range(6)]
    kw = dict(beta=0.9, update_after_step=2, update_every=2)
    jstate = ema_init(models[0])
    pm = SoundStream(**TINY, device="cpu")
    pm.load_state_dict(codec_state_dict_from_jax(jax_named(models[0])))
    ema = EMA(pm, **kw)
    jupdate = jax.jit(lambda s, m: ema_update(s, m, **kw))
    for m in models[1:]:
        jstate = jupdate(jstate, m)
        pm.load_state_dict(codec_state_dict_from_jax(jax_named(m)))
        ema.update(pm)
    assert ema.step == int(jstate.step) == 5
    want, got = jax_named(jstate.shadow), _port_named(ema.shadow)
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-7, err_msg=name)


class _Clips:
    """A dataset of fixed clips."""

    def __init__(self, clips):
        self.clips = clips

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]


def _trainers(tmp_path, jm, pm, **kw):
    clips = list(_waves(np.random.default_rng(12), 8, 1024))
    common = dict(num_train_steps=10, batch_size=2, grad_accum_every=2, lr=1e-5, warmup_steps=0,
                  apply_grad_penalty_every=2, ema_update_after_step=1, ema_update_every=1,
                  save_results_every=10 ** 9, save_model_every=10 ** 9, valid_frac=0.25)
    common.update(kw)
    jtr = JTrainer(jm, dataset=_Clips(clips), results_folder=str(tmp_path / "jax"),
                   data_parallel=False, **common)
    ptr = SoundStreamTrainer(pm, dataset=_Clips(clips), results_folder=tmp_path / "port",
                             device="cpu", **common)
    return jtr, ptr


def _float_leaves(named):
    return {k: v for k, v in named.items() if np.issubdtype(v.dtype, np.floating)}


def test_trainer_steps_match_the_jax_step_functions(pallas_vq, monkeypatch, tmp_path):
    """Two steps, the first with the gradient penalty: the JAX trainer's
    `_g_step` and `_d_step` against the port's `g_step` and `d_step` on the
    same batches and draws; the losses, each leaf's update, the quantizers'
    state and the EMA shadow."""
    from audiolm_pytorch_tpu.nn.module import combine
    kw = dict(rq_kwargs=dict(threshold_ema_dead_code=0.25))
    jm, pm = _tiny_pair(seed=11, codebook_scale=0.5, **kw)
    jtr, ptr = _trainers(tmp_path, jm, pm)
    draws = JaxDraws(monkeypatch)
    keys = []
    forward = ptr.model.forward

    def drawn_forward(x, **kwargs):
        if kwargs.get("train"):
            draws.codec(keys.pop(0), ptr.model, x.shape[0] * x.shape[1] // 8)
        return forward(x, **kwargs)

    monkeypatch.setattr(ptr.model, "forward", drawn_forward)
    rng = np.random.default_rng(13)
    try:
        for step in range(2):
            waves = np.stack([_waves(rng) for _ in range(2)])  # (accum, B, T)
            kg, kd = jax.random.PRNGKey(200 + step), jax.random.PRNGKey(300 + step)
            apply_gp = step % 2 == 0
            before_j, before_p = jax_named(jtr.model), _port_named(ptr.model)
            gen, rest = partition_trainable_where(jtr.model, lambda p: not _discr_path(p))
            jtr.model, jtr.gen_opt_state, jtr.ema_state, jg, jbd = jtr._g_step(
                gen, rest, jtr.gen_opt_state, jtr.ema_state, jnp.asarray(waves), kg)
            dparams, drest = partition_trainable_where(jtr.model, _discr_path)
            new_d, jtr.discr_opt_state, jd = jtr._d_step[apply_gp](
                dparams, drest, jtr.discr_opt_state, jnp.asarray(waves), kd)
            jtr.model = combine(new_d, drest)
            keys += list(jax.random.split(kg, 2))
            pg, pbd = ptr.g_step(t(waves))
            pd = ptr.d_step(t(waves), apply_gp)
            assert not draws.queue and not keys
            np.testing.assert_allclose(pg.item(), float(jg), **FWD)
            np.testing.assert_allclose(pbd.numpy(), np.asarray(jbd), **FWD)
            np.testing.assert_allclose(pd.item(), float(jd), **FWD)
            after_j, after_p = jax_named(jtr.model), _port_named(ptr.model)
            updates = {k: (after_p[k] - before_p[k], after_j[k] - before_j[k])
                       for k in _float_leaves(after_j) if "[<flat" not in k}
            largest = max(np.linalg.norm(dj) for _, dj in updates.values())
            for name, (dp, dj) in updates.items():
                if np.linalg.norm(dj) > 1e-6 * largest:
                    gap = np.linalg.norm(dp - dj) / np.linalg.norm(dj)
                    assert gap < 5e-2, (step, name, gap)
            for name in after_j:
                if "[<flat" in name:  # the quantizers' state
                    np.testing.assert_allclose(after_p[name], after_j[name], **STATE,
                                               err_msg=name)
            shadow_j, shadow_p = jax_named(jtr.ema_state.shadow), _port_named(ptr.ema.shadow)
            for name, w in _float_leaves(shadow_j).items():
                np.testing.assert_allclose(shadow_p[name], w, rtol=1e-4, atol=1e-6,
                                           err_msg=name)
    finally:
        ptr.close()
        jtr.dl_iter.stop()
        jtr.valid_dl_iter.stop()


def test_checkpoints_load_in_either_package(tmp_path):
    jm, pm = _tiny_pair(seed=14, codebook_scale=0.5)
    jtr, ptr = _trainers(tmp_path, jm, pm, warmup_steps=3, lr=1e-4)
    try:
        ptr.train_step()
        ptr.train_step()  # Adam's moments, the schedule's count and the EMA all move
        path = tmp_path / "soundstream.2.ckpt.npz"
        ptr.save(path)
        want = _port_named(ptr.model)
        # JAX reads the model, and the whole trainer state
        shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(0)))
        model = jckpt.load_pytree_into(str(path), shapes, prefix="['model']")
        got = jax_named(model)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        jtr.load(path)
        assert jtr.steps == 3
        for name, w in _port_named(ptr.ema.shadow).items():
            np.testing.assert_array_equal(jax_named(jtr.ema_state.shadow)[name], w)
        assert int(jtr.gen_opt_state[1].count) == 2 and int(jtr.gen_opt_state[2].count) == 2
        mu = codec_state_dict_from_jax(jax_named(jtr.gen_opt_state[1].mu))
        for name, p in ptr.model.named_parameters():
            if name in mu:
                np.testing.assert_array_equal(mu[name].numpy(),
                                              ptr.gen_opt.state[p]["exp_avg"].numpy())
        # and the port reads what the JAX trainer writes
        path2 = tmp_path / "jax.2.ckpt.npz"
        jtr.save(path2)
        with np.load(path2) as data:
            assert json.loads(bytes(data["__meta__"].tobytes()))["kind"] == "SoundStreamTrainer"
        _, pm2 = _tiny_pair(seed=15, codebook_scale=0.5)
        _, ptr2 = _trainers(tmp_path / "second", jm, pm2, warmup_steps=3, lr=1e-4)
        ptr2.load(path2)
        assert ptr2.steps == 3 and ptr2.ema.step == ptr.ema.step
        for name, w in want.items():
            np.testing.assert_array_equal(_port_named(ptr2.model)[name], w, err_msg=name)
        for opt, opt2, params, params2 in ((ptr.gen_opt, ptr2.gen_opt, ptr.gen_params,
                                            ptr2.gen_params),
                                           (ptr.discr_opt, ptr2.discr_opt, ptr.discr_params,
                                            ptr2.discr_params)):
            for p, p2 in zip(params, params2):
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(opt.state[p][key], opt2.state[p2][key])
        assert ptr2.gen_sched.last_epoch == ptr.gen_sched.last_epoch == 2
        assert ptr2.gen_opt.param_groups[0]["lr"] == ptr.gen_opt.param_groups[0]["lr"]
        codec = load_pytree_into(path2, SoundStream(**TINY, device="cpu"), "['ema'].shadow")
        for name, w in _port_named(ptr.ema.shadow).items():
            np.testing.assert_array_equal(_port_named(codec)[name], w)
        np.testing.assert_array_equal(
            _port_named(load_soundstream(path, device="cpu"))[".encoder_init.weight"],
            want[".encoder_init.weight"])
        ptr2.close()
    finally:
        ptr.close()
        jtr.dl_iter.stop()
        jtr.valid_dl_iter.stop()


def test_trainer_loop_saves_samples_and_resumes(tmp_path):
    folder = tmp_path / "sines"
    rng = np.random.default_rng(16)
    for i in range(4):
        paudio.save_audio(folder / f"sine_{i}.wav", _waves(rng, 1, 2048)[0], 16000)
    kw = dict(folder=folder, batch_size=2, grad_accum_every=2, num_train_steps=2,
              data_max_length=1024, save_results_every=2, save_model_every=2,
              results_folder=tmp_path / "results", warmup_steps=1, apply_grad_penalty_every=2,
              device="cpu")
    trainer = SoundStreamTrainer(SoundStream(**TINY, device="cpu"), **kw)
    try:
        trainer.train()
        assert trainer.steps == 2
        assert [p.name for p in (tmp_path / "results").glob("*.ckpt.npz")] == \
            ["soundstream.2.ckpt.npz"]
        assert sorted(p.name for p in (tmp_path / "results").glob("sample.*.wav")) == \
            ["sample.2.wav", "sample.ema.2.wav"]
        logs = [json.loads(line) for line in open(tmp_path / "results" / "metrics.jsonl")]
        assert [r["step"] for r in logs] == [0, 1] and all(np.isfinite(r["loss"]) for r in logs)
    finally:
        trainer.close()
    resumed = SoundStreamTrainer(SoundStream(**TINY, device="cpu"), **kw)
    try:
        assert resumed.resume_latest() and resumed.steps == 3
    finally:
        resumed.close()


def test_loader_keeps_the_discriminators_unless_serving():
    codec = load_soundstream(CKPT, device="cpu")
    served = load_soundstream(CKPT, device="cpu", discriminators=False)
    assert codec.discriminators is not None and served.discriminators is None
    with np.load(CKPT) as data:
        names = json.loads(bytes(data["__meta__"].tobytes()))["leaf_names"]
    assert set(_port_named(codec)) == set(names)
    assert not any(k.startswith(("discriminators", "stft_discriminator"))
                   for k in served.state_dict())
    x = t(_waves(np.random.default_rng(18), 1, 3200, 0.3))
    with torch.no_grad():
        assert torch.equal(codec.tokenize(x), served.tokenize(x))


def test_unported_trainer_options_raise(tmp_path):
    clips = _Clips(list(_waves(np.random.default_rng(17), 4, 1024)))
    kw = dict(dataset=clips, num_train_steps=1, batch_size=2, results_folder=tmp_path,
              device="cpu")
    with pytest.raises(NotImplementedError, match="bf16_compute"):
        SoundStreamTrainer(SoundStream(**TINY, device="cpu"), bf16_compute=True, **kw)
    with pytest.raises(NotImplementedError, match="wandb"):
        SoundStreamTrainer(SoundStream(**TINY, device="cpu"), use_wandb_tracking=True, **kw)


def test_quantizer_without_kmeans_init_starts_uniform_and_trains():
    gen = torch.Generator().manual_seed(0)
    layer = pq.VectorQuantizeEMA(32, 64, kmeans_init=False, generator=gen)
    assert bool(layer.initted) and layer.codebook.abs().max() <= 1 / 64
    assert torch.equal(layer.embed_avg, layer.codebook)
    before = layer.codebook.clone()
    x = t(np.random.default_rng(19).normal(size=(2, 40, 32)).astype(np.float32))
    out, idx, loss = layer(x, train=True, generator=gen)  # no kmeans: EMA at once
    assert out.shape == x.shape and idx.shape == (2, 40) and torch.isfinite(loss)
    assert not torch.equal(layer.codebook, before)
