"""The port's blocked local attention (K7) and the codec's attention modules
against the JAX package on the CPU: the plain version of K7 against the
model path's XLA `local_attention` and the Pallas kernel
`local_attention_pallas` in interpret mode, with and without a key mask and
an (H, w, 2w) bias, at T that is and is not a multiple of the window; the
case where the two JAX versions part (a query of window 0 whose every key is
masked), where the port follows the model path; q, k, v handed over as
LocalMHA's strided views of one projection, and which layouts the kernel
reads in place; the float64 evaluation the card's float32 kernel is held
to; gradients through the port's autograd.Function against `jax.vjp` of
the Pallas kernel (whose backward is XLA's); and `rotary_xpos`, `DynamicPositionBias`, `LocalMHA`
and `LocalTransformer` with weights copied across. Both sides get the same
numpy inputs.

Tolerances: 2e-3 on outputs (the JAX package's own for the Pallas kernel
against XLA); rtol 1e-2 / atol 1e-3 on gradients; 1e-5 on rotary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.ops import attention as ja
from audiolm_pytorch_tpu.ops.pallas.local_attention import local_attention_pallas

from audiolm_pytorch_tpu_torch.ops import attention as pa
from audiolm_pytorch_tpu_torch.ops.kernels import local_attention as pk
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax

from torch_port_util import jax_named, jax_replace, t

TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = dict(rtol=1e-2, atol=1e-3)


def _inputs(rng, b, h, n, d, w, masked, biased):
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((b, n), bool)
        mask[0, (2 * n) // 3:] = False
        mask[-1, rng.random(n) < 0.2] = False
        # key 0 kept: a query of window 0 left without any key is where the
        # two JAX versions part (the test after the next)
        mask[:, 0] = True
    bias = (0.3 * rng.normal(size=(h, w, 2 * w))).astype(np.float32) if biased else None
    return q, k, v, mask, bias


def _jax(fn, q, k, v, mask, bias, w, **kw):
    """fn compiled whole: op by op, JAX compiles each op for each shape."""
    run = jax.jit(lambda *a: fn(*a[:3], window_size=w, mask=a[3], attn_bias=a[4], **kw))
    return np.asarray(run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if mask is None else jnp.asarray(mask),
                          None if bias is None else jnp.asarray(bias)))


def _port(q, k, v, mask, bias, w, **kw):
    return pk.local_attention(t(q), t(k), t(v), window_size=w,
                              mask=None if mask is None else t(mask),
                              attn_bias=None if bias is None else t(bias), **kw)


@pytest.mark.parametrize("masked,biased", [(False, False), (True, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("n,w", [(16, 16), (100, 64), (128, 64), (300, 64), (100, 16),
                                 (300, 16), (61, 8), (150, 32), (130, 48), (250, 96)])
def test_plain_k7_matches_xla_and_pallas(n, w, masked, biased):
    rng = np.random.default_rng(n + w + 2 * masked + biased)
    q, k, v, mask, bias = _inputs(rng, 2, 2, n, 16, w, masked, biased)
    got = _port(q, k, v, mask, bias, w, scale=0.3).numpy()
    np.testing.assert_allclose(got, _jax(ja.local_attention, q, k, v, mask, bias, w, scale=0.3),
                               **TOL)
    np.testing.assert_allclose(got, _jax(local_attention_pallas, q, k, v, mask, bias, w,
                                         scale=0.3, interpret=True), **TOL)


def test_window_zero_fully_masked_follows_the_model_path():
    """Keys 0-3 masked: queries 0-3 of window 0 have no key. The XLA version
    (the model's) averages its 2w value slots, the zero look-back among them;
    the Pallas kernel looks back on window 0 itself. The port follows XLA."""
    rng = np.random.default_rng(5)
    w = 16
    q, k, v, _, _ = _inputs(rng, 1, 2, 64, 16, w, False, False)
    mask = np.ones((1, 64), bool)
    mask[0, :4] = False
    xla = _jax(ja.local_attention, q, k, v, mask, None, w)
    pallas = _jax(local_attention_pallas, q, k, v, mask, None, w, interpret=True)
    got = _port(q, k, v, mask, None, w).numpy()
    np.testing.assert_allclose(got, xla, **TOL)
    np.testing.assert_allclose(got[:, :, :4], v[:, :, :w].sum(2, keepdims=True) / (2 * w)
                               + np.zeros((1, 2, 4, 16), np.float32), **TOL)
    assert np.abs(pallas[:, :, :4] - xla[:, :, :4]).max() > 0.05
    np.testing.assert_allclose(pallas[:, :, 4:], xla[:, :, 4:], **TOL)


def _projection_views(rng, b, h, n, d):
    """q, k, v as LocalMHA hands them to K7: (B, H, T, D) views of the three
    chunks of one (B, T, 3 H D) projection, none of them contiguous."""
    qkv = t(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    return [a.reshape(b, n, h, d).transpose(1, 2) for a in qkv.chunk(3, dim=-1)]


@pytest.mark.parametrize("n,w", [(100, 64), (300, 16)])
def test_plain_k7_takes_strided_views_and_matches_xla(n, w):
    rng = np.random.default_rng(11 + n)
    views = _projection_views(rng, 2, 2, n, 16)
    assert not any(a.is_contiguous() for a in views)
    q, k, v = (np.ascontiguousarray(a.numpy()) for a in views)
    _, _, _, mask, bias = _inputs(rng, 2, 2, n, 16, w, True, True)
    got = pk.local_attention(*views, window_size=w, mask=t(mask), attn_bias=t(bias), scale=0.3)
    np.testing.assert_allclose(got.numpy(), _jax(ja.local_attention, q, k, v, mask, bias, w,
                                                 scale=0.3), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_projection_views_in_place_and_copies_other_layouts(dtype):
    # the kernel's 16-byte copies need a contiguous last dimension, and
    # (batch, head, time) strides and an address that are multiples of 16 bytes
    b, h, n, d = 2, 3, 10, 64
    views = [a.reshape(b, n, h, d).transpose(1, 2)
             for a in torch.zeros(b, n, 3 * h * d, dtype=dtype).chunk(3, dim=-1)]
    assert all(pk._readable(a) is a for a in views)
    others = (torch.arange(b * h * n * d + 1, dtype=dtype)[1:].view(b, h, n, d),  # misaligned
              torch.randn(b, h, n, 2 * d).to(dtype)[..., ::2],  # strided last dimension
              torch.randn(b, h, n, d + 2).to(dtype)[..., :d])  # rows 2 elements apart too many
    for a in others:
        got = pk._readable(a)
        assert got is not a and got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, a)


def test_plain_k7_evaluates_float64_inputs_in_float64():
    # the float64 evaluation a float32 kernel is held to on the card
    rng = np.random.default_rng(12)
    q, k, v, mask, bias = _inputs(rng, 2, 2, 100, 16, 64, True, True)
    kw = dict(window_size=64, mask=t(mask), scale=0.3)
    got64 = pk.local_attention_ref(t(q).double(), t(k).double(), t(v).double(),
                                   attn_bias=t(bias).double(), **kw)
    got32 = pk.local_attention_ref(t(q), t(k), t(v), attn_bias=t(bias), **kw)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), _jax(ja.local_attention, q, k, v, mask, bias, 64,
                                                   scale=0.3), **TOL)
    assert 0 < (got64 - got32.double()).abs().max() < 1e-5


@pytest.mark.parametrize("masked,biased", [(False, False), (True, True)])
@pytest.mark.parametrize("n,w", [(64, 16), (100, 64), (45, 8), (70, 32), (110, 48),
                                 (150, 96)])
def test_k7_gradients_match_jax(n, w, masked, biased):
    rng = np.random.default_rng(7 + n)
    q, k, v, mask, bias = _inputs(rng, 2, 2, n, 16, w, masked, biased)
    g = rng.normal(size=q.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    diff = [q, k, v] + ([bias] if biased else [])

    def jfn(*a):
        return local_attention_pallas(*a[:3], window_size=w, mask=jmask,
                                      attn_bias=a[3] if biased else None, interpret=True)

    want = jax.jit(lambda g_, *a: jax.vjp(jfn, *a)[1](g_))(jnp.asarray(g),
                                                           *(jnp.asarray(a) for a in diff))
    leaves = [t(a).requires_grad_() for a in diff]
    out = pk.local_attention(*leaves[:3], window_size=w,
                             mask=None if mask is None else t(mask),
                             attn_bias=leaves[3] if biased else None)
    got = torch.autograd.grad(out, leaves, t(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def _tile_keys(q0, t_, w):
    """csrc/local_attn.cu's walk (k_lo, ntiles) for its block of queries
    [q0, q0 + 63]: the first key, from the first row's look-back (none
    before key 0), and the 64-key tiles up to the block's last query (none
    at or past T)."""
    k_lo = max(0, (q0 // w - 1) * w)
    return k_lo, (min(q0 + 63, t_ - 1) - k_lo) // 64 + 1


@pytest.mark.parametrize("w", [1, 2, 7, 8, 16, 31, 32, 48, 63, 64, 65, 96, 128, 160])
def test_k7_tile_walk_visits_every_allowed_pair(w):
    """Each 64-query block of the kernel visits the keys of its walk
    (`_tile_keys`, the kernel's arithmetic): every pair the function allows
    (the key at or before the query, in its window or the one before) lies
    in them, and every visited tile holds a key some query of the block may
    see. The GPU tests hold the kernel's own walk to the plain version."""
    for t_ in (1, 7, 64, 65, 100, 129, 257, 400, 700):
        pos = np.arange(t_)
        lo = np.maximum(0, (pos // w - 1) * w)  # each query's first allowed key
        for q0 in range(0, t_, 64):
            k_lo, ntiles = _tile_keys(q0, t_, w)
            rows = pos[q0:q0 + 64]
            assert ntiles >= 1 and k_lo <= lo[rows].min() and k_lo + 64 * ntiles > rows.max()
            for i in range(ntiles):  # no tile of keys that no row sees
                k0 = k_lo + 64 * i
                assert k0 < t_ and (lo[rows] <= k0 + 63).any() and (rows >= k0).any()


@pytest.mark.parametrize("scale_base,invert", [(512.0, False), (8.0, True), (64.0, False)])
def test_rotary_xpos_matches_jax(scale_base, invert):
    x = np.random.default_rng(0).normal(size=(2, 3, 40, 16)).astype(np.float32)
    want = ja.rotary_xpos(jnp.asarray(x), scale_base=scale_base, invert_scale=invert)
    got = pa.rotary_xpos(t(x), scale_base=scale_base, invert_scale=invert)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _load(pm, jm):
    pm.load_state_dict(codec_state_dict_from_jax(jax_named(jm)))
    return pm


def test_dynamic_position_bias_matches_jax():
    jm = ja.DynamicPositionBias(dim=16, heads=3, key=jax.random.PRNGKey(0))
    pm = _load(pa.DynamicPositionBias(dim=16, heads=3), jm)
    np.testing.assert_allclose(pm(8, 16).detach().numpy(), np.asarray(jm(8, 16)), **TOL)


def _randomized(jm, rng):
    """The qk-RMSNorm scales away from their init of ones."""
    named = jax_named(jm)
    return jax_replace(jm, {k: rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
                            for k, a in named.items() if k.endswith(("q_scale", "k_scale"))})


def test_local_mha_matches_jax():
    rng = np.random.default_rng(1)
    jm = _randomized(ja.LocalMHA(dim=32, heads=2, dim_head=16, window_size=16,
                                 key=jax.random.PRNGKey(1)), rng)
    pm = _load(pa.LocalMHA(dim=32, heads=2, dim_head=16, window_size=16), jm)
    x = rng.normal(size=(2, 50, 32)).astype(np.float32)
    mask = np.ones((2, 50), bool)
    mask[1, 30:] = False
    run = jax.jit(lambda mod, a, m: mod(a, mask=m))
    for m in (None, mask):
        want = run(jm, jnp.asarray(x), None if m is None else jnp.asarray(m))
        got = pm(t(x), mask=None if m is None else t(m))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dynamic_pos_bias", [False, True])
def test_local_transformer_matches_jax(dynamic_pos_bias):
    rng = np.random.default_rng(2)
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, window_size=16,
              dynamic_pos_bias=dynamic_pos_bias)
    jm = _randomized(ja.LocalTransformer(**kw, key=jax.random.PRNGKey(2)), rng)
    pm = _load(pa.LocalTransformer(**kw), jm)
    x = rng.normal(size=(2, 40, 32)).astype(np.float32)
    want = jax.jit(lambda mod, a: mod(a))(jm, jnp.asarray(x))
    np.testing.assert_allclose(pm(t(x)).detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [16, 128, 256])
def test_plain_k7_matches_xla_and_pallas_at_head_dims(d):
    """A head dim the kernel takes by zero padding (16), the widest of its
    native forms (128) and one of its column-sliced form's (256), masked
    and biased, T past a window multiple."""
    rng = np.random.default_rng(d)
    q, k, v, mask, bias = _inputs(rng, 2, 2, 150, d, 64, True, True)
    got = _port(q, k, v, mask, bias, 64).numpy()
    np.testing.assert_allclose(got, _jax(ja.local_attention, q, k, v, mask, bias, 64), **TOL)
    np.testing.assert_allclose(got, _jax(local_attention_pallas, q, k, v, mask, bias, 64,
                                         interpret=True), **TOL)


@pytest.mark.parametrize("d", [8, 48, 96, 160])
def test_k7_padded_route_equals_the_unpadded_plain_version(d):
    """What the CUDA wrapper does with a head dim the kernel is not built
    for, through the plain version in float64: q, k, v zero-padded to the
    next built head dim, the true D's scale, the output sliced back; its
    padded columns are zeros."""
    rng = np.random.default_rng(d)
    q, k, v, mask, bias = _inputs(rng, 2, 2, 150, d, 64, True, True)
    q, k, v, bias = (torch.from_numpy(a.astype(np.float64)) for a in (q, k, v, bias))
    dn = pk.native_head_dim(d)
    assert dn == {8: 32, 48: 64, 96: 128, 160: 192}[d]
    kw = dict(window_size=64, mask=t(mask), attn_bias=bias, scale=d ** -0.5)
    want = pk.local_attention_ref(q, k, v, **kw)
    pad = [torch.nn.functional.pad(a, (0, dn - d)) for a in (q, k, v)]
    got = pk.local_attention_ref(*pad, **kw)
    torch.testing.assert_close(got[..., :d], want, rtol=1e-12, atol=1e-12)
    assert not got[..., d:].any()
