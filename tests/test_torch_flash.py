"""The port's flash-attention forward against the JAX package's Pallas kernel
(interpret mode on the CPU) and its `_math_reference`; at head dims 16 and
128 the forward and every gradient in the LMs' four forms against the
Pallas kernels, and the padded route the CUDA wrappers take for a head dim
the kernels are not built for.

On the CPU the wrapper takes the plain version, `flash_attention_ref`; the
CUDA kernel itself is held to that plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py. Tolerances: 2e-3 in float32,
3e-2 in bfloat16, as in the JAX package's flash tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.ops.pallas.flash_attention import (
    _flash_forward, _math_reference, flash_attention as j_flash)
from audiolm_pytorch_tpu.ops.relpos import toeplitz_expand as j_toeplitz

from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa

from torch_port_util import t

TOL = dict(rtol=2e-3, atol=2e-3)

# (n, causal, mqa, key mask): unaligned lengths, MQA and a key mask that pads rows
CASES = [(37, True, True, True), (130, True, False, True), (64, False, True, False),
         (50, False, False, True)]


def _inputs(n, mqa, masked, seed=0, b=2, h=4, d=32):
    rng = np.random.default_rng(seed)
    hk = 1 if mqa else h
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    tab = (0.5 * rng.normal(size=(2 * n - 1, h))).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, n), bool)
        mask[1, (2 * n) // 3:] = False
    return q, k, v, tab, mask


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_ref_matches_pallas_kernel_with_bias_table(n, causal, mqa, masked):
    q, k, v, tab, mask = _inputs(n, mqa, masked)
    ref = j_flash(_j(q), _j(k), _j(v), bias_tab=_j(tab), key_mask=_j(mask), causal=causal,
                  block_q=32, block_k=32, interpret=True)
    out = fa.flash_attention(t(q), t(k), t(v), bias_tab=t(tab),
                             key_mask=None if mask is None else t(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_ref_matches_math_reference_and_lse(n, causal, mqa, masked):
    q, k, v, tab, mask = _inputs(n, mqa, masked, seed=1)
    bias = j_toeplitz(_j(tab), n, n)
    scale = q.shape[-1] ** -0.5
    ref = _math_reference(_j(q), _j(k), _j(v), bias, _j(mask), causal, scale)
    _, ref_lse = _flash_forward(_j(q), _j(k), _j(v), bias=bias, key_mask=_j(mask),
                                causal=causal, block_q=32, block_k=32, interpret=True,
                                return_lse=True)
    out, lse = fa.flash_attention_ref(t(q), t(k), t(v), bias_tab=t(tab),
                                      key_mask=None if mask is None else t(mask),
                                      causal=causal, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)


def test_ref_bf16_matches_pallas_kernel():
    q, k, v, tab, mask = _inputs(48, True, True, seed=2)
    bf = jnp.bfloat16
    ref = j_flash(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
                  bias_tab=_j(tab), key_mask=_j(mask), causal=True, block_q=16, block_k=16,
                  interpret=True)
    out = fa.flash_attention(t(q, torch.bfloat16), t(k, torch.bfloat16), t(v, torch.bfloat16),
                             bias_tab=t(tab), key_mask=t(mask), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("mqa", [True, False])
def test_ref_matches_pallas_kernel_with_whole_key_tiles_masked(mqa):
    # keys 0-39 masked in row 0 (a whole 32-key tile: left padding), every
    # key in row 1. A row with no key weighs every key alike in
    # `_math_reference`; the Pallas kernel also weighs its padding keys (its
    # output there is finite, but not that mean), so row 1 is held to the
    # former only.
    n = 70
    q, k, v, tab, _ = _inputs(n, mqa, False, seed=5)
    mask = np.ones((2, n), bool)
    mask[0, :40] = False
    mask[1] = False
    ref = np.asarray(j_flash(_j(q), _j(k), _j(v), bias_tab=_j(tab), key_mask=_j(mask),
                             causal=False, block_q=32, block_k=32, interpret=True))
    math = _math_reference(_j(q), _j(k), _j(v), j_toeplitz(_j(tab), n, n), _j(mask), False,
                           q.shape[-1] ** -0.5)
    out = fa.flash_attention(t(q), t(k), t(v), bias_tab=t(tab), key_mask=t(mask)).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out[0], ref[0], **TOL)
    np.testing.assert_allclose(out, np.asarray(math), **TOL)


def test_ref_computes_float64_inputs_in_float64():
    # the float64 evaluation the kernels' float32 accuracy is measured against
    q, k, v, tab, mask = _inputs(40, True, True, seed=6)
    g = np.random.default_rng(7).normal(size=q.shape)
    kw = dict(causal=True, scale=0.125)
    f32 = (t(q), t(k), t(v), t(tab), t(mask))
    f64 = tuple(torch.from_numpy(a.astype(np.float64)) for a in (q, k, v, tab)) + (t(mask),)
    results = []
    for qq, kk, vv, tb, mk in (f32, f64):
        out, lse = fa.flash_attention_ref(qq, kk, vv, bias_tab=tb, key_mask=mk, **kw,
                                          return_lse=True)
        grads = fa.flash_attention_bwd_ref(qq, kk, vv, tb, mk, out, lse,
                                           torch.from_numpy(g).to(qq.dtype), **kw)
        results.append((out, lse, *grads))
    for a, b in zip(*results):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, tab, mask = _inputs(20, True, True, seed=3)
    before = fa.launches
    out = fa.flash_attention(t(q), t(k), t(v), bias_tab=t(tab), key_mask=t(mask), causal=True)
    ref = fa.flash_attention_ref(t(q), t(k), t(v), bias_tab=t(tab), key_mask=t(mask),
                                 causal=True)
    assert torch.equal(out, ref)
    assert fa.launches == before


@pytest.mark.parametrize("bad", ["dtype", "kv_heads", "tab_shape", "mask_dtype", "causal_nm"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, tab, mask = _inputs(16, True, True, seed=4)
    q, k, v, tab, mask = t(q), t(k), t(v), t(tab), t(mask)
    kw = dict(bias_tab=tab, key_mask=mask, causal=True)
    if bad == "dtype":
        q = q.double()
    elif bad == "kv_heads":
        k = v = torch.zeros(2, 3, 16, 32)
    elif bad == "tab_shape":
        kw["bias_tab"] = tab[1:]
    elif bad == "mask_dtype":
        kw["key_mask"] = mask.int()
    else:
        k, v = k[:, :, :8].contiguous(), v[:, :, :8].contiguous()
        kw["bias_tab"] = None
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v, **kw)



# (n, m, causal) of the LMs' four forms of attention: the Semantic LM's
# rel-pos table, the Coarse and Fine LMs' (H, N, M) bias, text conditioning's
# prefix (causal over M = P + N keys) and cross attention
FORMS = {"table": (50, 50, True), "bias": (50, 50, True), "prefix": (40, 56, True),
         "cross": (40, 17, False)}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("d", [16, 128, 256, 320])
def test_plain_versions_match_pallas_at_head_dims(d, form):
    """The forward and every gradient of the port's plain versions (the ones
    the kernels are held to on the card, here through the autograd.Function
    on CPU tensors) against JAX's Pallas kernels under `jax.vjp`, at a head
    dim the kernels take by zero padding (16), at the widest of their native
    forms (128) and at two of the column-sliced form's (256, 320). JAX's
    Pallas kernel aligns a causal mask with M > N to the top left (a recorded
    divergence, tests/test_torch_conditioning.py), so the prefix's
    bottom-right mask reaches it as a -1e30 bias, non-causal."""
    n, m, causal = FORMS[form]
    rng = np.random.default_rng(d + 10 * len(form))
    b, h = 2, 4
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, 1, m, d)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[1, (2 * m) // 3:] = False
    extra, jextra, jcausal = None, None, causal
    if form == "table":
        extra = jextra = (0.5 * rng.normal(size=(2 * n - 1, h))).astype(np.float32)
    elif form in ("bias", "prefix"):
        extra = jextra = (0.5 * rng.normal(size=(h, n, m))).astype(np.float32)
    if form == "prefix":
        keep = np.tril(np.ones((n, m), bool), m - n)
        jextra = np.where(keep, extra, np.float32(-1e30)).astype(np.float32)
        jcausal = False
    key = "bias_tab" if form == "table" else "bias"

    def jf(*args):
        kw = {key: args[3]} if len(args) > 3 else {}
        return j_flash(*args[:3], key_mask=jnp.asarray(mask), causal=jcausal, block_q=16,
                       block_k=16, interpret=True, **kw)

    jargs = [jnp.asarray(a) for a in (q, k, v) + (() if extra is None else (jextra,))]
    want, vjp = jax.vjp(jf, *jargs)
    wgrads = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_() for a in (q, k, v) + (() if extra is None else (extra,))]
    kw = {key: leaves[3]} if extra is not None else {}
    out = fa.flash_attention(*leaves[:3], key_mask=t(mask), causal=causal, **kw)
    grads = torch.autograd.grad(out, leaves, t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, wgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL, err_msg=name)


@pytest.mark.parametrize("d", [8, 48, 96, 160, 300])
def test_padded_route_equals_the_unpadded_plain_version(d):
    """What the CUDA wrappers do with a head dim the kernels are not built
    for, computed through the plain versions in float64: q, k, v (and, for
    the backward, out and dO) zero-padded to the next built head dim, the
    true D's scale, the results sliced back. The padded columns of the
    output and of every gradient are zeros, the rest equal the unpadded
    plain version's."""
    assert fa.native_head_dim(d) == {8: 32, 48: 64, 96: 128, 160: 192, 300: 320}[d]
    rng = np.random.default_rng(d)
    q, k, v, tab, mask = _inputs(70, True, True, seed=d, d=d)
    q, k, v, tab = (torch.from_numpy(a.astype(np.float64)) for a in (q, k, v, tab))
    g = torch.from_numpy(rng.normal(size=q.shape))
    mask = t(mask)
    kw = dict(bias_tab=tab, key_mask=mask, causal=True, scale=d ** -0.5)
    out, lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    grads = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, causal=True,
                                       scale=d ** -0.5)
    qp, kp, vp, gp = fa._padded(q, k, v, g)
    assert qp.shape[-1] == fa.native_head_dim(d)
    out_p, lse_p = fa.flash_attention_ref(qp, kp, vp, **kw, return_lse=True)
    grads_p = fa.flash_attention_bwd_ref(qp, kp, vp, tab, mask, out_p, lse_p, gp, causal=True,
                                         scale=d ** -0.5)
    tight = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(out_p[..., :d], out, **tight)
    torch.testing.assert_close(lse_p, lse, **tight)
    assert not out_p[..., d:].any()
    for name, a, r in zip(("dq", "dk", "dv"), grads_p, grads):
        torch.testing.assert_close(a[..., :d], r, **tight, msg=name)
        assert not a[..., d:].any(), name
    torch.testing.assert_close(grads_p[3], grads[3], **tight)


def test_wrapper_names_the_head_dims_the_card_takes():
    """Every head dim: the native forms' 32, 64 and 128 (another D up to 128
    padded to the next of them), and over 128 the column-sliced form's
    multiples of 64 (another D padded to the next of them); a head dim under
    1 is no head dim."""
    assert fa.HEAD_DIMS == (32, 64, 128) and fa.WIDE_CHUNK == 64
    assert [fa.native_head_dim(d) for d in (1, 16, 32, 33, 64, 80, 128)] == [32, 32, 32, 64, 64,
                                                                           128, 128]
    assert [fa.native_head_dim(d) for d in (129, 160, 192, 256, 257, 320, 512, 1000)] == [
        192, 192, 192, 256, 320, 320, 512, 1024]
    with pytest.raises(ValueError, match="1 and more"):
        fa.native_head_dim(0)
