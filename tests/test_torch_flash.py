"""The port's flash-attention forward against the JAX package's Pallas kernel
(interpret mode on the CPU) and its `_math_reference`.

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

