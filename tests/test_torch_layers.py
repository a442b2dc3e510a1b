"""The PyTorch port's layers, sampling helpers, rel-pos bias, attention and
hyper-connections against the JAX package, module by module, on the CPU.
Inputs come from numpy with a fixed seed; weights are copied across by key
path. Tolerance 2e-3 (float32), as in the JAX package's own tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import transformer as jtr
from audiolm_pytorch_tpu.models.wrappers import masked_cross_entropy as j_mce
from audiolm_pytorch_tpu.nn import layers as jl
from audiolm_pytorch_tpu.ops import sampling as js
from audiolm_pytorch_tpu.ops.attention import attend as j_attend
from audiolm_pytorch_tpu.ops.relpos import toeplitz_expand as j_toeplitz

from audiolm_pytorch_tpu_torch.models import transformer as ptr
from audiolm_pytorch_tpu_torch.models.wrappers import masked_cross_entropy as p_mce
from audiolm_pytorch_tpu_torch.nn import layers as pl
from audiolm_pytorch_tpu_torch.ops import sampling as ps
from audiolm_pytorch_tpu_torch.ops.attention import attend as p_attend
from audiolm_pytorch_tpu_torch.ops.relpos import toeplitz_expand as p_toeplitz

from torch_port_util import jax_named, jax_replace, load_into, randomize_dynamic, t

TOL = dict(rtol=2e-3, atol=2e-3)
KEY = jax.random.PRNGKey(0)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))


def test_layernorm():
    rng = np.random.default_rng(0)
    j = jax_replace(jl.LayerNorm(16), {".gamma": rng.normal(size=16)})
    p = load_into(pl.LayerNorm(16), j)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3 + 1
    close(p(t(x)), j(jnp.asarray(x)))


def test_rmsnorm():
    rng = np.random.default_rng(1)
    j = jax_replace(jl.RMSNorm(16), {".gamma": rng.normal(size=16)})
    p = load_into(pl.RMSNorm(16), j)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    close(p(t(x)), j(jnp.asarray(x)))


def test_feedforward():
    rng = np.random.default_rng(2)
    j = jl.FeedForward(24, key=KEY)
    j = jax_replace(j, {".pre_norm.gamma": rng.normal(size=24), ".norm.gamma": rng.normal(size=64)})
    p = load_into(pl.FeedForward(24), j)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    close(p(t(x)), j(jnp.asarray(x)))


def test_linear_with_bias():
    j = jl.Linear(5, 3, key=KEY)
    j = jax_replace(j, {".bias": np.arange(3, dtype=np.float32)})
    p = load_into(pl.Linear(5, 3), j)
    x = np.random.default_rng(3).normal(size=(4, 5)).astype(np.float32)
    close(p(t(x)), j(jnp.asarray(x)))


@pytest.mark.parametrize("i,j", [(6, 6), (3, 7), (1, 9)])
def test_relpos_table_and_expand(i, j):
    jm = jtr.RelativePositionBias(dim=16, heads=4, key=KEY)
    pm = load_into(ptr.RelativePositionBias(dim=16, heads=4), jm)
    jtab = jm.table(j)
    ptab = pm.table(j)
    close(ptab, jtab)
    close(p_toeplitz(ptab, i, j), j_toeplitz(jtab, i, j))


@pytest.mark.parametrize("mqa", [True, False])
def test_attend(mqa):
    rng = np.random.default_rng(4)
    b, h, n, m, d = 2, 4, 6, 9, 8
    hk = 1 if mqa else h
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in [(b, h, n, d), (b, hk, m, d), (b, hk, m, d)])
    bias = rng.normal(size=(h, n, m)).astype(np.float32)
    mask = rng.uniform(size=(b, 1, 1, m)) > 0.3
    mask[..., 0] = True
    ref = j_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
                   attn_bias=jnp.asarray(bias), causal=True)
    out = p_attend(t(q), t(k), t(v), mask=t(mask), attn_bias=t(bias), causal=True)
    close(out, ref)


def _attention_pair(dim=32, heads=4, dim_head=8):
    jm = jtr.Attention(dim, causal=True, heads=heads, dim_head=dim_head, key=KEY)
    rng = np.random.default_rng(5)
    jm = jax_replace(jm, {".norm.gamma": rng.normal(size=dim)})
    return jm, load_into(ptr.Attention(dim, heads=heads, dim_head=dim_head), jm)


def test_attention_key_mask_and_value_residual():
    jm, pm = _attention_pair()
    rng = np.random.default_rng(6)
    b, n = 2, 11
    x = rng.normal(size=(b, n, 32)).astype(np.float32)
    vr = rng.normal(size=(b, n, 8)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 7:] = False
    tab = rng.normal(size=(2 * n - 1, 4)).astype(np.float32)
    jout, jv = jm(jnp.asarray(x), mask=jnp.asarray(mask),
                  attn_bias=jtr.RelPosTable(jnp.asarray(tab)),
                  value_residual=jnp.asarray(vr), return_values=True)
    pout, pv = pm(t(x), mask=t(mask), bias_tab=t(tab), value_residual=t(vr))
    close(pout, jout)
    close(pv, jv)


def test_attention_cached_step():
    jm, pm = _attention_pair()
    rng = np.random.default_rng(7)
    b, n, max_len, pos = 2, 3, 10, 4
    x = rng.normal(size=(b, n, 32)).astype(np.float32)
    cache = rng.normal(size=(2, b, max_len, 8)).astype(np.float32)
    bias = rng.normal(size=(4, n, max_len)).astype(np.float32)
    jout, jcache = jm(jnp.asarray(x), attn_bias=jnp.asarray(bias), cache_kv=jnp.asarray(cache),
                      cache_pos=pos, return_kv=True)
    pc = t(cache)
    pout, _ = pm(t(x), cache_bias=t(bias), cache_kv=(pc[0], pc[1]), cache_pos=pos)
    close(pout, jout)
    close(pc, jcache)


@pytest.mark.parametrize("streams", [4, 1])
def test_hyperconnection_dynamic(streams):
    rng = np.random.default_rng(8)
    dim = 16
    jm = randomize_dynamic(jtr.HyperConnection(dim=dim, num_streams=streams, layer_index=5), rng)
    pm = load_into(ptr.HyperConnection(dim=dim, num_streams=streams, layer_index=5), jm)
    assert float(np.abs(jax_named(jm)[".dyn_alpha_w"]).min()) > 0
    x = rng.normal(size=(streams, 2, 5, dim)).astype(np.float32)
    w = rng.normal(size=(dim, dim)).astype(np.float32) / 4

    def j_branch(h):
        return jnp.tanh(h @ jnp.asarray(w)), h[..., :3]

    def p_branch(h):
        return torch.tanh(h @ t(w)), h[..., :3]

    jout, jrest = jm(jnp.asarray(x), j_branch)
    pout, prest = pm(t(x), p_branch)
    close(pout, jout)
    close(prest, jrest)


@pytest.mark.parametrize("streams", [4, 1])
def test_transformer_stack(streams):
    rng = np.random.default_rng(9)
    kw = dict(dim=32, depth=2, heads=4, dim_head=8, num_residual_streams=streams)
    jm = randomize_dynamic(jtr.Transformer(**kw, key=KEY), rng)
    pm = load_into(ptr.Transformer(**kw, device="cpu"), jm)
    x = rng.normal(size=(2, 13, 32)).astype(np.float32)
    mask = np.ones((2, 13), bool)
    mask[0, 9:] = False
    close(pm(t(x), self_attn_mask=t(mask)), jm(jnp.asarray(x), self_attn_mask=jnp.asarray(mask)))


def test_transformer_kv_cache():
    rng = np.random.default_rng(10)
    kw = dict(dim=32, depth=2, heads=4, dim_head=8, num_residual_streams=4)
    jm = randomize_dynamic(jtr.Transformer(**kw, key=KEY), rng)
    pm = load_into(ptr.Transformer(**kw, device="cpu"), jm)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    jcache = jtr.KVCache.create(2, 2, 10, 8)
    pcache = ptr.KVCache.create(2, 2, 10, 8, device="cpu")
    for lo, hi in [(0, 6), (6, 7)]:
        jout, jcache = jm(jnp.asarray(x[:, lo:hi]), kv_cache=jcache, return_kv_cache=True)
        pout = pm(t(x[:, lo:hi]), kv_cache=pcache)
        close(pout, jout)
    assert pcache.pos == int(jcache.pos) == 7
    close(pcache.k, jcache.k)
    close(pcache.v, jcache.v)


def test_transformer_and_cache_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptr.Transformer(dim=32, depth=1, heads=2, dim_head=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptr.KVCache.create(1, 1, 4, 8)
    assert ptr.KVCache.create(1, 1, 4, 8, device="cpu").k.device.type == "cpu"


def test_sampling_helpers():
    rng = np.random.default_rng(11)
    ids = rng.integers(-1, 4, size=(5, 12))
    np.testing.assert_array_equal(ps.batch_unique_consecutive(t(ids)).numpy(),
                                  np.asarray(js.batch_unique_consecutive(jnp.asarray(ids))))
    for keep in (True, False):
        np.testing.assert_array_equal(
            ps.mask_out_after_eos_id(t(ids), 3, keep_eos=keep).numpy(),
            np.asarray(js.mask_out_after_eos_id(jnp.asarray(ids), 3, keep_eos=keep)))
    np.testing.assert_array_equal(ps.append_eos_id(t(ids), 9).numpy(),
                                  np.asarray(js.append_eos_id(jnp.asarray(ids), 9)))
    logits = rng.normal(size=(3, 20)).astype(np.float32)
    np.testing.assert_array_equal(ps.top_k(t(logits), 0.8).numpy(),
                                  np.asarray(js.top_k(jnp.asarray(logits), 0.8)))
    table = rng.normal(size=(4, 6)).astype(np.float32)
    close(ps.get_embeds(t(table), t(ids)), js.get_embeds(jnp.asarray(table), jnp.asarray(ids)))
    x = t(rng.normal(size=(3,)).astype(np.float32)).requires_grad_()
    ps.grad_shrink(x, 0.25).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 0.25)


def test_gumbel_sample_near_zero_temperature_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(12).normal(size=(4, 50)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(ps.gumbel_sample(logits, 1e-10, generator=g), logits.argmax(-1))


def test_masked_cross_entropy():
    rng = np.random.default_rng(13)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, size=(2, 7))
    close(p_mce(t(logits), t(labels)), j_mce(jnp.asarray(logits), jnp.asarray(labels)))
