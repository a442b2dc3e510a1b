"""The port's nearest-code search (K6) and eval-mode quantizers against the
JAX package on the CPU: the plain version of K6 against the Pallas kernel
`ops/pallas/vq.py::vq_nearest_code` in interpret mode, at ragged N, with
duplicated codebook rows that force ties, and on a strided x; then
`VectorQuantizeEMA`, `ResidualVQ` and `GroupedResidualVQ` with JAX's
quantizer taking that kernel, as on the TPU (the test patches `on_tpu` and
the kernel's interpret flag; the JAX package is unchanged). Both sides get
the same numpy inputs.

Tolerances: indices identical; quantized outputs within 1e-5 (float32,
summation order only)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.ops import pallas as jpallas
from audiolm_pytorch_tpu.ops.pallas import vq as jvq
from audiolm_pytorch_tpu.ops.quantize import GroupedResidualVQ as JGRVQ
from audiolm_pytorch_tpu.ops.quantize import ResidualVQ as JRVQ
from audiolm_pytorch_tpu.ops.quantize import VectorQuantizeEMA as JVQ

from audiolm_pytorch_tpu_torch.ops.kernels.vq import vq_nearest_code, vq_nearest_code_ref
from audiolm_pytorch_tpu_torch.ops.quantize import GroupedResidualVQ, ResidualVQ, VectorQuantizeEMA
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax

from torch_port_util import jax_named, jax_replace, t

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def pallas_vq(monkeypatch):
    """JAX's quantizer on its TPU path: K6, here in interpret mode."""
    monkeypatch.setattr(jpallas, "on_tpu", lambda: True)
    monkeypatch.setattr(jvq, "vq_nearest_code",
                        functools.partial(jvq.vq_nearest_code, interpret=True))


def _codes_and_rows(rng, n, c, d):
    """A (c, d) codebook whose rows 1, c // 2 and c - 1 are copies of row 0;
    rows of x near random codes (the first near row c // 2, so a tie among
    the copies), and some far from any."""
    cb = rng.normal(size=(c, d)).astype(np.float32)
    cb[[1, c // 2, c - 1]] = cb[0]
    near = rng.integers(0, c, size=n)
    near[0] = c // 2
    x = cb[near] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    far = rng.random(n) < 0.3
    far[0] = False
    x[far] = rng.normal(size=(int(far.sum()), d)).astype(np.float32)
    return x.astype(np.float32), cb


@pytest.mark.parametrize("c,d", [(64, 32), (1024, 512), (64, 512), (1024, 32)])
@pytest.mark.parametrize("n", [1, 7, 8, 513])
def test_plain_k6_matches_pallas_kernel(n, c, d):
    x, cb = _codes_and_rows(np.random.default_rng(n * 31 + c + d), n, c, d)
    want = np.asarray(jvq.vq_nearest_code(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    got = vq_nearest_code(t(x), t(cb))  # a CPU tensor: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].item() == 0  # the first of the four equal codes


def test_plain_k6_ties_go_to_the_first_index():
    x = np.zeros((5, 16), np.float32)
    for cb in (np.zeros((32, 16), np.float32), np.ones((32, 16), np.float32)):
        want = np.asarray(jvq.vq_nearest_code(jnp.asarray(x), jnp.asarray(cb), interpret=True))
        np.testing.assert_array_equal(vq_nearest_code_ref(t(x), t(cb)).numpy(), want)
        assert (want == 0).all()


def test_plain_k6_takes_a_strided_x_and_matches_pallas_kernel():
    x, cb = _codes_and_rows(np.random.default_rng(3), 37, 64, 32)
    xt = t(np.ascontiguousarray(x.T)).t()  # the (N, D) transpose of a (D, N) array
    assert not xt.is_contiguous()
    want = np.asarray(jvq.vq_nearest_code(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    np.testing.assert_array_equal(vq_nearest_code(xt, t(cb)).numpy(), want)


def _jax_with_codebooks(jm, rng, scale):
    """A JAX quantizer whose codebooks are random (they are zeros at init)."""
    named = jax_named(jm)
    return jax_replace(jm, {k: scale * rng.normal(size=a.shape).astype(np.float32)
                            for k, a in named.items() if k.endswith("codebook[<flat index 0>]")})


def _port(module, jm):
    module.load_state_dict(codec_state_dict_from_jax(jax_named(jm)))
    return module


@pytest.mark.parametrize("rotation_trick", [True, False])
def test_vector_quantize_eval_matches_jax(pallas_vq, rotation_trick):
    rng = np.random.default_rng(1)
    jm = _jax_with_codebooks(JVQ(32, 64, rotation_trick=rotation_trick,
                                 key=jax.random.PRNGKey(0)), rng, 1.0)
    pm = _port(VectorQuantizeEMA(32, 64, rotation_trick=rotation_trick), jm)
    x = rng.normal(size=(3, 11, 32)).astype(np.float32)
    jq, jidx, jloss, _ = jm(jnp.asarray(x), train=False)
    pq, pidx, ploss = pm(t(x))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(ploss.item(), float(jloss), **TOL)
    with pytest.raises(ValueError, match="Generator"):
        pm(t(x), train=True)  # training draws from a generator (tests/test_torch_codec_train.py)


def _residual_input(rng, b, n, d):
    return (rng.normal(size=(b, n, d)) * 2.0).astype(np.float32)


def test_residual_vq_eval_matches_jax(pallas_vq):
    rng = np.random.default_rng(2)
    kw = dict(dim=32, num_quantizers=4, codebook_size=64)
    jm = _jax_with_codebooks(JRVQ(**kw, key=jax.random.PRNGKey(1)), rng, 1.0)
    pm = _port(ResidualVQ(**kw), jm)
    x = _residual_input(rng, 2, 37, 32)
    jq, jidx, jloss, _ = jm(jnp.asarray(x), train=False)
    pq, pidx, ploss = pm(t(x))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(ploss.numpy(), np.asarray(jloss), **TOL)
    # from indices: -1 entries, and fewer quantizers than the model has
    idx = np.asarray(jidx).copy()
    idx[0, 3:9, 2] = -1
    idx[1, 20:, :] = -1
    for q in (4, 2, 1):
        want = np.asarray(jm.get_output_from_indices(jnp.asarray(idx[..., :q])))
        got = pm.get_output_from_indices(t(idx[..., :q]).long())
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_grouped_residual_vq_eval_matches_jax(pallas_vq):
    rng = np.random.default_rng(3)
    kw = dict(dim=32, groups=2, num_quantizers=3, codebook_size=64)
    jm = _jax_with_codebooks(JGRVQ(**kw, key=jax.random.PRNGKey(2)), rng, 1.0)
    pm = _port(GroupedResidualVQ(**kw), jm)
    x = _residual_input(rng, 2, 29, 32)
    jq, jidx, jloss, _ = jm(jnp.asarray(x), train=False)
    pq, pidx, ploss = pm(t(x))
    assert pidx.shape == (2, 2, 29, 3)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(ploss.numpy(), np.asarray(jloss), **TOL)
    idx = np.asarray(jidx).copy()
    idx[1, 0, 5:8, 1] = -1
    for q in (3, 1):
        want = np.asarray(jm.get_output_from_indices(jnp.asarray(idx[..., :q])))
        got = pm.get_output_from_indices(t(idx[..., :q]).long())
        np.testing.assert_allclose(got.numpy(), want, **TOL)
