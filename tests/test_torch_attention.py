"""Port parity: the plain versions of kernels K3a (kv_write_int8) and K3b
(decode_attn_int8) against kv_cache_write_pallas and the 5-D
decode_attention_pallas in interpret mode. K3a: int8 values equal
exactly, scales to rtol 1e-6 (tests/test_pallas_attention.py:200-203);
K3b: atol/rtol 2e-2 (tests/test_pallas_attention.py:59)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.ops.pallas_attention import decode_attention_pallas, kv_cache_write_pallas
from qllm_tpu_torch.interop import tensor_from_numpy
from qllm_tpu_torch.ops import attention as tat
from qllm_tpu_torch.ops.kv_cache import QuantizedKVCache


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kv_write_plain_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    L, B, Hkv, S, d, layer = 2, 3, 2, 32, 64, 1
    kc = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    vc = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    k_new = jnp.asarray(rng.normal(size=(B, Hkv, d)).astype(np.float32) * 2.0, dtype)
    v_new = jnp.asarray(rng.normal(size=(B, Hkv, d)).astype(np.float32), dtype)
    pos = np.array([5, 17, 31], np.int32)
    k2, v2, ks2, vs2 = kv_cache_write_pallas(
        k_new, v_new, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
        jnp.int32(layer), jnp.asarray(pos),
    )
    tk, tv, tks, tvs = _t(kc), _t(vc), _t(ks), _t(vs)
    tat.kv_write_int8(_t(k_new), _t(v_new), tk, tv, tks, tvs, layer, _t(pos))  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))
    np.testing.assert_allclose(tks.numpy(), np.asarray(ks2), rtol=1e-6)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(vs2), rtol=1e-6)


@pytest.mark.parametrize("n_rep,d", [(1, 128), (2, 128), (2, 64)])
def test_decode_attention_plain_matches_pallas(n_rep, d):
    rng = np.random.default_rng(n_rep * 10 + d)
    L, B, Hkv, S, layer = 2, 2, 2, 128, 1
    H = Hkv * n_rep
    q = jnp.asarray(rng.normal(size=(B, H, d)).astype(np.float32), jnp.bfloat16)
    kc = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    vc = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    lengths = np.array([100, 37], np.int32)
    ref = np.asarray(
        decode_attention_pallas(
            q, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(lengths), layer=jnp.int32(layer),
        )
    )
    args = (_t(q), _t(kc), _t(vc), _t(ks), _t(vs), _t(lengths), layer)
    for out in (tat.decode_attn_int8_plain(*args), tat.decode_attention(*args)):
        assert out.dtype == torch.float32 and tuple(out.shape) == (B, H, d)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=2e-2)


def test_cache_update_matches_write_kernel_semantics():
    """cache.update (prefill) and K3a (decode) quantize a token alike."""
    rng = np.random.default_rng(9)
    cache = QuantizedKVCache.create(2, 2, 16, 2, 64, device="cpu")
    k = torch.from_numpy(rng.normal(size=(2, 1, 2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 1, 2, 64)).astype(np.float32))
    cache.update(1, k, v, torch.tensor([3, 7]))
    other = QuantizedKVCache.create(2, 2, 16, 2, 64, device="cpu")
    tat.kv_write_int8(k[:, 0], v[:, 0], other.k, other.v, other.k_scale, other.v_scale, 1, torch.tensor([3, 7]))
    for a, b in ((cache.k, other.k), (cache.v, other.v), (cache.k_scale, other.k_scale)):
        assert torch.equal(a, b)


def test_decode_attention_refuses_what_is_not_ported():
    """Only ALiBi past 8192 cache rows raises, as in the JAX package (its
    key-chunked kernel takes no bias); the softcap and a window are served,
    and so is a cache past 8192 rows (the JAX package's chunked path)."""
    L, B, Hkv, d = 1, 1, 1, 16
    q = torch.zeros((B, Hkv, d), dtype=torch.bfloat16)
    lengths = torch.ones((B,), dtype=torch.int32)
    for S, kw in ((64, {"softcap": 30.0}), (64, {"window": torch.tensor(4)})):
        kc = torch.zeros((L, B, Hkv, S, d), dtype=torch.int8)
        ksc = torch.ones((L, B, Hkv, S))
        out = tat.decode_attention(q, kc, kc, ksc, ksc, lengths, 0, **kw)
        assert torch.equal(out, torch.zeros((B, Hkv, d)))
    S = 8200
    kc = torch.zeros((L, B, Hkv, S, d), dtype=torch.int8)
    ksc = torch.ones((L, B, Hkv, S))
    full = torch.full((B,), S, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="alibi"):
        tat.decode_attention(q, kc, kc, ksc, ksc, full, 0, alibi_slopes=torch.ones(Hkv))
    out = tat.decode_attention(q, kc, kc, ksc, ksc, full, 0)
    assert torch.equal(out, torch.zeros((B, Hkv, d)))
