"""Decode attention past S = 8192 (the JAX package's key-chunked path,
``_decode_attention_stacked_chunked``): K3b's plain version against the
chunked kernel, interpreted on the CPU, and ``decode_attention`` serving a cache
longer than 8192 rows.

Past a few thousand rows the outputs are small (about 0.03 RMS here), so a
fixed atol of 2e-2 would pass a result with whole key tiles missing. The
limit scales with the output instead: |out - ref| <= 2e-2 * max|ref| + 1e-4,
and a control shows that it fails a result one 128-row tile short."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.ops.pallas_attention import _decode_attention_stacked_chunked
from qllm_tpu_torch.ops import attention as att


def _limit(ref):
    return 2e-2 * float(np.abs(ref).max()) + 1e-4


def _long_case():
    """One decode step's inputs over a 8320-row cache (tiny heads, n_rep 2)."""
    rng = np.random.default_rng(3)
    L, B, Hkv, S, d, n_rep = 1, 2, 1, 8192 + 128, 32, 2
    q = torch.from_numpy(rng.normal(size=(B, Hkv * n_rep, d)).astype(np.float32)).to(torch.bfloat16)
    k = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    v = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    lengths = np.array([S, 8200], np.int32)
    ref = _ref_attention(q.float().numpy(), k[0] * ks[0][..., None], v[0] * vs[0][..., None], lengths)
    return (q, *[torch.from_numpy(a) for a in (k, v, ks, vs)]), lengths, ref


def _ref_attention(q, k, v, lengths):
    """q [B, H, d], k / v [B, Hkv, S, d] float, per-sequence lengths."""
    B, H, d = q.shape
    n_rep = H // k.shape[1]
    k = np.repeat(k, n_rep, axis=1)
    v = np.repeat(v, n_rep, axis=1)
    scores = np.einsum("bhd,bhsd->bhs", q, k) / np.sqrt(d)
    mask = np.arange(k.shape[2])[None, None, :] < lengths[:, None, None]
    scores = np.where(mask, scores, -np.inf)
    p = np.exp(scores - scores.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhs,bhsd->bhd", p, v)


@pytest.mark.parametrize("n_rep", [1, 4])
def test_k3b_plain_matches_jax_chunked_kernel(n_rep):
    rng = np.random.default_rng(7)
    L, B, Hkv, S, d = 2, 2, 2, 384, 128
    H = Hkv * n_rep
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    k = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    v = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    lengths = np.array([300, 37], np.int32)  # spans chunks, stops mid-chunk
    chunked = np.asarray(
        _decode_attention_stacked_chunked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(lengths), jnp.int32(1), bs=128,
        )
    )
    t = [torch.from_numpy(a) for a in (k, v, ks, vs)]
    port = att.decode_attn_int8_plain(torch.from_numpy(q), *t, torch.from_numpy(lengths), 1).numpy()
    assert np.abs(port - chunked).max() <= _limit(chunked)


def test_decode_attention_serves_past_8192_rows():
    """One decode step over a 8320-row cache on the CPU: no raise, and the
    float reference (on the same bf16 query) within the scaled limit."""
    args, lengths, ref = _long_case()
    out = att.decode_attention(*args, torch.from_numpy(lengths), 0)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert np.abs(out.numpy() - ref).max() <= _limit(ref)


@pytest.mark.parametrize("short", [0, 1], ids=["first-length", "every-length"])
def test_long_decode_limit_fails_one_tile_short(short):
    """The control: the same step with one 128-row tile missing, from one
    sequence or from both, misses the limit."""
    args, lengths, ref = _long_case()
    cut = lengths - 128 * np.array([1, short], np.int32)
    out = att.decode_attention(*args, torch.from_numpy(cut), 0)
    assert np.abs(out.numpy() - ref).max() > _limit(ref)
