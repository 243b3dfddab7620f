"""Decode attention at any n_rep, and flash prefill with the logit softcap,
a sliding window and head width 256: the port's plain versions against
the JAX package's kernels, interpreted on the CPU (as
tests/test_pallas_attention.py runs them).

  * K3b (layer-stacked cache), K22 (one layer's 4-D cache), K21 (the
    partial statistics) and K6 (the ring-fused step) at n_rep 12 (a
    group JAX pads from 12 to 16 rows) and at Falcon-7B's n_rep 71 with a
    head width of 64, each within one bf16 ulp of max|JAX|: the two run
    the same arithmetic (bf16 q', f32 scores, bf16(p * vs) against int8 V)
    and differ only in the order of f32 sums;
  * the entry points' checks take any n_rep;
  * K5 (``prefill_attention_flash``) with the softcap, the window and
    d = 256 at n_rep 2 and 12, int8 and bf16 K/V, within atol/rtol 2e-2
    (tests/test_torch_flash_prefill.py's bound; JAX's own tests hold the
    kernel to 3e-2 against numpy). The softcap cases draw scores of RMS
    0.5-1.5 x the cap, and the port without the softcap must miss ten
    times that limit; without the window the port must miss it too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.ops.pallas_attention import decode_attention_pallas, decode_attention_partial, decode_attention_ring
from qllm_tpu.ops.pallas_attention import prefill_attention_flash as j_flash
from qllm_tpu_torch.ops import attention as att
from qllm_tpu_torch.ops import flash_prefill as tfp

FLASH_TOL = 2e-2
# An int8 draw in [-127, 127] has RMS 127 / sqrt(3); q ~ N(0, 1) is
# pre-scaled by d**-0.5, so the scores' RMS is about K_RMS * ks.
K_RMS = 127 / 3**0.5


def _ulp(ref) -> float:
    """One bf16 ulp at the magnitude of max|ref|."""
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache(rng, shape, n_rep):
    """q [B, H, d] as bf16 values in f32, an int8 cache of ``shape`` and its scales."""
    B, Hkv, d = shape[-4], shape[-3], shape[-1]
    q = np.asarray(jnp.asarray(rng.normal(size=(B, Hkv * n_rep, d)), jnp.bfloat16), np.float32)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32)
    return q, k, v, ks, vs


_GROUPS = [(12, 2, 128), (71, 1, 64)]  # (n_rep, Hkv, d): a padded group; Falcon-7B's multi-query attention


@pytest.mark.parametrize("n_rep,Hkv,d", _GROUPS)
@pytest.mark.parametrize("layout", ["stacked", "4d"])
def test_decode_plain_matches_jax_at_any_n_rep(layout, n_rep, Hkv, d):
    """K3b's plain version on a layer-stacked cache and K22's on a 4-D one
    against decode_attention_pallas, lengths 1, mid-cache and full."""
    rng = np.random.default_rng(n_rep + d)
    B, S, L, layer = 3, 256, 2, 1
    shape = (L, B, Hkv, S, d) if layout == "stacked" else (B, Hkv, S, d)
    q, k, v, ks, vs = _cache(rng, shape, n_rep)
    lengths = np.array([1, 130, S], np.int32)
    jl = None if layout == "4d" else jnp.int32(layer)
    ref = np.asarray(decode_attention_pallas(jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (k, v, ks, vs, lengths)),
                                             layer=jl))
    args = (_t(q).to(torch.bfloat16), _t(k), _t(v), _t(ks), _t(vs), _t(lengths))
    out = att.decode_attention(*args, None if layout == "4d" else layer).numpy()
    assert out.shape == (B, Hkv * n_rep, d)
    np.testing.assert_allclose(out, ref, atol=_ulp(ref), rtol=0)


@pytest.mark.parametrize("n_rep,Hkv,d", _GROUPS)
def test_partial_plain_matches_jax_at_any_n_rep(n_rep, Hkv, d):
    """K21's plain version against decode_attention_partial: acc, m and den
    each within one bf16 ulp of their max|JAX|; a zero-length shard row is
    exactly (m, acc, den) = (-1e30, 0, 0) in both."""
    rng = np.random.default_rng(7 * n_rep)
    L, B, S, layer = 2, 3, 192, 0
    q, k, v, ks, vs = _cache(rng, (L, B, Hkv, S, d), n_rep)
    lengths = np.array([0, 77, S], np.int32)
    ref = decode_attention_partial(jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (k, v, ks, vs, lengths)),
                                   jnp.int32(layer))
    got = att.decode_attention_partial(_t(q).to(torch.bfloat16), _t(k), _t(v), _t(ks), _t(vs), _t(lengths), layer)
    for name, a, r in zip(("acc", "m", "den"), got, ref):
        r = np.asarray(r)
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy()[1:], r[1:], atol=_ulp(r[1:]), rtol=0, err_msg=name)
    acc, m, den = (t.numpy()[0] for t in got)
    assert (m == -1e30).all() and (acc == 0).all() and (den == 0).all()
    r_acc, r_m, r_den = (np.asarray(t)[0] for t in ref)
    assert (r_m == -1e30).all() and (r_acc == 0).all() and (r_den == 0).all()


@pytest.mark.parametrize("n_rep,Hkv,d", _GROUPS)
def test_ring_plain_matches_jax_at_any_n_rep(n_rep, Hkv, d):
    """K6's plain version against decode_attention_ring (flushed rows, 0-7
    ring rows and the current token) within one bf16 ulp of max|JAX|; the
    appended rings bit-equal to JAX's new rings."""
    rng = np.random.default_rng(3 * n_rep)
    L, B, S, layer = 2, 3, 128, 1
    q, k, v, ks, vs = _cache(rng, (L, B, Hkv, S, d), n_rep)
    rk = jnp.asarray(rng.normal(size=(L, B, Hkv, att.RING, d)) * 0.5, jnp.bfloat16)
    rv = jnp.asarray(rng.normal(size=(L, B, Hkv, att.RING, d)) * 0.5, jnp.bfloat16)
    k_new = (rng.normal(size=(B, Hkv, d)) * 0.5).astype(np.float32)
    v_new = (rng.normal(size=(B, Hkv, d)) * 0.5).astype(np.float32)
    pos = np.array([5, 64, 127], np.int32)  # ring rows 5, 0, 7
    ref, rk2, rv2 = decode_attention_ring(jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (k_new, v_new, k, v, ks, vs)),
                                          rk, rv, jnp.asarray(pos), jnp.int32(layer))
    ref = np.asarray(ref)
    trk = _t(np.asarray(rk.astype(jnp.float32))).to(torch.bfloat16)
    trv = _t(np.asarray(rv.astype(jnp.float32))).to(torch.bfloat16)
    out = att.decode_attention_ring(_t(q).to(torch.bfloat16), _t(k_new), _t(v_new), _t(k), _t(v), _t(ks), _t(vs),
                                    trk, trv, _t(pos), layer).numpy()
    np.testing.assert_allclose(out, ref, atol=_ulp(ref), rtol=0)
    np.testing.assert_array_equal(trk.float().numpy(), np.asarray(rk2.astype(jnp.float32)))
    np.testing.assert_array_equal(trv.float().numpy(), np.asarray(rv2.astype(jnp.float32)))


@pytest.mark.parametrize("n_rep", [9, 12, 48, 71])
def test_entry_points_take_any_n_rep(n_rep):
    """The kernels' operand check (the only gate before a launch) takes any
    group size; it still refuses head widths the body does not hold."""
    B, Hkv, d = 2, 1, 64
    q = torch.zeros((B, Hkv * n_rep, d), dtype=torch.bfloat16)
    lengths = torch.ones((B,), dtype=torch.int32)
    _, _, got = att._query_operands("decode_attn_int8", q, lengths, B, Hkv, d)
    assert got == n_rep
    for bad in (72, 272):
        with pytest.raises(ValueError, match="D <="):
            att._query_operands("decode_attn_int8", torch.zeros((B, n_rep, bad), dtype=torch.bfloat16), lengths, B,
                                Hkv, bad)


def test_split_scratch_holds_a_slot_per_group_and_split():
    """The splits' scratch: (acc [8, D], m [8], den [8]) for every (b, kv
    head, group of 8 query heads, split of SPLIT_KEYS rows)."""
    B, Hkv, S, D, n_rep = 2, 3, 1000, 64, 71
    groups, splits = 9, -(-S // att.SPLIT_KEYS)
    assert att.SPLIT_KEYS % 128 == 0
    assert att._scratch_floats(B, Hkv, S, D, n_rep) == B * Hkv * groups * splits * 8 * (D + 2)


def _flash_inputs(rng, form, B, T, S, Hkv, n_rep, d, softcap):
    """q [B, T, H, d]; K/V int8 [B, Hkv, S, d] with scales, or f32 [B, S, Hkv, d].
    With a softcap the key draws give scores of RMS 0.5-1.5 x the cap."""
    q = rng.normal(size=(B, T, Hkv * n_rep, d)).astype(np.float32)
    spread = rng.uniform(0.5, 1.5, (B, Hkv, S)).astype(np.float32)
    if form == "int8":
        k = rng.integers(-127, 128, (B, Hkv, S, d)).astype(np.int8)
        v = rng.integers(-127, 128, (B, Hkv, S, d)).astype(np.int8)
        ks = (spread * softcap / K_RMS) if softcap else rng.uniform(0.005, 0.02, (B, Hkv, S))
        vs = rng.uniform(0.005, 0.02, (B, Hkv, S))
        return q, k, v, (ks.astype(np.float32), vs.astype(np.float32))
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    if softcap:
        k = k * (spread * softcap).transpose(0, 2, 1)[..., None]
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    return q, k, v, None


def _port_flash(q, k, v, pos, n_rep, scales, softcap=0.0, window=None):
    kw = dict(kv_native=True, kv_scales=tuple(map(_t, scales))) if scales is not None else {}
    win = None if window is None else torch.tensor([window], dtype=torch.int32)
    return tfp.prefill_attention_flash(_t(q), _t(k), _t(v), _t(pos), n_rep, softcap=softcap, window=win, **kw).numpy()


@pytest.mark.parametrize("form", ["int8", "bf16"])
@pytest.mark.parametrize(
    "B,T,S,Hkv,n_rep,d,pos,softcap,window,bs",
    [
        (1, 100, 100, 2, 2, 256, [0], 50.0, None, 0),  # Gemma-2's head width and cap, one key block
        (2, 60, 200, 1, 12, 128, [140, 3], 0.0, 24, 128),  # a window past whole key blocks, n_rep 12
        (1, 96, 300, 2, 2, 256, [204], 30.0, 40, 128),  # both options at d = 256, several key blocks
    ],
)
def test_flash_prefill_options_match_jax(monkeypatch, form, B, T, S, Hkv, n_rep, d, pos, softcap, window, bs):
    """prefill_attention_flash with the softcap, the window and d = 256
    against JAX's (QLLM_TPU_FLASH_BS forces its online-softmax kernel)."""
    if bs:
        monkeypatch.setenv("QLLM_TPU_FLASH_BS", str(bs))
    rng = np.random.default_rng(T + S + d)
    q, k, v, scales = _flash_inputs(rng, form, B, T, S, Hkv, n_rep, d, softcap)
    pos = np.asarray(pos, np.int32)
    jkw = dict(kv_native=True, kv_scales=tuple(map(jnp.asarray, scales))) if scales is not None else {}
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), n_rep, softcap=softcap,
                             window=None if window is None else jnp.int32(window), **jkw))
    out = _port_flash(q, k, v, pos, n_rep, scales, softcap, window)
    assert out.shape == (B, T, Hkv * n_rep, d)
    np.testing.assert_allclose(out, ref, atol=FLASH_TOL, rtol=FLASH_TOL)
    if softcap:  # the control: leaving the cap out cannot pass
        bare = _port_flash(q, k, v, pos, n_rep, scales, 0.0, window)
        assert not np.allclose(bare, ref, atol=10 * FLASH_TOL, rtol=10 * FLASH_TOL), "the softcap changes nothing"
    if window is not None:
        wide = _port_flash(q, k, v, pos, n_rep, scales, softcap, None)
        assert not np.allclose(wide, ref, atol=FLASH_TOL, rtol=FLASH_TOL), "the window changes nothing"
