"""Port parity for the ring-fused batch-1 decode path.

  * K6's plain version (decode_attention_ring) against the JAX Pallas
    kernel in interpret mode on tests/test_ring_kv.py's inputs: output
    within atol/rtol 1e-2 (inside that test's 3e-2 against numpy), rings
    bit-equal after the append.
  * K7's plain version (kv_ring_flush): int8 values and scales bit-equal
    to the JAX package's quantizer (the oracle tests/test_ring_kv.py holds
    kv_ring_flush_pallas to); against kv_ring_flush_pallas itself scales
    within rtol 1e-6 (the K3a test's bound) and int8 bit-equal on every
    row whose scale the interpreted kernel computes to the same bits;
    rows outside the window untouched.
  * The slice on a tiny llama with hd = 128 (hidden 256, 2 heads, 1 kv
    head, 2 layers, W4 g128, quantized lm_head): a T = 256 prefill (flash
    on both sides) into a ring cache of max_seq 280, then 16 ring-fused
    greedy steps (two flushes) against JAX forward_stacked with the
    Pallas kernels forced: logits within 5e-2 and greedy ids equal; run
    from one cache (JAX's, carried across with cache_from_numpy), the int8
    caches after the 16 steps equal up to the +-1 round-boundary flips
    tests/test_ring_kv.py allows (max 1, share < 1e-3).
  * The ring guards raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models import llama as jllama
from qllm_tpu.models import stacked as jstacked
from qllm_tpu.models.generate import decode_step as j_decode_step
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.models.generate import prefill as j_prefill
from qllm_tpu.ops.kv_cache import _quantize_kv as j_quantize_kv
from qllm_tpu.ops.pallas_attention import decode_attention_ring as j_ring_attention
from qllm_tpu.ops.pallas_attention import kv_ring_flush_pallas
from qllm_tpu_torch.interop import cache_from_numpy, params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.models.decode_loop import decode_loop as t_decode_loop
from qllm_tpu_torch.models.generate import decode_step as t_decode_step
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.models.generate import prefill as t_prefill
from qllm_tpu_torch.ops import attention as tat
from qllm_tpu_torch.ops.kv_cache import QuantizedKVCache
from test_torch_slice import TOL, _assert_separated, _np, _params

RING = tat.RING
# a max_position_embeddings no other test uses, so no cached JAX trace
# with other kernel-forcing env vars leaks in
RING_CFG = dict(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_hidden_layers=2,
    num_attention_heads=2,
    num_key_value_heads=1,
    max_position_embeddings=643,
)
PROMPT, STEPS, MAX_SEQ = 256, 16, 280


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("n_rep", [1, 4])
def test_ring_attention_plain_matches_pallas(n_rep):
    rng = np.random.default_rng(3)
    L, B, Hkv, S, d = 3, 2, 2, 64, 128
    H = Hkv * n_rep
    layer = 1
    pos = np.array([19, 10], np.int32)  # flushed 16 / 8, ring 3 / 2
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    k8 = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    ksc = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    vsc = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    rk = jnp.asarray(rng.normal(size=(L, B, Hkv, RING, d)) * 0.5, jnp.bfloat16)
    rv = jnp.asarray(rng.normal(size=(L, B, Hkv, RING, d)) * 0.5, jnp.bfloat16)
    k_new = (rng.normal(size=(B, Hkv, d)) * 0.5).astype(np.float32)
    v_new = (rng.normal(size=(B, Hkv, d)) * 0.5).astype(np.float32)

    out, rk2, rv2 = j_ring_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(ksc), jnp.asarray(vsc), rk, rv, jnp.asarray(pos), jnp.int32(layer),
    )
    trk, trv = _t(rk), _t(rv)
    tout = tat.decode_attention_ring(
        _t(q), _t(k_new), _t(v_new), _t(k8), _t(v8), _t(ksc), _t(vsc), trk, trv, _t(pos), layer
    )
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (B, H, d)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-2, rtol=1e-2)
    # the append, in place: bit-equal to JAX's new rings, every slot and layer
    np.testing.assert_array_equal(_np(trk), _np(rk2))
    np.testing.assert_array_equal(_np(trv), _np(rv2))


def test_ring_flush_plain_matches_pallas():
    rng = np.random.default_rng(5)
    L, B, Hkv, S, d = 2, 2, 4, 64, 128
    pos = np.array([16, 24], np.int32)  # windows [8, 16) and [16, 24)
    k8 = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    ksc = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    vsc = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    ring_k = jnp.asarray(rng.normal(size=(L, B, Hkv, RING, d)) * 0.5, jnp.bfloat16)
    ring_v = jnp.asarray(rng.normal(size=(L, B, Hkv, RING, d)) * 0.5, jnp.bfloat16)
    jout = kv_ring_flush_pallas(
        jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ksc), jnp.asarray(vsc), ring_k, ring_v, jnp.asarray(pos)
    )
    tk, tv, tks, tvs = _t(k8), _t(v8), _t(ksc), _t(vsc)
    tat.kv_ring_flush(tk, tv, tks, tvs, _t(ring_k), _t(ring_v), _t(pos))  # in place
    for got, got_s, ring, kern, kern_s, was, was_s in (
        (tk, tks, ring_k, jout[0], jout[2], k8, ksc),
        (tv, tvs, ring_v, jout[1], jout[3], v8, vsc),
    ):
        want, want_s = (np.asarray(a) for a in j_quantize_kv(ring))  # [L, B, Hkv, RING(, d)]
        kern, kern_s = np.asarray(kern), np.asarray(kern_s)
        np.testing.assert_allclose(got_s.numpy(), kern_s, rtol=1e-6)
        for b in range(B):
            lo, hi = pos[b] - RING, pos[b]
            # bit for bit the JAX package's quantizer, which its kernel test holds the kernel to
            np.testing.assert_array_equal(got.numpy()[:, b, :, lo:hi], want[:, b])
            np.testing.assert_array_equal(got_s.numpy()[:, b, :, lo:hi], want_s[:, b])
            # the interpreted Pallas kernel: equal on every row whose scale it
            # computed to the same bits; it takes amax / 127 an ulp off on a few
            # rows, and there a value on a rounding boundary may move by one
            same = kern_s[:, b, :, lo:hi] == want_s[:, b]
            diff = np.abs(got.numpy()[:, b, :, lo:hi].astype(np.int32) - kern[:, b, :, lo:hi].astype(np.int32))
            assert same.mean() > 0.8 and not diff[same].any() and diff.max() <= 1
            for g, w in ((got, was), (got_s, was_s)):  # rows outside the window untouched
                np.testing.assert_array_equal(g.numpy()[:, b, :, :lo], w[:, b, :, :lo])
                np.testing.assert_array_equal(g.numpy()[:, b, :, hi:], w[:, b, :, hi:])


def _stacked_pair(jcfg, npp):
    js = jstacked.stack_layer_params(jax.tree_util.tree_map(jnp.asarray, npp), scale_store_dtype=jnp.bfloat16)
    js["lm_head"] = jstacked.prepare_lm_head(js["lm_head"], scale_store_dtype=jnp.bfloat16)
    ts = tstacked.stack_layer_params(params_from_numpy(npp, device="cpu"), scale_store_dtype=torch.bfloat16)
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"], scale_store_dtype=torch.bfloat16)
    return js, ts


def test_ring_slice_flash_prefill_then_ring_decode_matches_jax(monkeypatch):
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    monkeypatch.setenv("QLLM_TPU_FORCE_PALLAS_ATTN", "1")
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    jax.clear_caches()
    jcfg, npp, tokens = _params(RING_CFG, 1, PROMPT)
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    assert tllama._flash_prefill_ok(tcfg, PROMPT, tcfg.hd)
    js, ts = _stacked_pair(jcfg, npp)

    # JAX: flash prefill into the ring cache, then 16 ring steps flushed
    # after every 8th (the schedule of its decode_loop)
    jl, jcache0 = j_prefill(js, jcfg, jnp.asarray(tokens), j_make_cache(jcfg, 1, MAX_SEQ, ring=True))
    j_logits = [np.asarray(jl)]
    j_tokens = [np.argmax(j_logits[0], axis=-1).astype(np.int32)[:, None]]
    jcache = jcache0
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(j_tokens[-1]), jcache, jnp.int32(PROMPT + i))
        j_logits.append(np.asarray(jl))
        j_tokens.append(np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None])
        if (PROMPT + i + 1) % RING == 0:
            k2, v2, ks2, vs2 = kv_ring_flush_pallas(
                jcache.k, jcache.v, jcache.k_scale, jcache.v_scale, jcache.ring_k, jcache.ring_v,
                jnp.full((1,), PROMPT + i + 1, jnp.int32),
            )
            jcache = dataclasses.replace(jcache, k=k2, v=v2, k_scale=ks2, v_scale=vs2)
    for lg in j_logits:
        _assert_separated(lg)

    # port, end to end: flash prefill, then decode_loop's ring branch
    tl, tcache = t_prefill(
        ts, tcfg, torch.from_numpy(tokens), t_make_cache(tcfg, 1, MAX_SEQ, ring=True, device="cpu"), device="cpu"
    )
    np.testing.assert_allclose(tl.numpy(), j_logits[0], atol=TOL, rtol=TOL)
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first.numpy(), j_tokens[0])
    t_ids, _ = t_decode_loop(ts, tcfg, first, tcache, PROMPT, STEPS, device="cpu")
    np.testing.assert_array_equal(t_ids.numpy(), np.concatenate(j_tokens[1:], axis=1))

    # port, per step from JAX's own post-prefill cache (each side's prefill
    # writes its own rounding of k / v: at hidden 256 JAX normalises inside
    # its prefill matmul kernel, the port before K2), on JAX's tokens
    tcache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache0), device="cpu")
    for i in range(STEPS):
        tl, tcache = t_decode_step(ts, tcfg, torch.from_numpy(j_tokens[i]), tcache, PROMPT + i, device="cpu")
        np.testing.assert_allclose(tl.numpy(), j_logits[i + 1], atol=TOL, rtol=TOL, err_msg=f"step {i}")
        if (PROMPT + i + 1) % RING == 0:
            pos = torch.full((1,), PROMPT + i + 1, dtype=torch.int32)
            tat.kv_ring_flush(tcache.k, tcache.v, tcache.k_scale, tcache.v_scale, tcache.ring_k, tcache.ring_v, pos)
    # the 16 decoded rows went through the ring and two flushes on each side
    for got, want in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())


def test_cache_from_numpy_carries_every_field():
    jcfg = jllama.ModelConfig(**RING_CFG)
    jc = j_make_cache(jcfg, 1, 16, ring=True)
    rng = np.random.default_rng(1)
    jc = dataclasses.replace(
        jc,
        k=jnp.asarray(rng.integers(-127, 128, jc.k.shape), jnp.int8),
        k_scale=jnp.asarray(rng.uniform(0.005, 0.02, jc.k_scale.shape), jnp.float32),
        ring_k=jnp.asarray(rng.normal(size=jc.ring_k.shape), jnp.bfloat16),
    )
    tc = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert isinstance(tc, QuantizedKVCache) and tc.quantized
    for f in ("k", "v", "k_scale", "v_scale", "ring_k", "ring_v"):
        np.testing.assert_array_equal(_np(getattr(tc, f)), _np(getattr(jc, f)), err_msg=f)
    plain = cache_from_numpy(jax.tree_util.tree_map(np.asarray, j_make_cache(jcfg, 1, 16)), device="cpu")
    assert plain.ring_k is None and plain.ring_v is None


def _tiny_ring_model():
    jcfg, npp, _ = _params(RING_CFG, 1, 8)
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    ts = tstacked.stack_layer_params(params_from_numpy(npp, device="cpu"), scale_store_dtype=torch.bfloat16)
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"], scale_store_dtype=torch.bfloat16)
    return tcfg, ts


@pytest.mark.parametrize(
    "case",
    ["steps % 8", "pos0 % 8", "quantized", "max_seq % 8", "softcap", "window"],
)
def test_ring_guards_raise(case):
    tcfg, ts = _tiny_ring_model()
    tok = torch.zeros((1, 1), dtype=torch.int32)
    if case == "steps % 8":
        cache = t_make_cache(tcfg, 1, 64, ring=True, device="cpu")
        with pytest.raises(ValueError, match="steps % 8"):
            t_decode_loop(ts, tcfg, tok, cache, 8, 13, device="cpu")
    elif case == "pos0 % 8":
        cache = t_make_cache(tcfg, 1, 64, ring=True, device="cpu")
        with pytest.raises(ValueError, match="pos0 % 8"):
            t_decode_loop(ts, tcfg, tok, cache, 12, 8, device="cpu")
    elif case == "quantized":
        with pytest.raises(ValueError, match="quantized cache"):
            t_make_cache(tcfg, 1, 64, quantized_kv=False, ring=True, device="cpu")
    elif case == "max_seq % 8":
        with pytest.raises(ValueError, match="max_seq % 8"):
            t_make_cache(tcfg, 1, 60, ring=True, device="cpu")
    else:
        # the ring branch of the block itself (forward refuses such
        # configs earlier, as outside the llama family)
        kw = {"softcap": dict(attn_logit_softcap=30.0), "window": dict(sliding_window=16)}[case]
        cfg = dataclasses.replace(tcfg, **kw)
        cache = t_make_cache(tcfg, 1, 64, ring=True, device="cpu")
        view = tstacked.StackedLayerView(ts["layers"], 0, cfg)
        h = torch.zeros((1, 1, cfg.hidden_size), dtype=torch.bfloat16)
        cos, sin = tllama._rope_cos_sin(torch.zeros((1, 1), dtype=torch.int64), cfg.rot_dim, cfg.rope_theta)
        mask, slots = tllama._attn_inputs(cfg, 1, 1, cache, 8, "cpu")
        with pytest.raises(NotImplementedError, match="ring-fused"):
            tllama._block_attn_mlp(view, cfg, h, cos, sin, mask, cache, 0, 8, slots)
