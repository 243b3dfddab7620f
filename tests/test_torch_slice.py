"""Port parity for the whole slice on a tiny llama (vocab 512, hidden 256,
intermediate 512, 2 layers, 4 heads, 2 kv heads, W4 g128, quantized
lm_head): the JAX params carried across leaf by leaf, stacked on both
sides (bit-identical buffers), then prefill (B=2, T=24: M=48 > 32) and 8
ring-less greedy decode steps against JAX forward_stacked with the
Pallas kernels forced (interpret mode). Logits within atol/rtol 5e-2
(tests/test_pallas_attention.py:83), greedy ids equal token for token."""

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
from qllm_tpu.quant.qtensor import QuantizedTensor as JQT
from qllm_tpu.utils.testing import random_quantized_params as j_random_params
from qllm_tpu_torch.interop import params_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.models.decode_loop import decode_loop as t_decode_loop
from qllm_tpu_torch.models.generate import decode_step as t_decode_step
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.models.generate import prefill as t_prefill
from qllm_tpu_torch.quant.qtensor import QuantizedTensor as TQT

TOL = 5e-2
# a max_position_embeddings no other test uses: prefill/decode_step are
# jitted with cfg static and read the kernel-forcing env vars at trace
# time, so a distinct cfg cannot pick up another test's cached XLA trace
CFG_KW = dict(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    max_position_embeddings=641,
)
SEED = 10
B, T, STEPS, MAX_SEQ = 2, 24, 8, 64


def _params(cfg_kw=CFG_KW, batch=B, prompt=T):
    """JAX random params as numpy, with the lm_head columns of 8 tokens
    scaled up 8x so that every greedy decision is separated by more than
    twice the tolerance (asserted below) and cannot tie."""
    jcfg = jllama.ModelConfig(**cfg_kw)
    npp = jax.tree_util.tree_map(
        np.asarray,
        j_random_params(jcfg, jax.random.key(SEED), bits=4, group_size=128, quantize_lm_head=True),
    )
    rng = np.random.default_rng(SEED)
    cols = rng.choice(cfg_kw["vocab_size"], 8, replace=False)
    sc = np.array(npp["lm_head"].scales)
    sc[:, cols] = (sc[:, cols].astype(np.float32) * 8.0).astype(np.float16)
    npp["lm_head"] = dataclasses.replace(npp["lm_head"], scales=sc)
    tokens = rng.integers(0, cfg_kw["vocab_size"], (batch, prompt)).astype(np.int32)
    return jcfg, npp, tokens


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def _assert_stacks_identical(js, ts):
    assert set(js) == set(ts)
    for k in js:
        jv, tv = js[k], ts[k]
        if isinstance(jv, JQT):
            assert isinstance(tv, TQT)
            assert (jv.planar, jv.zeros_prefolded) == (tv.planar, tv.zeros_prefolded) == (True, True)
            for f in ("qweight", "scales", "zeros"):
                np.testing.assert_array_equal(_np(getattr(tv, f)), _np(getattr(jv, f)), err_msg=f"{k}.{f}")
        else:
            np.testing.assert_array_equal(_np(tv), _np(jv), err_msg=k)


def _assert_separated(logits):
    s = np.sort(logits, axis=-1)
    tol = TOL + TOL * np.abs(s[:, -1])
    assert np.all(s[:, -1] - s[:, -2] > 2 * tol), "greedy decision within twice the tolerance"


def test_slice_stacked_prefill_decode_matches_jax(monkeypatch):
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    monkeypatch.setenv("QLLM_TPU_FORCE_PALLAS_ATTN", "1")
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    jax.clear_caches()
    jcfg, npp, tokens = _params()
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))

    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    js = jstacked.stack_layer_params(jp, scale_store_dtype=jnp.bfloat16)
    js["lm_head"] = jstacked.prepare_lm_head(js["lm_head"], scale_store_dtype=jnp.bfloat16)
    tp = params_from_numpy(npp, device="cpu")
    ts = tstacked.stack_layer_params(tp)
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"])
    _assert_stacks_identical(js["layers"], ts["layers"])
    _assert_stacks_identical({"lm_head": js["lm_head"]}, {"lm_head": ts["lm_head"]})

    # JAX reference: prefill + greedy decode_step through forward_stacked
    jcache = j_make_cache(jcfg, B, MAX_SEQ)
    assert MAX_SEQ % 8 == 0  # keeps JAX on the write-kernel branch
    jl, jcache = j_prefill(js, jcfg, jnp.asarray(tokens), jcache)
    j_logits = [np.asarray(jl)]
    tok = np.argmax(j_logits[0], axis=-1).astype(np.int32)[:, None]
    j_ids, j_inputs = [], [tok]
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(tok), jcache, jnp.int32(T + i))
        j_logits.append(np.asarray(jl))
        tok = np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None]
        j_ids.append(tok[:, 0])
        j_inputs.append(tok)
    for lg in j_logits:
        _assert_separated(lg)

    # port: prefill + decode_loop (greedy ids)
    tcache = t_make_cache(tcfg, B, MAX_SEQ, device="cpu")
    tl, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), tcache, device="cpu")
    np.testing.assert_allclose(tl.numpy(), j_logits[0], atol=TOL, rtol=TOL)
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    t_ids, _ = t_decode_loop(ts, tcfg, first, tcache, T, STEPS, device="cpu")
    np.testing.assert_array_equal(first.numpy(), j_inputs[0])
    np.testing.assert_array_equal(t_ids.numpy(), np.stack(j_ids, axis=1))

    # port: per-step logits on the JAX token stream
    tcache = t_make_cache(tcfg, B, MAX_SEQ, device="cpu")
    _, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), tcache, device="cpu")
    for i in range(STEPS):
        tl, tcache = t_decode_step(ts, tcfg, torch.from_numpy(j_inputs[i]), tcache, T + i, device="cpu")
        np.testing.assert_allclose(tl.numpy(), j_logits[i + 1], atol=TOL, rtol=TOL, err_msg=f"step {i}")


def test_slice_list_params_forward_matches_jax():
    """The per-layer (list) params path, cacheless, on the unstacked params."""
    jcfg, npp, tokens = _params()
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    jl, _ = jllama.forward(jax.tree_util.tree_map(jnp.asarray, npp), jcfg, jnp.asarray(tokens))
    tl, _ = tllama.forward(params_from_numpy(npp, device="cpu"), tcfg, torch.from_numpy(tokens))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, T, CFG_KW["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_unstack_inverts_stack():
    _, npp, _ = _params()
    tcfg = tllama.ModelConfig(**CFG_KW)
    tp = params_from_numpy(npp, device="cpu")
    ts = tstacked.stack_layer_params(tp)
    back = tstacked.unstack_layer_params(ts, tcfg.num_hidden_layers, tcfg)
    for lp0, lp1 in zip(tp["layers"], back["layers"]):
        assert set(lp0) == set(lp1)
        for k, v in lp0.items():
            if isinstance(v, TQT):
                assert torch.equal(lp1[k].qweight, v.qweight)
                # the stack keeps bf16 scales and zs = bf16(zeros * scales)
                assert torch.equal(lp1[k].scales, v.scales.to(torch.bfloat16).float())
                zs = (v.zeros.float() * v.scales.float()).to(torch.bfloat16).float()
                assert torch.equal((lp1[k].zeros * lp1[k].scales).to(torch.bfloat16).float(), zs)
            else:
                assert torch.equal(lp1[k], v)
    # and stacking the unstacked params again gives the same buffers
    again = tstacked.stack_layer_params(back)
    for k, v in ts["layers"].items():
        if isinstance(v, TQT):
            for f in ("qweight", "scales", "zeros"):
                assert torch.equal(getattr(again["layers"][k], f), getattr(v, f)), f"{k}.{f}"
        else:
            assert torch.equal(again["layers"][k], v)


def test_decode_past_cache_end_raises():
    """A write at or past max_seq raises on the host before any kernel
    runs (on the card K3a would otherwise drop it silently)."""
    jcfg, npp, tokens = _params()
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    ts = tstacked.stack_layer_params(params_from_numpy(npp, device="cpu"))
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"])
    cache = t_make_cache(tcfg, B, MAX_SEQ, device="cpu")
    first = torch.zeros((B, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_seq"):
        t_decode_loop(ts, tcfg, first, cache, MAX_SEQ - 2, 3, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        t_decode_step(ts, tcfg, first, cache, MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        t_prefill(ts, tcfg, torch.zeros((B, MAX_SEQ + 1), dtype=torch.int32), cache, device="cpu")
    # the last slot itself is writable
    t_decode_step(ts, tcfg, first, cache, MAX_SEQ - 1, device="cpu")
