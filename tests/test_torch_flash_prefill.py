"""Port parity for flash prefill attention: the plain version of K5
(flash_prefill, through prefill_attention_flash) against the JAX
package's prefill_attention_flash in interpret mode, in its int8
cache-native and bf16 forms, with n_rep 1 and 4, one and several key
blocks (QLLM_TPU_FLASH_BS forces the online-softmax kernel), T and S off
the block grid and nonzero per-sequence offsets: atol/rtol 2e-2, inside
the JAX test's 3e-2 against numpy (tests/test_pallas_attention.py:298).
Then the model's routing: a T = 256 cacheless forward and a prefill into
a bf16 cache take bf16 flash on both sides, logits within 5e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models import llama as jllama
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.ops.pallas_attention import prefill_attention_flash as j_flash
from qllm_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.ops import flash_prefill as tfp
from test_torch_slice import TOL, _params

ATOL = 2e-2


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("form", ["int8", "bf16"])
@pytest.mark.parametrize(
    "B,T,S,Hkv,n_rep,pos,bs",
    [
        (2, 64, 64, 2, 1, [0, 0], 0),  # one key block, T == S
        (1, 100, 100, 2, 4, [0], 0),  # T, S off the block grid
        (2, 37, 256, 2, 4, [100, 37], 128),  # several key blocks, cache-style offsets
        (2, 70, 200, 1, 1, [130, 5], 128),
    ],
)
def test_flash_prefill_plain_matches_pallas(monkeypatch, form, B, T, S, Hkv, n_rep, pos, bs):
    if bs:
        monkeypatch.setenv("QLLM_TPU_FLASH_BS", str(bs))
    rng = np.random.default_rng(T + S)
    H, d = Hkv * n_rep, 128
    q = rng.normal(size=(B, T, H, d)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    if form == "int8":
        k = rng.integers(-127, 128, (B, Hkv, S, d)).astype(np.int8)
        v = rng.integers(-127, 128, (B, Hkv, S, d)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (B, Hkv, S)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (B, Hkv, S)).astype(np.float32)
        kw = dict(kv_native=True)
        ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), n_rep,
                      kv_scales=(jnp.asarray(ks), jnp.asarray(vs)), **kw)
        out = tfp.prefill_attention_flash(_t(q), _t(k), _t(v), _t(pos), n_rep, kv_scales=(_t(ks), _t(vs)), **kw)
    else:
        k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
        v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
        ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), n_rep)
        out = tfp.prefill_attention_flash(_t(q), _t(k), _t(v), _t(pos), n_rep)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, T, H, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


def test_flash_prefill_bf16_out_and_int_pos():
    """out_dtype bf16 (the serving call) and a host-int offset."""
    rng = np.random.default_rng(4)
    B, T, S, Hkv, n_rep, d = 1, 24, 40, 1, 2, 128
    q = rng.normal(size=(B, T, Hkv * n_rep, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 16, n_rep, out_dtype=jnp.bfloat16)
    out = tfp.prefill_attention_flash(_t(q), _t(k), _t(v), 16, n_rep, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("kw", [{"softcap": 30.0}, {"window": 16}])
def test_flash_prefill_refuses_what_is_not_wired(kw):
    """The two options K5 once refused, the logit softcap and the sliding
    window, are served and match JAX's prefill_attention_flash (atol/rtol
    2e-2). The softcap case draws keys for scores of RMS 0.5-1.5 x the cap,
    and the port without an option must miss ten times that limit."""
    rng = np.random.default_rng(16)
    B, T, S, Hkv, n_rep, d = 1, 48, 48, 1, 2, 128
    q = rng.normal(size=(B, T, Hkv * n_rep, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    if "softcap" in kw:
        k *= kw["softcap"] * rng.uniform(0.5, 1.5, (B, S, Hkv, 1)).astype(np.float32)
    jkw = {n: (jnp.int32(x) if n == "window" else x) for n, x in kw.items()}
    tkw = {n: (torch.tensor([x], dtype=torch.int32) if n == "window" else x) for n, x in kw.items()}
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, n_rep, **jkw))
    out = tfp.prefill_attention_flash(_t(q), _t(k), _t(v), 0, n_rep, **tkw).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)
    bare = tfp.prefill_attention_flash(_t(q), _t(k), _t(v), 0, n_rep).numpy()
    assert not np.allclose(bare, ref, atol=10 * ATOL, rtol=10 * ATOL), f"{kw} changes nothing"


def test_flash_prefill_int8_needs_the_native_layout():
    k = torch.zeros((1, 1, 8, 128), dtype=torch.int8)
    s = torch.ones((1, 1, 8))
    with pytest.raises(ValueError, match="kv_native"):
        tfp.prefill_attention_flash(torch.zeros((1, 8, 2, 128)), k, k, 0, 2, kv_scales=(s, s))


# hd = 128, so T >= 256 takes flash; a max_position_embeddings no other
# test uses (no cached JAX trace with other kernel-forcing env vars)
FLASH_CFG = dict(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_hidden_layers=2,
    num_attention_heads=2,
    num_key_value_heads=1,
    max_position_embeddings=647,
)


def test_model_prefill_routes_bf16_flash_like_jax(monkeypatch):
    """The per-layer params forward at T = 256: cacheless, and into a
    non-quantized cache; JAX with its Pallas attention forced takes its
    bf16 flash branch in both (llama.py:951-981), the port K5's."""
    monkeypatch.setenv("QLLM_TPU_FORCE_PALLAS_ATTN", "1")
    jcfg, npp, tokens = _params(FLASH_CFG, 1, 256)
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    assert tllama._flash_prefill_ok(tcfg, 256, tcfg.hd)
    assert tllama._attn_inputs(tcfg, 1, 256, None, None, "cpu") == (None, None)  # no [B, 1, T, S] mask
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = params_from_numpy(npp, device="cpu")
    jl, _ = jllama.forward(jp, jcfg, jnp.asarray(tokens))
    tl, _ = tllama.forward(tp, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    jl, _ = jllama.forward(jp, jcfg, jnp.asarray(tokens), j_make_cache(jcfg, 1, 264, quantized_kv=False), pos=0)
    tc = t_make_cache(tcfg, 1, 264, quantized_kv=False, device="cpu")
    tl, _ = tllama.forward(tp, tcfg, torch.from_numpy(tokens), tc, pos=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
