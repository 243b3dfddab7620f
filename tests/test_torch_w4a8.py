"""Port parity for W4A8 (per-token int8 activations) against the JAX
package on the CPU, at tiny sizes:

  * the quantizer: x8, sx (and the group sums of x8) bit-equal to the JAX
    package's expressions (pallas_qmm.py:366-367, :1271-1275);
  * K12's plain version (``gptq_w4a8_gemv_plain``, through ``qmatmul_2d(...,
    w4a8=True)``) against ``qmatmul_pallas`` with QLLM_TPU_W4A8=1 in
    interpret mode, and the routes that keep bf16 activations (8 bits,
    M > 32) unchanged;
  * K11's plain version (through ``qmatmul_stacked(..., w4a8=True)``)
    against ``qmatmul_pallas_stacked`` with the stacked kernels forced,
    with and without the fused RMSNorm;
  * a tiny llama, stacked, decoding greedily under W4A8 against JAX
    (logits and ids); the engine with ``ServeConfig(w4a8=True)`` on
    per-layer params and on a tiny Mixtral against the JAX engine; an a16
    and an a8 engine in one process keeping their own numerics.

Kernel outputs are held to two bf16 ulps plus 1e-3 * max|y|: both sides
quantize x to the same int8 values and sum exact integer dots, so only
the f32 order of the group sums and the last rounding differ. Model
logits keep the slice's 5e-2 (tests/test_torch_slice.py).

The JAX package reads QLLM_TPU_W4A8 when it traces, and its engine sets
it for the whole process: every test that turns it on does so through
``monkeypatch`` (restored after) and clears JAX's caches on the way in
and out (``jax_w4a8``), so no trace crosses the switch into another test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qllm_tpu.ops.ref_matmul as j_ref_matmul
from qllm_tpu.models import llama as jllama
from qllm_tpu.models import stacked as jstacked
from qllm_tpu.models.generate import decode_step as j_decode_step
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.models.generate import prefill as j_prefill
from qllm_tpu.ops.pallas_qmm import qmatmul_pallas, qmatmul_pallas_stacked
from qllm_tpu.quant.qtensor import quantize_tensor
from qllm_tpu.serve import ContinuousBatchingEngine as JEngine
from qllm_tpu.serve import ServeConfig as JServeConfig
from qllm_tpu.utils.testing import random_quantized_params as j_random_params
from qllm_tpu_torch.interop import cache_from_numpy, params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.models.decode_loop import decode_loop as t_decode_loop
from qllm_tpu_torch.models.generate import greedy_generate as t_greedy_generate
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.models.generate import prefill as t_prefill
from qllm_tpu_torch.ops import qmm, qmm2d
from qllm_tpu_torch.serve import ContinuousBatchingEngine as TEngine
from qllm_tpu_torch.serve import ServeConfig
from qllm_tpu_torch.serve import engine as tengine

TOL = 5e-2  # model logits (tests/test_torch_slice.py)


@pytest.fixture
def jax_w4a8(monkeypatch):
    """QLLM_TPU_W4A8=1 for the JAX package, its caches cleared before and
    after (the switch is read at trace time)."""
    monkeypatch.setenv("QLLM_TPU_W4A8", "1")
    jax.clear_caches()
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def _bf16_ulp(y: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |y| (8 significand bits)."""
    a = np.maximum(np.abs(y), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _close_a8(y, ref):
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    limit = 2 * _bf16_ulp(ref) + 1e-3 * float(np.abs(ref).max())
    bad = np.abs(y - ref) > limit
    assert not bad.any(), f"{int(bad.sum())} outputs off by up to {float(np.abs(y - ref).max())}"


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,M,K,g", [(jnp.bfloat16, 8, 1280, 64), (jnp.float32, 3, 512, 128)])
def test_quantizer_matches_jax_bit_for_bit(dtype, M, K, g):
    rng = np.random.default_rng(M * 7 + K)
    x = rng.normal(size=(M, K)).astype(np.float32) * rng.uniform(0.01, 40.0, size=(M, 1)).astype(np.float32)
    x[0] = 0.0  # an all-zero row: sx = 1e-8 / 127, x8 = 0
    x[-1, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]  # ties at x / sx to round half to even
    xj = jnp.asarray(x, dtype)
    xf = xj.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=1), 1e-8) / 127.0
    x8 = jnp.clip(jnp.round(xf / sx[:, None]), -127, 127).astype(jnp.int8)
    sum8 = x8.astype(jnp.float32).reshape(M, K // g, g).sum(axis=2)
    t8, tsx, tsum = qmm.quantize_rows_int8(_t(xj), g)  # a CPU tensor: the plain version
    np.testing.assert_array_equal(t8.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
    np.testing.assert_array_equal(tsum.numpy().astype(np.float32), np.asarray(sum8))


# ---------------------------------------------------------------------------
# K12: per-layer GPTQ-order weights
# ---------------------------------------------------------------------------


def _gptq_pair(bits, g, K, N, seed, act_order=False):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05)
    perm = None
    if act_order:
        perm = jnp.asarray(rng.permutation(K).astype(np.int32))
        w = w[perm]
    jqt = quantize_tensor(w, bits=bits, group_size=g, perm=perm)
    return jqt, params_from_numpy(jax.tree_util.tree_map(np.asarray, jqt), device="cpu"), rng


# (bits, g, M, act_order): every bit width meets both group sizes and the
# decode Ms; the act-order case gathers x's columns first
K12_CASES = [(2, 64, 1, False), (2, 128, 32, False), (4, 64, 8, False), (4, 128, 32, False),
             (4, 128, 1, True)]


@pytest.mark.parametrize("bits,g,M,act_order", K12_CASES)
def test_k12_plain_matches_qmatmul_pallas_w4a8(jax_w4a8, bits, g, M, act_order):
    K, N = 512, 384
    jqt, tqt, rng = _gptq_pair(bits, g, K, N, seed=bits * 100 + g + M, act_order=act_order)
    xb = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    xp = jnp.take(xb, jqt.perm, axis=-1) if act_order else xb
    y_ref = np.asarray(qmatmul_pallas(xp, jqt).astype(jnp.float32))
    if not act_order:
        y = qmm2d.gptq_w4a8_gemv_plain(_t(xb), tqt.qweight, tqt.scales, tqt.zeros, bits, g)
        assert y.dtype == torch.bfloat16 and tuple(y.shape) == (M, N)
        _close_a8(y.float().numpy(), y_ref)
    # the entry point (perm first) takes K12 under w4a8 and K9 without it
    y8 = qmm2d.qmatmul_2d(_t(xb), tqt, w4a8=True).float().numpy()
    _close_a8(y8, y_ref)
    y16 = qmm2d.qmatmul_2d(_t(xb), tqt).float().numpy()
    assert not np.array_equal(y8, y16)


@pytest.mark.parametrize("bits,M", [(8, 8), (4, 40)])
def test_k12_routes_that_keep_bf16_activations(jax_w4a8, bits, M):
    """8-bit weights and M > 32 stay on K9 / K10 under w4a8, as _qmm_2d
    does with its flag on (pallas_qmm.py:353-363)."""
    K, N, g = 512, 256, 128
    jqt, tqt, rng = _gptq_pair(bits, g, K, N, seed=bits + M)
    xb = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    y_ref = np.asarray(qmatmul_pallas(xb, jqt).astype(jnp.float32))
    y8 = qmm2d.qmatmul_2d(_t(xb), tqt, w4a8=True)
    assert torch.equal(y8, qmm2d.qmatmul_2d(_t(xb), tqt))
    scale = float(np.abs(y_ref).max())
    np.testing.assert_allclose(y8.float().numpy(), y_ref, atol=1e-2 * scale, rtol=1e-2)


# ---------------------------------------------------------------------------
# K11: planar [L]-stacks
# ---------------------------------------------------------------------------


def _stacks(K, N, g, L, seed):
    rng = np.random.default_rng(seed)
    qts = [
        quantize_tensor(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4, group_size=g)
        for _ in range(L)
    ]
    params = {"embed_tokens": jnp.zeros((8, 8)), "norm": jnp.ones((8,)), "layers": [{"q_proj": q} for q in qts]}
    js = jstacked.stack_layer_params(params, scale_store_dtype=jnp.bfloat16)["layers"]["q_proj"]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return js, tstacked.stack_layer_params(tp, scale_store_dtype=torch.bfloat16)["layers"]["q_proj"], rng


@pytest.mark.parametrize("K,g,M,norm", [(1280, 64, 32, False), (1024, 128, 8, True)])
def test_k11_plain_matches_stacked_kernel_w4a8(jax_w4a8, K, g, M, norm):
    """The full-K planar kernel's a8 branch (interpret mode), the RMSNorm
    applied first where it is asked for, layer by layer."""
    jax_w4a8.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    N, L = 384, 2
    js, ts, rng = _stacks(K, N, g, L, seed=K + M)
    assert qmm.a8_full_k_ok(K, g, ts.qweight.shape[-1])
    xb = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, size=(L, K)).astype(np.float32), jnp.bfloat16) if norm else None
    tnw = None if nw is None else _t(nw)
    for layer in range(L):
        y_ref = np.asarray(qmatmul_pallas_stacked(xb, js, jnp.int32(layer), norm_w=nw).astype(jnp.float32))
        y8 = qmm.qmatmul_stacked(_t(xb), ts, layer, norm_w=tnw, w4a8=True).float().numpy()
        _close_a8(y8, y_ref)
        if not norm:
            y = qmm.w4a8_planar_gemv_plain(_t(xb), ts.qweight, ts.scales, ts.zeros, layer)
            _close_a8(y[:, :N].float().numpy(), y_ref)
        y16 = qmm.qmatmul_stacked(_t(xb), ts, layer, norm_w=tnw).float().numpy()
        assert not np.array_equal(y8, y16)


def test_k11_routes_that_keep_bf16_activations():
    """M > 32 keeps bf16 activations (K2) under w4a8. Every stack the
    serving prep makes is in the full-K geometry, so the other way out is
    JAX's VMEM cap on a (K/8) x bn word block, bn = _pick_block(Np, 128,
    512): 4 MiB, first passed at K = 32768 with bn = 512."""
    _, ts, rng = _stacks(1024, 384, 128, 2, seed=3)
    x = _t(np.asarray(jnp.asarray(rng.normal(size=(40, 1024)).astype(np.float32), jnp.bfloat16)))
    assert torch.equal(qmm.qmatmul_stacked(x, ts, 1, w4a8=True), qmm.qmatmul_stacked(x, ts, 1))
    assert qmm.a8_full_k_ok(16384, 128, 22016) and not qmm.a8_full_k_ok(32768, 128, 22016)
    assert qmm.a8_full_k_ok(32768, 128, 640)  # bn = 128: 2 MiB
    assert not qmm.a8_full_k_ok(1152, 64, 512)  # K % 256 != 0: no full-K kernel


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _separate(npp, vocab, seed):
    """The lm_head columns of 8 tokens scaled up 8x (as test_torch_slice.py
    does): greedy picks among them with margins (asserted below)."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(vocab, 8, replace=False)
    sc = np.array(npp["lm_head"].scales)
    sc[:, cols] = (sc[:, cols].astype(np.float32) * 8.0).astype(sc.dtype)
    npp["lm_head"] = dataclasses.replace(npp["lm_head"], scales=sc)
    return npp


def _model(cfg_kw, seed, g):
    jcfg = jllama.ModelConfig(**cfg_kw)
    npp = jax.tree_util.tree_map(
        np.asarray, j_random_params(jcfg, jax.random.key(seed), bits=4, group_size=g, quantize_lm_head=True)
    )
    npp = _separate(npp, cfg_kw["vocab_size"], seed)
    return jcfg, npp, tllama.ModelConfig(**dataclasses.asdict(jcfg))


def _assert_separated(logits):
    s = np.sort(logits, axis=-1)
    assert np.all(s[:, -1] - s[:, -2] > 2 * (TOL + TOL * np.abs(s[:, -1]))), "greedy decision too close"


# max_position_embeddings no other test uses (cfg is static in JAX's jit)
LLAMA = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=651)


def test_tiny_llama_stacked_w4a8_greedy_matches_jax(jax_w4a8):
    """Prefill (B=2, T=24: M = 48, bf16 activations in both) then 6 greedy
    steps under W4A8 (every stacked matmul at M = 2: K11's plain version)."""
    for k in ("QLLM_TPU_FORCE_STACKED_KERNEL", "QLLM_TPU_FORCE_PALLAS_ATTN"):
        jax_w4a8.setenv(k, "1")
    jax_w4a8.setenv("QLLM_TPU_WIDE_PAD", "0")
    B, T, STEPS, MAX_SEQ = 2, 24, 6, 64
    jcfg, npp, tcfg = _model(LLAMA, 10, 128)
    tokens = np.random.default_rng(10).integers(0, LLAMA["vocab_size"], (B, T)).astype(np.int32)
    js = jstacked.stack_layer_params(jax.tree_util.tree_map(jnp.asarray, npp), scale_store_dtype=jnp.bfloat16)
    js["lm_head"] = jstacked.prepare_lm_head(js["lm_head"], scale_store_dtype=jnp.bfloat16)
    ts = tstacked.stack_layer_params(params_from_numpy(npp, device="cpu"), scale_store_dtype=torch.bfloat16)
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"], scale_store_dtype=torch.bfloat16)

    jcache = j_make_cache(jcfg, B, MAX_SEQ)
    jl, jcache = j_prefill(js, jcfg, jnp.asarray(tokens), jcache)
    jcache0 = jax.tree_util.tree_map(np.asarray, jcache)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    j_inputs, j_logits = [tok], []
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(tok), jcache, jnp.int32(T + i))
        j_logits.append(np.asarray(jl))
        _assert_separated(j_logits[-1])
        tok = np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None]
        j_inputs.append(tok)

    tcache = t_make_cache(tcfg, B, MAX_SEQ, device="cpu")
    tl, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), tcache, device="cpu", w4a8=True)
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first.numpy(), j_inputs[0])
    t_ids, tcache = t_decode_loop(ts, tcfg, first, tcache, T, STEPS, device="cpu", w4a8=True)
    np.testing.assert_array_equal(t_ids.numpy(), np.concatenate(j_inputs[1:], axis=1))
    # per-step logits on the JAX stream from JAX's prefilled cache (the
    # prefills' int8 rows differ at this width: tests/test_torch_ring.py)
    tcache = cache_from_numpy(jcache0, "cpu")
    for i in range(STEPS):
        tok = torch.from_numpy(j_inputs[i])
        if i == 0:  # the step with bf16 activations first: the a8 step rewrites its cache row
            tl16, _ = tllama.forward(ts, tcfg, tok, tcache, pos=T)
        tl8, _ = tllama.forward(ts, tcfg, tok, tcache, pos=T + i, w4a8=True)
        np.testing.assert_allclose(tl8[:, -1].numpy(), j_logits[i], atol=TOL, rtol=TOL, err_msg=f"step {i}")
        if i == 0:
            assert not torch.equal(tl8, tl16)


SERVE_LLAMA = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=653)
MIXTRAL = dict(vocab_size=256, hidden_size=256, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, arch="mixtral", num_local_experts=8, num_experts_per_tok=2,
               max_position_embeddings=655)


def _serve_both(jcfg, npp, tcfg, requests, scfg_kw):
    """The JAX engine (W4A8 through its env switch) and the port's engine
    (ServeConfig(w4a8=True), the plain versions on the CPU) on the same
    params and requests -> (jax outputs, port outputs)."""
    outs = []
    for Engine, Cfg, params, cfg, kw in (
        (JEngine, JServeConfig, jax.tree_util.tree_map(jnp.asarray, npp), jcfg, {}),
        (TEngine, ServeConfig, params_from_numpy(npp, device="cpu"), tcfg, {"device": "cpu"}),
    ):
        eng = Engine(params, cfg, Cfg(**scfg_kw, w4a8=True), **kw)
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in requests]
        assert len(eng.run()) == len(requests)
        outs.append([r.output for r in reqs])
    return outs


def test_engine_w4a8_per_layer_matches_jax_engine(jax_w4a8):
    """Per-layer params: decode steps and bucket-16 prefills through K12's
    plain version, the 40-token prompt's bucket-64 prefill through K10's.
    JAX's per-layer CPU route is XLA and ignores the switch
    (ref_matmul.py:55-61), so the test sends it to qmatmul_pallas."""
    jax_w4a8.setattr(j_ref_matmul, "_use_pallas", lambda: True)
    jcfg, npp, tcfg = _model(SERVE_LLAMA, 21, 64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, SERVE_LLAMA["vocab_size"], size=n).astype(np.int32) for n in (5, 9, 40)]
    j_out, t_out = _serve_both(jcfg, npp, tcfg, [(p, 5) for p in prompts],
                               dict(max_batch=2, max_seq=64, prefill_buckets=(16, 64)))
    assert t_out == j_out


def test_tiny_mixtral_engine_w4a8_matches_jax_engine(jax_w4a8):
    """Hybrid-stacked MoE: attention and the lm_head through K11's plain
    version, the dense expert loop of the bucket-16 prefills too; the
    sparse decode's grouped launches stay a16 (K8) in both packages."""
    jax_w4a8.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    jcfg, npp, tcfg = _model(MIXTRAL, 3, 128)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, MIXTRAL["vocab_size"], size=n).astype(np.int32) for n in (5, 9)]
    j_out, t_out = _serve_both(jcfg, npp, tcfg, [(p, 4) for p in prompts],
                               dict(max_batch=2, max_seq=32, prefill_buckets=(16,)))
    assert t_out == j_out


def test_a16_and_a8_engines_keep_their_own_numerics(monkeypatch):
    """Two engines in one process: every forward the a8 engine runs gets
    w4a8=True and every one of the a16 engine's False; each serves
    greedy_generate's tokens with its own flag, and their first prefill's
    logits differ (the JAX engine sets one process-wide switch)."""
    jcfg, npp, tcfg = _model(SERVE_LLAMA, 22, 64)
    tp = params_from_numpy(npp, device="cpu")
    seen = {True: [], False: []}
    forward = tengine.forward

    def spy(*a, w4a8=False, **kw):
        out = forward(*a, w4a8=w4a8, **kw)
        seen[w4a8].append(out[0])
        return out

    monkeypatch.setattr(tengine, "forward", spy)
    prompt = np.random.default_rng(2).integers(1, SERVE_LLAMA["vocab_size"], size=16).astype(np.int32)
    engines = {a8: TEngine(tp, tcfg, ServeConfig(max_batch=1, max_seq=32, prefill_buckets=(16,), w4a8=a8),
                           device="cpu") for a8 in (True, False)}
    reqs = {a8: eng.submit(prompt, 4) for a8, eng in engines.items()}
    while any(not r.finished for r in reqs.values()):  # interleaved
        for eng in engines.values():
            eng.step()
    assert len(seen[True]) == len(seen[False]) == 4  # one prefill and three decode steps each
    assert not torch.equal(seen[True][0], seen[False][0])
    for a8, r in reqs.items():
        ref = t_greedy_generate(tp, tcfg, torch.from_numpy(prompt[None]), 4, max_seq=32, device="cpu", w4a8=a8)
        assert r.output == ref[0, 16:].tolist()
