"""Port parity for the MoE slice against the JAX package, on the CPU at
tiny sizes (the tolerances of tests/test_moe_sparse.py):

  * K8's plain version against ``qmatmul_grouped_experts`` interpreted
    (QLLM_TPU_FORCE_STACKED_KERNEL=1), shared-row and per-row modes,
    within 2e-2 * max|y| + 1e-3, equal (row, id) pairs bit-equal;
  * the mixtral and deepseek/qwen3 routers, ties included;
  * ``_moe_sparse`` at small batch with colliding selections against the
    dense all-experts branch and against JAX's sparse path;
  * ``stack_experts`` / ``stack_layer_params_hybrid`` leaves bit-equal to
    JAX's, ``_moe_stride`` included;
  * greedy tokens of a tiny Mixtral and a tiny Qwen3-MoE (rms q/k norm,
    H * hd != hidden) hybrid-stacked in both packages, token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models import llama as jllama
from qllm_tpu.models import moe as jmoe
from qllm_tpu.models import stacked as jstacked
from qllm_tpu.models.generate import decode_step as j_decode_step
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.models.generate import prefill as j_prefill
from qllm_tpu.ops import pallas_qmm as jpq
from qllm_tpu.quant.qtensor import QuantizedTensor as JQT
from qllm_tpu.quant.qtensor import quantize_tensor as j_quantize
from qllm_tpu.utils.testing import random_quantized_params as j_random_params
from qllm_tpu_torch.interop import params_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models import moe as tmoe
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.models.decode_loop import decode_loop as t_decode_loop
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.models.generate import prefill as t_prefill
from qllm_tpu_torch.ops import qmm as tqmm
from qllm_tpu_torch.quant.qtensor import QuantizedTensor as TQT

TOL = 5e-2  # model logits (tests/test_torch_slice.py)
_BASE = dict(
    vocab_size=512, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2,
)
# max_position_embeddings no other test uses: prefill / decode_step are
# jitted with cfg static and read the kernel-forcing env vars at trace time
CFGS = {
    "mixtral": dict(_BASE, arch="mixtral", num_local_experts=8, num_experts_per_tok=2,
                    max_position_embeddings=643),
    # head_dim 128: H * hd = 512 != hidden 256, as Qwen3-30B-A3B's 4096 != 2048
    "qwen3_moe": dict(_BASE, arch="qwen3_moe", num_local_experts=16, num_experts_per_tok=4, head_dim=128,
                      moe_router="deepseek", norm_topk_prob=True, qk_norm="rms", rms_norm_eps=1e-6,
                      rope_theta=1e6, max_position_embeddings=644),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_identical(js, ts, path="layers"):
    """Every leaf of the two hybrid layer dicts bit-equal (QTs field by field)."""
    assert set(js) == set(ts), path
    for k in js:
        jv, tv = js[k], ts[k]
        where = f"{path}.{k}"
        if isinstance(jv, dict):
            _assert_identical(jv, tv, where)
        elif isinstance(jv, JQT):
            assert isinstance(tv, TQT), where
            assert (jv.planar, jv.zeros_prefolded, jv.out_features) == (tv.planar, tv.zeros_prefolded, tv.out_features)
            for f in ("qweight", "scales", "zeros"):
                np.testing.assert_array_equal(_np(getattr(tv, f)), _np(getattr(jv, f)), err_msg=f"{where}.{f}")
        elif isinstance(jv, int):
            assert isinstance(tv, int) and tv == jv, where
        else:
            np.testing.assert_array_equal(_np(tv), _np(jv), err_msg=where)


def _moe_params(name, seed, prestacked):
    """JAX random params as numpy (+ q/k head-norm weights away from 1
    where the config has them), with 8 lm_head columns scaled up 8x so
    every greedy decision is well separated (asserted by the callers)."""
    jcfg = jllama.ModelConfig(**CFGS[name])
    npp = jax.tree_util.tree_map(
        np.asarray,
        j_random_params(jcfg, jax.random.key(seed), bits=4, group_size=128, quantize_lm_head=True,
                        experts_prestacked=prestacked),
    )
    rng = np.random.default_rng(seed)
    if jcfg.qk_norm:
        for lp in npp["layers"]:
            for nm in ("q_norm", "k_norm"):
                lp[nm] = np.asarray(jnp.asarray(rng.uniform(0.7, 1.3, (jcfg.hd,)), jnp.bfloat16))
    cols = rng.choice(jcfg.vocab_size, 8, replace=False)
    sc = np.array(npp["lm_head"].scales)
    sc[:, cols] = (sc[:, cols].astype(np.float32) * 8.0).astype(np.float16)
    npp["lm_head"] = dataclasses.replace(npp["lm_head"], scales=sc)
    return jcfg, npp, rng


def _hybrid_both(npp, consume=False):
    js = jstacked.stack_layer_params_hybrid(jax.tree_util.tree_map(jnp.asarray, npp), scale_store_dtype=jnp.bfloat16)
    js["lm_head"] = jstacked.prepare_lm_head(js["lm_head"], scale_store_dtype=jnp.bfloat16)
    tp = params_from_numpy(npp, device="cpu")
    ts = tstacked.stack_layer_params_hybrid(tp, consume=consume)
    if consume:  # the caller's layer dicts are handed over and emptied
        assert all(lp == {} for lp in tp["layers"])
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"])
    return js, ts


def _count_grouped(monkeypatch):
    """Count K8 calls on the CPU (the wrapper's launch count moves only
    where it launches the kernel): a list bumped by the plain version."""
    calls = []
    plain = tqmm.w4_grouped_gemv_plain

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(tqmm, "w4_grouped_gemv_plain", counted)
    return calls


@pytest.fixture
def kernels_forced(monkeypatch):
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    monkeypatch.setenv("QLLM_TPU_FORCE_PALLAS_ATTN", "1")
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    jax.clear_caches()


# ---------------------------------------------------------------------------
# (a) K8's plain version against the JAX grouped kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "K,N,shared", [(256, 384, True), (256, 384, False), (512, 256, True), (512, 256, False)]
)
def test_grouped_gemv_plain_matches_jax_kernel(monkeypatch, K, N, shared):
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    rng = np.random.default_rng(K + N)
    E = 4
    parts = [
        j_quantize(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4, group_size=128)
        for _ in range(E)
    ]
    raw = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *parts)
    jw = jstacked.prepare_stacked_tensor(raw, lane_quantum=128, planar=True, scale_store_dtype=jnp.bfloat16)
    tw = tstacked.prepare_stacked_tensor(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, raw), device="cpu"), lane_quantum=128
    )
    _assert_identical({"w": jw}, {"w": tw})
    x = rng.normal(size=(5, K)).astype(np.float32)
    x[3] = x[0]
    ids = np.array([2, 0, 3, 2, 1], np.int32)  # selection 3 repeats selection 0

    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    assert jpq.grouped_experts_ok(jw) and tqmm.grouped_experts_ok(tw)
    yj = np.asarray(jpq.qmatmul_grouped_experts(jnp.asarray(x), jw, jnp.asarray(ids), x_shared=shared), np.float32)
    yt = tmoe.grouped_expert_linear(
        tw, torch.from_numpy(ids), torch.from_numpy(x).to(torch.bfloat16), x_shared=shared
    )
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == (5, N)
    yt = yt.float().numpy()
    assert np.abs(yt - yj).max() < 2e-2 * np.abs(yj).max() + 1e-3
    np.testing.assert_array_equal(yt[0], yt[3])
    np.testing.assert_array_equal(yj[0], yj[3])


# ---------------------------------------------------------------------------
# (b) routing
# ---------------------------------------------------------------------------

_ROUTERS = {
    "mixtral": dict(arch="mixtral"),
    "qwen3_norm_topk": dict(arch="qwen3_moe", moe_router="deepseek", norm_topk_prob=True),
    "deepseek_scaled": dict(arch="deepseek_v2", moe_router="deepseek", routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("router", sorted(_ROUTERS))
def test_router_topk_matches_jax(router):
    E, k, D = 16, 4, 64
    jcfg = jllama.ModelConfig(hidden_size=D, num_local_experts=E, num_experts_per_tok=k, **_ROUTERS[router])
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, D)).astype(np.float32)
    w = rng.normal(size=(D, E)).astype(np.float32)
    jw, jid = jllama._router_topk({"router": jnp.asarray(w)}, jcfg, jnp.asarray(x))
    tw, tid = tllama._router_topk({"router": torch.from_numpy(w)}, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    jd = jllama._router_weights({"router": jnp.asarray(w)}, jcfg, jnp.asarray(x))
    td = tllama._router_weights({"router": torch.from_numpy(w)}, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["rms", "cohere"])
def test_qk_head_norm_matches_jax(kind):
    rng = np.random.default_rng(9)
    B, T, H, hd = 2, 3, 4, 64
    x = np.asarray(jnp.asarray(rng.normal(size=(B, T, H, hd)) * 3.0, jnp.bfloat16))
    w = rng.uniform(0.5, 1.5, (hd,) if kind == "rms" else (H, hd)).astype(np.float32)
    jy = np.asarray(jllama.qk_head_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, kind))
    ty = tllama.qk_head_norm(params_from_numpy(x, device="cpu"), torch.from_numpy(w), 1e-6, kind)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ty), _np(jy))


def test_routing_topk_ties_take_the_lowest_index():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0, 1.0, 5.0]], np.float32)
    jv, ji = jllama._routing_topk(jnp.asarray(x), 4)
    tv, ti = tllama._routing_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# (c) the sparse block against the dense branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,E,k,B", [("mixtral", 16, 2, 4), ("qwen3_moe", 16, 4, 3)])
def test_moe_sparse_matches_dense_and_jax(monkeypatch, name, E, k, B):
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    kw = dict(CFGS[name], num_local_experts=E, num_experts_per_tok=k, num_hidden_layers=1)
    jcfg = jllama.ModelConfig(**kw)
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    npp = jax.tree_util.tree_map(np.asarray, j_random_params(jcfg, jax.random.key(21), bits=4, group_size=128))
    rng = np.random.default_rng(3)
    # a sharper router than the random params' (more distinct selections)
    npp["layers"][0]["router"] = rng.normal(size=(jcfg.hidden_size, E)).astype(np.float32) * 0.2
    x_np = rng.normal(size=(B, 1, jcfg.hidden_size)).astype(np.float32)
    x_np[2] = x_np[0]  # identical rows -> identical top-k -> colliding ids
    assert B * k < E  # the sparse regime

    jlp = jmoe.stack_experts(jax.tree_util.tree_map(jnp.asarray, npp), scale_store_dtype=jnp.bfloat16)["layers"][0]
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    assert jpq.grouped_experts_ok(jlp["experts_stacked"]["gateup_proj"])
    xj = jnp.asarray(x_np).astype(jnp.bfloat16)
    y_jax = np.asarray(jllama._moe_sparse(jllama.LayerView(jlp), jcfg, xj, k), np.float32)

    tp = params_from_numpy(npp, device="cpu")
    assert tmoe.has_stackable_experts(tp)
    tlp = tmoe.stack_experts(tp)["layers"][0]
    assert not tmoe.has_stackable_experts({"layers": [tlp]})
    _assert_identical(
        {"e": jlp["experts_stacked"], "router": jlp["router"]}, {"e": tlp["experts_stacked"], "router": tlp["router"]}
    )
    pv = tllama.LayerView(tlp)
    x = torch.from_numpy(x_np).to(torch.bfloat16)
    calls = _count_grouped(monkeypatch)
    y_sparse = tllama._moe_forward(pv, tcfg, x).float().numpy()
    assert len(calls) == 2  # gate|up and down, every selection at once
    # the dense loop over the same stacks (B*T*k >= E routes there)
    y_dense = tllama._moe_forward(pv, tcfg, torch.cat([x, x], dim=1))[:, :1].float().numpy()
    scale = np.abs(y_dense).max()
    assert np.abs(y_sparse - y_dense).max() < 2e-2 * scale + 1e-3
    assert np.abs(y_sparse - y_jax).max() < 2e-2 * scale + 1e-3
    np.testing.assert_array_equal(y_sparse[0], y_sparse[2])


# ---------------------------------------------------------------------------
# (d) serving stacks bit-equal to JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,prestacked,consume", [
    ("mixtral", False, False), ("mixtral", True, True), ("qwen3_moe", False, True), ("qwen3_moe", True, False),
])
def test_hybrid_stacks_match_jax(monkeypatch, name, prestacked, consume):
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    jcfg, npp, _ = _moe_params(name, 31, prestacked)
    js, ts = _hybrid_both(npp, consume=consume)
    E = jcfg.num_local_experts
    assert ts["layers"]["_moe_stride"] == js["layers"]["_moe_stride"] == E
    est = ts["layers"]["experts_stacked"]
    assert set(est) == {"gateup_proj", "down_proj"}
    assert est["gateup_proj"].qweight.shape[0] == E * jcfg.num_hidden_layers
    # narrow expert stacks pad to 128 lanes, not 512
    assert est["down_proj"].qweight.shape[-1] == jcfg.hidden_size
    _assert_identical(js["layers"], ts["layers"])
    _assert_identical({"lm_head": js["lm_head"]}, {"lm_head": ts["lm_head"]})
    # per-layer stacking alone matches too
    jl = jmoe.stack_experts(jax.tree_util.tree_map(jnp.asarray, npp), scale_store_dtype=jnp.bfloat16)["layers"]
    tl = tmoe.stack_experts(params_from_numpy(npp, device="cpu"))["layers"]
    for a, b in zip(jl, tl):
        _assert_identical(a["experts_stacked"], b["experts_stacked"])


def test_moe_stride_carries_across_as_an_int():
    tp = params_from_numpy({"layers": {"_moe_stride": np.asarray(8), "router": np.zeros((2, 3), np.float32)}},
                           device="cpu")
    assert type(tp["layers"]["_moe_stride"]) is int and tp["layers"]["_moe_stride"] == 8


# ---------------------------------------------------------------------------
# (e) the slice end to end: greedy tokens
# ---------------------------------------------------------------------------


# seeds whose greedy decisions all clear twice the tolerance (asserted)
@pytest.mark.parametrize("name,prestacked,B,seed", [("mixtral", False, 1, 56), ("qwen3_moe", True, 2, 49)])
def test_moe_slice_greedy_matches_jax(kernels_forced, monkeypatch, name, prestacked, B, seed):
    """Prefill (dense expert loop, K2) then greedy steps (sparse: K8 with
    a shared row at B=1, sorted selections at B=2) on the int8 cache."""
    T, STEPS, MAX_SEQ = 24, 8, 64
    jcfg, npp, rng = _moe_params(name, seed, prestacked)
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    assert B * jcfg.num_experts_per_tok < jcfg.num_local_experts  # decode is sparse
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    js, ts = _hybrid_both(npp)
    _assert_identical(js["layers"], ts["layers"])

    jcache = j_make_cache(jcfg, B, MAX_SEQ)
    jl, jcache = j_prefill(js, jcfg, jnp.asarray(tokens), jcache)
    j_logits = [np.asarray(jl)]
    tok = np.argmax(j_logits[0], axis=-1).astype(np.int32)[:, None]
    first, j_ids = tok, []
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(tok), jcache, jnp.int32(T + i))
        j_logits.append(np.asarray(jl))
        tok = np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None]
        j_ids.append(tok[:, 0])
    for lg in j_logits:
        s = np.sort(lg, axis=-1)
        assert np.all(s[:, -1] - s[:, -2] > 2 * (TOL + TOL * np.abs(s[:, -1]))), "greedy decision too close"

    tcache = t_make_cache(tcfg, B, MAX_SEQ, device="cpu")
    tl, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), tcache, device="cpu")
    np.testing.assert_allclose(tl.numpy(), j_logits[0], atol=TOL, rtol=TOL)
    tfirst = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(tfirst.numpy(), first)
    calls = _count_grouped(monkeypatch)
    t_ids, _ = t_decode_loop(ts, tcfg, tfirst, tcache, T, STEPS, device="cpu")
    assert len(calls) == 2 * jcfg.num_hidden_layers * STEPS
    np.testing.assert_array_equal(t_ids.numpy(), np.stack(j_ids, axis=1))
