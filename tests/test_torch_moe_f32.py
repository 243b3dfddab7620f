"""Port parity for MoE expert stacks that the grouped kernel K8 does not
take, served per selection as the JAX package serves them
(``grouped_expert_linear``, qllm_tpu/models/moe.py:275-277), on the CPU
at tiny sizes:

  * ``stack_layer_params_hybrid`` / ``stack_experts`` leaves bit-equal to
    JAX's at the f32 default and at bf16 (tiny Mixtral and Qwen3-MoE);
  * ``grouped_expert_linear`` on f32-scale 4-bit stacks (K17 where the
    stack has a k-block, the fallback where it has none, as the Qwen3
    down_proj K = 768) and on 2-bit stacks (K14) against JAX's
    per-selection loop on its chip's branch (QLLM_TPU_FORCE_STACKED_KERNEL
    =1, QLLM_TPU_FUSED_CORR=0, ``grouped_experts_ok`` answered as on the
    chip), within one bf16 ulp of max|y| (the fallback, which JAX's CPU
    sends to its XLA product and the port to K9's plain version, within
    the K8 tolerance of tests/test_moe_sparse.py:174); the ids never leave
    the device: K8 is not called;
  * a tiny Mixtral and a tiny Qwen3-MoE stacked with both packages'
    defaults (f32 scales): prefill and greedy steps through the
    per-selection path give JAX's greedy tokens, logits within 5e-2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models import moe as jmoe
from qllm_tpu.models import stacked as jstacked
from qllm_tpu.models.generate import decode_step as j_decode_step
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.models.generate import prefill as j_prefill
from qllm_tpu.ops import pallas_qmm as jpq
from qllm_tpu.quant.qtensor import quantize_tensor as j_quantize
from qllm_tpu_torch.interop import params_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models import moe as tmoe
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.models.decode_loop import decode_loop as t_decode_loop
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.models.generate import prefill as t_prefill
from qllm_tpu_torch.ops import qmm as tqmm
from qllm_tpu_torch.ops import qmm_planar, qmm_stacked
from test_torch_moe import TOL, _assert_identical, _moe_params

K8_TOL = (2e-2, 1e-3)  # |y - ref| <= 2e-2 * max|ref| + 1e-3 (tests/test_moe_sparse.py:174)
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


# seeds whose greedy decisions all clear twice the tolerance (asserted)
SLICES = {"mixtral": (1, 0), "qwen3_moe": (2, 3)}  # batch, seed


@functools.lru_cache(maxsize=None)
def _source(name):
    """The config and numpy params of a tiny model (read only by the
    callers) and the state of the generator that drew them."""
    jcfg, npp, rng = _moe_params(name, SLICES[name][1], False)
    return jcfg, npp, rng.bit_generator.state


@pytest.mark.parametrize("sd", ["default", "bf16"])
@pytest.mark.parametrize("name", ["mixtral", "qwen3_moe"])
def test_hybrid_stacks_match_jax(monkeypatch, name, sd):
    """Both packages' defaults (f32 scales and zs) and bf16 storage."""
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    _, npp, _ = _source(name)
    jkw, tkw = ({}, {}) if sd == "default" else ({"scale_store_dtype": _DT[sd][0]}, {"scale_store_dtype": _DT[sd][1]})
    js = jstacked.stack_layer_params_hybrid(jax.tree_util.tree_map(jnp.asarray, npp), **jkw)
    ts = tstacked.stack_layer_params_hybrid(params_from_numpy(npp, device="cpu"), **tkw)
    _assert_identical(js["layers"], ts["layers"])
    want = torch.bfloat16 if sd == "bf16" else torch.float32
    assert all(v.scales.dtype == want for v in ts["layers"]["experts_stacked"].values())
    jl = jmoe.stack_experts(jax.tree_util.tree_map(jnp.asarray, npp), **jkw)["layers"]
    tl = tmoe.stack_experts(params_from_numpy(npp, device="cpu"), **tkw)["layers"]
    for a, b in zip(jl, tl):
        _assert_identical(a["experts_stacked"], b["experts_stacked"])


def _count(monkeypatch, mod, name):
    calls = []
    plain = getattr(mod, name)

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.fixture
def chip_branch(monkeypatch):
    """JAX's CPU on its chip's branches for these stacks: the stacked
    kernels forced (interpreted), the correction of f32 planar stacks kept
    outside the kernel, and ``grouped_experts_ok`` answered as on the chip
    (False for f32 scales and for every width but 4 bits)."""
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    monkeypatch.setenv("QLLM_TPU_FUSED_CORR", "0")
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    gate = jpq.grouped_experts_ok

    def on_chip(qt):
        with monkeypatch.context() as mp:
            mp.setattr(jax, "default_backend", lambda: "tpu")
            return gate(qt)

    monkeypatch.setattr(jpq, "grouped_experts_ok", on_chip)
    jax.clear_caches()
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


# (bits, K, N, g, scale storage, the branch qmatmul_stacked takes at M = 1)
PER_SELECTION = [
    (4, 2048, 384, 128, "f32", "planar_f32"),  # Qwen3's gate|up geometry: K17
    (4, 768, 512, 128, "f32", "fallback"),  # Qwen3's down_proj geometry: no k-block
    (2, 512, 256, 64, "f32", "v3"),  # a 2-bit stack: K14
]


@pytest.mark.parametrize(
    "bits,K,N,g,sd,route,shared", [c + (True,) for c in PER_SELECTION] + [PER_SELECTION[0] + (False,)]
)
def test_per_selection_matches_jax(chip_branch, bits, K, N, g, sd, route, shared):
    """One token's selections (a shared row) on every branch; per-row
    selections (the sorted batch path) on K17's."""
    E = 4
    rng = np.random.default_rng(K + bits)
    parts = [
        j_quantize(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=bits, group_size=g)
        for _ in range(E)
    ]
    raw = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *parts)
    jw = jstacked.prepare_stacked_tensor(raw, lane_quantum=128, planar=True, scale_store_dtype=_DT[sd][0])
    tw = params_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    assert not jpq.grouped_experts_ok(jw) and not tqmm.grouped_experts_ok(tw)
    assert tqmm.stacked_route(tw, 1) == route
    ids = np.array([2, 0, 3, 2], np.int32)  # selection 3 repeats selection 0's expert and row
    x = rng.normal(size=(len(ids), K)).astype(np.float32)
    x[3] = x[0]
    if shared:
        x[:] = x[0]
    xj = jnp.asarray(x, jnp.bfloat16)
    yj = np.asarray(jmoe.grouped_expert_linear(jw, jnp.asarray(ids), xj, x_shared=shared), np.float32)
    k8 = _count(chip_branch, tqmm, "w4_grouped_gemv_plain")
    k17 = _count(chip_branch, qmm_planar, "w4_planar_f32s_gemv_plain")
    k14 = _count(chip_branch, qmm_stacked, "gptq_stacked_gemv_plain")
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    yt = tmoe.grouped_expert_linear(tw, torch.from_numpy(ids), xt[:1] if shared else xt, x_shared=shared)
    assert tuple(yt.shape) == (len(ids), N) and not k8
    assert len(k17) == (len(ids) if route == "planar_f32" else 0)
    assert len(k14) == (len(ids) if route == "v3" else 0)
    yt = yt.float().numpy()
    scale = np.abs(yj).max()
    tol = K8_TOL[0] * scale + K8_TOL[1] if route == "fallback" else 2.0 ** (np.floor(np.log2(scale)) - 7)
    np.testing.assert_allclose(yt, yj, atol=tol, rtol=0)
    np.testing.assert_array_equal(yt[0], yt[3])


@pytest.mark.parametrize("name", sorted(SLICES))
def test_f32_expert_slice_matches_jax(monkeypatch, name):
    """Both packages' default (f32-scale) hybrid stacks: a prefill (the
    dense expert loop) and greedy sparse steps; the port serves every
    expert stack per selection (no K8)."""
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    T, STEPS, MAX_SEQ = 16, 4, 32
    jcfg, npp, state = _source(name)
    B = SLICES[name][0]
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    assert B * jcfg.num_experts_per_tok < jcfg.num_local_experts  # decode is sparse
    js = jstacked.stack_layer_params_hybrid(jax.tree_util.tree_map(jnp.asarray, npp))
    js["lm_head"] = jstacked.prepare_lm_head(js["lm_head"])
    ts = tstacked.stack_layer_params_hybrid(params_from_numpy(npp, device="cpu"))
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"])
    _assert_identical(js["layers"], ts["layers"])
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)

    jcache = j_make_cache(jcfg, B, MAX_SEQ)
    jl, jcache = j_prefill(js, jcfg, jnp.asarray(tokens), jcache)
    j_logits = [np.asarray(jl)]
    tok = np.argmax(j_logits[0], axis=-1).astype(np.int32)[:, None]
    j_ids = []
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
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first.numpy()[:, 0], np.argmax(j_logits[0], axis=-1))
    k8 = _count(monkeypatch, tqmm, "w4_grouped_gemv_plain")
    t_ids, _ = t_decode_loop(ts, tcfg, first, tcache, T, STEPS, device="cpu")
    assert not k8
    np.testing.assert_array_equal(t_ids.numpy(), np.stack(j_ids, axis=1))
