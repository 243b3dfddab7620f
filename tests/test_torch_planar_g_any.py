"""Port parity for planar 4-bit stacks whose groups end inside a planar
word's k quadruple (g = 3, 6: any g that JAX's planar gates admit, g % 4
!= 0), with g = 12 (a multiple of 4 that closes inside a 16-k tile) as
the control.

  * Routing: ``stacked_route`` against the branch JAX's gate takes on its
    chip (traced with ``default_backend`` reporting "tpu", as
    tests/test_torch_planar_f32.py does) at g = 3, 6 and 12 on K = 768 and
    1536, bf16 prefolded and f32 stacks, M = 1 and 64, with and without
    W4A8: a kernel route, as in JAX, never the fallback.
  * The plain versions of K1, K2 (bf16 prefolded stacks, against
    ``qmatmul_pallas_stacked`` with the stacked kernels forced, in
    interpret mode, within 2e-2 * max|y|), K17, K18 (f32 stacks plus the
    port's correction, against ``_qmm_kernel_planar`` called directly,
    within one bf16 ulp), K8 (against JAX's interpreted grouped kernel)
    and K11 (against the a8 branch of the full-K kernel) at g = 6, with the
    limits of tests/test_torch_planar_g8.py.
  * On a stand-in card (the C library replaced by a recorder), each route
    calls its kernel's C entry with the stack's g, not the fallback's.

The JAX package reads its switches when it traces: the fixtures clear its
caches on the way in and out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qllm_tpu.ops.pallas_qmm as pq
import qllm_tpu.ops.ref_matmul as j_ref_matmul
from qllm_tpu.models import stacked as jstacked
from qllm_tpu.ops import pallas_qmm as jpq
from qllm_tpu.quant.qtensor import quantize_tensor as j_quantize
from qllm_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.models import moe as tmoe
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.ops import _build, qmm, qmm_planar
from test_torch_planar_f32 import (  # noqa: F401 (jax_env is a fixture)
    _clear_gate_traces,
    _count_calls,
    _jax_unfused,
    _stacks,
    _ulp_tol,
    jax_env,
)
from test_torch_w4a8 import _close_a8

GEOMS = [(K, g) for K in (768, 1536) for g in (3, 6, 12)]
ROUTE_TAG = {"planar": "fused", "planar_f32": "unfused", "fallback": "fallback"}


def _jax_chip_branch(monkeypatch, js, M, w4a8):
    """The kernel ``qmatmul_pallas_stacked`` hands pallas_call on its chip
    at M rows: as tests/test_torch_planar_f32.py's ``_jax_chip_branches``
    (``jax.default_backend`` reporting "tpu", ``jax.eval_shape``, the gate's
    traces cleared before and after), but the planar kernel bodies are
    replaced by their counters, so a stack of many groups traces no
    per-group loop (the gate's choice is made before any body runs)."""
    seen = []

    def counted(tag):
        def body(*a, **k):
            seen.append("a8" if k.get("a8") else tag)

        return body

    def fallback(*a, **k):
        seen.append("fallback")
        return j_qmatmul(*a, **k)

    j_qmatmul = j_ref_matmul.qmatmul
    with monkeypatch.context() as mp:
        for name, tag in (("_qmm_kernel_planar_full", "fused"), ("_qmm_kernel_planar_fused", "fused"),
                          ("_qmm_kernel_planar", "unfused")):
            mp.setattr(pq, name, counted(tag))
        mp.setattr(j_ref_matmul, "qmatmul", fallback)
        if w4a8:
            mp.setenv("QLLM_TPU_W4A8", "1")
        mp.setenv("QLLM_TPU_QMM_BN", "512")
        mp.setenv("QLLM_TPU_QMM_BK", "2048")
        mp.setattr(jax, "default_backend", lambda: "tpu")
        _clear_gate_traces()
        x = jax.ShapeDtypeStruct((M, js.in_features), jnp.bfloat16)
        jax.eval_shape(lambda x: pq.qmatmul_pallas_stacked(x, js, jnp.int32(1)), x)
    _clear_gate_traces()
    assert len(set(seen)) == 1, (M, seen)
    return seen[0]


@pytest.mark.parametrize("K,g", GEOMS)
@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_route_matches_jax_chip_gate(jax_env, K, g, sd):
    """stacked_route names the kernel JAX's chip gate traces, never the
    fallback, at M = 1 and 64 with and without W4A8."""
    js, ts = _stacks(K, g, sd, True, seed=K + g)
    assert qmm._kernel_geometry_ok(K, g) and qmm.planar_full_ok(K, g)
    for w4a8 in (False, True):
        for M in (1, 64):
            expected = _jax_chip_branch(jax_env, js, M, w4a8)
            route = qmm.stacked_route(ts, M, w4a8=w4a8)
            port = ROUTE_TAG[route]
            if port == "fused" and w4a8 and M <= 32 and qmm.a8_full_k_ok(K, g, ts.qweight.shape[-1]):
                port = "a8"
            assert port == expected != "fallback", (M, w4a8, route)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K17", "K18"])
def test_plain_versions_match_interpreted_kernels_at_g6(jax_env, kernel):
    """K1 (M = 8) and K2 (M = 40) through qmatmul_stacked on a bf16
    prefolded stack against qmatmul_pallas_stacked; K17 (M = 8) and K18 (M =
    40) plus the correction on an f32 stack against _qmm_kernel_planar."""
    K, g = 768, 6
    M = 8 if kernel in ("K1", "K17") else 40
    rng = np.random.default_rng(K + g + M)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    xt = tensor_from_numpy(np.asarray(x), "cpu")
    if kernel in ("K1", "K2"):
        js, ts = _stacks(K, g, "bf16", True, seed=K + g)
        name = "w4_planar_gemv" if kernel == "K1" else "w4_planar_gemm"
        calls = _count_calls(jax_env, qmm, (name,))
        y_ref = np.asarray(jpq.qmatmul_pallas_stacked(x, js, jnp.int32(1)).astype(jnp.float32))
        y = qmm.qmatmul_stacked(xt, ts, 1).float().numpy()
        assert calls == {name: 1}
        scale = float(np.abs(y_ref).max())
        np.testing.assert_allclose(y, y_ref, atol=2e-2 * scale, rtol=2e-2)
    else:
        js, ts = _stacks(K, g, "f32", True, seed=K + g)
        name = "w4_planar_f32s_gemv" if kernel == "K17" else "w4_planar_f32s_gemm"
        calls = _count_calls(jax_env, qmm_planar, (name,))
        y_ref = _jax_unfused(js, x, 1)
        y = qmm._planar_unfused_matmul(xt, ts, 1, None, 1e-6, M, K, g)
        assert calls == {name: 1}
        np.testing.assert_allclose(y.float().numpy(), y_ref, atol=_ulp_tol(y_ref), rtol=0)


def test_k8_plain_matches_jax_grouped_kernel_at_g6(jax_env):
    """K8's plain version (through grouped_expert_linear) against
    qmatmul_grouped_experts in interpret mode on an [E]-stack at g = 6,
    within 2e-2 * max|y| + 1e-3 (tests/test_torch_moe.py)."""
    K, N, E, g = 768, 256, 4, 6
    rng = np.random.default_rng(6)
    parts = [j_quantize(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4, group_size=g)
             for _ in range(E)]
    raw = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *parts)
    jw = jstacked.prepare_stacked_tensor(raw, lane_quantum=128, planar=True, scale_store_dtype=jnp.bfloat16)
    tw = tstacked.prepare_stacked_tensor(params_from_numpy(jax.tree_util.tree_map(np.asarray, raw), device="cpu"),
                                         lane_quantum=128, scale_store_dtype=torch.bfloat16)
    assert jpq.grouped_experts_ok(jw) and qmm.grouped_experts_ok(tw)
    x = rng.normal(size=(5, K)).astype(np.float32)
    ids = np.array([2, 0, 3, 2, 1], np.int32)
    yj = np.asarray(jpq.qmatmul_grouped_experts(jnp.asarray(x), jw, jnp.asarray(ids)), np.float32)
    calls = _count_calls(jax_env, qmm, ("w4_grouped_gemv",))
    yt = tmoe.grouped_expert_linear(tw, torch.from_numpy(ids), torch.from_numpy(x).to(torch.bfloat16))
    assert calls == {"w4_grouped_gemv": 1}
    yt = yt.float().numpy()
    assert np.abs(yt - yj).max() < 2e-2 * np.abs(yj).max() + 1e-3


def test_k11_plain_matches_a8_kernel_at_g6(jax_env):
    """K11's plain version (qmatmul_stacked with w4a8=True) against the a8
    branch of the full-K kernel (QLLM_TPU_W4A8=1, interpret mode) on a g =
    6 stack with its RMSNorm, within two bf16 ulps plus 1e-3 * max|y|
    (tests/test_torch_w4a8.py)."""
    jax_env.setenv("QLLM_TPU_W4A8", "1")
    jax.clear_caches()
    K, g, M = 768, 6, 8
    js, ts = _stacks(K, g, "bf16", True, seed=K + g)
    assert qmm.a8_full_k_ok(K, g, ts.qweight.shape[-1])
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, size=(2, K)).astype(np.float32), jnp.bfloat16)
    y_ref = np.asarray(jpq.qmatmul_pallas_stacked(x, js, jnp.int32(1), norm_w=nw).astype(jnp.float32))
    calls = _count_calls(jax_env, qmm, ("w4a8_planar_gemv",))
    tnw = tensor_from_numpy(np.asarray(nw), "cpu")
    y = qmm.qmatmul_stacked(tensor_from_numpy(np.asarray(x), "cpu"), ts, 1, norm_w=tnw, w4a8=True)
    assert calls == {"w4a8_planar_gemv": 1}
    _close_a8(y.float().numpy(), y_ref)


class _Recorder:
    """Stands in for the kernel library: records each entry point it is
    asked for and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.mark.parametrize("g", [3, 6])
@pytest.mark.parametrize("sd", ["bf16", "f32"])
def test_routes_call_the_kernels_not_the_fallback(monkeypatch, sd, g):
    """On a stand-in card, qmatmul_stacked on a g % 4 != 0 planar stack
    calls the planar kernels' C entries (K1 / K2 on bf16 prefolded stacks,
    K11 under W4A8, K17 / K18 on f32 stacks) with the stack's g, and no
    other entry (the fallback would call K9 / K10 / K12)."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda t, name: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(qmm, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    K = 768
    _, ts = _stacks(K, g, sd, True, seed=K + g)
    want = {"bf16": ("qllm_w4_planar_gemv", "qllm_w4_planar_gemm", "qllm_w4a8_planar_gemv"),
            "f32": ("qllm_w4_planar_f32s_gemv", "qllm_w4_planar_f32s_gemm", "qllm_w4_planar_f32s_gemv")}[sd]
    for (M, w4a8), entry in zip(((8, False), (40, False), (8, True)), want):
        lib.calls.clear()
        x = torch.randn((M, K), dtype=torch.float32).to(torch.bfloat16)
        y = qmm.qmatmul_stacked(x, ts, 1, w4a8=w4a8)
        assert tuple(y.shape) == (M, ts.out_features)
        (name, args), = lib.calls
        assert name == entry and g in args, (M, w4a8, name)
