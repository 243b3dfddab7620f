"""Port parity for planar 4-bit stacks whose groups close inside a 16-k
tile (g = 8, 24, 40: any g % 4 == 0 that JAX's planar gates admit).

  * Routing: ``stacked_route`` against the branch JAX's gate takes on its
    chip (traced with ``default_backend`` reporting "tpu", as
    tests/test_torch_planar_f32.py does), bf16 prefolded and f32 stacks,
    M in (1, 8, 64), with and without W4A8: every such stack takes a
    kernel route, as in JAX, and the wrapper each route calls.
  * The plain versions of K1, K2 (bf16 prefolded stacks, against
    ``qmatmul_pallas_stacked`` with the stacked kernels forced: #1 / #2 in
    interpret mode, within 2e-2 * max|y|, tests/test_torch_qmm.py's limit)
    and of K17, K18 (f32 stacks plus the port's correction, against
    ``_qmm_kernel_planar`` called directly, within one bf16 ulp of the
    output's magnitude) at g = 8 and 24.
  * K8's plain version against JAX's interpreted grouped kernel and K11's
    against the a8 branch of the full-K kernel (QLLM_TPU_W4A8=1), where
    JAX's gates take g = 8, with their tests' limits
    (tests/test_torch_moe.py, tests/test_torch_w4a8.py).

The JAX package reads its switches when it traces: the fixtures clear its
caches on the way in and out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models import stacked as jstacked
from qllm_tpu.ops import pallas_qmm as jpq
from qllm_tpu.quant.qtensor import quantize_tensor as j_quantize
from qllm_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.models import moe as tmoe
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.ops import qmm, qmm_planar
from test_torch_planar_f32 import (  # noqa: F401 (jax_env is a fixture)
    _count_calls,
    _jax_chip_branches,
    _jax_unfused,
    _port_branch,
    _stacks,
    _ulp_tol,
    jax_env,
)
from test_torch_w4a8 import _close_a8

# (K, g): the smallest K at which JAX's blocked planar kernel has a k-block
# (planar_bk: lcm(256, 16g)) and the full-K geometry holds
GEOMS = [(512, 8), (768, 24), (1280, 40)]
ROUTE_TAG = {"planar": "fused", "planar_f32": "unfused", "fallback": "fallback"}


@pytest.mark.parametrize("K,g", GEOMS)
@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_route_matches_jax_chip_gate(jax_env, K, g, sd):
    """stacked_route names the kernel JAX's chip gate traces, never the
    fallback, at M in (1, 8, 64) with and without W4A8; at M = 1 and 64 the
    port calls that route's wrapper."""
    js, ts = _stacks(K, g, sd, True, seed=K + g)
    assert qmm._kernel_geometry_ok(K, g)
    Ms = (1, 8, 64)
    for w4a8 in (False, True):
        # one trace per M: JAX pads M = 1 to 8 rows, and a cached trace
        # would not run the counters
        want = [_jax_chip_branches(jax_env, js, (M,), w4a8)[0] for M in Ms]
        for M, expected in zip(Ms, want):
            route = qmm.stacked_route(ts, M, w4a8=w4a8)
            port = ROUTE_TAG[route]
            if port == "fused" and w4a8 and M <= 32 and qmm.a8_full_k_ok(K, g, ts.qweight.shape[-1]):
                port = "a8"
            assert port == expected != "fallback", (M, w4a8, route)
            if M in (1, 64):
                assert _port_branch(jax_env, ts, M, w4a8) == expected, (M, w4a8)


@pytest.mark.parametrize("K,g", GEOMS[:2])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K17", "K18"])
def test_plain_versions_match_interpreted_kernels(jax_env, kernel, K, g):
    """K1 (M = 8) and K2 (M = 40) through qmatmul_stacked on a bf16
    prefolded stack against qmatmul_pallas_stacked; K17 (M = 8) and K18 (M =
    40) plus the correction on an f32 stack against _qmm_kernel_planar."""
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


@pytest.mark.parametrize("shared", [True, False])
def test_k8_plain_matches_jax_grouped_kernel_at_g8(jax_env, shared):
    """K8's plain version (through grouped_expert_linear) against
    qmatmul_grouped_experts in interpret mode on an [E]-stack at g = 8,
    within 2e-2 * max|y| + 1e-3 (tests/test_torch_moe.py)."""
    K, N, E, g = 512, 256, 4, 8
    rng = np.random.default_rng(8 + shared)
    parts = [j_quantize(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4, group_size=g)
             for _ in range(E)]
    raw = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *parts)
    jw = jstacked.prepare_stacked_tensor(raw, lane_quantum=128, planar=True, scale_store_dtype=jnp.bfloat16)
    tw = tstacked.prepare_stacked_tensor(params_from_numpy(jax.tree_util.tree_map(np.asarray, raw), device="cpu"),
                                         lane_quantum=128, scale_store_dtype=torch.bfloat16)
    assert jpq.grouped_experts_ok(jw) and qmm.grouped_experts_ok(tw)
    x = rng.normal(size=(5, K)).astype(np.float32)
    ids = np.array([2, 0, 3, 2, 1], np.int32)
    yj = np.asarray(jpq.qmatmul_grouped_experts(jnp.asarray(x), jw, jnp.asarray(ids), x_shared=shared), np.float32)
    calls = _count_calls(jax_env, qmm, ("w4_grouped_gemv",))
    yt = tmoe.grouped_expert_linear(tw, torch.from_numpy(ids), torch.from_numpy(x).to(torch.bfloat16), x_shared=shared)
    assert calls == {"w4_grouped_gemv": 1}
    yt = yt.float().numpy()
    assert np.abs(yt - yj).max() < 2e-2 * np.abs(yj).max() + 1e-3


@pytest.mark.parametrize("norm", [False, True])
def test_k11_plain_matches_a8_kernel_at_g8(jax_env, norm):
    """K11's plain version (qmatmul_stacked with w4a8=True) against the a8
    branch of the full-K kernel (QLLM_TPU_W4A8=1, interpret mode) on a g =
    8 stack, within two bf16 ulps plus 1e-3 * max|y|
    (tests/test_torch_w4a8.py)."""
    jax_env.setenv("QLLM_TPU_W4A8", "1")
    jax.clear_caches()
    K, g, M = 512, 8, 8
    js, ts = _stacks(K, g, "bf16", True, seed=K + g)
    assert qmm.a8_full_k_ok(K, g, ts.qweight.shape[-1])
    rng = np.random.default_rng(11 + norm)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    nw = jnp.asarray(rng.uniform(0.5, 1.5, size=(2, K)).astype(np.float32), jnp.bfloat16) if norm else None
    y_ref = np.asarray(jpq.qmatmul_pallas_stacked(x, js, jnp.int32(1), norm_w=nw).astype(jnp.float32))
    calls = _count_calls(jax_env, qmm, ("w4a8_planar_gemv",))
    tnw = None if nw is None else tensor_from_numpy(np.asarray(nw), "cpu")
    y = qmm.qmatmul_stacked(tensor_from_numpy(np.asarray(x), "cpu"), ts, 1, norm_w=tnw, w4a8=True)
    assert calls == {"w4a8_planar_gemv": 1}
    _close_a8(y.float().numpy(), y_ref)
