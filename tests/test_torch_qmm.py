"""Port parity: the plain versions of kernels K1 (w4_planar_gemv) and K2
(w4_planar_gemm) against qmatmul_pallas_stacked in interpret mode, on
bf16-scale zs-prefolded planar stacks (L=2, layer 1). Tolerance as in
tests/test_pallas_qmm.py: atol 2e-2 * max|y|, rtol 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models.stacked import stack_layer_params
from qllm_tpu.ops.pallas_qmm import planar_bk, planar_full_ok, qmatmul_pallas_stacked
from qllm_tpu.quant.qtensor import quantize_tensor
from qllm_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.ops import qmm as tqmm


def _stacked_pair(K, N, seed, L=2, g=128):
    rng = np.random.default_rng(seed)
    qts = [
        quantize_tensor(
            jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4, group_size=g
        )
        for _ in range(L)
    ]
    params = {
        "embed_tokens": jnp.zeros((8, 8)),
        "norm": jnp.ones((8,)),
        "layers": [{"q_proj": qt} for qt in qts],
    }
    js = stack_layer_params(params, scale_store_dtype=jnp.bfloat16)["layers"]["q_proj"]
    ts = params_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    return js, ts, rng


@pytest.mark.parametrize(
    "M,K,norm,branch",
    [
        (8, 512, False, "full-K per-group (#1)"),
        (3, 512, False, "full-K per-group (#1), ragged M"),
        (8, 768, True, "full-K per-group with fused RMSNorm (#1)"),
        (40, 2048, False, "blocked big-dot (#2)"),
        (40, 768, False, "full-K big-dot (#1)"),
    ],
)
def test_planar_matmul_plain_matches_pallas(monkeypatch, M, K, norm, branch):
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    N, layer = 256, 1
    if M > 32 and K == 768:
        assert planar_bk(K, 128) is None and planar_full_ok(K, 128)
    if M > 32 and K == 2048:
        assert planar_bk(K, 128) == 2048
    js, ts, rng = _stacked_pair(K, N, seed=M * 1000 + K)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    nw = None
    if norm:
        nw = jnp.asarray(rng.uniform(0.5, 1.5, size=(2, K)).astype(np.float32), jnp.bfloat16)
    y_ref = np.asarray(
        qmatmul_pallas_stacked(x, js, jnp.int32(layer), norm_w=nw, norm_eps=1e-5).astype(jnp.float32)
    )
    tx = tensor_from_numpy(np.asarray(x), "cpu")
    tnw = None if nw is None else tensor_from_numpy(np.asarray(nw), "cpu")
    if M <= tqmm.GEMV_MAX_M:
        y_plain = tqmm.w4_planar_gemv_plain(tx, ts.qweight, ts.scales, ts.zeros, layer, tnw, 1e-5)
    else:
        assert not norm
        y_plain = tqmm.w4_planar_gemm_plain(tx, ts.qweight, ts.scales, ts.zeros, layer)
    y_plain = y_plain[:, :N].float().numpy()
    y_port = tqmm.qmatmul_stacked(tx, ts, layer, norm_w=tnw, norm_eps=1e-5).float().numpy()
    scale = np.abs(y_ref).max()
    for y in (y_plain, y_port):
        assert y.shape == y_ref.shape
        np.testing.assert_allclose(y, y_ref, atol=2e-2 * scale, rtol=2e-2, err_msg=branch)


def test_qmatmul_stacked_refuses_f32_scale_stacks():
    rng = np.random.default_rng(0)
    qts = [
        quantize_tensor(jnp.asarray(rng.normal(size=(256, 128)).astype(np.float32)), bits=4, group_size=128)
        for _ in range(2)
    ]
    js = stack_layer_params({"layers": [{"q_proj": q} for q in qts]})["layers"]["q_proj"]
    ts = params_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tqmm.qmatmul_stacked(torch.zeros((2, 256), dtype=torch.bfloat16), ts, 0)
