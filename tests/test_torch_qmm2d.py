"""Port parity for the per-layer quantized matmul: the plain versions of
K9 (gptq_gemv, M <= 32) and K10 (gptq_gemm, M > 32) against the JAX
package's qmatmul_pallas in interpret mode (its own mode on the CPU) on
the same packed words, scales and zeros. Both compute _qmm_2d's function,
so the tolerance is 1e-2 * max|y|: one bf16 ulp of the output plus f32
summation order (tests/test_pallas_qmm.py's 2e-2 holds the kernel to the
looser dequantize-first reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.ops.pallas_qmm import qmatmul_pallas
from qllm_tpu.ops.ref_matmul import qmatmul_ref as j_qmatmul_ref
from qllm_tpu.quant.qtensor import quantize_tensor
from qllm_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.ops import qmm2d
from qllm_tpu_torch.ops.ref_matmul import qmatmul_ref

TOL = 1e-2
K, N = 512, 384


def _pair(bits, g, seed, act_order=False):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05)
    perm = None
    if act_order:  # w given in the permuted row order, as quantize_tensor takes it
        perm = jnp.asarray(rng.permutation(K).astype(np.int32))
        w = w[perm]
    jqt = quantize_tensor(w, bits=bits, group_size=g, perm=perm)
    tqt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jqt), device="cpu")
    return jqt, tqt, rng


def _close(y, ref):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(y, ref, atol=TOL * scale, rtol=TOL)


CASES = [(bits, g) for bits in (2, 4, 8) for g in (32, 64, 128, -1)]


@pytest.mark.parametrize("bits,g", CASES)
def test_plain_versions_match_qmatmul_pallas(bits, g):
    """Each (bits, g) at one decode M (1 or 8: K9's branch) and one
    prefill M (33 or 64: K10's), so every M meets every bit width."""
    i = CASES.index((bits, g))
    jqt, tqt, rng = _pair(bits, g, seed=bits * 100 + (g if g > 0 else 7))
    for M in ((1, 8)[i % 2], (33, 64)[(i // 2) % 2]):
        x = rng.normal(size=(M, K)).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        y_ref = np.asarray(qmatmul_pallas(xb, jqt).astype(jnp.float32))
        plain = qmm2d.gptq_gemv_plain if M <= qmm2d.GEMV_MAX_M else qmm2d.gptq_gemm_plain
        xt = tensor_from_numpy(np.asarray(xb), "cpu")
        y = plain(xt, tqt.qweight, tqt.scales, tqt.zeros, bits, g)
        assert y.dtype == torch.bfloat16 and tuple(y.shape) == (M, N)
        _close(y.float().numpy(), y_ref)
        # and the CPU route of the entry point (the same plain version)
        _close(qmm2d.qmatmul_2d(xt, tqt).float().numpy(), y_ref)


def test_act_order_perm_through_qmatmul_2d():
    """The perm is applied to x before the plain version, as qmatmul does
    before qmatmul_pallas (ref_matmul.py:86)."""
    jqt, tqt, rng = _pair(4, 128, seed=5, act_order=True)
    assert tqt.perm is not None
    for M in (3, 40):
        x = jnp.asarray(rng.normal(size=(2, M, K)).astype(np.float32), jnp.bfloat16)
        y_ref = np.asarray(qmatmul_pallas(jnp.take(x, jqt.perm, axis=-1), jqt).astype(jnp.float32))
        y = qmm2d.qmatmul_2d(tensor_from_numpy(np.asarray(x), "cpu"), tqt)
        assert tuple(y.shape) == (2, M, N)
        _close(y.float().numpy(), y_ref)
        # qmatmul_ref (the CPU route of ops.qmatmul) agrees with JAX's too
        _close(
            qmatmul_ref(tensor_from_numpy(np.asarray(x), "cpu"), tqt).float().numpy(),
            np.asarray(j_qmatmul_ref(x, jqt).astype(jnp.float32)),
        )


def test_f32_activations_keep_their_branches():
    """x in f32: the decode branch sums the unrounded x, the prefill
    branch rounds x to bf16 for the product; the output comes back in f32."""
    jqt, tqt, rng = _pair(4, 64, seed=9)
    for M in (8, 48):
        x = rng.normal(size=(M, K)).astype(np.float32)
        y_ref = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt))
        y = qmm2d.qmatmul_2d(torch.from_numpy(x), tqt)
        assert y.dtype == torch.float32
        _close(y.numpy(), y_ref)


def test_odd_bits_raise():
    """As qmatmul_pallas (tests/test_pallas_qmm.py:50-53): 3-bit weights
    are not served by the per-layer kernels."""
    rng = np.random.default_rng(0)
    jqt = quantize_tensor(jnp.asarray(rng.normal(size=(128, 128)).astype(np.float32)), bits=3, group_size=64)
    with pytest.raises(NotImplementedError):
        qmatmul_pallas(jnp.ones((2, 128), jnp.float32), jqt)
    tqt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jqt), device="cpu")
    with pytest.raises(NotImplementedError):
        qmm2d.qmatmul_2d(torch.ones((2, 128)), tqt)
    with pytest.raises(NotImplementedError):
        qmm2d.gptq_gemv(torch.ones((2, 128)), tqt.qweight, tqt.scales, tqt.zeros, 3, 64)
