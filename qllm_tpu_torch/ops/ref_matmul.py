"""Plain quantized matmul: unpack -> dequantize -> dot (the counterpart
of ``qllm_tpu/ops/ref_matmul.py``), and the ``qmatmul`` dispatch.

``qmatmul`` routes a 3-D (L=1 stacked, ``models.stacked.prepare_lm_head``)
weight to ``ops.qmm.qmatmul_stacked`` and its CUDA kernels. A 2-D
per-layer weight takes ``qmatmul_ref`` on the CPU, as the JAX package's
``qmatmul`` does there, and ``ops.qmm2d.qmatmul_2d`` (CUDA kernels K9 /
K10, the counterpart of ``qmatmul_pallas``) on the card. With
``w4a8=True`` a 2-D weight takes ``qmatmul_2d`` on either device (K12
where ``_qmm_2d`` takes int8 activations; plain versions on the CPU), so
the choice of int8 activations is never dropped.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ..quant.qtensor import QuantizedTensor, unpack_rows

__all__ = ["qmatmul_ref", "qmatmul", "dequant_ref"]


def dequant_ref(qt: QuantizedTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Unpack + dequantize to dense [K, N] (permuted row order)."""
    q = unpack_rows(qt.qweight, qt.bits, qt.in_features)
    g = qt.effective_group_size
    K, N = qt.in_features, qt.out_features
    scales = qt.scales.to(torch.float32)
    zeros = qt.zeros.to(torch.float32)
    w = (q.reshape(K // g, g, N).to(torch.float32) - zeros[:, None, :]) * scales[:, None, :]
    return w.reshape(K, N).to(dtype)


def _apply_perm(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    if qt.perm is None:
        return x
    return torch.index_select(x, -1, qt.perm.to(torch.int64))


def qmatmul_ref(
    x: torch.Tensor, qt: QuantizedTensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """y = x @ dequant(qt) (+ bias): bf16 operands, f32 accumulation.
    x: [..., K] -> [..., N]."""
    w = dequant_ref(qt, dtype=torch.bfloat16)
    xp = _apply_perm(x, qt)
    y = (xp.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def qmatmul(
    x: torch.Tensor, qt: QuantizedTensor, bias: Optional[torch.Tensor] = None, w4a8: bool = False
) -> torch.Tensor:
    """Quantized matmul. A 3-D qweight is an L=1 serving stack and goes
    through the stacked kernels with layer 0. ``w4a8``: int8 activations
    where the JAX package's W4A8 takes them."""
    if qt.qweight.dim() == 3:
        from .qmm import qmatmul_stacked

        y = qmatmul_stacked(x, qt, 0, w4a8=w4a8)
    elif w4a8 or _build.use_kernel(x, "qmatmul"):
        from .qmm2d import qmatmul_2d

        return qmatmul_2d(x, qt, bias, w4a8=w4a8)
    else:
        return qmatmul_ref(x, qt, bias)
    if bias is not None:
        y = y + bias
    return y
