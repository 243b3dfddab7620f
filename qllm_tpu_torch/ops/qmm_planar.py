"""The planar 4-bit stacked matmul with f32 scales and the zero-point
term outside (the counterpart of ``_qmm_kernel_planar`` in
``qllm_tpu/ops/pallas_qmm.py:999``, driven by ``_qmm_2d_stacked``
:1357).

Both kernels compute ``out[m, n] = sum_g (x_g . q_g[:, n]) * s_g[n]`` in
f32 from bf16 x [M, K], one layer of planar words [L, K/8, Np] and f32
scales [L, G, Np], q the nibble value 0..15, and write f32 [M, Np]:

  * K17 ``w4_planar_f32s_gemv`` (csrc/planar_f32.cu), M <= 32: the
    tensor-core body of csrc/stacked_mma.cuh with K1's planar consumer,
    f32 scales, without the norm and the zs term, K split by
    ``qmm.planar_splits``;
  * K18 ``w4_planar_f32s_gemm`` (csrc/planar_f32.cu), M > 32: K2's
    128 x 128 tiling, one pass over K per half with the open group's
    partial closed in f32 at the group's end.

Each group's dot is exact products summed in f32 and is scaled in f32 at
the group's end; the weight is never rounded to bf16. The correction
``out - xsum @ zs``, the pre-normalize and the bf16 result are the
caller's (``ops.qmm._planar_unfused_matmul``), as in the JAX package.
Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build
from .qmm import GEMV_MAX_M, _aligned, _kernel_geometry_ok, _planar_values, planar_splits

__all__ = [
    "w4_planar_f32s_gemv",
    "w4_planar_f32s_gemv_plain",
    "w4_planar_f32s_gemm",
    "w4_planar_f32s_gemm_plain",
]


def w4_planar_f32s_gemv_plain(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, layer: int) -> torch.Tensor:
    """The plain version of K17 and K18: out[m, n] = sum_g (x_g . q_g[:, n])
    * s_g[n], f32 group dots scaled in f32 -> f32 [M, Np]. x [M, K] bf16,
    qweight [L, K/8, Np], scales [L, G, Np]."""
    M, K = x.shape
    G = scales.shape[1]
    g = K // G
    v = _planar_values(qweight[layer], K).reshape(G, g, -1)
    d = torch.einsum("mgk,gkn->mgn", x.to(torch.float32).reshape(M, G, g), v)
    return (d * scales[layer].to(torch.float32)[None]).sum(dim=1)


# K18 computes K17's function at any M
w4_planar_f32s_gemm_plain = w4_planar_f32s_gemv_plain


def _check(name, x, qweight, scales, layer, max_m=2**31 - 1):
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not 1 <= x.shape[0] <= max_m:
        raise ValueError(f"{name}: x must be bf16 [1 <= M <= {max_m}, K]")
    K = x.shape[1]
    if qweight.dtype != torch.int32 or qweight.dim() != 3 or qweight.shape[1] != K // 8:
        raise ValueError(f"{name}: qweight must be int32 [L, K/8, Np], got {tuple(qweight.shape)}")
    L, _, Np = qweight.shape
    if scales.dtype != torch.float32 or scales.dim() != 3 or scales.shape[0] != L or scales.shape[2] != Np:
        raise ValueError(f"{name}: scales must be f32 [L, G, Np]")
    G = scales.shape[1]
    if K % G or not _kernel_geometry_ok(K, K // G):
        raise ValueError(f"{name}: geometry K={K}, G={G} is not taken")
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} out of range [0, {L})")
    for t in (qweight, scales):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned on {x.device}")
    return K, Np, G


def w4_planar_f32s_gemv(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, layer: int) -> torch.Tensor:
    """K17: x [M <= 32, K] bf16 -> out [M, Np] f32 (see the plain
    version). Replaces _qmm_kernel_planar (pallas_qmm.py:999) at decode.
    Bound: bytes (words + scales + x + out) over 3.35 TB/s."""
    if not _build.use_kernel(x, "w4_planar_f32s_gemv"):
        return w4_planar_f32s_gemv_plain(x, qweight, scales, layer)
    K, Np, G = _check("w4_planar_f32s_gemv", x, qweight, scales, layer, GEMV_MAX_M)
    if Np % 32:
        raise ValueError("w4_planar_f32s_gemv: the padded width must be a multiple of 32")
    M = x.shape[0]
    x = _aligned(x.contiguous())  # 8-byte x copies
    # the split of K from (K, Np) alone: a row's bits never depend on M
    splits, per = planar_splits(K, Np)
    part = torch.empty((splits, M, Np), dtype=torch.float32, device=x.device) if splits > 1 else None
    out = torch.empty((M, Np), dtype=torch.float32, device=x.device)
    code = _build.load_library().qllm_w4_planar_f32s_gemv(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), _build.ptr(part), out.data_ptr(), layer, M, K, Np, K // G,
        splits, per, _build.stream(x),
    )
    _build.check("w4_planar_f32s_gemv", code)
    w4_planar_f32s_gemv.launches += 1
    return out


w4_planar_f32s_gemv.launches = 0


def w4_planar_f32s_gemm(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, layer: int) -> torch.Tensor:
    """K18: x [M, K] bf16 -> out [M, Np] f32 (see the plain version).
    Replaces _qmm_kernel_planar (pallas_qmm.py:999) at prefill, any
    k-block of the TPU's grid (bk = 2048, or the relaxed 256 of down_proj).
    Bound: 2 M K Np flops over 989 TFLOP/s bf16 at prefill sizes."""
    if not _build.use_kernel(x, "w4_planar_f32s_gemm"):
        return w4_planar_f32s_gemm_plain(x, qweight, scales, layer)
    K, Np, G = _check("w4_planar_f32s_gemm", x, qweight, scales, layer)
    if Np % 128:
        raise ValueError("w4_planar_f32s_gemm: the padded width must be a multiple of 128")
    M = x.shape[0]
    x = _aligned(x.contiguous())  # 16-byte x copies
    out = torch.empty((M, Np), dtype=torch.float32, device=x.device)
    code = _build.load_library().qllm_w4_planar_f32s_gemm(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), out.data_ptr(), layer, M, K, Np, K // G,
        _build.stream(x),
    )
    _build.check("w4_planar_f32s_gemm", code)
    w4_planar_f32s_gemm.launches += 1
    return out


w4_planar_f32s_gemm.launches = 0
