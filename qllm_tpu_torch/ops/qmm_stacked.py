"""Decode matmuls on [L]-stacked GPTQ-order and bit-plane serving weights
(the counterpart of the packed and odd-width branches of
``_qmm_2d_stacked`` in ``qllm_tpu/ops/pallas_qmm.py``).

Three hand-written CUDA kernels, each reading its layer straight out of
the stack (the layer index moves the pointers; nothing is copied), for
M <= 32 rows of x:

  * K14 ``gptq_stacked_gemv`` (csrc/gptq_stacked.cu): 2- and 4-bit
    GPTQ-order words [L, K/pf, Np]. Unfused (``_qmm_kernel_v3_stacked``,
    :476): ``sum_g s_g (x_g . q_g)`` in f32, the zero-point term taken off
    by the caller; fused (``_qmm_kernel_v4_stacked``, :514): ``sum_g
    (s_g (x_g . q_g) - sum(x_g) zs_g)``, rounded to bf16;
  * K15 ``gptq_stacked_w4a8_gemv`` (csrc/gptq_stacked.cu): int8
    activations against 2- and 4-bit words, exact s8 x s8 -> s32 group
    dots on the int8 tensor cores, ``sum_g s_g d_g`` in f32
    (``_qmm_kernel_w4a8_v3_stacked``, :584);
  * K16 ``bitplane_stacked_gemv`` (csrc/bitplane.cu): 3/5/6/7-bit
    plane-major bit-plane words [L, bits * K/32, Np], unfused and fused as
    K14 (``_qmm_kernel_odd_stacked``, :676).

Scales and ``zs = zeros * scales`` [L, G, Np] are read in the dtype they
are stored in. Each wrapper launches its kernel on a CUDA tensor (or
raises) and runs its plain PyTorch version on a CPU tensor; the plain
versions compute the TPU kernels' function in the JAX package's order of
rounding (f32 group dots, the scale after each group). The routing and
the work outside the kernels are ``ops.qmm.qmatmul_stacked``'s.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ..quant.qtensor import unpack_rows
from .tc_plan import PARAM_TYPES, TC_TARGET_BLOCKS, tc_splits

__all__ = [
    "gptq_stacked_gemv",
    "gptq_stacked_gemv_plain",
    "gptq_stacked_w4a8_gemv",
    "gptq_stacked_w4a8_gemv_plain",
    "bitplane_stacked_gemv",
    "bitplane_stacked_gemv_plain",
    "STACKED_MAX_M",
]

STACKED_MAX_M = 32


def _group(K: int, group_size: int) -> int:
    return K if group_size == -1 else group_size


def _layer_values(qweight: torch.Tensor, layer: int, bits: int, K: int, g: int) -> torch.Tensor:
    """Layer ``layer``'s fields as f32 [G, g, Np] (GPTQ-order or bit-plane
    words alike: ``unpack_rows`` reads both)."""
    return unpack_rows(qweight[layer], bits, K).to(torch.float32).reshape(K // g, g, -1)


def _stacked_dot_plain(x, qweight, scales, zs, layer, bits, group_size, fused):
    M, K = x.shape
    g = _group(K, group_size)
    xg = x.to(torch.float32).reshape(M, K // g, g)
    d = torch.einsum("mgk,gkn->mgn", xg, _layer_values(qweight, layer, bits, K, g))
    s = scales[layer].to(torch.float32)[None]
    if fused:
        y = (d * s - xg.sum(dim=2)[:, :, None] * zs[layer].to(torch.float32)[None]).sum(dim=1)
        return y.to(torch.bfloat16)
    return (d * s).sum(dim=1)


def gptq_stacked_gemv_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: Optional[torch.Tensor],
    layer: int,
    bits: int,
    group_size: int,
    fused: bool,
) -> torch.Tensor:
    """The plain version of K14: x [M, K] (bf16 or f32, taken as f32),
    layer ``layer`` of qweight [L, K/pf, Np] and scales / zs [L, G, Np].
    Unfused: f32 [M, Np] = sum_g s_g (x_g . q_g); fused: bf16 [M, Np] =
    sum_g (s_g (x_g . q_g) - sum(x_g) zs_g)."""
    return _stacked_dot_plain(x, qweight, scales, zs, layer, bits, group_size, fused)


def bitplane_stacked_gemv_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: Optional[torch.Tensor],
    layer: int,
    bits: int,
    group_size: int,
    fused: bool,
) -> torch.Tensor:
    """The plain version of K16: K14's function on plane-major bit-plane
    words [L, bits * K/32, Np]."""
    return _stacked_dot_plain(x, qweight, scales, zs, layer, bits, group_size, fused)


def gptq_stacked_w4a8_gemv_plain(
    x8: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, layer: int, bits: int, group_size: int
) -> torch.Tensor:
    """The plain version of K15: x8 [M, K] int8 -> f32 [M, Np] = sum_g s_g
    d_g, d_g = x8_g . q_g exact (integer dots below 2^24 are exact in
    f32)."""
    M, K = x8.shape
    g = _group(K, group_size)
    d = torch.einsum("mgk,gkn->mgn", x8.to(torch.float32).reshape(M, K // g, g), _layer_values(qweight, layer, bits, K, g))
    return (d * scales[layer].to(torch.float32)[None]).sum(dim=1)


def _check(name, x, qweight, scales, zs, layer, rows_per_layer, K, g, x_types):
    if x.dim() != 2 or x.dtype not in x_types or not 1 <= x.shape[0] <= STACKED_MAX_M:
        raise ValueError(f"{name}: x must be {x_types} [M <= {STACKED_MAX_M}, K]")
    if qweight.dtype != torch.int32 or qweight.dim() != 3 or qweight.shape[1] != rows_per_layer:
        raise ValueError(f"{name}: qweight must be int32 [L, {rows_per_layer}, Np], got {tuple(qweight.shape)}")
    L, _, Np = qweight.shape
    if K % g:
        raise ValueError(f"{name}: group size {g} does not divide K={K}")
    if scales.dtype not in PARAM_TYPES or tuple(scales.shape) != (L, K // g, Np):
        raise ValueError(f"{name}: scales must be f32/fp16/bf16 [{L}, {K // g}, {Np}]")
    ops = [qweight, scales]
    if zs is not None:
        if zs.dtype != scales.dtype or zs.shape != scales.shape:
            raise ValueError(f"{name}: zs must match the scales' dtype and shape")
        ops.append(zs)
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} out of range [0, {L})")
    for t in ops:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on {x.device}")
    return Np, PARAM_TYPES[scales.dtype]


def _launch_dot(name, fn, x, qweight, scales, zs, layer, bits, group_size, fused, words, splits_rows):
    """K14 / K16's common launch: ``words`` word rows of a layer,
    ``splits_rows`` the K-split unit count."""
    M, K = x.shape
    g = _group(K, group_size)
    Np, s_type = _check(name, x, qweight, scales, zs if fused else None, layer, words, K, g,
                        (torch.bfloat16, torch.float32))
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels stage x by 16-byte copies
        x = x.clone()
    body = "bitplane" if name == "bitplane_stacked_gemv" else "gptq"
    splits, per = tc_splits(splits_rows, Np, TC_TARGET_BLOCKS[body])
    part = torch.empty((splits, M, Np), dtype=torch.float32, device=x.device) if splits > 1 else None
    out = torch.empty((M, Np), dtype=torch.bfloat16 if fused else torch.float32, device=x.device)
    code = fn(
        x.data_ptr(), int(x.dtype == torch.float32), qweight.data_ptr(), scales.data_ptr(),
        zs.data_ptr() if fused else None, s_type, _build.ptr(part), out.data_ptr(), layer, bits, int(fused), M, K,
        Np, g, splits, per, _build.stream(x),
    )
    _build.check(name, code)
    return out


def gptq_stacked_gemv(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: Optional[torch.Tensor],
    layer: int,
    bits: int,
    group_size: int,
    fused: bool,
) -> torch.Tensor:
    """K14: x [M <= 32, K] bf16 or f32 -> f32 (unfused) or bf16 (fused)
    [M, Np] (see the plain version). Replaces _qmm_kernel_v3_stacked and
    _qmm_kernel_v4_stacked (pallas_qmm.py:476, :514). Bound: bytes (the
    layer's words, scales and, fused, zs; x and y) over 3.35 TB/s."""
    if bits not in (2, 4):
        raise NotImplementedError(f"gptq_stacked_gemv serves 2/4 bits, got {bits}")
    if not _build.use_kernel(x, "gptq_stacked_gemv"):
        return gptq_stacked_gemv_plain(x, qweight, scales, zs, layer, bits, group_size, fused)
    K = x.shape[-1]
    rows = K * bits // 32
    out = _launch_dot("gptq_stacked_gemv", _build.load_library().qllm_gptq_stacked_gemv, x, qweight, scales, zs,
                      layer, bits, group_size, fused, rows, rows)
    gptq_stacked_gemv.launches += 1
    return out


gptq_stacked_gemv.launches = 0


def bitplane_stacked_gemv(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: Optional[torch.Tensor],
    layer: int,
    bits: int,
    group_size: int,
    fused: bool,
) -> torch.Tensor:
    """K16: x [M <= 32, K] bf16 or f32 against 3/5/6/7-bit bit-plane words
    -> f32 (unfused) or bf16 (fused) [M, Np] (see the plain version).
    Replaces _qmm_kernel_odd_stacked (pallas_qmm.py:676). Takes K % 32 ==
    0 and groups of a multiple of 8 rows. Bound: bytes over 3.35 TB/s."""
    if bits not in (3, 5, 6, 7):
        raise NotImplementedError(f"bitplane_stacked_gemv serves 3/5/6/7 bits, got {bits}")
    if not _build.use_kernel(x, "bitplane_stacked_gemv"):
        return bitplane_stacked_gemv_plain(x, qweight, scales, zs, layer, bits, group_size, fused)
    K = x.shape[-1]
    if K % 32 or _group(K, group_size) % 8:
        raise ValueError(f"bitplane_stacked_gemv: K={K} must be a multiple of 32 and the group of 8")
    out = _launch_dot("bitplane_stacked_gemv", _build.load_library().qllm_bitplane_stacked_gemv, x, qweight,
                      scales, zs, layer, bits, group_size, fused, bits * K // 32, K // 32)
    bitplane_stacked_gemv.launches += 1
    return out


bitplane_stacked_gemv.launches = 0


def gptq_stacked_w4a8_gemv(
    x8: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, layer: int, bits: int, group_size: int
) -> torch.Tensor:
    """K15: x8 [M <= 32, K] int8 (``ops.qmm.quantize_rows_int8``) -> f32
    [M, Np] (see the plain version). Replaces _qmm_kernel_w4a8_v3_stacked
    (pallas_qmm.py:584). Bound: bytes (the layer's words and scales, x8
    and y) over 3.35 TB/s. K splits by ``tc_splits`` of the word rows and
    Np (never M)."""
    if bits not in (2, 4):
        raise NotImplementedError(f"gptq_stacked_w4a8_gemv serves 2/4 bits, got {bits}")
    if not _build.use_kernel(x8, "gptq_stacked_w4a8_gemv"):
        return gptq_stacked_w4a8_gemv_plain(x8, qweight, scales, layer, bits, group_size)
    M, K = x8.shape
    g = _group(K, group_size)
    rows = K * bits // 32
    Np, s_type = _check("gptq_stacked_w4a8_gemv", x8, qweight, scales, None, layer, rows, K, g, (torch.int8,))
    x8 = x8.contiguous()
    if x8.data_ptr() % 16:  # the kernel stages x8 by 8- and 16-byte loads
        x8 = x8.clone()
    splits, per = tc_splits(rows, Np, TC_TARGET_BLOCKS["gptq"])
    part = torch.empty((splits, M, Np), dtype=torch.float32, device=x8.device) if splits > 1 else None
    out = torch.empty((M, Np), dtype=torch.float32, device=x8.device)
    code = _build.load_library().qllm_gptq_stacked_w4a8_gemv(
        x8.data_ptr(), qweight.data_ptr(), scales.data_ptr(), s_type, _build.ptr(part), out.data_ptr(), layer, bits,
        M, K, Np, g, splits, per, _build.stream(x8),
    )
    _build.check("gptq_stacked_w4a8_gemv", code)
    gptq_stacked_w4a8_gemv.launches += 1
    return out


gptq_stacked_w4a8_gemv.launches = 0
