"""Quantized matmul on [L]-stacked serving weights (the counterpart of
``qmatmul_pallas_stacked`` in ``qllm_tpu/ops/pallas_qmm.py``).

``qmatmul_stacked(x, qt, layer)`` computes ``y = x @ dequant(qt[layer])``
for the stacks ``models.stacked`` prepares, and takes the branch the JAX
package's gate takes on its chip (``stacked_route``, pallas_qmm.py:
1576-1664 and ``_qmm_2d_stacked`` :1115-1168):

  * 4-bit planar stacks ``[L, K/8, Np]`` with bf16 scales and prefolded
    ``zs = zeros * scales`` ``[L, G, Np]`` (the fused correction): K1
    ``w4_planar_gemv`` (M <= 32, decode: per-group dots over the integer
    nibbles on the tensor cores, the zero-point correction and the
    pre-matmul RMSNorm in-kernel), K2
    ``w4_planar_gemm`` (M > 32, prefill: dequantize to bf16 in registers,
    bf16 tensor-core product; the RMSNorm runs before it), K11
    ``w4a8_planar_gemv`` (M <= 32 with ``w4a8=True`` where the JAX package
    takes its full-K kernel: per-token int8 activations,
    ``quantize_rows_int8``, bit for bit the JAX package's, in s8 x s8 ->
    s32 tensor-core products on the body's int8 planar consumer, the
    RMSNorm in K11's quantizer prologue);
  * every other 4-bit planar stack (f32 scales, the JAX package's default,
    or zeros not prefolded): K17 ``w4_planar_f32s_gemv`` (M <= 32) and
    K18 ``w4_planar_f32s_gemm`` (M > 32) (``ops.qmm_planar``), with the
    pre-normalize and the f32 correction ``out - xsum @ zs[layer]`` done
    here in torch, as the JAX package does outside ``_qmm_kernel_planar``;
  * GPTQ-order 2/4-bit and bit-plane 3/5/6/7-bit stacks at M <= 32: K14,
    K15 and K16 (``ops.qmm_stacked``), with what JAX computes outside its
    kernels done here in torch: the pre-normalize, the f32 zero-point
    correction of the unfused kernels and the int8 token scale;
  * everything else (8 bits, act-order, M > 32 off the planar path, a
    planar geometry with no k-block at decode, e.g. the 7B down_proj
    K = 11008 with f32 scales): the layer sliced out, un-prefolded,
    unplanarized and unpadded, through ``ops.ref_matmul.qmatmul`` (K9 /
    K10 / K12 on the card).

``qmatmul_grouped_experts(x_rows, stack, ids)`` computes
``y[i] = x_rows[i] @ dequant(stack[ids[i]])`` for every MoE (token,
expert) selection in one launch of K8 ``w4_grouped_gemv``
(csrc/grouped_mma.cu: the tensor-core body of csrc/stacked_mma.cuh on
planar words), with the expert ids read on the device: a block whose
selection starts a run of equal ids takes up to 8 of them as its rows, so
an expert several sorted selections chose streams once a run of 8
(``grouped_run_rows`` is the plan, in plain PyTorch).

Two products with a serial dependency run as one cooperative launch
each (``csrc/fused_mlp.cu``): ``qmatmul_grouped_experts_fused`` (K19
``w4_grouped_fused_mlp``, JAX's ``_qmm_kernel_grouped_fused``) computes
a selection's whole expert MLP, gate|up, the activation and down, and
``qmatmul_pnp_stacked`` (K20 ``w4_pnp_gemv``, JAX's ``_qmm_kernel_pnp``)
o_proj, the residual, RMSNorm and gate|up; both run each product on the
tensor-core body's planar consumer.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs
its plain PyTorch version on a CPU tensor. The TPU autotuner does not
carry over: launch shapes are picked here in code.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from . import _build
from ..quant.qtensor import QuantizedTensor
from .tc_plan import TC_TARGET_BLOCKS, tc_splits

__all__ = [
    "qmatmul_stacked",
    "stacked_route",
    "odd_stacked_kernel_ok",
    "quantize_rows_int8",
    "quantize_rows_int8_plain",
    "w4a8_planar_gemv",
    "w4a8_planar_gemv_plain",
    "a8_full_k_ok",
    "qmatmul_grouped_experts",
    "grouped_experts_ok",
    "w4_grouped_gemv",
    "w4_grouped_gemv_plain",
    "grouped_run_rows",
    "grouped_plan_heads",
    "grouped_splits",
    "qmatmul_grouped_experts_fused",
    "grouped_fused_ok",
    "w4_grouped_fused_mlp",
    "w4_grouped_fused_mlp_plain",
    "qmatmul_pnp_stacked",
    "pnp_stacked_ok",
    "w4_pnp_gemv",
    "w4_pnp_gemv_plain",
    "w4_planar_gemv",
    "w4_planar_gemv_plain",
    "w4_planar_gemm",
    "w4_planar_gemm_plain",
    "planar_full_ok",
    "planar_splits",
    "a8_splits",
    "planar_bk",
    "planar_bk_relaxed",
]

GEMV_MAX_M = 32
# the JAX package's VMEM cap on a full-K planar block, (K/8) * bn words
# (QLLM_TPU_QMM_FULLK_MAX's default, pallas_qmm.py:1181, :1648): the
# planar gate and the a8 kernel admit only what JAX's full-K kernel would
_FULLK_MAX_BYTES = 4 << 20


def _mean_sq(xf: torch.Tensor) -> torch.Tensor:
    """mean(x^2) over the last axis, keepdim, summed in an order that does
    not depend on the number of rows: PyTorch's CUDA reduction picks its
    thread layout from the row count, so one long reduction would give a
    row other bits at batch 8 than alone. In 128-wide pieces, then over
    the pieces, every row is summed the same way at any batch."""
    D = xf.shape[-1]
    sq = xf * xf
    if D % 128 == 0 and D > 128:
        sq = sq.reshape(*sq.shape[:-1], D // 128, 128).sum(dim=-1)
    return sq.sum(dim=-1, keepdim=True) / D


def _rms_norm_rows(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis with the weight product in f32 (the
    pre-normalize the JAX package runs outside its blocked kernel and
    before its a8 kernel); a row's bits do not depend on the row count."""
    xf = x.to(torch.float32)
    return (xf * torch.rsqrt(_mean_sq(xf) + eps) * w.to(torch.float32)).to(x.dtype)


def planar_full_ok(K: int, g: int) -> bool:
    """The full-K planar geometry: K % 256 == 0 and a group split at K/2."""
    return g > 0 and K % 256 == 0 and (K // 2) % g == 0


def planar_bk(K: int, g: int, target: int = 2048):
    """k-block of the JAX package's blocked planar kernel, or None (kept
    because models.stacked decides planarization with it)."""
    if g <= 0 or K % (2 * g):
        return None
    quantum = math.lcm(256, 16 * g)
    best = None
    for bk in range(quantum, K + 1, quantum):
        if K % bk == 0 and bk <= target:
            best = bk
    return best


def planar_bk_relaxed(K: int, g: int, target: int = 2048):
    """k-block of the JAX package's blocked planar kernel at prefill where
    ``planar_bk`` finds none (pallas_qmm.py:974-996): bk | K, bk % 256 ==
    0, bk % 2g == 0 (whole groups per half-block), or None. The 7B
    down_proj K = 11008 = 2^8 * 43 takes bk = 256."""
    if g <= 0 or K % (2 * g):
        return None
    quantum = math.lcm(256, 2 * g)
    best = None
    for bk in range(quantum, min(K, target) + 1, quantum):
        if K % bk == 0:
            best = bk
    return best


def _pick_block(dim: int, quantum: int, target: int) -> int:
    """The largest multiple of ``quantum`` that divides ``dim`` and is <=
    ``target``, else ``dim`` (pallas_qmm.py:55)."""
    best = None
    for b in range(quantum, min(dim, target) + 1, quantum):
        if dim % b == 0:
            best = b
    return best if best is not None else dim


def a8_full_k_ok(K: int, g: int, Np: int) -> bool:
    """Where ``_qmm_2d_stacked`` takes its full-K kernel at M <= 32, and so
    its a8 branch under W4A8 (pallas_qmm.py:1164-1180): the full-K
    geometry and a (K/8) x bn word block within the VMEM cap, bn =
    _pick_block(Np, 128, 512) (no tuned table carries over)."""
    return planar_full_ok(K, g) and (K // 8) * _pick_block(Np, 128, 512) * 4 <= _FULLK_MAX_BYTES


def _kernel_geometry_ok(K: int, g: int) -> bool:
    """What the planar kernels (K1, K2, K8, K11, K17-K20) take: K a
    multiple of 128 below 2^17 and any group size g >= 1 split at K/2.
    Every planar stack the JAX package builds has K % 256 == 0
    (``planar_full_ok``, ``planar_bk``), so this admits every g that JAX
    makes planar (3, 6, 8, 12, 24 and 40 among them); a group that closes
    inside a kernel's k-tile runs the tile once per group it touches, the
    other groups' elements zeroed one value at a time."""
    return g >= 1 and K % 128 == 0 and K < (1 << 17) and (K // 2) % g == 0


def _choose_bk(K: int, g: int, pf: int, target: int) -> int:
    """The JAX package's k-block for GPTQ-order words (pallas_qmm.py:101);
    it decides whether the decode branch runs the per-group kernel (scale
    after each group's dot) or the field-loop kernel (scale in the
    weight)."""
    quantum = 128 * pf if K // g == 1 else math.lcm(128 * pf, 8 * g)
    best = None
    for bk in range(quantum, K + 1, quantum):
        if K % bk == 0 and bk <= target:
            best = bk
    return best if best is not None else K


def _per_group_branch(K: int, g: int, bits: int) -> bool:
    """The JAX gate's per-group geometry for 2/4-bit GPTQ-order words:
    ``v3_ok`` of ``_qmm_2d`` at M <= 32 (pallas_qmm.py:355-360) and the
    non-planar condition of ``qmatmul_pallas_stacked`` (:1657-1661)."""
    if bits not in (2, 4):
        return False
    npar = 8 // bits
    return _choose_bk(K, g, 32 // bits, 2048) % g == 0 and (g // npar) % 8 == 0


def _choose_bk_odd(K: int, g: int, target: int):
    """The JAX package's k-block for the bit-plane kernel, or None
    (pallas_qmm.py:646): bk % g == 0, bk % 256 == 0, (bk // g) % 8 == 0,
    else the full K when K % 256 == 0."""
    if g <= 0 or K % 32 or K % g:
        return None
    quantum = math.lcm(256, 8 * g)
    best = None
    for bk in range(quantum, K + 1, quantum):
        if K % bk == 0 and bk <= target:
            best = bk
    if best is None and K % 256 == 0:
        best = K
    return best


def odd_stacked_kernel_ok(K: int, group_size: int) -> bool:
    """Whether the JAX package serves a (K, g) odd-width stack with its
    bit-plane kernel (pallas_qmm.py:668, the default k-block target)."""
    g = K if group_size == -1 else group_size
    return g % 8 == 0 and _choose_bk_odd(K, g, 2048) is not None


def _planar_values(qw: torch.Tensor, K: int) -> torch.Tensor:
    """Planar words [K/8, Np] -> f32 [K, Np] nibble values in k order.
    Byte j of word row r (little-endian, as the words lie in memory) holds
    k = 4r + j in its low nibble and K/2 + 4r + j in its high one, so the
    nibbles are taken from a byte view and converted straight into the
    output's two halves."""
    b = qw.to(torch.int32).contiguous().view(torch.uint8).reshape(K // 8, -1, 4)
    out = torch.empty((2, K // 8, 4, b.shape[1]), dtype=torch.float32, device=qw.device)
    out[0].copy_((b & 0xF).permute(0, 2, 1))
    out[1].copy_((b >> 4).permute(0, 2, 1))
    return out.reshape(K, -1)


# ---------------------------------------------------------------------------
# K1 w4_planar_gemv
# ---------------------------------------------------------------------------


def _fullk_f32(xf: torch.Tensor, qw: torch.Tensor, sc: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """The full-K per-group product of the JAX package's planar kernels
    (``fullk`` in pallas_qmm.py:1976-2006, :2259-2284): y[m, n] = sum_g
    (x_g . q_g[:, n]) * s_g[n] - (sum x_g) * zs_g[n] in f32. xf f32 [M, K];
    one layer's (or expert's) words qw [K/8, Np] and scales / zs [G, Np]."""
    M, K = xf.shape
    G = sc.shape[0]
    v = _planar_values(qw, K).reshape(G, K // G, -1)
    xg = xf.reshape(M, G, K // G)
    d = torch.einsum("mgk,gkn->mgn", xg, v)
    xsum = xg.sum(dim=2)
    return (d * sc.to(torch.float32)[None] - xsum[:, :, None] * zs.to(torch.float32)[None]).sum(dim=1)


def w4_planar_gemv_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: torch.Tensor,
    layer: int,
    norm_w: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The plain version of K1: y[m, n] = sum_g (x_g . q_g[:, n]) * s_g[n]
    - (sum x_g) * zs_g[n] in f32, rounded to bf16. x [M, K] bf16,
    qweight [L, K/8, Np], scales / zs [L, G, Np], norm_w [L, K] or None."""
    K = x.shape[1]
    xf = x.to(torch.float32)
    if norm_w is not None:
        var = torch.sum(xf * xf, dim=1, keepdim=True) * (1.0 / K)
        xf = xf * torch.rsqrt(var + eps) * norm_w[layer].to(torch.float32)
    return _fullk_f32(xf, qweight[layer], scales[layer], zs[layer]).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def planar_splits(K: int, Np: int):
    """K1's and K17's (splits of K, word rows a split): ``tc_splits`` of the
    K/8 word rows over Np columns on the planar target, from (K, Np)
    alone, so a row's bits never depend on M."""
    return tc_splits(K // 8, Np, TC_TARGET_BLOCKS["planar"])


def a8_splits(K: int, Np: int):
    """K11's (splits of K, word rows a split): ``planar_splits`` with each
    split widened to whole 4-row steps (its x8 is staged by 16-byte
    copies); from (K, Np) alone, so a row's bits never depend on M."""
    _, per = planar_splits(K, Np)
    per = -(-per // 4) * 4
    return -(-(K // 8) // per), per


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if its data starts on a 16-byte boundary, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_stack(name, x, qweight, scales, zs, layer, K):
    if qweight.dtype != torch.int32 or qweight.dim() != 3 or qweight.shape[1] != K // 8:
        raise ValueError(f"{name}: qweight must be int32 [L, K/8, Np], got {tuple(qweight.shape)}")
    L, _, Np = qweight.shape
    G = scales.shape[1]
    for t in (scales, zs):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (L, G, Np):
            raise ValueError(f"{name}: scales/zs must be bf16 [L, G, Np]")
    if not _kernel_geometry_ok(K, K // G) or K % G:
        raise ValueError(f"{name}: geometry K={K}, G={G} is not taken")
    if not 0 <= layer < L:
        raise IndexError(f"{name}: layer {layer} out of range [0, {L})")
    for t in (qweight, scales, zs):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned on {x.device}")
    return L, Np, G


def w4_planar_gemv(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: torch.Tensor,
    layer: int,
    norm_w: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """K1: x [M <= 32, K] bf16 -> y [M, Np] bf16 (see the plain version).
    Replaces the per-group branch of _qmm_kernel_planar_full
    (pallas_qmm.py:832) with its fused RMSNorm. Bound: bytes (words +
    scales + zs + x + y) over 3.35 TB/s. K splits by ``planar_splits``; a
    second kernel adds the splits in split order (and applies the norm's
    row factor)."""
    if not _build.use_kernel(x, "w4_planar_gemv"):
        return w4_planar_gemv_plain(x, qweight, scales, zs, layer, norm_w, eps)
    M, K = x.shape
    if x.dtype != torch.bfloat16 or not 1 <= M <= GEMV_MAX_M:
        raise ValueError(f"w4_planar_gemv: x must be bf16 [M <= {GEMV_MAX_M}, K]")
    L, Np, G = _check_stack("w4_planar_gemv", x, qweight, scales, zs, layer, K)
    # the kernel stages x and the norm weight by 8- and 16-byte copies
    x = _aligned(x.contiguous())
    nw_f32 = 0
    if norm_w is not None:
        if tuple(norm_w.shape) != (L, K) or norm_w.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("w4_planar_gemv: norm_w must be bf16/f32 [L, K]")
        norm_w = _aligned(norm_w.contiguous())
        nw_f32 = int(norm_w.dtype == torch.float32)
    if Np % 32:
        raise ValueError("w4_planar_gemv: the padded width must be a multiple of 32")
    splits, per = planar_splits(K, Np)
    # the splits' partial sums (the norm's row factor is applied as they are added)
    part = (torch.empty((splits, M, Np), dtype=torch.float32, device=x.device)
            if splits > 1 or norm_w is not None else None)
    out = torch.empty((M, Np), dtype=torch.bfloat16, device=x.device)
    code = _build.load_library().qllm_w4_planar_gemv(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zs.data_ptr(), _build.ptr(norm_w), _build.ptr(part),
        out.data_ptr(), layer, M, K, Np, K // G, splits, per, nw_f32, float(eps), _build.stream(x),
    )
    _build.check("w4_planar_gemv", code)
    w4_planar_gemv.launches += 1
    return out


w4_planar_gemv.launches = 0


# ---------------------------------------------------------------------------
# K2 w4_planar_gemm
# ---------------------------------------------------------------------------


def w4_planar_gemm_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: torch.Tensor,
    layer: int,
) -> torch.Tensor:
    """The plain version of K2: w = bf16(q * s - zs); y = x @ w with f32
    accumulation (exact bf16 products in f32), rounded to bf16."""
    M, K = x.shape
    G = scales.shape[1]
    g = K // G
    v = _planar_values(qweight[layer], K).reshape(G, g, -1)
    sc = scales[layer].to(torch.float32)[:, None, :]
    zz = zs[layer].to(torch.float32)[:, None, :]
    w = (v * sc - zz).reshape(K, -1).to(torch.bfloat16)
    y = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    return y.to(torch.bfloat16)


def w4_planar_gemm(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: torch.Tensor,
    layer: int,
) -> torch.Tensor:
    """K2: x [M, K] bf16 -> y [M, Np] bf16 (see the plain version)."""
    if not _build.use_kernel(x, "w4_planar_gemm"):
        return w4_planar_gemm_plain(x, qweight, scales, zs, layer)
    M, K = x.shape
    if x.dtype != torch.bfloat16 or M < 1:
        raise ValueError("w4_planar_gemm: x must be bf16 [M, K]")
    _, Np, G = _check_stack("w4_planar_gemm", x, qweight, scales, zs, layer, K)
    if Np % 128:
        raise ValueError("w4_planar_gemm: the padded width must be a multiple of 128")
    x = _aligned(x.contiguous())  # the kernel loads x in 16-byte vectors
    out =torch.empty((M, Np), dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library()
    code = lib.qllm_w4_planar_gemm(
        x.data_ptr(),
        qweight.data_ptr(),
        scales.data_ptr(),
        zs.data_ptr(),
        out.data_ptr(),
        layer,
        M,
        K,
        Np,
        K // G,
        _build.stream(x),
    )
    _build.check("w4_planar_gemm", code)
    w4_planar_gemm.launches += 1
    return out


w4_planar_gemm.launches = 0


# ---------------------------------------------------------------------------
# W4A8: the activation quantizer and K11 w4a8_planar_gemv
# ---------------------------------------------------------------------------


def quantize_rows_int8_plain(x: torch.Tensor, group_size: int):
    """Per-token symmetric int8 activations, as the JAX package computes
    them (pallas_qmm.py:366-367, :1271-1275): x [M, K] as it arrives, in
    f32 -> (x8 int8 [M, K], sx f32 [M], per-group sums of x8 int32 [M,
    K / group_size]). sx = max(max|x|, 1e-8) / 127, x8 = clip(round half
    to even(x / sx), -127, 127); both divisions are by tensors, which
    PyTorch carries out as IEEE quotients on the card too."""
    M, K = x.shape
    xf = x.to(torch.float32)
    amax = torch.clamp(xf.abs().amax(dim=1), min=1e-8)
    sx = amax / torch.full_like(amax, 127.0)
    x8 = torch.clamp(torch.round(xf / sx[:, None]), -127, 127).to(torch.int8)
    xsum = x8.to(torch.int32).reshape(M, K // group_size, group_size).sum(dim=2, dtype=torch.int32)
    return x8, sx, xsum


def quantize_rows_int8(x: torch.Tensor, group_size: int):
    """The quantizer that K11 and K12 launch first, alone (for checks, and
    K15's x8): x [M, K] bf16 / f32 -> (x8, sx, xsum) as the plain version
    gives them."""
    if not _build.use_kernel(x, "quantize_rows_int8"):
        return quantize_rows_int8_plain(x, group_size)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("quantize_rows_int8: x must be bf16/f32 [M, K]")
    M, K = x.shape
    x = x.contiguous()
    x8 = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    xsum = torch.empty((M, K // group_size), dtype=torch.int32, device=x.device)
    code = _build.load_library().qllm_quantize_rows_int8(
        x.data_ptr(), int(x.dtype == torch.float32), x8.data_ptr(), sx.data_ptr(), xsum.data_ptr(),
        M, K, group_size, _build.stream(x),
    )
    _build.check("quantize_rows_int8", code)
    return x8, sx, xsum


def w4a8_planar_gemv_plain(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: torch.Tensor,
    layer: int,
    norm_w: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The plain version of K11: x8, sx = quantize(x), x first RMS-
    normalised by norm_w[layer] (``_rms_norm_rows``, rounded to x's dtype)
    when given; y[m, n] = sx[m] * sum_g ((x8_g . q_g[:, n]) * s_g[n] - (sum
    x8_g) * zs_g[n]), f32, rounded to bf16. The integer dots are exact in
    f32 (below 2^24)."""
    M, K = x.shape
    G = scales.shape[1]
    g = K // G
    if norm_w is not None:
        x = _rms_norm_rows(x, norm_w[layer], eps)
    x8, sx, _ = quantize_rows_int8_plain(x, g)
    v = _planar_values(qweight[layer], K).reshape(G, g, -1)
    xg = x8.to(torch.float32).reshape(M, G, g)
    d = torch.einsum("mgk,gkn->mgn", xg, v)
    xsum = xg.sum(dim=2)
    sc = scales[layer].to(torch.float32)
    zz = zs[layer].to(torch.float32)
    y = (d * sc[None] - xsum[:, :, None] * zz[None]).sum(dim=1)
    return (y * sx[:, None]).to(torch.bfloat16)


def w4a8_planar_gemv(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: torch.Tensor,
    layer: int,
    norm_w: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """K11: x [M <= 32, K] bf16 or f32, normalised (norm_w [L, K]) and
    quantized per row in the kernel's prologue -> y [M, Np] bf16 (see the
    plain version). Replaces the a8 branch of _qmm_kernel_planar_full
    (pallas_qmm.py:832). Bound: bytes (words + scales + zs + x + y) over
    3.35 TB/s. The product runs on the body's int8 planar consumer, K split
    by ``a8_splits``; a third kernel adds the splits in split order and
    scales by sx."""
    if not _build.use_kernel(x, "w4a8_planar_gemv"):
        return w4a8_planar_gemv_plain(x, qweight, scales, zs, layer, norm_w, eps)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) or not 1 <= x.shape[0] <= GEMV_MAX_M:
        raise ValueError(f"w4a8_planar_gemv: x must be bf16/f32 [M <= {GEMV_MAX_M}, K]")
    M, K = x.shape
    L, Np, G = _check_stack("w4a8_planar_gemv", x, qweight, scales, zs, layer, K)
    if not planar_full_ok(K, K // G) or Np % 32:
        raise ValueError(f"w4a8_planar_gemv: K={K}, G={G}, Np={Np} is not the full-K geometry")
    x = _aligned(x.contiguous())
    nw_f32 = 0
    if norm_w is not None:
        if tuple(norm_w.shape) != (L, K) or norm_w.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("w4a8_planar_gemv: norm_w must be bf16/f32 [L, K]")
        norm_w = _aligned(norm_w.contiguous())
        nw_f32 = int(norm_w.dtype == torch.float32)
    splits, per = a8_splits(K, Np)
    # the body stages x8 by 16-byte copies; the splits' partial sums when K is split
    x8 = _aligned(torch.empty((M, K), dtype=torch.int8, device=x.device))
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, M, Np), dtype=torch.float32, device=x.device) if splits > 1 else None
    out = torch.empty((M, Np), dtype=torch.bfloat16, device=x.device)
    code = _build.load_library().qllm_w4a8_planar_gemv(
        x.data_ptr(), int(x.dtype == torch.float32), x8.data_ptr(), sx.data_ptr(), qweight.data_ptr(),
        scales.data_ptr(), zs.data_ptr(), _build.ptr(norm_w), nw_f32, float(eps), _build.ptr(part), out.data_ptr(),
        layer, M, K, Np, K // G, splits, per, _build.stream(x),
    )
    _build.check("w4a8_planar_gemv", code)
    w4a8_planar_gemv.launches += 1
    return out


w4a8_planar_gemv.launches = 0


# ---------------------------------------------------------------------------
# K8 w4_grouped_gemv
# ---------------------------------------------------------------------------


def w4_grouped_gemv_plain(
    x_rows: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: torch.Tensor,
    ids: torch.Tensor,
    x_shared: bool = False,
) -> torch.Tensor:
    """The plain version of K8: for each selection i, K1's arithmetic on
    the one row x_rows[0 if x_shared else i] against expert ids[i] of the
    stack -> bf16 [n, Np]; an id outside [0, E) gives a row of NaN. The
    expert's words are gathered with index_select (a clamped id), so the
    ids are never read on the host."""
    E = qweight.shape[0]
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < E)
    safe = ids.clamp(0, E - 1)
    out = []
    for i in range(ids.shape[0]):
        e = safe[i : i + 1]
        x = x_rows[:1] if x_shared else x_rows[i : i + 1]
        out.append(
            w4_planar_gemv_plain(
                x, qweight.index_select(0, e), scales.index_select(0, e), zs.index_select(0, e), 0
            )
        )
    y = torch.cat(out)
    return torch.where(valid[:, None], y, torch.full_like(y, float("nan")))


# the selections a K8 block takes as its rows when its selection heads a run
GROUPED_RUN_ROWS = 8


def grouped_run_rows(ids: torch.Tensor) -> torch.Tensor:
    """K8's plan of runs, as each block makes it in the launch from the ids
    around it: int32 [n], the rows selection i's block takes. A selection
    heads when it starts a run of equal ids or lies a multiple of
    GROUPED_RUN_ROWS past the run's start; a head takes the run's next
    min(GROUPED_RUN_ROWS, left) selections, every other block none. Any
    order of ids is served; sorted ids make the runs long."""
    n = ids.shape[0]
    pos = torch.arange(n, device=ids.device)
    starts = torch.ones(n, dtype=torch.bool, device=ids.device)
    starts[1:] = ids[1:] != ids[:-1]
    run = torch.cumsum(starts.to(torch.int64), 0) - 1
    start = torch.zeros(int(run[-1]) + 1 if n else 0, dtype=torch.int64, device=ids.device)
    start[run[starts]] = pos[starts]
    offset = pos - start[run]
    left = torch.bincount(run)[run] - offset
    head = offset % GROUPED_RUN_ROWS == 0
    return torch.where(head, left.clamp(max=GROUPED_RUN_ROWS), 0).to(torch.int32)


# The head blocks K8's split plan counts on, from the expert's shape alone,
# so that neither the selection count nor the runs move a row's bits (a
# token's row takes the same split of K at batch 1 and at batch 8): as many
# heads as stream GROUPED_PLAN_BYTES of expert words, within
# GROUPED_PLAN_HEADS, the heads of a batch-1 token on the MoE models served
# (top-2 to top-8). Measured on the H100 (chip_stacked_ab.py --parts
# k8_heads): Mixtral-8x7B's down_proj (29 MB an expert) runs fastest planned
# for 2 heads (8 splits), Qwen3-30B-A3B's gate|up and down (1.6 / 0.8 MB)
# for 8 at batch 1, and within 10% of their best at batch 8.
GROUPED_PLAN_BYTES = 64 << 20
GROUPED_PLAN_HEADS = (2, 8)


def grouped_plan_heads(K: int, Np: int) -> int:
    """The head blocks K8's split plan counts on for a K x Np expert."""
    lo, hi = GROUPED_PLAN_HEADS
    return max(lo, min(hi, round(GROUPED_PLAN_BYTES / ((K // 8) * Np * 4))))


def grouped_splits(K: int, Np: int):
    """K8's (splits of K, word rows a split): ``tc_splits`` of the K/8 word
    rows over Np columns and ``grouped_plan_heads`` head blocks on the
    planar target; from (K, Np) alone, never from the selection count or
    the ids, so a row's bits depend neither on n nor on its run."""
    return tc_splits(K // 8, Np, TC_TARGET_BLOCKS["planar"], row_blocks=grouped_plan_heads(K, Np))


def w4_grouped_gemv(
    x_rows: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zs: torch.Tensor,
    ids: torch.Tensor,
    x_shared: bool = False,
) -> torch.Tensor:
    """K8: x_rows [n, K] bf16 (or [>= 1, K] when ``x_shared``), an expert
    stack qweight [E, K/8, Np] / scales, zs [E, G, Np], ids [n] int32 on
    the device -> y [n, Np] bf16. An id outside [0, E) gives a row of NaN
    (no host check: it would wait on the device). Replaces
    ``_qmm_kernel_planar_full`` as ``qmatmul_grouped_experts`` runs it
    (pallas_qmm.py:1843). Bound: bytes (the experts the ids touch, read
    once) over 3.35 TB/s. K splits by ``grouped_splits``; a second kernel
    adds the splits in split order."""
    if not _build.use_kernel(x_rows, "w4_grouped_gemv"):
        return w4_grouped_gemv_plain(x_rows, qweight, scales, zs, ids, x_shared)
    if x_rows.dtype != torch.bfloat16 or x_rows.dim() != 2:
        raise ValueError("w4_grouped_gemv: x_rows must be bf16 [n, K]")
    K = x_rows.shape[1]
    E, Np, G = _check_stack("w4_grouped_gemv", x_rows, qweight, scales, zs, 0, K)
    if ids.dim() != 1 or ids.device != x_rows.device or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError("w4_grouped_gemv: ids must be an int [n] tensor on the rows' device")
    n = ids.shape[0]
    if not x_shared and x_rows.shape[0] != n:
        raise ValueError(f"w4_grouped_gemv: {x_rows.shape[0]} rows for {n} selections")
    if n < 1 or n > 65535:
        raise ValueError("w4_grouped_gemv: 1 <= n <= 65535 selections")
    if Np % 32:
        raise ValueError("w4_grouped_gemv: the padded width must be a multiple of 32")
    x_rows = _aligned(x_rows.contiguous())  # 8-byte x copies, 16-byte alignment checked
    ids = ids.to(torch.int32).contiguous()
    splits, per = grouped_splits(K, Np)
    part = torch.empty((splits, n, Np), dtype=torch.float32, device=x_rows.device) if splits > 1 else None
    out = torch.empty((n, Np), dtype=torch.bfloat16, device=x_rows.device)
    code = _build.load_library().qllm_w4_grouped_gemv(
        x_rows.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zs.data_ptr(), ids.data_ptr(), _build.ptr(part),
        out.data_ptr(), n, E, int(bool(x_shared)), K, Np, K // G, splits, per, GROUPED_RUN_ROWS,
        _build.stream(x_rows),
    )
    _build.check("w4_grouped_gemv", code)
    w4_grouped_gemv.launches += 1
    return out


w4_grouped_gemv.launches = 0


# ---------------------------------------------------------------------------
# the stacked matmul entry point
# ---------------------------------------------------------------------------


def _planar_chip_ok(qt_stacked: QuantizedTensor, M: int, fuse: bool) -> bool:
    """The JAX gate's admission of a planar stack on its chip
    (pallas_qmm.py:1627-1653): a k-block (``planar_bk``), or the fused
    full-K kernel within its VMEM cap, or at M > 32 the relaxed k-block."""
    K = qt_stacked.in_features
    g = qt_stacked.effective_group_size
    bn = _pick_block(qt_stacked.qweight.shape[-1], 128, 512)
    ok = planar_bk(K, g, K) is not None or (
        fuse and planar_full_ok(K, g) and (K // 8) * bn * 4 <= _FULLK_MAX_BYTES
    )
    if not ok and M > GEMV_MAX_M:
        ok = planar_bk_relaxed(K, g, K) is not None
    return ok


def stacked_route(qt_stacked: QuantizedTensor, M: int, w4a8: bool = False) -> str:
    """The branch ``qmatmul_pallas_stacked`` takes for this stack at M rows
    on the JAX package's chip (pallas_qmm.py:1576-1664, then
    ``_qmm_2d_stacked`` :1115-1168; the CPU-only fusing of f32-scale
    stacks, :1615, is not the chip's and is not taken), one of:

      * "planar": K1 / K2 / K11, a 4-bit planar stack whose correction
        the JAX package fuses (prefolded zs, bf16 scales);
      * "planar_f32": K17 / K18, every other 4-bit planar stack (f32
        scales, or zeros not prefolded): ``_qmm_kernel_planar`` with the
        correction outside;
      * "v3", "v4", "a8": 2/4-bit GPTQ-order words, M <= 32, the per-group
        geometry; "v4" (K14 fused) for prefolded bf16-scale stacks, "a8"
        (K15) under ``w4a8`` for the other prefolded ones, else "v3" (K14
        unfused);
      * "odd", "odd_fused": 3/5/6/7 bits, M <= 32, in the bit-plane
        kernel's geometry (``odd_stacked_kernel_ok``); fused for prefolded
        bf16-scale stacks (K16);
      * "fallback": the layer through ``ops.ref_matmul.qmatmul``; for a
        planar stack, a geometry the JAX gate admits no kernel for (at
        decode: no ``planar_bk`` and no fused full-K kernel, e.g. the 7B
        down_proj K = 11008 with f32 scales).

    Not mirrored, as in every ported gate: the environment switches
    (``QLLM_TPU_FUSED_CORR``, ``QLLM_TPU_FUSED_CORR_V3``,
    ``QLLM_TPU_QMM_PREFILL_FULLK_A8``, ``QLLM_TPU_PREFILL_RELAXED_BK``,
    ``QLLM_TPU_PREFILL_DEQUANT``) and the autotuned blocks
    (``_tuned_blocks``, :1562): each takes its default. A GPTQ-order stack
    fuses its correction when its scales are stored bf16."""
    bits = qt_stacked.bits
    K = qt_stacked.in_features
    g = qt_stacked.effective_group_size
    bf16_scales = qt_stacked.scales.dtype != torch.float32
    if qt_stacked.planar:
        fuse = qt_stacked.zeros_prefolded and bf16_scales
        ok = bits == 4 and qt_stacked.perm is None and _planar_chip_ok(qt_stacked, M, fuse)
        if not ok or not _kernel_geometry_ok(K, g):
            return "fallback"
        return "planar" if fuse else "planar_f32"
    if qt_stacked.perm is not None or M > GEMV_MAX_M or bits not in (2, 3, 4, 5, 6, 7):
        return "fallback"
    fuse = qt_stacked.zeros_prefolded and bf16_scales
    if bits in (3, 5, 6, 7):
        if not odd_stacked_kernel_ok(K, qt_stacked.group_size):
            return "fallback"
        return "odd_fused" if fuse else "odd"
    if not _per_group_branch(K, g, bits):
        return "fallback"
    if fuse:
        return "v4"
    return "a8" if w4a8 and qt_stacked.zeros_prefolded else "v3"


def _stacked_fallback(x, qt_stacked, layer, norm_w, norm_eps, w4a8):
    """``qmatmul_pallas_stacked``'s fallback (pallas_qmm.py:1665-1728): the
    layer sliced out, zeros un-prefolded (zs / scales in the stored
    dtype), planar words unplanarized, the lane padding stripped, x
    pre-normalized, then the per-layer ``qmatmul``."""
    from ..quant.qtensor import unplanarize_packed
    from .ref_matmul import qmatmul

    if norm_w is not None:
        x = _rms_norm_rows(x, norm_w[layer], norm_eps)
    qt = qt_stacked.map_arrays(lambda a: a[layer])
    if qt_stacked.zeros_prefolded:
        qt = dataclasses.replace(qt, zeros=qt.zeros / qt.scales, zeros_prefolded=False)
    if qt_stacked.planar:
        qt = dataclasses.replace(qt, qweight=unplanarize_packed(qt.qweight, qt.in_features), planar=False)
    N = qt.out_features
    if qt.qweight.shape[-1] != N:
        qt = dataclasses.replace(
            qt, qweight=qt.qweight[:, :N].contiguous(), scales=qt.scales[:, :N].contiguous(),
            zeros=qt.zeros[:, :N].contiguous(),
        )
    return qmatmul(x, qt, w4a8=w4a8)


def qmatmul_stacked(
    x: torch.Tensor,
    qt_stacked: QuantizedTensor,
    layer: int,
    norm_w: Optional[torch.Tensor] = None,
    norm_eps: float = 1e-6,
    w4a8: bool = False,
) -> torch.Tensor:
    """y = x @ dequant(stack[layer]) for a stack ``models.stacked`` prepared
    (the counterpart of ``qmatmul_pallas_stacked``), through the branch
    ``stacked_route`` names.

    ``norm_w`` ([L, K] stacked RMSNorm weights): compute
    ``rms_norm(x, norm_w[layer]) @ W``, fused into K1 (planar, M <= 32) and
    K11, applied before every other kernel. ``w4a8``: int8 activations
    where the JAX package's W4A8 takes them: K11 on planar stacks at M <=
    32 in the full-K geometry (``a8_full_k_ok``), K15 on prefolded f32-scale
    2/4-bit GPTQ-order stacks, K12 in the fallback; every other call keeps
    bf16 / f32 activations. x: [..., K] -> [..., N] in x.dtype."""
    K, N = qt_stacked.in_features, qt_stacked.out_features
    lead = x.shape[:-1]
    M = 1
    for d in lead:
        M *= d
    route = stacked_route(qt_stacked, M, w4a8)
    if route == "fallback":
        return _stacked_fallback(x, qt_stacked, layer, norm_w, norm_eps, w4a8).to(x.dtype)
    g = qt_stacked.effective_group_size
    x2 = x.reshape(M, K)
    Np = qt_stacked.qweight.shape[-1]
    if route == "planar":
        y = _planar_matmul(x2, qt_stacked, layer, norm_w, norm_eps, w4a8, M, K, g, Np)
    elif route == "planar_f32":
        y = _planar_unfused_matmul(x2, qt_stacked, layer, norm_w, norm_eps, M, K, g)
    else:
        y = _packed_matmul(x2, qt_stacked, layer, norm_w, norm_eps, route, K, g)
    if y.shape[1] != N:
        y = y[:, :N]
    return y.reshape(*lead, N).to(x.dtype)


def _planar_matmul(x2, qt_stacked, layer, norm_w, norm_eps, w4a8, M, K, g, Np):
    if w4a8 and M <= GEMV_MAX_M and a8_full_k_ok(K, g, Np):
        return w4a8_planar_gemv(x2, qt_stacked.qweight, qt_stacked.scales, qt_stacked.zeros, layer, norm_w, norm_eps)
    if M <= GEMV_MAX_M:
        return w4_planar_gemv(
            x2.to(torch.bfloat16), qt_stacked.qweight, qt_stacked.scales, qt_stacked.zeros, layer, norm_w, norm_eps
        )
    if norm_w is not None:
        x2 = _rms_norm_rows(x2, norm_w[layer], norm_eps)
    return w4_planar_gemm(x2.to(torch.bfloat16), qt_stacked.qweight, qt_stacked.scales, qt_stacked.zeros, layer)


def _planar_unfused_matmul(x2, qt_stacked, layer, norm_w, norm_eps, M, K, g):
    """K17 / K18 and the work JAX does outside ``_qmm_kernel_planar``
    (pallas_qmm.py:1165-1167, :1300-1304, :1351-1383): the pre-normalize,
    x in bf16, bf16 scales cast to f32 (here the layer's slice), then
    ``out - xsum @ zs_l`` in f32 with xsum the group sums of the bf16 x and
    zs_l the prefolded zs or ``zeros * scales`` folded here, rounded to
    bf16. Stays a16 under W4A8, as in the JAX package (its a8 branch lives
    in the fused full-K kernel only)."""
    from .qmm_planar import w4_planar_f32s_gemm, w4_planar_f32s_gemv

    if norm_w is not None:
        x2 = _rms_norm_rows(x2, norm_w[layer], norm_eps)
    xb = x2.to(torch.bfloat16)
    qw, sc, lsc = qt_stacked.qweight, qt_stacked.scales, layer
    if sc.dtype != torch.float32:
        qw, sc, lsc = qw[layer : layer + 1], sc[layer : layer + 1].to(torch.float32), 0
    fn = w4_planar_f32s_gemv if M <= GEMV_MAX_M else w4_planar_f32s_gemm
    out = fn(xb, qw, sc, lsc)
    xsum = xb.to(torch.float32).reshape(M, K // g, g).sum(dim=2)
    zs_l = qt_stacked.zeros[layer].to(torch.float32)
    if not qt_stacked.zeros_prefolded:
        zs_l = zs_l * sc[lsc]
    return (out - xsum @ zs_l).to(torch.bfloat16)


def _packed_matmul(x2, qt_stacked, layer, norm_w, norm_eps, route, K, g):
    """K14 / K15 / K16 and the work JAX does outside them (pallas_qmm.py:
    1434-1473, 1530-1559): the pre-normalize, the f32 correction
    ``out - xsum @ zs[layer]`` of the unfused kernels, the token scale."""
    from . import qmm_stacked

    if norm_w is not None:
        x2 = _rms_norm_rows(x2, norm_w[layer], norm_eps)
    bits, gs = qt_stacked.bits, qt_stacked.group_size
    qw, sc, zs = qt_stacked.qweight, qt_stacked.scales, qt_stacked.zeros
    if route in ("v4", "odd_fused"):
        fn = qmm_stacked.gptq_stacked_gemv if route == "v4" else qmm_stacked.bitplane_stacked_gemv
        return fn(x2, qw, sc, zs, layer, bits, gs, True)
    sx = None
    if route == "a8":
        x8, sx, xsum = quantize_rows_int8(x2, g)
        out = qmm_stacked.gptq_stacked_w4a8_gemv(x8, qw, sc, layer, bits, gs)
        xsum = xsum.to(torch.float32)
    else:
        fn = qmm_stacked.gptq_stacked_gemv if route == "v3" else qmm_stacked.bitplane_stacked_gemv
        out = fn(x2, qw, sc, None, layer, bits, gs, False)
        xsum = x2.to(torch.float32).reshape(x2.shape[0], K // g, g).sum(dim=2)
    zs_l = zs[layer].to(torch.float32)
    if not qt_stacked.zeros_prefolded:
        zs_l = zs_l * sc[layer].to(torch.float32)
    y = out - xsum @ zs_l
    if sx is not None:
        y = y * sx[:, None]
    return y.to(torch.bfloat16)


def grouped_experts_ok(qt_stacked: QuantizedTensor) -> bool:
    """Whether K8 serves this [E]-stack: the serving layout (4-bit planar,
    prefolded bf16 zs, no act-order) in the full-K planar geometry the
    JAX package's grouped kernel takes (``planar_full_ok``)."""
    K = qt_stacked.in_features
    g = qt_stacked.effective_group_size
    return (
        qt_stacked.bits == 4
        and qt_stacked.planar
        and qt_stacked.zeros_prefolded
        and qt_stacked.perm is None
        and qt_stacked.scales.dtype == torch.bfloat16
        and planar_full_ok(K, g)
        and _kernel_geometry_ok(K, g)
    )


def qmatmul_grouped_experts(
    x_rows: torch.Tensor,  # [n, K], or [>= 1, K] with x_shared
    qt_stacked: QuantizedTensor,  # [E]-stacked serving prep
    expert_ids: torch.Tensor,  # [n] int, on the device
    x_shared: bool = False,  # every selection reads x_rows[0] (one token's k experts)
) -> torch.Tensor:
    """y[i] = x_rows[i] @ dequant(stack[expert_ids[i]]) for every
    selection in one K8 launch -> bf16 [n, N] (f32 sums)."""
    if not grouped_experts_ok(qt_stacked):
        raise NotImplementedError("qmatmul_grouped_experts: the stack is not in K8's geometry (grouped_experts_ok)")
    y = w4_grouped_gemv(
        x_rows.to(torch.bfloat16),
        qt_stacked.qweight,
        qt_stacked.scales,
        qt_stacked.zeros,
        expert_ids,
        x_shared,
    )
    N = qt_stacked.out_features
    return y[:, :N] if y.shape[1] != N else y


# ---------------------------------------------------------------------------
# K19 w4_grouped_fused_mlp: a selection's whole expert MLP in one launch
# ---------------------------------------------------------------------------

_FUSED_ACTS = ("silu", "gelu")
_grid_barriers = {}


def _grid_barrier(dev: torch.device) -> torch.Tensor:
    """The 64-bit arrival count of K19's / K20's grid barriers on ``dev``
    (two int32 words), zeroed once: each launch leaves it at the next
    multiple of 2^16, so launches on one stream share it without a reset."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    t = _grid_barriers.get(key)
    if t is None:
        t = _grid_barriers[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return t


def grouped_fused_ok(gu: QuantizedTensor, dn: QuantizedTensor, n: int, act: str) -> bool:
    """Whether K19 serves this (gate|up, down) expert-stack pair for n
    selections: the JAX package's chip gate (``grouped_fused_ok``,
    pallas_qmm.py:2322-2353): a silu / gelu gate, n <= 16, gate|up of
    width 2 * K2 with K2 <= 1024 and a buffer that K2 tiles, one group
    size, both stacks 4-bit planar, prefolded, without act-order, in the
    full-K geometry, with bf16 scales (the chip's rule, taken on every
    device). As for K8, the planar kernels' geometry (``_kernel_geometry_ok``).
    JAX's switch ``QLLM_TPU_MOE_FUSED`` is the caller's ``moe_fused``."""
    K1, K2 = gu.in_features, dn.in_features
    if act not in _FUSED_ACTS or n > 16 or gu.out_features != 2 * K2 or K2 > 1024:
        return False
    if gu.qweight.shape[-1] % K2:
        return False
    g = gu.effective_group_size
    if g != dn.effective_group_size:
        return False
    return all(
        qt.bits == 4
        and qt.planar
        and qt.zeros_prefolded
        and qt.perm is None
        and qt.scales.dtype == torch.bfloat16
        and planar_full_ok(K, g)
        and _kernel_geometry_ok(K, g)
        for qt, K in ((gu, K1), (dn, K2))
    )


def _fused_act(name: str, gt: torch.Tensor) -> torch.Tensor:
    """The gate activation of ``_qmm_kernel_grouped_fused`` (pallas_qmm.py:
    2297-2308), in f32: silu, or gelu in its tanh form (the JAX package's
    ``act_fn("gelu")`` is the erf form; its fused kernel is not)."""
    if name == "gelu":
        return 0.5 * gt * (1.0 + torch.tanh(0.7978845608 * (gt + 0.044715 * gt * gt * gt)))
    return gt * torch.sigmoid(gt)


def w4_grouped_fused_mlp_plain(
    x_rows: torch.Tensor,
    gu_qw: torch.Tensor,
    gu_sc: torch.Tensor,
    gu_zs: torch.Tensor,
    dn_qw: torch.Tensor,
    dn_sc: torch.Tensor,
    dn_zs: torch.Tensor,
    ids: torch.Tensor,
    K2: int,
    act: str = "silu",
    x_shared: bool = False,
) -> torch.Tensor:
    """The plain version of K19: for each selection i with e = ids[i], x =
    bf16(x_rows[0 if x_shared else i]) in f32, gu = fullk(x, GU[e]) (f32),
    a = act(gu[:, :K2]) * gu[:, K2:2K2] (f32, not rounded), y = fullk(a,
    DN[e]) -> bf16 [n, Np2]. The experts are gathered with index_select:
    the ids are never read on the host."""
    ids = ids.to(torch.int64)
    out = []
    for i in range(ids.shape[0]):
        e = ids[i : i + 1]
        x = (x_rows[:1] if x_shared else x_rows[i : i + 1]).to(torch.bfloat16).to(torch.float32)
        gu = _fullk_f32(x, gu_qw.index_select(0, e)[0], gu_sc.index_select(0, e)[0], gu_zs.index_select(0, e)[0])
        a = _fused_act(act, gu[:, :K2]) * gu[:, K2 : 2 * K2]
        out.append(_fullk_f32(a, dn_qw.index_select(0, e)[0], dn_sc.index_select(0, e)[0], dn_zs.index_select(0, e)[0]))
    return torch.cat(out).to(torch.bfloat16)


def w4_grouped_fused_mlp(
    x_rows: torch.Tensor,
    gu_qw: torch.Tensor,
    gu_sc: torch.Tensor,
    gu_zs: torch.Tensor,
    dn_qw: torch.Tensor,
    dn_sc: torch.Tensor,
    dn_zs: torch.Tensor,
    ids: torch.Tensor,
    K2: int,
    act: str = "silu",
    x_shared: bool = False,
) -> torch.Tensor:
    """K19: x_rows [n, K1] bf16 (or [>= 1, K1] when ``x_shared``), the
    gate|up stack [E, K1/8, Np1] / [E, G1, Np1] (gate in columns [0, K2),
    up in [K2, 2K2)), the down stack [E, K2/8, Np2] / [E, G2, Np2], ids [n]
    int on the device -> bf16 [n, Np2] in one cooperative launch (see the
    plain version) on the tensor-core body: K1 and K2 split by
    ``grouped_splits`` of each stack's shape, as K8 splits them; the
    scratch (both products' partial sums, the activation as three bf16
    parts) allocated here. An id outside [0, E) gives a row of NaN. Bound:
    bytes (the selected experts' words, scales and zs) over 3.35 TB/s."""
    if not _build.use_kernel(x_rows, "w4_grouped_fused_mlp"):
        return w4_grouped_fused_mlp_plain(x_rows, gu_qw, gu_sc, gu_zs, dn_qw, dn_sc, dn_zs, ids, K2, act, x_shared)
    name = "w4_grouped_fused_mlp"
    if x_rows.dtype != torch.bfloat16 or x_rows.dim() != 2:
        raise ValueError(f"{name}: x_rows must be bf16 [n, K1]")
    K1 = x_rows.shape[1]
    E, Np1, G1 = _check_stack(name, x_rows, gu_qw, gu_sc, gu_zs, 0, K1)
    E2, Np2, G2 = _check_stack(name, x_rows, dn_qw, dn_sc, dn_zs, 0, K2)
    if E2 != E or K1 // G1 != K2 // G2 or Np1 < 2 * K2 or Np2 % 4 or act not in _FUSED_ACTS:
        raise ValueError(f"{name}: stacks E={E}/{E2}, g={K1 // G1}/{K2 // G2}, Np1={Np1} < 2*K2={2 * K2}, "
                         f"Np2={Np2} or act {act!r} not taken")
    if ids.dim() != 1 or ids.device != x_rows.device or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: ids must be an int [n] tensor on the rows' device")
    n = ids.shape[0]
    if not x_shared and x_rows.shape[0] != n:
        raise ValueError(f"{name}: {x_rows.shape[0]} rows for {n} selections")
    if not 1 <= n <= 65535:
        raise ValueError(f"{name}: 1 <= n <= 65535 selections")
    x_rows = _aligned(x_rows.contiguous())
    ids = ids.to(torch.int32).contiguous()
    splits1, per1 = grouped_splits(K1, Np1)
    splits2, per2 = grouped_splits(K2, Np2)
    dev = x_rows.device
    part1 = torch.empty((splits1, n, 2 * K2), dtype=torch.float32, device=dev)
    a3 = torch.empty((n, 3, K2), dtype=torch.bfloat16, device=dev)
    part2 = torch.empty((splits2, n, Np2), dtype=torch.float32, device=dev) if splits2 > 1 else None
    out = torch.empty((n, Np2), dtype=torch.bfloat16, device=dev)
    code = _build.load_library().qllm_w4_grouped_fused_mlp(
        x_rows.data_ptr(), gu_qw.data_ptr(), gu_sc.data_ptr(), gu_zs.data_ptr(), dn_qw.data_ptr(), dn_sc.data_ptr(),
        dn_zs.data_ptr(), ids.data_ptr(), part1.data_ptr(), a3.data_ptr(), _build.ptr(part2),
        _grid_barrier(dev).data_ptr(), out.data_ptr(), n, E, int(bool(x_shared)), K1, K2, Np1, Np2, K1 // G1,
        splits1, per1, splits2, per2, _FUSED_ACTS.index(act), _build.stream(x_rows),
    )
    _build.check(name, code)
    w4_grouped_fused_mlp.launches += 1
    return out


w4_grouped_fused_mlp.launches = 0


def qmatmul_grouped_experts_fused(
    x_rows: torch.Tensor,  # [n, K1], or [>= 1, K1] with x_shared
    gu_stacked: QuantizedTensor,  # [E]-stacked fused gate|up serving prep
    dn_stacked: QuantizedTensor,  # [E]-stacked down serving prep
    expert_ids: torch.Tensor,  # [n] int, on the device
    act: str = "silu",
    x_shared: bool = False,  # every selection reads x_rows[0] (one token's k experts)
) -> torch.Tensor:
    """y[i] = act(x[i] @ GU[ids[i]])[:, :K2] * (x[i] @ GU[ids[i]])[:, K2:]
    @ DN[ids[i]] for every selection in one K19 launch -> bf16 [n, N2] (the
    counterpart of ``qmatmul_grouped_experts_fused``, pallas_qmm.py:2363)."""
    if not grouped_fused_ok(gu_stacked, dn_stacked, expert_ids.shape[0], act):
        raise NotImplementedError("qmatmul_grouped_experts_fused: the stacks are not K19's (grouped_fused_ok)")
    y = w4_grouped_fused_mlp(
        x_rows.to(torch.bfloat16), gu_stacked.qweight, gu_stacked.scales, gu_stacked.zeros, dn_stacked.qweight,
        dn_stacked.scales, dn_stacked.zeros, expert_ids, dn_stacked.in_features, act, x_shared,
    )
    N2 = dn_stacked.out_features
    return y[:, :N2] if y.shape[1] != N2 else y


# ---------------------------------------------------------------------------
# K20 w4_pnp_gemv: o_proj -> residual + RMSNorm -> gate|up in one launch
# ---------------------------------------------------------------------------


def pnp_stacked_ok(qt1: QuantizedTensor, qt2: QuantizedTensor) -> bool:
    """Whether K20 serves this (proj1, proj2) stack pair: the JAX package's
    chip gate (``pnp_stacked_ok``, pallas_qmm.py:2077-2106): both stacks
    4-bit planar, prefolded, without act-order, in the full-K geometry,
    with bf16 scales (the chip's rule, taken on every device); proj1
    unpadded and as wide as proj2 is deep; each (K/8) x bn word block
    within the 4 MiB full-K cap (bn = 512 at most). As for K1, groups of a
    size the planar kernels take (``_kernel_geometry_ok``)."""
    for qt in (qt1, qt2):
        K, g = qt.in_features, qt.effective_group_size
        if not (
            qt.bits == 4
            and qt.planar
            and qt.zeros_prefolded
            and qt.perm is None
            and qt.scales.dtype == torch.bfloat16
            and planar_full_ok(K, g)
            and _kernel_geometry_ok(K, g)
        ):
            return False
    if qt1.qweight.shape[-1] != qt1.out_features or qt1.out_features != qt2.in_features:
        return False
    return (qt1.in_features // 8) * min(512, qt1.out_features) * 4 <= _FULLK_MAX_BYTES and (
        qt2.in_features // 8
    ) * min(512, qt2.qweight.shape[-1]) * 4 <= _FULLK_MAX_BYTES


def w4_pnp_gemv_plain(
    x1: torch.Tensor,
    h: torch.Tensor,
    qw1: torch.Tensor,
    s1: torch.Tensor,
    z1: torch.Tensor,
    qw2: torch.Tensor,
    s2: torch.Tensor,
    z2: torch.Tensor,
    norm_w: torch.Tensor,
    layer: int,
    eps: float,
):
    """The plain version of K20 (``_qmm_kernel_pnp``, pallas_qmm.py:1950):
    hn = h + fullk(bf16(x1), W1[layer]) in f32; xn = hn * rsqrt(mean(hn^2)
    + eps) * norm_w[layer] in f32, not rounded; y2 = fullk(xn, W2[layer])
    -> (hn f32 [M, D], y2 bf16 [M, Np2])."""
    x1f = x1.to(torch.bfloat16).to(torch.float32)
    hn = _fullk_f32(x1f, qw1[layer], s1[layer], z1[layer]) + h.to(torch.float32)
    var = torch.sum(hn * hn, dim=1, keepdim=True) * (1.0 / hn.shape[1])
    xn = hn * torch.rsqrt(var + eps) * norm_w[layer].to(torch.float32)
    return hn, _fullk_f32(xn, qw2[layer], s2[layer], z2[layer]).to(torch.bfloat16)


def w4_pnp_gemv(
    x1: torch.Tensor,
    h: torch.Tensor,
    qw1: torch.Tensor,
    s1: torch.Tensor,
    z1: torch.Tensor,
    qw2: torch.Tensor,
    s2: torch.Tensor,
    z2: torch.Tensor,
    norm_w: torch.Tensor,
    layer: int,
    eps: float,
):
    """K20: x1 [M <= 32, K1] bf16, h [M, D] f32, proj1 [L, K1/8, D] / [L,
    G1, D], proj2 [L, D/8, Np2] / [L, G2, Np2], norm_w [L, D] bf16 / f32 ->
    (hn f32 [M, D], y2 bf16 [M, Np2]) in one cooperative launch (see the
    plain version) on the tensor-core body: K1 and D split by
    ``planar_splits`` of each product's shape; the scratch (both products'
    partial sums, x~ = hn * w as three bf16 parts, the rows' sums of
    squares by 128-column tile) allocated here. Bound: bytes (both layers'
    words, scales and zs) over 3.35 TB/s."""
    if not _build.use_kernel(x1, "w4_pnp_gemv"):
        return w4_pnp_gemv_plain(x1, h, qw1, s1, z1, qw2, s2, z2, norm_w, layer, eps)
    name = "w4_pnp_gemv"
    if x1.dtype != torch.bfloat16 or x1.dim() != 2 or not 1 <= x1.shape[0] <= GEMV_MAX_M:
        raise ValueError(f"{name}: x1 must be bf16 [M <= {GEMV_MAX_M}, K1]")
    M, K1 = x1.shape
    L, D, G1 = _check_stack(name, x1, qw1, s1, z1, layer, K1)
    L2, Np2, G2 = _check_stack(name, x1, qw2, s2, z2, layer, D)
    if L2 != L or Np2 % 4 or tuple(h.shape) != (M, D) or h.dtype != torch.float32 or h.device != x1.device:
        raise ValueError(f"{name}: stacks L={L}/{L2}, Np2={Np2}, h {tuple(h.shape)} {h.dtype} not taken")
    if tuple(norm_w.shape) != (L, D) or norm_w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: norm_w must be bf16/f32 [L, D]")
    x1 = _aligned(x1.contiguous())
    h = _aligned(h.contiguous())
    norm_w = _aligned(norm_w.contiguous())
    splits1, per1 = planar_splits(K1, D)
    splits2, per2 = planar_splits(D, Np2)
    dev = x1.device
    hn = torch.empty((M, D), dtype=torch.float32, device=dev)
    y2 = torch.empty((M, Np2), dtype=torch.bfloat16, device=dev)
    part1 = torch.empty((splits1, M, D), dtype=torch.float32, device=dev)
    x3 = torch.empty((M, 3, D), dtype=torch.bfloat16, device=dev)
    sq = torch.empty((M, D // 128), dtype=torch.float32, device=dev)
    part2 = torch.empty((splits2, M, Np2), dtype=torch.float32, device=dev) if splits2 > 1 else None
    code = _build.load_library().qllm_w4_pnp_gemv(
        x1.data_ptr(), h.data_ptr(), norm_w.data_ptr(), int(norm_w.dtype == torch.float32), qw1.data_ptr(),
        s1.data_ptr(), z1.data_ptr(), qw2.data_ptr(), s2.data_ptr(), z2.data_ptr(), hn.data_ptr(), part1.data_ptr(),
        x3.data_ptr(), sq.data_ptr(), _build.ptr(part2), _grid_barrier(dev).data_ptr(), y2.data_ptr(), layer, M, K1, D,
        Np2, K1 // G1, D // G2, splits1, per1, splits2, per2, float(eps), _build.stream(x1),
    )
    _build.check(name, code)
    w4_pnp_gemv.launches += 1
    return hn, y2


w4_pnp_gemv.launches = 0


def qmatmul_pnp_stacked(
    x1: torch.Tensor,  # [M, K1] (the attention context)
    h: torch.Tensor,  # [M, D] residual stream
    qt1: QuantizedTensor,  # [L]-stacked proj1 (o_proj)
    qt2: QuantizedTensor,  # [L]-stacked proj2 (gate|up)
    norm_w: torch.Tensor,  # [L, D] RMSNorm weights
    layer: int,
    eps: float,
):
    """(h + x1 @ W1[layer], rmsnorm(h + x1 @ W1) @ W2[layer]) in one K20
    launch -> (hn f32 [M, D], y2 bf16 [M, N2]): the counterpart of
    ``qmatmul_pnp_stacked`` (pallas_qmm.py:2109-2230), whose kernel writes
    f32 and which returns y2 as bf16."""
    if not pnp_stacked_ok(qt1, qt2):
        raise NotImplementedError("qmatmul_pnp_stacked: the stacks are not K20's (pnp_stacked_ok)")
    hn, y2 = w4_pnp_gemv(
        x1.to(torch.bfloat16), h.to(torch.float32), qt1.qweight, qt1.scales, qt1.zeros, qt2.qweight, qt2.scales,
        qt2.zeros, norm_w, layer, eps,
    )
    N2 = qt2.out_features
    return hn, (y2[:, :N2] if y2.shape[1] != N2 else y2)
