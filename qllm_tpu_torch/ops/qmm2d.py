"""Per-layer quantized matmul on GPTQ-order packed words (the counterpart
of ``_qmm_2d`` / ``qmatmul_pallas`` in ``qllm_tpu/ops/pallas_qmm.py``).

``qmatmul_2d(x, qt)`` computes ``y = x @ dequant(qt)`` for a 2-D
(per-layer) ``QuantizedTensor`` of 2, 4 or 8 bits, as the JAX package
does branch by branch:

  * M <= 32 (decode): x in f32, ``y = bf16(sum_g s_g (x_g . q_g) -
    xsum_g @ (z * s))`` with f32 sums. CUDA kernel K9 ``gptq_gemv``
    (csrc/gptq_stacked.cu, on the tensor-core body of
    csrc/stacked_mma.cuh), the counterpart of ``_qmm_kernel_v3`` (:177)
    and of ``_qmm_kernel``'s f32-dot branch (:119).
  * M > 32 (prefill, speculative verify): x in bf16, ``w = bf16(q * s)``
    (the zero point is NOT in the rounded weight), a bf16 product with f32
    sums, then the zero-point term ``xsum_g @ (z * s)`` taken off in f32.
    CUDA kernel K10 ``gptq_gemm``, the counterpart of ``_qmm_kernel``
    (:119) at M > 32.

  * M <= 32 with ``w4a8=True`` (2 and 4 bits in the per-group geometry,
    where the JAX package takes ``_qmm_kernel_w4a8``): per-token int8
    activations (``ops.qmm.quantize_rows_int8``), exact s8 x s8 -> s32
    group dots, ``y = bf16((sum_g d_g s_g - xsum @ (z s)) * sx)``.
    CUDA kernel K12 ``gptq_w4a8_gemv`` (csrc/gptq_stacked.cu: the
    quantizer, K15's int8 body on the tensor cores, an epilogue), the
    counterpart of ``_qmm_kernel_w4a8`` (:239) with the correction after it
    (:385-400). 8-bit weights and M > 32 keep K9 / K10, as in JAX.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs
its plain PyTorch version on a CPU tensor; the plain versions compute
``_qmm_2d``'s function in the JAX package's order of rounding. The
act-order permutation gathers x's columns first (``ref_matmul.py`` :86):
``qmatmul_2d`` gathers them for K9 / K10, and K12's quantizer gathers them
as it reads x.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ..quant.qtensor import QuantizedTensor, unpack_rows
from .qmm import _per_group_branch, _sm_count, quantize_rows_int8_plain
from .tc_plan import PARAM_TYPES, TC_TARGET_BLOCKS, tc_group_splits, tc_splits

__all__ = [
    "qmatmul_2d",
    "gptq_gemv",
    "gptq_gemv_plain",
    "gptq_gemm",
    "gptq_gemm_plain",
    "gptq_w4a8_gemv",
    "gptq_w4a8_gemv_plain",
    "GEMV_MAX_M",
    "gemm_segments",
    "w4a8_splits",
]

GEMV_MAX_M = 32
_BITS = (2, 4, 8)


def _check_bits(bits: int) -> None:
    if bits not in _BITS:
        raise NotImplementedError(f"the per-layer kernels serve 2/4/8 bits, got {bits}")


def _group(K: int, group_size: int) -> int:
    return K if group_size == -1 else group_size


def _operands(x, qweight, scales, zeros, bits, group_size):
    M, K = x.shape
    N = qweight.shape[1]
    g = _group(K, group_size)
    G = K // g
    q = unpack_rows(qweight, bits, K).to(torch.float32).reshape(G, g, N)
    return M, K, N, g, G, q, scales.to(torch.float32), zeros.to(torch.float32)


def _zero_point_term(xf: torch.Tensor, s, z, G: int, g: int) -> torch.Tensor:
    """xsum_g @ (z * s) in f32 (pallas_qmm.py:470-472)."""
    return xf.reshape(xf.shape[0], G, g).sum(dim=2) @ (z * s)


# ---------------------------------------------------------------------------
# K9 gptq_gemv
# ---------------------------------------------------------------------------


def gptq_gemv_plain(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, bits: int, group_size: int
) -> torch.Tensor:
    """The plain version of K9: ``_qmm_2d`` at M <= 32. x [M, K] (bf16 or
    f32, taken as f32), qweight [K/pf, N], scales / zeros [G, N] -> bf16
    [M, N]. 2- and 4-bit weights whose groups suit the TPU's per-group
    kernel scale each group's f32 dot (``_qmm_kernel_v3``); the others
    dot x with the f32 weight q * s (``_qmm_kernel``, f32_dot)."""
    _check_bits(bits)
    M, K, N, g, G, q, s, z = _operands(x, qweight, scales, zeros, bits, group_size)
    xf = x.to(torch.float32)
    if _per_group_branch(K, g, bits):
        d = torch.einsum("mgk,gkn->mgn", xf.reshape(M, G, g), q)
        y1 = (d * s[None]).sum(dim=1)
    else:
        y1 = xf @ (q * s[:, None, :]).reshape(K, N)
    return (y1 - _zero_point_term(xf, s, z, G, g)).to(torch.bfloat16)


def _param_type(name: str, scales: torch.Tensor, zeros: torch.Tensor) -> int:
    if scales.dtype != zeros.dtype or scales.dtype not in PARAM_TYPES:
        raise ValueError(f"{name}: scales and zeros must share one of f32/fp16/bf16, got {scales.dtype}, {zeros.dtype}")
    return PARAM_TYPES[scales.dtype]


def _check_weight(name, x, qweight, scales, zeros, bits, K, g):
    pf = 32 // bits
    if qweight.dtype != torch.int32 or qweight.dim() != 2 or qweight.shape[0] * pf != K:
        raise ValueError(f"{name}: qweight must be int32 [K/{pf}, N], got {tuple(qweight.shape)}")
    N = qweight.shape[1]
    if g % pf or K % g:
        raise ValueError(f"{name}: group size {g} must divide K={K} and be a multiple of {pf}")
    for t in (scales, zeros):
        if tuple(t.shape) != (K // g, N):
            raise ValueError(f"{name}: scales/zeros must be [{K // g}, {N}], got {tuple(t.shape)}")
    for t in (qweight, scales, zeros):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on {x.device}")
    return N, _param_type(name, scales, zeros)


def gptq_gemv(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, bits: int, group_size: int
) -> torch.Tensor:
    """K9: x [M <= 32, K] bf16 or f32 -> y [M, N] bf16 (see the plain version).
    Replaces ``_qmm_kernel_v3`` (pallas_qmm.py:177) and ``_qmm_kernel``'s
    f32-dot branch (:119). Bound: bytes (words + scales + zeros + x + y)
    over 3.35 TB/s. K splits by ``tc_splits`` of the word rows and N
    (never M); a second kernel adds the splits in split order."""
    _check_bits(bits)
    if not _build.use_kernel(x, "gptq_gemv"):
        return gptq_gemv_plain(x, qweight, scales, zeros, bits, group_size)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) or not 1 <= x.shape[0] <= GEMV_MAX_M:
        raise ValueError(f"gptq_gemv: x must be bf16/f32 [M <= {GEMV_MAX_M}, K]")
    M, K = x.shape
    g = _group(K, group_size)
    N, s_type = _check_weight("gptq_gemv", x, qweight, scales, zeros, bits, K, g)
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel stages x by 8- and 16-byte copies
        x = x.clone()
    splits, per = tc_splits(K * bits // 32, N, TC_TARGET_BLOCKS["gptq"])
    part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    code = _build.load_library().qllm_gptq_gemv(
        x.data_ptr(), int(x.dtype == torch.float32), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        s_type, _build.ptr(part), out.data_ptr(), bits, M, K, N, g, splits, per, _build.stream(x),
    )
    _build.check("gptq_gemv", code)
    gptq_gemv.launches += 1
    return out


gptq_gemv.launches = 0


# ---------------------------------------------------------------------------
# K10 gptq_gemm
# ---------------------------------------------------------------------------


def gptq_gemm_plain(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, bits: int, group_size: int
) -> torch.Tensor:
    """The plain version of K10: ``_qmm_2d`` at M > 32. w = bf16(q * s);
    y1 = bf16(x) @ w with f32 sums (exact products); y = bf16(y1 -
    xsum_g @ (z * s)) with xsum over the unrounded x in f32."""
    _check_bits(bits)
    M, K, N, g, G, q, s, z = _operands(x, qweight, scales, zeros, bits, group_size)
    w = (q * s[:, None, :]).reshape(K, N).to(torch.bfloat16).to(torch.float32)
    y1 = x.to(torch.bfloat16).to(torch.float32) @ w
    return (y1 - _zero_point_term(x.to(torch.float32), s, z, G, g)).to(torch.bfloat16)


# K10: blocks of 128 columns; K splits into segments of 64-k tiles, about
# one block per SM of the H100's 132 at one row tile, at least 4 tiles a
# segment
_GEMM_COLS = 128
_GEMM_KT = 64
_GEMM_TARGET_BLOCKS = 132
_GEMM_MIN_TILES = 4


def gemm_segments(K: int, N: int) -> Tuple[int, int]:
    """K10's split of K: (segments, 64-k tiles per segment), from the
    weight's shape alone. Every launch adds the segments' sums in segment
    order, so a row's bits never depend on M or on how the launch spreads
    the segments over blocks."""
    tiles = -(-K // _GEMM_KT)
    blocks_n = -(-N // _GEMM_COLS)
    want = max(1, min(-(-_GEMM_TARGET_BLOCKS // blocks_n), tiles // _GEMM_MIN_TILES))
    per = -(-tiles // want)
    return -(-tiles // per), per


def gemm_split_launch(M: int, N: int, segments: int, sms: int) -> bool:
    """Whether K10 runs one block per segment (partial sums, then a second
    kernel adds them): where the row and column tiles alone leave SMs idle."""
    return segments > 1 and -(-N // _GEMM_COLS) * -(-M // 128) < sms


def gptq_gemm(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, bits: int, group_size: int
) -> torch.Tensor:
    """K10: x [M, K] bf16 or f32 -> y [M, N] bf16 (see the plain version).
    Replaces ``_qmm_kernel`` (pallas_qmm.py:119) at M > 32, every geometry
    ``_qmm_2d`` takes (2/4/8 bits, g a multiple of pf that divides K).
    Bound: the words' bytes at the verify shapes, operations (2 * M * N *
    K over 989 TFLOP/s bf16) at prefill."""
    _check_bits(bits)
    if not _build.use_kernel(x, "gptq_gemm"):
        return gptq_gemm_plain(x, qweight, scales, zeros, bits, group_size)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) or x.shape[0] < 1:
        raise ValueError("gptq_gemm: x must be bf16/f32 [M, K]")
    M, K = x.shape
    g = _group(K, group_size)
    N, s_type = _check_weight("gptq_gemm", x, qweight, scales, zeros, bits, K, g)
    x = x.contiguous()
    # the MMA operand, zero-padded to whole 64-k tiles, loaded in 16-byte copies
    Kp = -(-K // _GEMM_KT) * _GEMM_KT
    x_mma = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    if Kp != K:
        x_mma = torch.nn.functional.pad(x_mma, (0, Kp - K))
    if x_mma.data_ptr() % 16:
        x_mma = x_mma.clone()
    segments, per = gemm_segments(K, N)
    dev = x.device
    split = gemm_split_launch(M, N, segments, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()))
    xsum = torch.empty((M, K // g), dtype=torch.float32, device=dev)
    part = torch.empty((segments, M, N), dtype=torch.float32, device=dev) if split else None
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    vec = int(N % 4 == 0 and qweight.data_ptr() % 16 == 0)
    code = _build.load_library().qllm_gptq_gemm(
        x_mma.data_ptr(), Kp, x.data_ptr(), int(x.dtype == torch.float32), qweight.data_ptr(), scales.data_ptr(),
        zeros.data_ptr(), s_type, xsum.data_ptr(), _build.ptr(part), out.data_ptr(), bits, M, K, N, g, segments, per,
        int(split), vec, _build.stream(x),
    )
    _build.check("gptq_gemm", code)
    gptq_gemm.launches += 1
    return out


gptq_gemm.launches = 0


# ---------------------------------------------------------------------------
# K12 gptq_w4a8_gemv
# ---------------------------------------------------------------------------


def gptq_w4a8_gemv_plain(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, bits: int, group_size: int
) -> torch.Tensor:
    """The plain version of K12: ``_qmm_2d``'s W4A8 branch. x8, sx, xsum =
    quantize(x); y1 = sum_g (x8_g . q_g) * s_g (exact integer dots in f32);
    y = bf16((y1 - xsum @ (z * s)) * sx)."""
    _check_bits(bits)
    M, K, N, g, G, q, s, z = _operands(x, qweight, scales, zeros, bits, group_size)
    x8, sx, xsum = quantize_rows_int8_plain(x, g)
    d = torch.einsum("mgk,gkn->mgn", x8.to(torch.float32).reshape(M, G, g), q)
    y1 = (d * s[None]).sum(dim=1)
    corr = xsum.to(torch.float32) @ (z * s)
    return ((y1 - corr) * sx[:, None]).to(torch.bfloat16)


def w4a8_splits(K: int, N: int, bits: int, g: int) -> Tuple[int, int]:
    """K12's (splits of K, word rows a split): ``tc_splits`` of the word
    rows and N on the body's GPTQ-order target, each split widened to whole
    groups (the epilogue takes whole groups' zero-point terms off); from
    (K, N, bits, g) alone, so a row's bits never depend on M."""
    pf = 32 // bits
    return tc_group_splits(K // pf, N, TC_TARGET_BLOCKS["gptq"], g // pf)


def gptq_w4a8_gemv(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    zeros: torch.Tensor,
    bits: int,
    group_size: int,
    perm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K12: x [M <= 32, K] bf16 or f32 -> y [M, N] bf16 (see the plain
    version), 2- and 4-bit words; ``perm`` (act-order, int [K]): value k of
    a row is x[:, perm[k]], gathered by the quantizer as it reads x.
    Replaces ``_qmm_kernel_w4a8`` (pallas_qmm.py:239) and the correction
    after it. Three launches: the quantizer, K15's int8 tensor-core body
    (each split's partial sums), the epilogue (the splits in split order,
    the zero-point term, the token scale). Bound: bytes (words + scales +
    zeros + x + y) over 3.35 TB/s."""
    if bits not in (2, 4):
        raise NotImplementedError(f"gptq_w4a8_gemv serves 2/4 bits, got {bits}")
    if not _build.use_kernel(x, "gptq_w4a8_gemv"):
        if perm is not None:
            x = torch.index_select(x, -1, perm.to(torch.int64))
        return gptq_w4a8_gemv_plain(x, qweight, scales, zeros, bits, group_size)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) or not 1 <= x.shape[0] <= GEMV_MAX_M:
        raise ValueError(f"gptq_w4a8_gemv: x must be bf16/f32 [M <= {GEMV_MAX_M}, K]")
    M, K = x.shape
    g = _group(K, group_size)
    N, s_type = _check_weight("gptq_w4a8_gemv", x, qweight, scales, zeros, bits, K, g)
    if perm is not None:
        if perm.dim() != 1 or perm.shape[0] != K or perm.device != x.device:
            raise ValueError(f"gptq_w4a8_gemv: perm must be an int [{K}] tensor on {x.device}")
        if perm.dtype != torch.int32 or not perm.is_contiguous():
            perm = perm.to(torch.int32).contiguous()
    x = x.contiguous()
    splits, per = w4a8_splits(K, N, bits, g)
    dev = x.device
    x8 = torch.empty((M, K), dtype=torch.int8, device=dev)
    sx = torch.empty((M,), dtype=torch.float32, device=dev)
    xsum = torch.empty((M, K // g), dtype=torch.int32, device=dev)
    part = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    code = _build.load_library().qllm_gptq_w4a8_gemv(
        x.data_ptr(), int(x.dtype == torch.float32), _build.ptr(perm), x8.data_ptr(), sx.data_ptr(),
        xsum.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(), s_type, part.data_ptr(),
        out.data_ptr(), bits, M, K, N, g, splits, per, _build.stream(x),
    )
    _build.check("gptq_w4a8_gemv", code)
    gptq_w4a8_gemv.launches += 1
    return out


gptq_w4a8_gemv.launches = 0


# ---------------------------------------------------------------------------
# the per-layer matmul entry point
# ---------------------------------------------------------------------------


def qmatmul_2d(
    x: torch.Tensor, qt: QuantizedTensor, bias: Optional[torch.Tensor] = None, w4a8: bool = False
) -> torch.Tensor:
    """y = x @ dequant(qt) (+ bias) for a 2-D GPTQ-order weight (the
    counterpart of ``qmatmul_pallas`` with the perm applied first):
    K9 at M <= 32, else K10; with ``w4a8``, K12 where ``_qmm_2d`` takes
    its W4A8 kernel (2/4 bits, M <= 32, the per-group geometry), whose
    quantizer gathers x by the act-order perm (K9 / K10 take x gathered
    here). x: [..., K] -> [..., N] in x.dtype."""
    _check_bits(qt.bits)
    if qt.planar or qt.zeros_prefolded or qt.qweight.dim() != 2:
        raise ValueError("qmatmul_2d takes a per-layer GPTQ-order weight (not a serving stack)")
    K, N = qt.in_features, qt.out_features
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    small = x2.shape[0] <= GEMV_MAX_M
    w = (qt.qweight, qt.scales, qt.zeros, qt.bits, qt.group_size)
    if w4a8 and small and _per_group_branch(K, _group(K, qt.group_size), qt.bits):
        y = gptq_w4a8_gemv(x2, *w, perm=qt.perm)
    else:
        if qt.perm is not None:
            x2 = torch.index_select(x2, -1, qt.perm.to(torch.int64))
        y = (gptq_gemv if small else gptq_gemm)(x2, *w)
    y = y.reshape(*lead, N).to(x.dtype)
    return y if bias is None else y + bias
