"""Planar W4 matmul on [L]-stacked serving weights (the counterpart of
the planar subset of ``qllm_tpu/ops/pallas_qmm.py``).

``qmatmul_stacked(x, qt, layer)`` computes ``y = x @ dequant(qt[layer])``
for the stacks ``models.stacked`` prepares: 4-bit planar words
``[L, K/8, Np]``, bf16 scales and prefolded ``zs = zeros * scales``
``[L, G, Np]``. Two hand-written CUDA kernels serve it:

  * K1 ``w4_planar_gemv`` (M <= 32, decode): per-group dots over the
    integer nibbles on the tensor cores (exact products, f32 sums) with
    the zero-point correction in-kernel, and the pre-matmul RMSNorm fused
    in;
  * K2 ``w4_planar_gemm`` (M > 32, prefill): dequantize to bf16 in
    registers, bf16 tensor-core product with f32 accumulation; the
    RMSNorm runs before it.

``qmatmul_grouped_experts(x_rows, stack, ids)`` computes
``y[i] = x_rows[i] @ dequant(stack[ids[i]])`` for every MoE (token,
expert) selection in one launch of K8 ``w4_grouped_gemv``: K1's inner
loop, one block per (column tile, selection), with the expert ids read
on the device.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs
its plain PyTorch version on a CPU tensor. The TPU autotuner does not
carry over: launch shapes are picked here in code.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build
from ..quant.qtensor import QuantizedTensor

__all__ = [
    "qmatmul_stacked",
    "qmatmul_grouped_experts",
    "grouped_experts_ok",
    "w4_grouped_gemv",
    "w4_grouped_gemv_plain",
    "w4_planar_gemv",
    "w4_planar_gemv_plain",
    "w4_planar_gemm",
    "w4_planar_gemm_plain",
    "planar_full_ok",
    "planar_bk",
]

GEMV_MAX_M = 32


def _rms_norm_rows(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis with the weight product in f32 (the
    pre-normalize the JAX package runs outside its blocked kernel)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def planar_full_ok(K: int, g: int) -> bool:
    """The full-K planar geometry: K % 256 == 0 and a group split at K/2."""
    return g > 0 and K % 256 == 0 and (K // 2) % g == 0


def planar_bk(K: int, g: int, target: int = 2048):
    """k-block of the JAX package's blocked planar kernel, or None (kept
    because models.stacked decides planarization with it)."""
    if g <= 0 or K % (2 * g):
        return None
    import math

    quantum = math.lcm(256, 16 * g)
    best = None
    for bk in range(quantum, K + 1, quantum):
        if K % bk == 0 and bk <= target:
            best = bk
    return best


def _kernel_geometry_ok(K: int, g: int) -> bool:
    """What K1 and K2 take: groups of a multiple of 32 values (whole
    32-value tiles of each half of K) and a group split at K/2."""
    return g > 0 and g % 32 == 0 and K % 64 == 0 and (K // 2) % g == 0


def _planar_values(qw: torch.Tensor, K: int) -> torch.Tensor:
    """Planar words [K/8, Np] -> f32 [K, Np] nibble values in k order.
    The shifts stay in int32: an arithmetic shift by <= 28 bits keeps
    the nibble's own bits, and the mask drops the sign copies."""
    sh = torch.arange(0, 32, 8, dtype=torch.int32, device=qw.device)[None, :, None]
    w = qw.to(torch.int32)[:, None, :]
    lo = ((w >> sh) & 0xF).reshape(K // 2, -1)
    hi = ((w >> (sh + 4)) & 0xF).reshape(K // 2, -1)
    return torch.cat([lo, hi], dim=0).to(torch.float32)


# ---------------------------------------------------------------------------
# K1 w4_planar_gemv
# ---------------------------------------------------------------------------


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
    M, K = x.shape
    G = scales.shape[1]
    g = K // G
    xf = x.to(torch.float32)
    if norm_w is not None:
        var = torch.sum(xf * xf, dim=1, keepdim=True) * (1.0 / K)
        xf = xf * torch.rsqrt(var + eps) * norm_w[layer].to(torch.float32)
    v = _planar_values(qweight[layer], K).reshape(G, g, -1)
    xg = xf.reshape(M, G, g)
    d = torch.einsum("mgk,gkn->mgn", xg, v)
    xsum = xg.sum(dim=2)
    sc = scales[layer].to(torch.float32)
    zz = zs[layer].to(torch.float32)
    y = (d * sc[None] - xsum[:, :, None] * zz[None]).sum(dim=1)
    return y.to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gemv_launch(dev: torch.device, M: int, Np: int, K: int, row_blocks=None):
    """K1's launch shape: 16-column MMA tiles per block (4 where that
    still gives a block per SM, else 2) and warps per block (each takes a
    share of K's 32-value tiles), about 16 warps per SM in all.
    ``row_blocks``: blocks along the rows (K8: one per selection; K1:
    one per 8 rows)."""
    sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    nt = 4 if Np % 64 == 0 and Np // 64 >= sms else 2
    blocks = (Np // (16 * nt)) * (-(-M // 8) if row_blocks is None else row_blocks)
    warps = max(1, min(16, K // 32, -(-16 * sms // blocks)))
    return nt, warps


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
    """K1: x [M <= 32, K] bf16 -> y [M, Np] bf16 (see the plain version)."""
    if not _build.use_kernel(x, "w4_planar_gemv"):
        return w4_planar_gemv_plain(x, qweight, scales, zs, layer, norm_w, eps)
    M, K = x.shape
    if x.dtype != torch.bfloat16 or not 1 <= M <= GEMV_MAX_M:
        raise ValueError(f"w4_planar_gemv: x must be bf16 [M <= {GEMV_MAX_M}, K]")
    L, Np, G = _check_stack("w4_planar_gemv", x, qweight, scales, zs, layer, K)
    # the kernel loads x and the norm weight in 8- and 16-byte vectors
    x = _aligned(x.contiguous())
    nw_f32 = 0
    if norm_w is not None:
        if tuple(norm_w.shape) != (L, K) or norm_w.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError("w4_planar_gemv: norm_w must be bf16/f32 [L, K]")
        norm_w = _aligned(norm_w.contiguous())
        nw_f32 = int(norm_w.dtype == torch.float32)
    if Np % 32:
        raise ValueError("w4_planar_gemv: the padded width must be a multiple of 32")
    nt, warps = _gemv_launch(x.device, M, Np, K)
    out = torch.empty((M, Np), dtype=torch.bfloat16, device=x.device)
    lib = _build.load_library()
    code = lib.qllm_w4_planar_gemv(
        x.data_ptr(),
        qweight.data_ptr(),
        scales.data_ptr(),
        zs.data_ptr(),
        _build.ptr(norm_w),
        out.data_ptr(),
        layer,
        M,
        K,
        Np,
        K // G,
        nt,
        warps,
        nw_f32,
        float(eps),
        _build.stream(x),
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
    stack -> bf16 [n, Np]. The expert's words are gathered with
    index_select, so the ids are never read on the host."""
    ids = ids.to(torch.int64)
    out = []
    for i in range(ids.shape[0]):
        e = ids[i : i + 1]
        x = x_rows[:1] if x_shared else x_rows[i : i + 1]
        out.append(
            w4_planar_gemv_plain(
                x, qweight.index_select(0, e), scales.index_select(0, e), zs.index_select(0, e), 0
            )
        )
    return torch.cat(out)


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
    (no host check: it would wait on the device)."""
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
    x_rows = _aligned(x_rows.contiguous())  # 8-byte x loads
    ids = ids.to(torch.int32).contiguous()
    nt, warps = _gemv_launch(x_rows.device, 1, Np, K, row_blocks=n)
    out = torch.empty((n, Np), dtype=torch.bfloat16, device=x_rows.device)
    lib = _build.load_library()
    code = lib.qllm_w4_grouped_gemv(
        x_rows.data_ptr(),
        qweight.data_ptr(),
        scales.data_ptr(),
        zs.data_ptr(),
        ids.data_ptr(),
        out.data_ptr(),
        n,
        E,
        int(bool(x_shared)),
        K,
        Np,
        K // G,
        nt,
        warps,
        _build.stream(x_rows),
    )
    _build.check("w4_grouped_gemv", code)
    w4_grouped_gemv.launches += 1
    return out


w4_grouped_gemv.launches = 0


# ---------------------------------------------------------------------------
# the stacked matmul entry point
# ---------------------------------------------------------------------------


def qmatmul_stacked(
    x: torch.Tensor,
    qt_stacked: QuantizedTensor,
    layer: int,
    norm_w: Optional[torch.Tensor] = None,
    norm_eps: float = 1e-6,
) -> torch.Tensor:
    """y = x @ dequant(stack[layer]) for a planar, zs-prefolded, bf16-scale
    4-bit stack (the counterpart of ``qmatmul_pallas_stacked``).

    ``norm_w`` ([L, K] stacked RMSNorm weights): compute
    ``rms_norm(x, norm_w[layer]) @ W``, fused into K1 at M <= 32 and
    applied before K2 at M > 32. x: [..., K] -> [..., N] in x.dtype."""
    K, N = qt_stacked.in_features, qt_stacked.out_features
    g = qt_stacked.effective_group_size
    if not (
        qt_stacked.bits == 4
        and qt_stacked.planar
        and qt_stacked.zeros_prefolded
        and qt_stacked.perm is None
        and qt_stacked.scales.dtype == torch.bfloat16
        and _kernel_geometry_ok(K, g)
    ):
        raise NotImplementedError(
            "qmatmul_stacked serves 4-bit planar stacks with bf16 scales and "
            "prefolded zeros (models.stacked.stack_layer_params) "
            f"whose groups of a multiple of 32 split at K/2 (K={K}, g={g}); f32-scale "
            "stacks (_qmm_kernel_planar, pallas_qmm.py:999), GPTQ-order stacks "
            "(_qmm_kernel_v3/v4_stacked, :476/:514) and odd bits "
            "(_qmm_kernel_odd_stacked, :676) are not yet ported"
        )
    lead = x.shape[:-1]
    M = 1
    for d in lead:
        M *= d
    x2 = x.reshape(M, K)
    if M <= GEMV_MAX_M:
        y = w4_planar_gemv(
            x2.to(torch.bfloat16),
            qt_stacked.qweight,
            qt_stacked.scales,
            qt_stacked.zeros,
            layer,
            norm_w,
            norm_eps,
        )
    else:
        if norm_w is not None:
            x2 = _rms_norm_rows(x2, norm_w[layer], norm_eps)
        y = w4_planar_gemm(
            x2.to(torch.bfloat16),
            qt_stacked.qweight,
            qt_stacked.scales,
            qt_stacked.zeros,
            layer,
        )
    if y.shape[1] != N:
        y = y[:, :N]
    return y.reshape(*lead, N).to(x.dtype)


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
