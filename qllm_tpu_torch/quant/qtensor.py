"""Canonical packed quantized-tensor format, in PyTorch.

The same layout ("tpu.v1") as the JAX package's ``quant/qtensor.py``, so
packed words, scales and zeros carry across bit for bit:

  * ``qweight``: ``[K // (32 // bits), N]`` words for bits in {2, 4, 8},
    row-major K-packed little-endian fields (value k at bit offset
    ``(k % pf) * bits`` of word ``k // pf``); ``[bits * K // 32, N]``
    plane-major bit planes for bits in {3, 5, 6, 7}.
  * ``scales`` / ``zeros``: ``[G, N]`` float, zeros unpacked.
  * ``perm``: optional ``[K]`` act-order input permutation.

Dequant: ``w[k, n] = (q[k, n] - zeros[k // g, n]) * scales[k // g, n]``.

Words are 32-bit patterns. PyTorch on the CPU has no right shift on
``torch.uint32``, so a word is held as an ``int32`` tensor with the same
bits; the bit arithmetic here widens to ``int64`` (where every uint32
value is non-negative) and narrows back with ``_to_i32``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

__all__ = [
    "QuantizedTensor",
    "pack_rows",
    "unpack_rows",
    "quantize_tensor",
    "dequantize_tensor",
    "compute_scale_zero",
    "planarize_packed",
    "unplanarize_packed",
    "take_columns",
    "concat_columns",
]

SUPPORTED_BITS = (2, 3, 4, 5, 6, 7, 8)
_U32 = 0xFFFFFFFF


def _is_pow2_field(bits: int) -> bool:
    return bits in (2, 4, 8)


def _as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) words -> int64 holding the unsigned 32-bit value."""
    return words.to(torch.int64) & _U32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> int32 with the same bits."""
    x = x & _U32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _arange(n: int, like: torch.Tensor, step: int = 1) -> torch.Tensor:
    return torch.arange(0, n * step, step, dtype=torch.int64, device=like.device)


# ---------------------------------------------------------------------------
# bit packing / unpacking
# ---------------------------------------------------------------------------


def pack_rows(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int values q[K, N] in [0, 2**bits) into int32 words along K
    (bit order of the JAX ``pack_rows``)."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be in {SUPPORTED_BITS}, got {bits}")
    K, N = q.shape
    q = q.to(torch.int64)
    if _is_pow2_field(bits):
        pf = 32 // bits
        if K % pf:
            raise ValueError(f"K={K} not divisible by pack factor {pf}")
        shifts = _arange(pf, q, bits)[None, :, None]
        # fields are disjoint, so the sum is their bitwise or
        return _to_i32((q.reshape(K // pf, pf, N) << shifts).sum(dim=1))
    if K % 32:
        raise ValueError(f"K={K} must be divisible by 32 for {bits}-bit packing")
    shifts = _arange(32, q)[None, :, None]
    planes = [
        (((q >> b) & 1).reshape(K // 32, 32, N) << shifts).sum(dim=1)
        for b in range(bits)
    ]
    return _to_i32(torch.cat(planes, dim=0))


def unpack_rows(packed: torch.Tensor, bits: int, rows: int) -> torch.Tensor:
    """Inverse of pack_rows -> int32 [rows, N]. The shifts stay in int32:
    an arithmetic shift keeps a field's own bits, and the mask drops the
    sign copies."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be in {SUPPORTED_BITS}, got {bits}")
    p = _to_i32(_as_u32(packed)) if packed.dtype != torch.int32 else packed
    n_words, N = p.shape
    if _is_pow2_field(bits):
        pf = 32 // bits
        shifts = torch.arange(0, 32, bits, dtype=torch.int32, device=p.device)[None, :, None]
        vals = (p[:, None, :] >> shifts) & ((1 << bits) - 1)
        return vals.reshape(n_words * pf, N)[:rows]
    wpp = rows // 32
    shifts = torch.arange(32, dtype=torch.int32, device=p.device)[None, :, None]
    out = torch.zeros((rows, N), dtype=torch.int32, device=p.device)
    for b in range(bits):
        plane = p[b * wpp : (b + 1) * wpp]
        out |= ((plane[:, None, :] >> shifts) & 1).reshape(rows, N) << b
    return out


# ---------------------------------------------------------------------------
# QuantizedTensor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Packed weight-only-quantized matrix ``W: [in_features(K),
    out_features(N)]`` of ``y = x @ W`` (K-major, the transpose of
    ``nn.Linear`` storage). Stacked serving tensors carry a leading [L]
    axis on every array field (models.stacked)."""

    qweight: torch.Tensor  # int32 words, see pack_rows
    scales: torch.Tensor  # [G, N] float
    zeros: torch.Tensor  # [G, N] float (zs = zeros * scales when prefolded)
    perm: Optional[torch.Tensor]  # int32 [K] or None
    bits: int
    group_size: int  # -1 => one group covering all of K
    in_features: int
    out_features: int
    sym: bool = False
    # planar (4-bit, runtime-only relayout, see planarize_packed): word r
    # byte j holds k = 4r+j in the low nibble and k = K/2+4r+j in the
    # high nibble. Never serialized.
    planar: bool = False
    # zeros_prefolded (runtime-only, set by models.stacked): the zeros
    # field holds zs = zeros * scales.
    zeros_prefolded: bool = False

    @property
    def effective_group_size(self) -> int:
        return self.in_features if self.group_size == -1 else self.group_size

    def map_arrays(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "QuantizedTensor":
        """Apply ``fn`` to every array field (the pytree map of the JAX
        version): indexing a layer out of a stack, moving devices."""
        return dataclasses.replace(
            self,
            qweight=fn(self.qweight),
            scales=fn(self.scales),
            zeros=fn(self.zeros),
            perm=None if self.perm is None else fn(self.perm),
        )


def compute_scale_zero(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    sym: bool = False,
    eps: float = 1e-8,
    scale_dtype: torch.dtype = torch.float16,
):
    """Min/max affine scale+zero per (group, out_channel); w: [K, N] ->
    scales [G, N], zeros [G, N] float32 (the JAX ``compute_scale_zero``)."""
    K, N = w.shape
    g = K if group_size == -1 else group_size
    maxq = (1 << bits) - 1
    wg = w.reshape(K // g, g, N).to(torch.float32)
    if sym:
        mabs = wg.abs().amax(dim=1)
        scale = torch.clamp(2.0 * mabs / maxq, min=eps)
        scale = scale.to(scale_dtype).to(torch.float32)
        zero = torch.full_like(scale, (maxq + 1) / 2.0)
    else:
        wmin = torch.clamp(wg.amin(dim=1), max=0.0)
        wmax = torch.clamp(wg.amax(dim=1), min=0.0)
        scale = torch.clamp((wmax - wmin) / maxq, min=eps)
        # the zero is derived from the scale as stored
        scale = scale.to(scale_dtype).to(torch.float32)
        zero = torch.round(-wmin / scale)
    return scale, zero


def quantize_tensor(
    w: torch.Tensor,
    bits: int = 4,
    group_size: int = 128,
    sym: bool = False,
    scales: Optional[torch.Tensor] = None,
    zeros: Optional[torch.Tensor] = None,
    perm: Optional[torch.Tensor] = None,
    scale_dtype: torch.dtype = torch.float16,
) -> QuantizedTensor:
    """RTN-quantize w[K, N] into the canonical packed layout. Given
    scales/zeros are used verbatim; a given ``perm`` means ``w`` is
    already row-permuted by it."""
    K, N = w.shape
    g = K if group_size == -1 else group_size
    if K % g:
        raise ValueError(f"in_features={K} not divisible by group_size={g}")
    if scales is None or zeros is None:
        scales, zeros = compute_scale_zero(w, bits, group_size, sym)
    # round-trip through the storage dtype so the integer grid is built
    # on the scales as stored
    scales = scales.to(scale_dtype).to(torch.float32)
    zeros = zeros.to(scale_dtype).to(torch.float32)
    maxq = (1 << bits) - 1
    ws = w.to(torch.float32).reshape(K // g, g, N)
    q = torch.clamp(torch.round(ws / scales[:, None, :] + zeros[:, None, :]), 0, maxq)
    q = q.reshape(K, N).to(torch.int32)
    return QuantizedTensor(
        qweight=pack_rows(q, bits),
        scales=scales.to(scale_dtype),
        zeros=zeros.to(scale_dtype),
        perm=None if perm is None else perm.to(torch.int32),
        bits=bits,
        group_size=group_size,
        in_features=K,
        out_features=N,
        sym=sym,
    )


def dequantize_tensor(qt: QuantizedTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unpack to dense [K, N] in the permuted row order."""
    q = unpack_rows(qt.qweight, qt.bits, qt.in_features)
    g = qt.effective_group_size
    K, N = qt.in_features, qt.out_features
    qg = q.reshape(K // g, g, N).to(torch.float32)
    w = (qg - qt.zeros.to(torch.float32)[:, None, :]) * qt.scales.to(torch.float32)[:, None, :]
    return w.reshape(K, N).to(dtype)


def planarize_packed(qweight: torch.Tensor, K: int) -> torch.Tensor:
    """4-bit GPTQ-order packed rows -> planar layout (see
    QuantizedTensor.planar), on [..., K//8, N]. Unpacks every value to
    int64: the reference, not the load-time path (ops.repack)."""
    lead = qweight.shape[:-2]
    N = qweight.shape[-1]
    q = _as_u32(qweight.reshape(-1, K // 8, N))
    shifts = _arange(8, q, 4)[None, None, :, None]
    vals = ((q[:, :, None, :] >> shifts) & 0xF).reshape(-1, K, N)  # k order
    lo = vals[:, : K // 2].reshape(-1, K // 8, 4, N)
    hi = vals[:, K // 2 :].reshape(-1, K // 8, 4, N)
    byte_shift = _arange(4, q, 8)[None, None, :, None]
    words = ((lo << byte_shift) | (hi << (byte_shift + 4))).sum(dim=2)
    return _to_i32(words).reshape(*lead, K // 8, N)


def unplanarize_packed(qweight: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse of planarize_packed, byte by byte (little-endian, as the
    words lie in memory): GPTQ word i < K/16 takes the low nibbles of
    planar rows 2i and 2i + 1 (bytes 0-3 each), word K/16 + i their high
    nibbles."""
    lead = qweight.shape[:-2]
    N = qweight.shape[-1]
    if qweight.dtype != torch.int32:
        qweight = _to_i32(_as_u32(qweight))
    b = qweight.contiguous().view(torch.uint8).reshape(-1, K // 16, 2, N, 4)
    halves = []
    for h in (b & 0xF, b >> 4):
        pairs = h[..., 0::2] | (h[..., 1::2] << 4)  # [E, K/16, 2, N, 2]: nibbles (2c, 2c + 1) of a row
        halves.append(pairs.permute(0, 1, 3, 2, 4).reshape(-1, K // 16, N, 4))
    words = torch.cat(halves, dim=1).contiguous().view(torch.int32)
    return words.reshape(*lead, K // 8, N)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def take_columns(qt: QuantizedTensor, idx) -> QuantizedTensor:
    """Select output columns ``idx`` (exact for every bit width: qweight,
    scales and zeros are all column-indexed)."""
    if qt.planar or qt.zeros_prefolded:
        raise ValueError("take_columns on a runtime-relayout tensor")
    i = _index(idx, qt.qweight.device)
    return dataclasses.replace(
        qt,
        qweight=qt.qweight[:, i],
        scales=qt.scales[:, i],
        zeros=qt.zeros[:, i],
        out_features=int(i.shape[0]),
    )


def concat_columns(
    parts: Sequence[QuantizedTensor], col_indices, out_features: int
) -> QuantizedTensor:
    """Inverse of take_columns: scatter each part's columns into one
    fused [., out_features] tensor. Parts must share (bits, group_size,
    sym, in_features) and carry no act-order perm."""
    p0 = parts[0]
    for p in parts:
        if (p.bits, p.group_size, p.sym, p.in_features) != (
            p0.bits,
            p0.group_size,
            p0.sym,
            p0.in_features,
        ):
            raise ValueError("concat_columns: mismatched quantization params")
        if p.perm is not None:
            raise ValueError("concat_columns: act_order tensors cannot fuse")
        if p.planar or p.zeros_prefolded:
            raise ValueError("concat_columns on a runtime-relayout tensor")
    dev = p0.qweight.device
    rows, G = p0.qweight.shape[0], p0.scales.shape[0]
    qw = torch.zeros((rows, out_features), dtype=p0.qweight.dtype, device=dev)
    sc = torch.ones((G, out_features), dtype=p0.scales.dtype, device=dev)
    zr = torch.zeros((G, out_features), dtype=p0.zeros.dtype, device=dev)
    for p, idx in zip(parts, col_indices):
        i = _index(idx, dev)
        qw[:, i] = p.qweight
        sc[:, i] = p.scales
        zr[:, i] = p.zeros
    return dataclasses.replace(p0, qweight=qw, scales=sc, zeros=zr, out_features=out_features)
