"""Planar relayout of 4-bit packed weights in one pass over the words
(the counterpart of ``qllm_tpu/ops/pallas_repack.py``).

``quant.qtensor.planarize_packed`` unpacks every value to a wide
integer; the mapping is word-local, so it can be done with 32-bit
shift/mask arithmetic instead:

  source word i (GPTQ order) holds k = 8i..8i+7 in nibbles 0..7
  planar word j holds, in byte b, k = 4j+b in the low nibble and
  k = K/2+4j+b in the high nibble

so planar row 2m takes nibbles 0-3 of source rows m and K/16+m, and row
2m+1 nibbles 4-7. ``planarize_w4`` launches kernel K4 (csrc/repack.cu)
on a CUDA tensor and runs ``planarize_w4_plain`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build
from ..quant.qtensor import _as_u32, _to_i32

__all__ = ["planarize_w4", "planarize_w4_plain"]


def _deposit(x16: torch.Tensor) -> torch.Tensor:
    """Spread the 4 nibbles of the low 16 bits into the low nibble of
    each byte of a 32-bit word."""
    return (x16 & 0xF) | ((x16 & 0xF0) << 4) | ((x16 & 0xF00) << 8) | ((x16 & 0xF000) << 12)


def _split_halves(qweight: torch.Tensor, K: int):
    lead = qweight.shape[:-2]
    N = qweight.shape[-1]
    if K % 16 or qweight.shape[-2] != K // 8:
        raise ValueError(f"planarize: need [..., K/8, N] words with K % 16 == 0, K={K}")
    E = 1
    for d in lead:
        E *= d
    return lead, E, N


def planarize_w4_plain(qweight: torch.Tensor, K: int) -> torch.Tensor:
    """The plain version of K4: [..., K/8, N] int32 -> planar words."""
    lead, E, N = _split_halves(qweight, K)
    q4 = _as_u32(qweight.reshape(E, 2, K // 16, N))
    lo, hi = q4[:, 0], q4[:, 1]
    even = _deposit(lo & 0xFFFF) | (_deposit(hi & 0xFFFF) << 4)
    odd = _deposit(lo >> 16) | (_deposit(hi >> 16) << 4)
    out = torch.stack([even, odd], dim=2)  # [E, K/16, 2, N]
    return _to_i32(out).reshape(*lead, K // 8, N)


def planarize_w4(qweight: torch.Tensor, K: int) -> torch.Tensor:
    """planarize_packed semantics ([..., K/8, N] int32 words in, same
    shape planar out) without the unpacked intermediate."""
    if not _build.use_kernel(qweight, "planarize_w4"):
        return planarize_w4_plain(qweight, K)
    lead, E, N = _split_halves(qweight, K)
    if qweight.dtype != torch.int32:
        raise TypeError(f"planarize_w4: int32 words expected, got {qweight.dtype}")
    src = qweight.contiguous()
    out = torch.empty_like(src)
    lib = _build.load_library()
    code = lib.qllm_planarize_w4(
        src.data_ptr(), out.data_ptr(), E, K // 16, N, _build.stream(src)
    )
    _build.check("planarize_w4", code)
    planarize_w4.launches += 1
    return out.reshape(*lead, K // 8, N)


planarize_w4.launches = 0
