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


def _nibbles(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The four nibbles of two consecutive bytes of a word, low first,
    each as a byte (the last axis)."""
    return torch.stack([b0 & 0xF, b0 >> 4, b1 & 0xF, b1 >> 4], dim=-1)


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
    """The plain version of K4: [..., K/8, N] int32 -> planar words, byte
    by byte (little-endian, as the words lie in memory): byte j of planar
    row 2m is nibble j of source row m, with nibble j of row K/16 + m
    above it; row 2m + 1 takes nibbles 4 + j."""
    lead, E, N = _split_halves(qweight, K)
    if qweight.dtype != torch.int32:
        qweight = _to_i32(_as_u32(qweight))
    s = qweight.contiguous().view(torch.uint8).reshape(E, 2, K // 16, N, 4)
    even = _nibbles(s[..., 0], s[..., 1])  # [E, 2, K/16, N, 4]: nibbles 0-3
    odd = _nibbles(s[..., 2], s[..., 3])  # nibbles 4-7
    out = torch.stack([even[:, 0] | (even[:, 1] << 4), odd[:, 0] | (odd[:, 1] << 4)], dim=2)
    return out.view(torch.int32).reshape(*lead, K // 8, N)


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
