"""Decode-step KV write and single-query attention over the int8 KV
cache (the counterpart of the 5-D one-shot decode path of
``qllm_tpu/ops/pallas_attention.py``).

  * K3a ``kv_write_int8``: quantize one token's k and v per (batch,
    kv-head) and write them and their scales IN PLACE at ``pos[b]``
    (the JAX kernel returns buffer-aliased arrays instead).
  * K3b ``decode_attn_int8``: GQA attention of one query token over the
    first ``lengths[b]`` cache rows; the k scale folds into the scores
    and the v scale into the probabilities.

Each wrapper launches its CUDA kernel (csrc/attention.cu) on a CUDA
tensor, or raises, and runs its plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .kv_cache import _quantize_kv

__all__ = [
    "kv_write_int8",
    "kv_write_int8_plain",
    "decode_attn_int8",
    "decode_attn_int8_plain",
    "decode_attention",
    "ONESHOT_MAX_S",
]

ONESHOT_MAX_S = 8192  # the JAX package streams longer caches in chunks
_MAX_REP = 8
_MAX_D = 256


def _check_cache(name, k_cache, v_cache, k_scale, v_scale, layer):
    if k_cache.dtype != torch.int8 or k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches must be int8 [L, B, Hkv, S, D]")
    if k_scale.dtype != torch.float32 or k_scale.shape != k_cache.shape[:4] or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: scales must be f32 [L, B, Hkv, S]")
    for t in (k_cache, v_cache, k_scale, v_scale):
        if not t.is_contiguous():
            raise ValueError(f"{name}: caches must be contiguous")
    if not 0 <= layer < k_cache.shape[0]:
        raise IndexError(f"{name}: layer {layer} out of range")


# ---------------------------------------------------------------------------
# K3a kv_write_int8
# ---------------------------------------------------------------------------


def kv_write_int8_plain(k_new, v_new, k_cache, v_cache, k_scale, v_scale, layer, pos) -> None:
    """The plain version of K3a: k_new/v_new [B, Hkv, D], pos [B]."""
    b = torch.arange(k_new.shape[0], device=k_new.device)
    p = pos.to(torch.int64)
    kq, ks = _quantize_kv(k_new)
    vq, vs = _quantize_kv(v_new)
    k_cache[layer, b, :, p] = kq
    v_cache[layer, b, :, p] = vq
    k_scale[layer, b, :, p] = ks
    v_scale[layer, b, :, p] = vs


def kv_write_int8(
    k_new: torch.Tensor,  # [B, Hkv, D] this step's k (post-rope)
    v_new: torch.Tensor,
    k_cache: torch.Tensor,  # [L, B, Hkv, S, D] int8, written in place
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, Hkv, S] f32, written in place
    v_scale: torch.Tensor,
    layer: int,
    pos: torch.Tensor,  # [B] int32 write positions
) -> None:
    """K3a: quantize + write one token per sequence into the cache."""
    if not _build.use_kernel(k_new, "kv_write_int8"):
        return kv_write_int8_plain(k_new, v_new, k_cache, v_cache, k_scale, v_scale, layer, pos)
    _check_cache("kv_write_int8", k_cache, v_cache, k_scale, v_scale, layer)
    L, B, H, S, D = k_cache.shape
    if tuple(k_new.shape) != (B, H, D) or v_new.shape != k_new.shape:
        raise ValueError("kv_write_int8: k_new/v_new must be [B, Hkv, D]")
    if k_new.dtype not in (torch.bfloat16, torch.float32) or v_new.dtype != k_new.dtype:
        raise ValueError("kv_write_int8: k_new/v_new must both be bf16 or f32")
    if tuple(pos.shape) != (B,):
        raise ValueError("kv_write_int8: pos must be [B]")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    pos = pos.to(torch.int32).contiguous()
    lib = _build.load_library()
    code = lib.qllm_kv_write_int8(
        k_new.data_ptr(),
        v_new.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        k_scale.data_ptr(),
        v_scale.data_ptr(),
        pos.data_ptr(),
        int(k_new.dtype == torch.float32),
        layer,
        B,
        H,
        S,
        D,
        _build.stream(k_new),
    )
    _build.check("kv_write_int8", code)
    kv_write_int8.launches += 1


kv_write_int8.launches = 0


# ---------------------------------------------------------------------------
# K3b decode_attn_int8
# ---------------------------------------------------------------------------


def decode_attn_int8_plain(q, k_cache, v_cache, k_scale, v_scale, lengths, layer) -> torch.Tensor:
    """The plain version of K3b (the JAX kernel's one-shot softmax):
    q [B, H, D] -> f32 [B, H, D]."""
    B, H, d = q.shape
    Hkv, S = k_cache.shape[2], k_cache.shape[3]
    n_rep = H // Hkv
    qg = (q.to(torch.float32) * (d**-0.5)).reshape(B, Hkv, n_rep, d)
    qg = qg.to(torch.bfloat16).to(torch.float32)
    scores = qg @ k_cache[layer].to(torch.float32).transpose(-1, -2)  # [B, Hkv, n_rep, S]
    scores = scores * k_scale[layer][:, :, None, :]
    col = torch.arange(S, device=q.device)
    ok = (col[None, :] < lengths.to(torch.int64)[:, None])[:, None, None, :]
    scores = torch.where(ok, scores, torch.tensor(float("-inf"), device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    pv = (p * v_scale[layer][:, :, None, :]).to(torch.bfloat16).to(torch.float32)
    out = (pv @ v_cache[layer].to(torch.float32)) / denom
    return out.reshape(B, H, d)


def decode_attn_int8(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [L, B, Hkv, S, D] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, Hkv, S] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32: attend to cache[:length]
    layer: int,
) -> torch.Tensor:
    """K3b: -> f32 [B, H, D]."""
    if not _build.use_kernel(q, "decode_attn_int8"):
        return decode_attn_int8_plain(q, k_cache, v_cache, k_scale, v_scale, lengths, layer)
    _check_cache("decode_attn_int8", k_cache, v_cache, k_scale, v_scale, layer)
    L, B, Hkv, S, D = k_cache.shape
    if q.dim() != 3 or q.shape[0] != B or q.shape[2] != D or q.shape[1] % Hkv:
        raise ValueError("decode_attn_int8: q must be [B, H, D] with H a multiple of Hkv")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode_attn_int8: q must be bf16, got {q.dtype}")
    n_rep = q.shape[1] // Hkv
    if n_rep > _MAX_REP or D > _MAX_D or D % 16:
        raise ValueError(f"decode_attn_int8: n_rep <= {_MAX_REP}, D <= {_MAX_D}, D % 16 == 0")
    if tuple(lengths.shape) != (B,):
        raise ValueError("decode_attn_int8: lengths must be [B]")
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    code = lib.qllm_decode_attn_int8(
        q.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        k_scale.data_ptr(),
        v_scale.data_ptr(),
        lengths.data_ptr(),
        out.data_ptr(),
        layer,
        B,
        Hkv,
        S,
        D,
        n_rep,
        float(D**-0.5),
        _build.stream(q),
    )
    _build.check("decode_attn_int8", code)
    decode_attn_int8.launches += 1
    return out


decode_attn_int8.launches = 0


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    layer: int,
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over a layer-stacked int8 cache (the 5-D path of
    ``decode_attention_pallas``): q [B, H, D] -> f32 [B, H, D]."""
    if k_cache.dim() != 5:
        raise NotImplementedError(
            "the per-layer 4-D cache path (_attn_kernel, pallas_attention.py:671) is not ported yet"
        )
    if k_cache.shape[3] > ONESHOT_MAX_S:
        raise NotImplementedError(
            f"S > {ONESHOT_MAX_S} needs the chunked decode kernel "
            "_decode_attention_stacked_chunked (pallas_attention.py:371), not ported yet"
        )
    if softcap or alibi_slopes is not None or window is not None:
        raise NotImplementedError(
            "logit softcap, ALiBi and sliding-window masking are not wired into "
            "decode_attn_int8 yet"
        )
    return decode_attn_int8(q, k_cache, v_cache, k_scale, v_scale, lengths, layer)
