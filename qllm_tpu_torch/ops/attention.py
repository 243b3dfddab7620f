"""Decode-step KV write and single-query attention over the int8 KV
cache (the counterpart of the 5-D one-shot decode path of
``qllm_tpu/ops/pallas_attention.py``).

  * K3a ``kv_write_int8``: quantize one token's k and v per (batch,
    kv-head) and write them and their scales IN PLACE at ``pos[b]``
    (the JAX kernel returns buffer-aliased arrays instead).
  * K3b ``decode_attn_int8``: GQA attention of one query token over the
    first ``lengths[b]`` cache rows; the k scale folds into the scores
    and the v scale into the probabilities. It walks the rows in 128-key
    tiles with an online softmax, so it serves every S: both the JAX
    package's one-shot kernel (S <= 8192) and its key-chunked one.
  * K6 ``decode_attention_ring``: the ring-fused decode step: one query over the int8 rows
    [0, flushed), the bf16 ring rows [flushed, pos) and the current
    token, whose k/v it appends IN PLACE to ring slot pos - flushed
    (flushed = pos // 8 * 8).
  * K7 ``kv_ring_flush``: every layer's full ring quantized into the
    int8 rows [pos - 8, pos) and their scales, in place, in one launch.

Each wrapper launches its CUDA kernel (csrc/attention.cu) on a CUDA
tensor, or raises, and runs its plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .kv_cache import _quantize_kv

__all__ = [
    "RING",
    "decode_attention_ring",
    "decode_attention_ring",
    "decode_attention_ring_plain",
    "kv_ring_flush",
    "kv_ring_flush_plain",
    "kv_write_int8",
    "kv_write_int8_plain",
    "decode_attn_int8",
    "decode_attn_int8_plain",
    "decode_attention",
]

RING = 8  # ring depth == the rows one flush writes
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
    ``decode_attention_pallas``): q [B, H, D] -> f32 [B, H, D]. K3b
    serves every S: at S > 8192 the JAX package switches to its
    key-chunked kernel (``_decode_attention_stacked_chunked``), whose
    online softmax over key chunks K3b already is."""
    if k_cache.dim() != 5:
        raise NotImplementedError(
            "the per-layer 4-D cache path (_attn_kernel, pallas_attention.py:671) is not ported yet"
        )
    if softcap or alibi_slopes is not None or window is not None:
        raise NotImplementedError(
            "logit softcap, ALiBi and sliding-window masking are not wired into "
            "decode_attn_int8 yet"
        )
    return decode_attn_int8(q, k_cache, v_cache, k_scale, v_scale, lengths, layer)


# ---------------------------------------------------------------------------
# K6 decode_attention_ring
# ---------------------------------------------------------------------------


def _check_rings(name, k_cache, ring_k, ring_v):
    L, B, Hkv, _, D = k_cache.shape
    want = (L, B, Hkv, RING, D)
    for r in (ring_k, ring_v):
        if r.dtype != torch.bfloat16 or tuple(r.shape) != want or not r.is_contiguous():
            raise ValueError(f"{name}: rings must be contiguous bf16 {list(want)}")


def decode_attention_ring_plain(
    q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, ring_k, ring_v, lengths, layer
) -> torch.Tensor:
    """The plain version of K6 (the JAX kernel's one-shot softmax):
    q [B, H, D], k_new / v_new [B, Hkv, D] -> f32 [B, H, D]; appends
    bf16(k_new) / bf16(v_new) to ring slot lengths - flushed in place."""
    B, H, d = q.shape
    Hkv = k_cache.shape[2]
    n_rep = H // Hkv
    dev = q.device
    qg = (q.to(torch.float32) * (d**-0.5)).reshape(B, Hkv, n_rep, d)
    qg = qg.to(torch.bfloat16).to(torch.float32)
    length = lengths.to(torch.int64)
    flushed = (length // RING) * RING
    nring = length - flushed
    ninf = torch.tensor(float("-inf"), device=dev)
    # int8 rows [0, flushed), k scale on the score columns
    s_c = (qg @ k_cache[layer].to(torch.float32).transpose(-1, -2)) * k_scale[layer][:, :, None, :]
    col = torch.arange(k_cache.shape[3], device=dev)
    s_c = torch.where((col[None, :] < flushed[:, None])[:, None, None, :], s_c, ninf)
    # bf16 ring rows [flushed, length)
    s_r = qg @ ring_k[layer].to(torch.float32).transpose(-1, -2)  # [B, Hkv, n_rep, RING]
    rcol = torch.arange(RING, device=dev)
    s_r = torch.where((rcol[None, :] < nring[:, None])[:, None, None, :], s_r, ninf)
    # the current token, in f32
    kn = k_new.to(torch.float32)[:, :, None, :]
    vn = v_new.to(torch.float32)[:, :, None, :]
    s_n = (qg * kn).sum(dim=-1, keepdim=True)
    m = torch.maximum(torch.maximum(s_c.amax(-1, keepdim=True), s_r.amax(-1, keepdim=True)), s_n)
    p_c, p_r, p_n = torch.exp(s_c - m), torch.exp(s_r - m), torch.exp(s_n - m)
    den = p_c.sum(-1, keepdim=True) + p_r.sum(-1, keepdim=True) + p_n
    pv = (p_c * v_scale[layer][:, :, None, :]).to(torch.bfloat16).to(torch.float32)
    out = pv @ v_cache[layer].to(torch.float32)
    out = out + p_r.to(torch.bfloat16).to(torch.float32) @ ring_v[layer].to(torch.float32)
    out = (out + p_n * vn) / den
    b = torch.arange(B, device=dev)
    ring_k[layer, b, :, nring] = k_new.to(ring_k.dtype)
    ring_v[layer, b, :, nring] = v_new.to(ring_v.dtype)
    return out.reshape(B, H, d)


def decode_attention_ring(
    q: torch.Tensor,  # [B, H, D] bf16
    k_new: torch.Tensor,  # [B, Hkv, D] this step's k (post-rope), bf16 (any float on the CPU)
    v_new: torch.Tensor,
    k_cache: torch.Tensor,  # [L, B, Hkv, S, D] int8, read only
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, Hkv, S] f32
    v_scale: torch.Tensor,
    ring_k: torch.Tensor,  # [L, B, Hkv, RING, D] bf16, slot appended in place
    ring_v: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 = pos: past tokens, the current one excluded
    layer: int,
) -> torch.Tensor:
    """K6: fused decode attention + KV append over a layer-stacked int8
    cache and its bf16 rings -> attn f32 [B, H, D]. The JAX function
    returns new rings; here the current token's k/v land in ring slot
    lengths - flushed in place. The int8 cache is not written: the
    driver flushes full rings with ``kv_ring_flush`` every RING steps."""
    args = (q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, ring_k, ring_v, lengths, layer)
    if not _build.use_kernel(q, "decode_attention_ring"):
        return decode_attention_ring_plain(*args)
    _check_cache("decode_attention_ring", k_cache, v_cache, k_scale, v_scale, layer)
    _check_rings("decode_attention_ring", k_cache, ring_k, ring_v)
    L, B, Hkv, S, D = k_cache.shape
    if q.dim() != 3 or q.shape[0] != B or q.shape[2] != D or q.shape[1] % Hkv:
        raise ValueError("decode_attention_ring: q must be [B, H, D] with H a multiple of Hkv")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode_attention_ring: q must be bf16, got {q.dtype}")
    if tuple(k_new.shape) != (B, Hkv, D) or v_new.shape != k_new.shape:
        raise ValueError("decode_attention_ring: k_new/v_new must be [B, Hkv, D]")
    if k_new.dtype != torch.bfloat16 or v_new.dtype != torch.bfloat16:
        raise ValueError("decode_attention_ring: k_new/v_new must be bf16")
    n_rep = q.shape[1] // Hkv
    if n_rep > _MAX_REP or D > _MAX_D or D % 16:
        raise ValueError(f"decode_attention_ring: n_rep <= {_MAX_REP}, D <= {_MAX_D}, D % 16 == 0")
    if tuple(lengths.shape) != (B,):
        raise ValueError("decode_attention_ring: lengths must be [B]")
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    code = lib.qllm_decode_attn_ring(
        q.data_ptr(),
        k_new.data_ptr(),
        v_new.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        k_scale.data_ptr(),
        v_scale.data_ptr(),
        ring_k.data_ptr(),
        ring_v.data_ptr(),
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
    _build.check("decode_attention_ring", code)
    decode_attention_ring.launches += 1
    return out


decode_attention_ring.launches = 0


# ---------------------------------------------------------------------------
# K7 kv_ring_flush
# ---------------------------------------------------------------------------


def kv_ring_flush_plain(k_cache, v_cache, k_scale, v_scale, ring_k, ring_v, pos) -> None:
    """The plain version of K7: rings [L, B, Hkv, RING, D] -> int8 rows
    [pos[b] - RING, pos[b]) of every layer and their scales, in place."""
    B = k_cache.shape[1]
    dev = k_cache.device
    rows = pos.to(torch.int64)[:, None] - RING + torch.arange(RING, device=dev)[None, :]  # [B, RING]
    b = torch.arange(B, device=dev)[:, None]
    for ring, cache, scale in ((ring_k, k_cache, k_scale), (ring_v, v_cache, v_scale)):
        q, s = _quantize_kv(ring)  # [L, B, Hkv, RING, D], [L, B, Hkv, RING]
        # advanced indices (b, rows) around the Hkv slice go first: [B, RING, L, Hkv, ...]
        cache[:, b, :, rows] = q.permute(1, 3, 0, 2, 4)
        scale[:, b, :, rows] = s.permute(1, 3, 0, 2)


def kv_ring_flush(
    k_cache: torch.Tensor,  # [L, B, Hkv, S, D] int8, rows written in place
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, Hkv, S] f32, written in place
    v_scale: torch.Tensor,
    ring_k: torch.Tensor,  # [L, B, Hkv, RING, D] bf16, FULL rings
    ring_v: torch.Tensor,
    pos: torch.Tensor,  # [B] int32: the position AFTER the group, a multiple of RING
) -> None:
    """K7: quantize every layer's full ring into the int8 rows
    [pos - RING, pos), one launch for the whole model (the counterpart of
    ``kv_ring_flush_pallas``, which returns new arrays)."""
    if not _build.use_kernel(k_cache, "kv_ring_flush"):
        return kv_ring_flush_plain(k_cache, v_cache, k_scale, v_scale, ring_k, ring_v, pos)
    _check_cache("kv_ring_flush", k_cache, v_cache, k_scale, v_scale, 0)
    _check_rings("kv_ring_flush", k_cache, ring_k, ring_v)
    L, B, Hkv, S, D = k_cache.shape
    if tuple(pos.shape) != (B,):
        raise ValueError("kv_ring_flush: pos must be [B]")
    if D > _MAX_D:
        raise ValueError(f"kv_ring_flush: D <= {_MAX_D}")
    pos = pos.to(torch.int32).contiguous()
    lib = _build.load_library()
    code = lib.qllm_kv_ring_flush(
        ring_k.data_ptr(),
        ring_v.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        k_scale.data_ptr(),
        v_scale.data_ptr(),
        pos.data_ptr(),
        L,
        B,
        Hkv,
        S,
        D,
        _build.stream(k_cache),
    )
    _build.check("kv_ring_flush", code)
    kv_ring_flush.launches += 1


kv_ring_flush.launches = 0
