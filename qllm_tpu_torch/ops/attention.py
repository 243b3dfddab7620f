"""Decode-step KV write and single-query attention over the int8 KV
cache (the counterpart of the 5-D one-shot decode path of
``qllm_tpu/ops/pallas_attention.py``).

  * K3a ``kv_write_int8``: quantize one token's k and v per (batch,
    kv-head) and write them and their scales IN PLACE at ``pos[b]``
    (the JAX kernel returns buffer-aliased arrays instead).
  * K3b ``decode_attn_int8``: GQA attention of one query token over the
    first ``lengths[b]`` cache rows, any number of query heads a kv head;
    the k scale folds into the scores and the v scale into the
    probabilities; optional logit softcap, ALiBi bias and sliding window.
    Blocks take fixed splits of SPLIT_KEYS rows and the last of a
    sequence's splits merges them in the same launch, so it serves every
    S: both the JAX package's one-shot kernel (S <= 8192) and its
    key-chunked one.
  * K22 ``decode_attn_int8_4d``: K3b over one layer's [B, Hkv, S, D]
    cache (the 4-D branch of ``decode_attention_pallas``).
  * K21 ``decode_attn_int8_partial`` (``decode_attention_partial``): the
    unnormalised (acc, m, den) of one sequence shard, which
    ``parallel.sp_decode_attention`` merges across ranks.
  * K6 ``decode_attention_ring``: the ring-fused decode step: one query over the int8 rows
    [0, flushed), the bf16 ring rows [flushed, pos) and the current
    token, whose k/v it appends IN PLACE to ring slot pos - flushed
    (flushed = pos // 8 * 8).
  * K7 ``kv_ring_flush``: every layer's full ring quantized into the
    int8 rows [pos - 8, pos) and their scales, in place, in one launch.

Each wrapper launches its CUDA kernel (csrc/attention.cu) on a CUDA
tensor, or raises, and runs its plain PyTorch version on a CPU tensor.
K3b, K22, K21 and K6 share one device body; their wrappers allocate the
splits' scratch.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .kv_cache import _quantize_kv
from .qmm import _aligned

__all__ = [
    "ONESHOT_S",
    "RING",
    "SPLIT_KEYS",
    "decode_attention_ring",
    "decode_attention_ring_plain",
    "kv_ring_flush",
    "kv_ring_flush_plain",
    "kv_write_int8",
    "kv_write_int8_plain",
    "decode_attn_int8",
    "decode_attn_int8_plain",
    "decode_attn_int8_4d",
    "decode_attn_int8_4d_plain",
    "decode_attn_int8_partial",
    "decode_attn_int8_partial_plain",
    "decode_attention",
    "decode_attention_partial",
]

RING = 8  # ring depth == the rows one flush writes
_MAX_D = 256
_KV_WRITE_MAX_D = 512  # K3a: four 128-wide chunks a lane
# The key rows a block of K3b / K22 / K21 / K6 takes: split j covers rows
# [j * SPLIT_KEYS, (j + 1) * SPLIT_KEYS). A multiple of the kernel's
# 128-key tile, and one constant for every batch, cache length and
# sequence length, so a sequence's bits depend on its own rows alone.
SPLIT_KEYS = 256
_GROUP = 8  # query heads a block serves (a kv head's group is cut into these)
_split_buffers = {}  # device index -> (scratch, arrival counts)


def _check_cache(name, k_cache, v_cache, k_scale, v_scale, layer):
    if k_cache.dtype != torch.int8 or k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches must be int8 [L, B, Hkv, S, D]")
    if k_scale.dtype != torch.float32 or k_scale.shape != k_cache.shape[:4] or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: scales must be f32 [L, B, Hkv, S]")
    for t in (k_cache, v_cache, k_scale, v_scale):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: caches must be contiguous and 16-byte aligned")
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
    """K3a: quantize + write one token per sequence into the cache; one
    warp a (b, kv head, k or v) row, D a multiple of 4 up to 512."""
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
    if D % 4 or D > _KV_WRITE_MAX_D:
        raise ValueError(f"kv_write_int8: head width {D} is not a multiple of 4 up to {_KV_WRITE_MAX_D}")
    # a lane loads 4 consecutive d at once: rows on a 16-byte boundary
    k_new, v_new = (_aligned(t.contiguous()) for t in (k_new, v_new))
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
# K3b decode_attn_int8, K22 decode_attn_int8_4d, K21 decode_attn_int8_partial
# ---------------------------------------------------------------------------

ONESHOT_S = 8192  # decode_attention_pallas's one-shot limit (QLLM_TPU_ATTN_ONESHOT_S default)
_NEG = -1e30  # the partial kernel's mask value (pallas_attention.py:281)


def _group_scores(q, k_cache, k_scale, layer) -> torch.Tensor:
    """bf16(q * d**-0.5) . k_int8 times the k scale: f32 [B, Hkv, n_rep, S]."""
    B, H, d = q.shape
    Hkv = k_cache.shape[2]
    qg = (q.to(torch.float32) * (d**-0.5)).reshape(B, Hkv, H // Hkv, d)
    qg = qg.to(torch.bfloat16).to(torch.float32)
    scores = qg @ k_cache[layer].to(torch.float32).transpose(-1, -2)
    return scores * k_scale[layer][:, :, None, :]


def _pv(p, v_cache, v_scale, layer) -> torch.Tensor:
    """bf16(p * vs) . v_int8: f32 [B, Hkv, n_rep, D]."""
    pv = (p * v_scale[layer][:, :, None, :]).to(torch.bfloat16).to(torch.float32)
    return pv @ v_cache[layer].to(torch.float32)


def decode_attn_int8_plain(
    q, k_cache, v_cache, k_scale, v_scale, lengths, layer, softcap=0.0, alibi_slopes=None, window=None
) -> torch.Tensor:
    """The plain version of K3b (the JAX kernel's one-shot softmax,
    ``_attn_kernel``): q [B, H, D] -> f32 [B, H, D]. The options apply in
    the kernel's order: softcap, the ALiBi bias slopes[h] * s, then the
    mask len - window <= s < len; masked scores are -inf."""
    B, H, d = q.shape
    Hkv, S = k_cache.shape[2], k_cache.shape[3]
    dev = q.device
    _check_window(window, dev)
    scores = _group_scores(q, k_cache, k_scale, layer)
    if softcap:
        scores = softcap * torch.tanh(scores * (1.0 / softcap))
    if alibi_slopes is not None:
        pos = torch.arange(S, dtype=torch.float32, device=dev)
        scores = scores + alibi_slopes.to(torch.float32).reshape(Hkv, H // Hkv, 1) * pos
    col = torch.arange(S, device=dev)
    length = lengths.to(torch.int64)[:, None]
    ok = col[None, :] < length
    if window is not None:
        ok = ok & (col[None, :] >= length - window.to(torch.int64).reshape(1, 1))
    scores = torch.where(ok[:, None, None, :], scores, torch.tensor(float("-inf"), device=dev))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    return (_pv(p, v_cache, v_scale, layer) / denom).reshape(B, H, d)


def decode_attn_int8_4d_plain(
    q, k_cache, v_cache, k_scale, v_scale, lengths, softcap=0.0, alibi_slopes=None, window=None
) -> torch.Tensor:
    """The plain version of K22: K3b's over one layer's [B, Hkv, S, D] cache."""
    caches = (k_cache[None], v_cache[None], k_scale[None], v_scale[None])
    return decode_attn_int8_plain(q, *caches, lengths, 0, softcap, alibi_slopes, window)


def decode_attn_int8_partial_plain(q, k_cache, v_cache, k_scale, v_scale, lengths, layer):
    """The plain version of K21 (``_attn_kernel_stacked_partial``):
    q [B, H, D] over a shard's first lengths[b] rows (lengths may be 0) ->
    (acc f32 [B, H, D] = sum of bf16(p * vs) . v, m f32 [B, H, 1] the
    largest score, den f32 [B, H, 1] = sum of p), p = exp(s - m) on the
    valid rows, masked scores _NEG."""
    B, H, d = q.shape
    S = k_cache.shape[3]
    dev = q.device
    scores = _group_scores(q, k_cache, k_scale, layer)
    valid = (torch.arange(S, device=dev)[None, :] < lengths.to(torch.int64)[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, torch.tensor(_NEG, device=dev))
    m = scores.amax(dim=-1, keepdim=True)  # _NEG when the length is 0
    p = torch.exp(scores - m) * valid.to(torch.float32)  # exp(0) = 1 on an empty shard
    den = p.sum(dim=-1, keepdim=True)
    acc = _pv(p, v_cache, v_scale, layer)
    return acc.reshape(B, H, d), m.reshape(B, H, 1), den.reshape(B, H, 1)


def _check_cache_4d(name, k_cache, v_cache, k_scale, v_scale):
    if k_cache.dtype != torch.int8 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches must be int8 [B, Hkv, S, D]")
    if k_scale.dtype != torch.float32 or k_scale.shape != k_cache.shape[:3] or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: scales must be f32 [B, Hkv, S]")
    for t in (k_cache, v_cache, k_scale, v_scale):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: caches must be contiguous and 16-byte aligned")


def _query_operands(name, q, lengths, B, Hkv, D):
    """Check q [B, H, D] bf16 and lengths [B]; -> (q, lengths int32, n_rep).
    Any n_rep is served; the head width is at most 256, a multiple of 16."""
    if q.dim() != 3 or q.shape[0] != B or q.shape[2] != D or q.shape[1] % Hkv:
        raise ValueError(f"{name}: q must be [B, H, D] with H a multiple of Hkv")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: q must be bf16, got {q.dtype}")
    if D > _MAX_D or D % 16:
        raise ValueError(f"{name}: D <= {_MAX_D}, D % 16 == 0")
    if B * Hkv > 65535:
        raise ValueError(f"{name}: B * Hkv <= 65535")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: lengths must be [B]")
    return q.contiguous(), lengths.to(torch.int32).contiguous(), q.shape[1] // Hkv


def _scratch_floats(B, Hkv, S, D, n_rep) -> int:
    """The f32 words of the splits' scratch: an (acc [8, D], m [8], den [8])
    slot for each (b, kv head, group of 8 query heads, split)."""
    return B * Hkv * -(-n_rep // _GROUP) * -(-S // SPLIT_KEYS) * _GROUP * (D + 2)


def _split_operands(q, B, Hkv, S, D, n_rep):
    """The body's last arguments before the stream: its scratch, its arrival
    counts and the keys a split. Both buffers are kept per device and grow
    when a launch needs more; launches on one stream use them in turn, and
    every launch leaves the counts it used at 0 (they are zeroed once)."""
    scratch, counts = _split_buffers.get(q.device.index, (None, None))
    need = _scratch_floats(B, Hkv, S, D, n_rep)
    if scratch is None or scratch.numel() < need:
        scratch = torch.empty(max(need, 1 << 16), dtype=torch.float32, device=q.device)
    groups = B * Hkv * -(-n_rep // _GROUP)
    if counts is None or counts.numel() < groups:
        counts = torch.zeros(max(groups, 1024), dtype=torch.int32, device=q.device)
    _split_buffers[q.device.index] = (scratch, counts)
    return scratch.data_ptr(), counts.data_ptr(), SPLIT_KEYS


def _check_window(window, device) -> None:
    """The window must be None or one integer in a tensor on ``device``
    (the JAX package traces it; a Python int would be read on the host)."""
    if window is None:
        return
    if not isinstance(window, torch.Tensor) or window.numel() != 1 or window.device != device:
        raise ValueError(f"window must be a tensor holding one int32 on {device}, not {window!r}")


def _window_tensor(window, device) -> Optional[torch.Tensor]:
    """The window as an int32 [1] on the device, never read on the host."""
    _check_window(window, device)
    return None if window is None else window.reshape(1).to(torch.int32).contiguous()


def _launch_one_shot(name, entry, q, caches, lengths, layer_args, B, Hkv, S, D, softcap, alibi_slopes, window):
    """K3b / K22: one launch of the options' instance -> f32 [B, H, D]."""
    q, lengths, n_rep = _query_operands(name, q, lengths, B, Hkv, D)
    slopes = None
    if alibi_slopes is not None:
        if tuple(alibi_slopes.shape) != (q.shape[1],) or alibi_slopes.device != q.device:
            raise ValueError(f"{name}: alibi_slopes must be [H] on {q.device}")
        slopes = alibi_slopes.to(torch.float32).contiguous()
    win = _window_tensor(window, q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    split = _split_operands(q, B, Hkv, S, D, n_rep)
    code = entry(
        q.data_ptr(),
        *(t.data_ptr() for t in caches),
        lengths.data_ptr(),
        out.data_ptr(),
        *layer_args,
        B,
        Hkv,
        S,
        D,
        n_rep,
        float(D**-0.5),
        float(softcap),
        float(1.0 / softcap) if softcap else 0.0,
        _build.ptr(slopes),
        _build.ptr(win),
        *split,
        _build.stream(q),
    )
    _build.check(name, code)
    return out


def decode_attn_int8(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [L, B, Hkv, S, D] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, Hkv, S] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32: attend to cache[:length]
    layer: int,
    softcap: float = 0.0,  # gemma2 logit soft-capping
    alibi_slopes: Optional[torch.Tensor] = None,  # [H] f32 (bloom / mpt position bias)
    window: Optional[torch.Tensor] = None,  # one int32 on q's device: the sliding window (None = off)
) -> torch.Tensor:
    """K3b: -> f32 [B, H, D]. ALiBi past ONESHOT_S rows raises, as the
    JAX package's key-chunked kernel takes no bias."""
    if alibi_slopes is not None and k_cache.shape[3] > ONESHOT_S:
        raise NotImplementedError(
            f"alibi is not served past {ONESHOT_S} cache rows (the JAX package's key-chunked "
            "long-context decode kernel takes no bias)"
        )
    options = (softcap, alibi_slopes, window)
    if not _build.use_kernel(q, "decode_attn_int8"):
        return decode_attn_int8_plain(q, k_cache, v_cache, k_scale, v_scale, lengths, layer, *options)
    _check_cache("decode_attn_int8", k_cache, v_cache, k_scale, v_scale, layer)
    L, B, Hkv, S, D = k_cache.shape
    out = _launch_one_shot(
        "decode_attn_int8", _build.load_library().qllm_decode_attn_int8, q, (k_cache, v_cache, k_scale, v_scale),
        lengths, (layer,), B, Hkv, S, D, *options,
    )
    decode_attn_int8.launches += 1
    return out


decode_attn_int8.launches = 0


def decode_attn_int8_4d(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D] int8: one layer
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [B, Hkv, S] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K22: K3b over a per-layer 4-D cache (the 4-D branch of
    ``decode_attention_pallas``) -> f32 [B, H, D]."""
    options = (softcap, alibi_slopes, window)
    if not _build.use_kernel(q, "decode_attn_int8_4d"):
        return decode_attn_int8_4d_plain(q, k_cache, v_cache, k_scale, v_scale, lengths, *options)
    _check_cache_4d("decode_attn_int8_4d", k_cache, v_cache, k_scale, v_scale)
    B, Hkv, S, D = k_cache.shape
    out = _launch_one_shot(
        "decode_attn_int8_4d", _build.load_library().qllm_decode_attn_int8_4d, q,
        (k_cache, v_cache, k_scale, v_scale), lengths, (), B, Hkv, S, D, *options,
    )
    decode_attn_int8_4d.launches += 1
    return out


decode_attn_int8_4d.launches = 0


def decode_attn_int8_partial(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [L, B, Hkv, S, D] int8: this rank's shard of the sequence
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [L, B, Hkv, S] f32
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 LOCAL lengths into the shard (may be 0)
    layer: int,
):
    """K21: the unnormalised statistics of decode attention over a KV
    shard, (acc f32 [B, H, D], m f32 [B, H, 1], den f32 [B, H, 1]); the
    exact merge over shards i, with m = max_i m_i, is
    out = sum_i acc_i e^(m_i - m) / sum_i den_i e^(m_i - m). An empty
    shard gives m = -1e30, acc = 0, den = 0."""
    if not _build.use_kernel(q, "decode_attn_int8_partial"):
        return decode_attn_int8_partial_plain(q, k_cache, v_cache, k_scale, v_scale, lengths, layer)
    _check_cache("decode_attn_int8_partial", k_cache, v_cache, k_scale, v_scale, layer)
    L, B, Hkv, S, D = k_cache.shape
    q, lengths, n_rep = _query_operands("decode_attn_int8_partial", q, lengths, B, Hkv, D)
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty((B, q.shape[1], 1), dtype=torch.float32, device=q.device)
    den = torch.empty_like(m)
    split = _split_operands(q, B, Hkv, S, D, n_rep)
    code = _build.load_library().qllm_decode_attn_int8_partial(
        q.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        k_scale.data_ptr(),
        v_scale.data_ptr(),
        lengths.data_ptr(),
        acc.data_ptr(),
        m.data_ptr(),
        den.data_ptr(),
        layer,
        B,
        Hkv,
        S,
        D,
        n_rep,
        float(D**-0.5),
        *split,
        _build.stream(q),
    )
    _build.check("decode_attn_int8_partial", code)
    decode_attn_int8_partial.launches += 1
    return acc, m, den


decode_attn_int8_partial.launches = 0

# the JAX package's name for the partial-statistics entry point
decode_attention_partial = decode_attn_int8_partial


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    layer: Optional[int] = None,
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over the int8 cache, the counterpart of
    ``decode_attention_pallas``: q [B, H, D] -> f32 [B, H, D]. A
    layer-stacked [L, B, Hkv, S, D] cache runs K3b on ``layer`` at every S
    (at S > 8192 the JAX package switches to its key-chunked kernel, whose
    online softmax over key chunks K3b already is); a per-layer
    [B, Hkv, S, D] cache runs K22. Both take the logit softcap, ALiBi
    slopes [H] and a sliding window (one int32 on q's device)."""
    args = (q, k_cache, v_cache, k_scale, v_scale, lengths)
    if k_cache.dim() == 5:
        if layer is None:
            raise ValueError("decode_attention: a layer-stacked cache needs the layer")
        return decode_attn_int8(*args, layer, softcap, alibi_slopes, window)
    return decode_attn_int8_4d(*args, softcap, alibi_slopes, window)


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
    q, lengths, n_rep = _query_operands("decode_attention_ring", q, lengths, B, Hkv, D)
    if tuple(k_new.shape) != (B, Hkv, D) or v_new.shape != k_new.shape:
        raise ValueError("decode_attention_ring: k_new/v_new must be [B, Hkv, D]")
    if k_new.dtype != torch.bfloat16 or v_new.dtype != torch.bfloat16:
        raise ValueError("decode_attention_ring: k_new/v_new must be bf16")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    split = _split_operands(q, B, Hkv, S, D, n_rep)
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
        *split,
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
