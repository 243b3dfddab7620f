"""Causal GQA prefill attention (the counterpart of
``prefill_attention_flash`` in ``qllm_tpu/ops/pallas_attention.py``).

  * K5 ``flash_prefill``: query t of sequence b attends to keys
    s <= pos[b] + t; K/V are int8 in the cache's own layout with per-key
    f32 scales (the serving path reads the cache directly) or bf16. The
    CUDA kernel (csrc/flash_prefill.cu) runs both products on the tensor
    cores with an online softmax over key tiles.

The wrapper launches the kernel on a CUDA tensor, or raises, and runs
its plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import _build

__all__ = ["flash_prefill", "flash_prefill_plain", "prefill_attention_flash"]

_MASKED = -1e30  # the TPU kernel's mask value (pallas_attention.py:281)
_KERNEL_D = 128
_MAX_REP = 8


def flash_prefill_plain(q, k, v, k_scale, v_scale, pos, out_dtype) -> torch.Tensor:
    """The plain version of K5 (the JAX kernel's one-shot softmax):
    q [B, T, H, d]; k / v [B, Hkv, S, d] int8 with k_scale / v_scale
    [B, Hkv, S] f32, or bf16 with None; pos [B] -> [B, T, H, d]."""
    B, T, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    qg = (q.to(torch.float32) * (d**-0.5)).to(torch.bfloat16).to(torch.float32)
    qg = qg.reshape(B, T, Hkv, n_rep, d).permute(0, 2, 3, 1, 4)  # [B, Hkv, n_rep, T, d]
    s = qg @ k.to(torch.float32)[:, :, None].transpose(-1, -2)  # [B, Hkv, n_rep, T, S]
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :]
    t = torch.arange(T, device=q.device)
    col = torch.arange(S, device=q.device)
    visible = col[None, None, :] <= pos.to(torch.int64)[:, None, None] + t[None, :, None]  # [B, T, S]
    s = torch.where(visible[:, None, None], s, torch.tensor(_MASKED, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :]
    out = (p.to(torch.bfloat16).to(torch.float32) @ v.to(torch.float32)[:, :, None]) / den
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, d).to(out_dtype)


def _aligned(t: torch.Tensor) -> bool:
    """Every [d]-row of t starts 16-byte aligned and is contiguous."""
    elt = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all((st * elt) % 16 == 0 for st in t.stride()[:-1])


def flash_prefill(
    q: torch.Tensor,  # [B, T, H, d] bf16 (any float on the CPU)
    k: torch.Tensor,  # [B, Hkv, S, d] int8 or bf16 (any strides over a unit d stride)
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # [B, Hkv, S] f32 for int8 K/V, else None
    v_scale: Optional[torch.Tensor],
    pos: torch.Tensor,  # [B] int32: query t sits at absolute position pos[b] + t
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K5: -> [B, T, H, d] in ``out_dtype`` (bf16 or f32)."""
    if not _build.use_kernel(q, "flash_prefill"):
        return flash_prefill_plain(q, k, v, k_scale, v_scale, pos, out_dtype)
    B, T, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_prefill: q must be bf16, got {q.dtype}")
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != d or v.shape != k.shape or H % Hkv:
        raise ValueError("flash_prefill: k/v must be [B, Hkv, S, d] with H a multiple of Hkv")
    n_rep = H // Hkv
    if d != _KERNEL_D or n_rep > _MAX_REP:
        raise ValueError(f"flash_prefill: the kernel takes d == {_KERNEL_D} and n_rep <= {_MAX_REP}")
    int8 = k.dtype == torch.int8
    if int8:
        if v.dtype != torch.int8 or k_scale is None or v_scale is None:
            raise ValueError("flash_prefill: int8 k/v need both scales")
        if k_scale.dtype != torch.float32 or tuple(k_scale.shape) != (B, Hkv, S) or v_scale.shape != k_scale.shape:
            raise ValueError("flash_prefill: scales must be f32 [B, Hkv, S]")
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    elif k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16 or k_scale is not None:
        raise ValueError("flash_prefill: k/v must be int8 with scales or bf16 without")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_prefill: out_dtype must be bf16 or f32, got {out_dtype}")
    if tuple(pos.shape) != (B,):
        raise ValueError("flash_prefill: pos must be [B]")
    if not (_aligned(k) and _aligned(v) and k.stride() == v.stride()):
        k, v = k.contiguous(), v.contiguous()
    q = q.contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lib = _build.load_library()
    code = lib.qllm_flash_prefill(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        _build.ptr(k_scale),
        _build.ptr(v_scale),
        pos.data_ptr(),
        out.data_ptr(),
        B,
        T,
        S,
        Hkv,
        n_rep,
        d,
        k.stride(0),
        k.stride(1),
        k.stride(2),
        int(int8),
        int(out_dtype == torch.float32),
        float(d**-0.5),
        _build.stream(q),
    )
    _build.check("flash_prefill", code)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def prefill_attention_flash(
    q: torch.Tensor,  # [B, T, H, d]
    k: torch.Tensor,  # [B, S, Hkv, d] (or [B, Hkv, S, d] when kv_native)
    v: torch.Tensor,
    pos: Union[int, torch.Tensor],  # scalar or [B]: query t sits at absolute position pos + t
    n_rep: int,
    softcap: float = 0.0,
    window: Optional[torch.Tensor] = None,
    kv_native: bool = False,
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Causal prefill attention with the JAX function's signature: key s
    is visible to query t iff s <= pos + t. ``kv_native`` takes K/V in
    the cache's layout [B, Hkv, S, d]; ``kv_scales`` = (k_scale,
    v_scale) [B, Hkv, S] f32 with int8 K/V (the serving path, fed by
    ``QuantizedKVCache.layer_kv_raw``). Float K/V are rounded to bf16.
    Output [B, T, H, d] in ``out_dtype`` (None = f32, as in JAX)."""
    if softcap or window is not None:
        raise NotImplementedError(
            "logit softcap and sliding-window masking are not wired into flash_prefill yet"
        )
    B, T, H, d = q.shape
    if kv_native:
        kb, vb = k, v
    else:
        if kv_scales is not None:
            raise ValueError("int8 kv_scales need the kv_native layout")
        kb, vb = k.transpose(1, 2), v.transpose(1, 2)  # views, no copy
    if H != kb.shape[1] * n_rep:
        raise ValueError(f"n_rep {n_rep} does not match {H} query heads over {kb.shape[1]} kv heads")
    if kv_scales is None:
        kb, vb = kb.to(torch.bfloat16), vb.to(torch.bfloat16)
        ks = vs = None
    else:
        ks, vs = kv_scales
    if isinstance(pos, int):
        pos_b = torch.full((B,), pos, dtype=torch.int32, device=q.device)
    else:
        pos_b = torch.as_tensor(pos, device=q.device).to(torch.int32).reshape(-1).expand(B)
    return flash_prefill(q, kb, vb, ks, vs, pos_b, torch.float32 if out_dtype is None else out_dtype)
