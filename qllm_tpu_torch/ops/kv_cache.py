"""Quantized (int8) KV cache (the counterpart of
``qllm_tpu/ops/kv_cache.py``).

Layout: k/v ``int8 [L, B, H_kv, S_max, D]``, scales ``[L, B, H_kv, S_max]``
float32, symmetric per (token, head). (S, D) are the trailing dims, so
each (batch, head) slice is a contiguous [S, D] block, which the decode
attention kernel streams.

Unlike the JAX version, which returns new arrays from ``update`` (XLA
aliases them in place), this cache is updated IN PLACE: ``update``
writes into the existing tensors and returns the same object, and the
decode-step write kernel (ops.attention.kv_write_int8) writes into them
too.

``ring=True`` adds the ring-fused decode fields ``ring_k`` / ``ring_v``,
bf16 ``[L, B, H_kv, 8, D]``: the <= 8 newest tokens, appended IN PLACE
by the ring attention kernel (ops.attention.decode_attention_ring) and
flushed into the int8 rows, again in place, once per 8 decode steps
(ops.attention.kv_ring_flush).

``insert_slot`` and ``insert_seq`` (the serving engine's admission and
prefix stamping) also write IN PLACE, one slice copy per field: a 7B
engine cache is ~4.3 GB, and a functional copy per admission would move
all of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..utils.device import resolve_device

__all__ = ["QuantizedKVCache"]


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] float -> (int8 [..., D], scale [...]) symmetric
    per-vector, round half to even."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor: PyTorch on CUDA multiplies by the reciprocal of a
    # Python-scalar divisor, which is not the IEEE quotient jnp computes
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class QuantizedKVCache:
    """KV cache for all layers. When quantized=False, k/v hold ``dtype``
    and the scale tensors are size-1 placeholders. ``ring_k`` / ``ring_v``
    are the ring-fused decode fields, or None for the per-token write
    path."""

    k: torch.Tensor  # [L, B, H_kv, S, D] int8 or bf16
    v: torch.Tensor
    k_scale: torch.Tensor  # [L, B, H_kv, S] f32 (placeholder if not quantized)
    v_scale: torch.Tensor
    quantized: bool
    ring_k: Optional[torch.Tensor] = None  # [L, B, H_kv, 8, D] bf16 or None
    ring_v: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls,
        n_layers: int,
        batch: int,
        max_seq: int,
        n_kv_heads: int,
        head_dim: int,
        quantized: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        ring: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> "QuantizedKVCache":
        if ring and not quantized:
            raise ValueError("the ring-fused path needs a quantized cache")
        if ring and max_seq % 8:
            raise ValueError("ring-fused path needs max_seq % 8 == 0")
        dev = resolve_device(device)
        shape = (n_layers, batch, n_kv_heads, max_seq, head_dim)
        if quantized:
            kv_dtype = torch.int8
            sshape = (n_layers, batch, n_kv_heads, max_seq)
        else:
            kv_dtype = dtype
            sshape = (1,)
        rshape = (n_layers, batch, n_kv_heads, 8, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=kv_dtype, device=dev),
            v=torch.zeros(shape, dtype=kv_dtype, device=dev),
            k_scale=torch.ones(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.ones(sshape, dtype=torch.float32, device=dev),
            quantized=quantized,
            ring_k=torch.zeros(rshape, dtype=torch.bfloat16, device=dev) if ring else None,
            ring_v=torch.zeros(rshape, dtype=torch.bfloat16, device=dev) if ring else None,
        )

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def device(self) -> torch.device:
        return self.k.device

    def update(
        self,
        layer: int,
        k_new: torch.Tensor,
        v_new: torch.Tensor,
        pos: Union[int, torch.Tensor],
    ) -> "QuantizedKVCache":
        """Write k_new/v_new [B, T, H_kv, D] at time offset ``pos``, in
        place. ``pos`` is an int (all sequences aligned) or an int tensor,
        scalar or [B] per-slot offsets."""
        k_new = k_new.transpose(1, 2)  # -> [B, H, T, D]
        v_new = v_new.transpose(1, 2)
        B, _, T, _ = k_new.shape
        if self.quantized:
            kq, ks = _quantize_kv(k_new)
            vq, vs = _quantize_kv(v_new)
        else:
            kq, vq = k_new.to(self.k.dtype), v_new.to(self.v.dtype)
        if isinstance(pos, int):
            self.k[layer, :, :, pos : pos + T] = kq
            self.v[layer, :, :, pos : pos + T] = vq
            if self.quantized:
                self.k_scale[layer, :, :, pos : pos + T] = ks
                self.v_scale[layer, :, :, pos : pos + T] = vs
            return self
        # per-slot offsets: rows pos[b] + t of batch b (advanced indices
        # around a slice put the [B, T] index dims first)
        p = torch.as_tensor(pos, device=self.device).to(torch.int64).reshape(-1).expand(B)
        s_idx = p[:, None] + torch.arange(T, device=self.device)[None, :]
        b_idx = torch.arange(B, device=self.device)[:, None]
        self.k[layer][b_idx, :, s_idx] = kq.transpose(1, 2)
        self.v[layer][b_idx, :, s_idx] = vq.transpose(1, 2)
        if self.quantized:
            self.k_scale[layer][b_idx, :, s_idx] = ks.transpose(1, 2)
            self.v_scale[layer][b_idx, :, s_idx] = vs.transpose(1, 2)
        return self

    def insert_slot(self, slot: int, other: "QuantizedKVCache") -> "QuantizedKVCache":
        """Copy a batch-1 cache (a finished prefill) into batch slot
        ``slot``, rows [0, other.max_seq), in place; returns self. Rows past
        other.max_seq keep what they held (never visible: the slot's
        lengths stop short of them)."""
        S = other.max_seq
        if other.k.shape[1] != 1 or S > self.max_seq or other.quantized != self.quantized:
            raise ValueError(f"insert_slot: needs a batch-1 cache of <= {self.max_seq} rows of the same kind")
        if not 0 <= slot < self.k.shape[1]:
            raise IndexError(f"insert_slot: slot {slot} out of range [0, {self.k.shape[1]})")
        self.k[:, slot : slot + 1, :, :S].copy_(other.k)
        self.v[:, slot : slot + 1, :, :S].copy_(other.v)
        if self.quantized:
            self.k_scale[:, slot : slot + 1, :, :S].copy_(other.k_scale)
            self.v_scale[:, slot : slot + 1, :, :S].copy_(other.v_scale)
        return self

    def insert_seq(self, other: "QuantizedKVCache", offset: int = 0) -> "QuantizedKVCache":
        """Copy ``other``'s rows into rows [offset, offset + other.max_seq),
        in place (batch sizes match; quantized rows travel with their
        scales); returns self. Used by prefix caching: a stored prefix cache
        is stamped into a fresh admission cache. A window that runs past the
        end starts at max_seq - other.max_seq instead, as JAX's
        dynamic_update_slice clamps it."""
        S = other.max_seq
        if other.k.shape[1] != self.k.shape[1] or S > self.max_seq or other.quantized != self.quantized:
            raise ValueError("insert_seq: needs a cache of the same batch and kind, no longer than this one")
        o = max(0, min(int(offset), self.max_seq - S))
        self.k[:, :, :, o : o + S].copy_(other.k)
        self.v[:, :, :, o : o + S].copy_(other.v)
        if self.quantized:
            self.k_scale[:, :, :, o : o + S].copy_(other.k_scale)
            self.v_scale[:, :, :, o : o + S].copy_(other.v_scale)
        return self

    def layer_kv(self, layer: int, dtype: torch.dtype = torch.bfloat16, length: Optional[int] = None):
        """Dequantized (k, v) [B, S, H_kv, D] for the plain attention path;
        ``length``: only rows [0, length) (the keys a forward can see)."""
        S = self.max_seq if length is None else length
        k = self.k[layer, :, :, :S]
        v = self.v[layer, :, :, :S]
        if self.quantized:
            k = k.to(torch.float32) * self.k_scale[layer, :, :, :S][..., None]
            v = v.to(torch.float32) * self.v_scale[layer, :, :, :S][..., None]
        return k.to(dtype).transpose(1, 2), v.to(dtype).transpose(1, 2)

    def layer_kv_raw(self, layer: int):
        """Raw int8 (k, v, k_scale, v_scale) [B, H, S, D] of one layer."""
        return self.k[layer], self.v[layer], self.k_scale[layer], self.v_scale[layer]
