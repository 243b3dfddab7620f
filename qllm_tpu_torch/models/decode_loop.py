"""Multi-step greedy decode (the counterpart of
``qllm_tpu/models/decode_loop.py``).

The JAX package keeps the token loop on the device with ``lax.scan``;
here it is a Python loop of eager steps whose argmax stays on the
device, so no step waits for the host. Capturing the step in a CUDA
graph is later work.

On a ring-fused cache the steps run in groups of 8: the attention
kernel appends each token's k/v to the bf16 ring, and after each group
one all-layers launch (ops.attention.kv_ring_flush) quantizes the full
rings into the int8 cache.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..ops.attention import RING, kv_ring_flush
from ..ops.kv_cache import QuantizedKVCache
from ..utils.device import resolve_device
from .llama import ModelConfig, forward

__all__ = ["decode_loop"]


@torch.no_grad()
def decode_loop(
    params,
    cfg: ModelConfig,
    token: torch.Tensor,  # [B, 1] int32
    cache: QuantizedKVCache,
    pos0: int,
    steps: int,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, QuantizedKVCache]:
    """Decode ``steps`` greedy tokens. Returns ([B, steps] int32, cache);
    the cache is updated in place. A ring-fused cache needs ``steps`` and
    ``pos0`` to be multiples of 8: the flush writes whole rings, and a
    start off the 8-row grid would leave earlier tokens unflushed (the
    JAX package drops them silently; here that raises)."""
    dev = resolve_device(device)
    if cache.device.type != dev.type:
        raise ValueError(f"the cache lives on {cache.device}, not on {dev}")
    ring = cache.ring_k is not None
    if ring and steps % RING:
        raise ValueError(
            "ring-fused decode needs steps % 8 == 0 (the flush kernel only writes "
            "full rings); pad steps or use a ring-less cache"
        )
    if ring and pos0 % RING:
        raise ValueError(
            f"ring-fused decode needs pos0 % 8 == 0 (got {pos0}): rows [pos0 // 8 * 8, pos0) "
            "would never reach the int8 cache; pad the prompt or use a ring-less cache"
        )
    if not 0 <= pos0 <= cache.max_seq - steps:
        raise ValueError(f"{steps} steps from position {pos0} run past max_seq {cache.max_seq}")
    token = token.to(cache.device)
    toks = []
    for i in range(steps):
        logits, cache = forward(params, cfg, token, cache, pos=pos0 + i)
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks.append(token)
        if ring and (pos0 + i + 1) % RING == 0:
            pos = torch.full((token.shape[0],), pos0 + i + 1, dtype=torch.int32, device=cache.device)
            kv_ring_flush(cache.k, cache.v, cache.k_scale, cache.v_scale, cache.ring_k, cache.ring_v, pos)
    if not toks:
        return torch.zeros((token.shape[0], 0), dtype=torch.int32, device=cache.device), cache
    return torch.cat(toks, dim=1), cache
