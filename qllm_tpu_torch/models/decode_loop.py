"""Multi-step greedy decode (the counterpart of
``qllm_tpu/models/decode_loop.py``, ring-less branch).

The JAX package keeps the token loop on the device with ``lax.scan``;
here it is a Python loop of eager steps whose argmax stays on the
device, so no step waits for the host. Capturing the step in a CUDA
graph is later work.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

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
    the cache is updated in place."""
    dev = resolve_device(device)
    if cache.device.type != dev.type:
        raise ValueError(f"the cache lives on {cache.device}, not on {dev}")
    if cache.ring_k is not None:
        # the ring-fused branch (flush every 8 steps) is not ported yet
        raise ValueError(
            "ring-fused decode needs decode_attention_ring and kv_ring_flush_pallas, "
            "not ported yet; use a ring-less cache"
        )
    if not 0 <= pos0 <= cache.max_seq - steps:
        raise ValueError(f"{steps} steps from position {pos0} run past max_seq {cache.max_seq}")
    token = token.to(cache.device)
    toks = []
    for i in range(steps):
        logits, cache = forward(params, cfg, token, cache, pos=pos0 + i)
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks.append(token)
    if not toks:
        return torch.zeros((token.shape[0], 0), dtype=torch.int32, device=cache.device), cache
    return torch.cat(toks, dim=1), cache
