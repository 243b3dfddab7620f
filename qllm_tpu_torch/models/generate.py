"""Generation: prefill + decode with the quantized KV cache (the
counterpart of ``qllm_tpu/models/generate.py``). PyTorch runs eagerly,
so there is no compiled step: each call runs the layers directly.

Each function takes ``device`` ("cuda" unless the caller asks for the
CPU) and raises when the card is asked for and absent; the tokens are
moved there and the params and cache must already live there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..ops.kv_cache import QuantizedKVCache
from ..utils.device import resolve_device
from .llama import ModelConfig, forward

__all__ = ["prefill", "decode_step", "greedy_generate", "make_cache"]

Device = Union[str, torch.device]


def make_cache(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    quantized_kv: bool = True,
    ring: bool = False,
    device: Device = "cuda",
) -> QuantizedKVCache:
    """An empty KV cache for ``cfg``. ``ring=True`` adds the bf16 rings of
    the ring-fused decode path (``decode_loop`` flushes them every 8
    steps); it needs ``quantized_kv`` and ``max_seq % 8 == 0``."""
    return QuantizedKVCache.create(
        cfg.num_hidden_layers,
        batch,
        max_seq,
        cfg.num_key_value_heads,
        cfg.hd,
        quantized=quantized_kv,
        ring=ring,
        device=device,
    )


def _on(cache: QuantizedKVCache, tokens: torch.Tensor, device: Device) -> torch.Tensor:
    dev = resolve_device(device)
    if cache.device.type != dev.type:
        raise ValueError(f"the cache lives on {cache.device}, not on {dev}")
    return tokens.to(cache.device)


@torch.no_grad()
def prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T]
    cache: QuantizedKVCache,
    device: Device = "cuda",
) -> Tuple[torch.Tensor, QuantizedKVCache]:
    """Run the prompt through the model, filling cache[0:T) in place.
    Returns (last-token logits [B, V], cache)."""
    tokens = _on(cache, tokens, device)
    logits, cache = forward(params, cfg, tokens, cache, pos=0)
    return logits[:, -1, :], cache


@torch.no_grad()
def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    token: torch.Tensor,  # [B, 1]
    cache: QuantizedKVCache,
    pos: Union[int, torch.Tensor],  # index where this token is written
    device: Device = "cuda",
) -> Tuple[torch.Tensor, QuantizedKVCache]:
    token = _on(cache, token, device)
    logits, cache = forward(params, cfg, token, cache, pos=pos)
    return logits[:, -1, :], cache


@torch.no_grad()
def greedy_generate(
    params: Dict[str, Any],
    cfg: ModelConfig,
    prompt: torch.Tensor,  # [B, T]
    max_new_tokens: int,
    max_seq: Optional[int] = None,
    quantized_kv: bool = True,
    eos_token_id: Optional[int] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """Greedy decode. Returns [B, T + max_new_tokens] token ids (fewer
    when every row has emitted ``eos_token_id``)."""
    B, T = prompt.shape
    max_seq = max_seq or (T + max_new_tokens)
    cache = make_cache(cfg, B, max_seq, quantized_kv, device=device)
    prompt = prompt.to(cache.device)
    logits, cache = prefill(params, cfg, prompt, cache, device=device)
    out = [prompt]
    token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    finished = torch.zeros((B,), dtype=torch.bool, device=cache.device)
    for i in range(max_new_tokens):
        out.append(token)
        if eos_token_id is not None:
            finished = finished | (token[:, 0] == eos_token_id)
            if bool(finished.all()):
                break
        if i == max_new_tokens - 1:
            break
        logits, cache = decode_step(params, cfg, token, cache, T + i, device=device)
        token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return torch.cat([t.to(torch.int32) for t in out], dim=1)
