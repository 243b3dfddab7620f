"""Llama-family causal LM over a params dict."""

from .generate import decode_step, greedy_generate, make_cache, prefill
from .llama import ModelConfig, forward

__all__ = [
    "ModelConfig",
    "forward",
    "greedy_generate",
    "prefill",
    "decode_step",
    "make_cache",
]
