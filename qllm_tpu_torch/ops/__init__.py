"""Compute ops: quantized matmul, KV cache and decode attention, each
kernel with its plain PyTorch version beside it."""

from .kv_cache import QuantizedKVCache
from .ref_matmul import qmatmul, qmatmul_ref

__all__ = ["qmatmul", "qmatmul_ref", "QuantizedKVCache"]
