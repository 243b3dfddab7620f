"""Carry params across from the JAX package, leaf by leaf.

``params_from_numpy(tree)`` takes the JAX params as nested dicts and
lists of numpy arrays (for example ``jax.tree_util.tree_map(np.asarray,
params)``) and returns the port's params with the same structure:

  * an object with ``qweight / scales / zeros / perm / bits / group_size
    / in_features / out_features / sym / planar / zeros_prefolded``
    becomes a ``QuantizedTensor`` (per-layer 2-D or stacked [L]-leading);
  * ``uint32`` words arrive as the ``int32`` tensor with the same bits;
  * numpy bfloat16 (ml_dtypes) arrays become ``torch.bfloat16`` tensors;
  * MoE leaves carry across the same way: per-expert lists, raw or
    prepared ``experts_stacked`` stacks, the f32 router, the q/k head-norm
    weights; ``_moe_stride`` (a Python int in the JAX params, a 0-d array
    after a tree map) stays a Python int.

``cache_from_numpy(cache)`` carries a JAX ``QuantizedKVCache`` across
the same way (its arrays as numpy, rings included), so a test can start
both packages from one cache.

It imports nothing of JAX: the leaves are recognised by their fields.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .ops.kv_cache import QuantizedKVCache
from .quant.qtensor import QuantizedTensor
from .utils.device import resolve_device

__all__ = ["params_from_numpy", "tensor_from_numpy", "cache_from_numpy"]

_QT_FIELDS = (
    "qweight",
    "scales",
    "zeros",
    "perm",
    "bits",
    "group_size",
    "in_features",
    "out_features",
    "sym",
    "planar",
    "zeros_prefolded",
)


def tensor_from_numpy(a, device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """One numpy array -> tensor with the same bits on ``device``."""
    a = np.array(a, order="C")  # a writable copy: arrays from JAX are read-only
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def _is_qt(obj) -> bool:
    return all(hasattr(obj, f) for f in _QT_FIELDS)


def params_from_numpy(tree: Any, device: Union[str, torch.device] = "cuda") -> Any:
    """Convert a params tree (dicts, lists, quantized leaves, arrays)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: int(np.asarray(v)) if k == "_moe_stride" else conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if _is_qt(node):
            return QuantizedTensor(
                qweight=tensor_from_numpy(node.qweight, dev),
                scales=tensor_from_numpy(node.scales, dev),
                zeros=tensor_from_numpy(node.zeros, dev),
                perm=None if node.perm is None else tensor_from_numpy(node.perm, dev),
                bits=int(node.bits),
                group_size=int(node.group_size),
                in_features=int(node.in_features),
                out_features=int(node.out_features),
                sym=bool(node.sym),
                planar=bool(node.planar),
                zeros_prefolded=bool(node.zeros_prefolded),
            )
        if node is None or isinstance(node, (int, float, bool, str)):
            return node
        return tensor_from_numpy(node, dev)

    return conv(tree)


def cache_from_numpy(cache, device: Union[str, torch.device] = "cuda") -> QuantizedKVCache:
    """A KV cache with ``k / v / k_scale / v_scale / quantized / ring_k /
    ring_v`` fields (numpy arrays or None) -> the port's cache, bit for
    bit, on ``device``."""
    dev = resolve_device(device)

    def conv(a):
        return None if a is None else tensor_from_numpy(a, dev)

    return QuantizedKVCache(
        k=conv(cache.k),
        v=conv(cache.v),
        k_scale=conv(cache.k_scale),
        v_scale=conv(cache.v_scale),
        quantized=bool(cache.quantized),
        ring_k=conv(cache.ring_k),
        ring_v=conv(cache.ring_v),
    )
