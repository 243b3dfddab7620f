"""Synthetic quantized models for tests and throughput measurements
(the dense part of the counterpart of ``qllm_tpu/utils/testing.py``).

Packed weights are drawn directly (random bits + sane scales) from a
``torch.Generator`` on the target device, so a 7B-shaped model is built
on the card without ever allocating dense weights. The same seed gives
other numbers than ``jax.random``: tests that compare with the JAX
package carry its params across with ``interop.params_from_numpy``.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from ..models.llama import LINEAR_NAMES, ModelConfig
from ..quant.qtensor import QuantizedTensor
from .device import resolve_device

__all__ = ["random_quantized_tensor", "random_quantized_params"]


def random_quantized_tensor(
    gen: torch.Generator,
    in_features: int,
    out_features: int,
    bits: int = 4,
    group_size: int = 128,
    scale: float = 0.01,
) -> QuantizedTensor:
    """Random words, scales uniform in [0.5, 1.5) * scale (fp16), zeros
    at mid-range, on ``gen``'s device."""
    K, N = in_features, out_features
    dev = gen.device
    rows = K // (32 // bits) if bits in (2, 4, 8) else bits * K // 32
    qweight = torch.randint(
        -(2**31), 2**31, (rows, N), dtype=torch.int32, device=dev, generator=gen
    )
    G = 1 if group_size == -1 else K // group_size
    scales = ((torch.rand((G, N), device=dev, generator=gen) + 0.5) * scale).to(torch.float16)
    zeros = torch.full((G, N), (1 << bits) / 2.0, dtype=torch.float16, device=dev)
    return QuantizedTensor(
        qweight=qweight,
        scales=scales,
        zeros=zeros,
        perm=None,
        bits=bits,
        group_size=group_size,
        in_features=K,
        out_features=N,
        sym=False,
    )


def random_quantized_params(
    cfg: ModelConfig,
    seed: int,
    bits: int = 4,
    group_size: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    quantize_lm_head: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """Random W-quantized dense-model params with dense embed/norm and,
    when ``quantize_lm_head``, a packed lm_head."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    shapes = {
        "q_proj": (D, H * hd),
        "k_proj": (D, Hkv * hd),
        "v_proj": (D, Hkv * hd),
        "o_proj": (H * hd, D),
        "gate_proj": (D, I),
        "up_proj": (D, I),
        "down_proj": (I, D),
    }
    if cfg.num_local_experts:
        raise NotImplementedError("MoE params are not in this slice")
    layers = []
    for _ in range(cfg.num_hidden_layers):
        lp = {
            "input_layernorm": torch.ones((D,), dtype=dtype, device=dev),
            "post_attention_layernorm": torch.ones((D,), dtype=dtype, device=dev),
        }
        for name in LINEAR_NAMES:
            Kf, Nf = shapes[name]
            lp[name] = random_quantized_tensor(gen, Kf, Nf, bits, group_size)
        layers.append(lp)
    embed = (torch.randn((V, D), device=dev, generator=gen) * 0.02).to(dtype)
    if quantize_lm_head:
        lm_head = random_quantized_tensor(gen, D, V, bits, group_size)
    else:
        lm_head = (torch.randn((D, V), device=dev, generator=gen) * 0.02).to(dtype)
    return {
        "embed_tokens": embed,
        "layers": layers,
        "norm": torch.ones((D,), dtype=dtype, device=dev),
        "lm_head": lm_head,
    }
