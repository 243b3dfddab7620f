"""Synthetic quantized models for tests and throughput measurements
(the dense part of the counterpart of ``qllm_tpu/utils/testing.py``).

Packed weights are drawn directly (random bits + sane scales) from a
``torch.Generator`` on the target device, so a 7B-shaped model is built
on the card without ever allocating dense weights. The same seed gives
other numbers than ``jax.random``: tests that compare with the JAX
package carry its params across with ``interop.params_from_numpy``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

from ..models.llama import LINEAR_NAMES, ModelConfig
from ..quant.qtensor import QuantizedTensor
from .device import resolve_device

__all__ = ["random_quantized_tensor", "random_stacked_expert_tensor", "random_quantized_params"]


def random_quantized_tensor(
    gen: torch.Generator,
    in_features: int,
    out_features: int,
    bits: int = 4,
    group_size: int = 128,
    scale: float = 0.01,
    centered: bool = False,
    act_order: bool = False,
) -> QuantizedTensor:
    """Random words, scales uniform in [0.5, 1.5) * scale (fp16), zeros
    at mid-range, on ``gen``'s device. Words are GPTQ-order for 2, 4 and 8
    bits and plane-major bit planes for 3, 5, 6 and 7 (quant.qtensor).
    Uniform words average 2^(bits-1) - 0.5, so zeros of 2^(bits-1) give
    every column a mean of -0.5 * its scale; ``centered`` puts the zeros
    at 2^(bits-1) - 0.5 (mean 0). ``act_order``: a random int32 ``perm``
    of the K rows (x is gathered by it before the product)."""
    qt = _random_qt(gen, (), in_features, out_features, bits, group_size, scale, centered)
    if act_order:
        perm = torch.randperm(in_features, generator=gen, device=gen.device).to(torch.int32)
        qt = dataclasses.replace(qt, perm=perm)
    return qt


def random_stacked_expert_tensor(
    gen: torch.Generator,
    n_experts: int,
    in_features: int,
    out_features: int,
    bits: int = 4,
    group_size: int = 128,
    scale: float = 0.01,
    centered: bool = False,
) -> QuantizedTensor:
    """A raw [E]-leading expert stack in one draw per field (what stacking
    E ``random_quantized_tensor`` results gives, without E draws)."""
    return _random_qt(gen, (n_experts,), in_features, out_features, bits, group_size, scale, centered)


def _random_qt(gen, lead, K: int, N: int, bits: int, group_size: int, scale: float, centered: bool) -> QuantizedTensor:
    dev = gen.device
    rows = K // (32 // bits) if bits in (2, 4, 8) else bits * K // 32
    qweight = torch.randint(
        -(2**31), 2**31, (*lead, rows, N), dtype=torch.int32, device=dev, generator=gen
    )
    G = 1 if group_size == -1 else K // group_size
    scales = ((torch.rand((*lead, G, N), device=dev, generator=gen) + 0.5) * scale).to(torch.float16)
    zeros = torch.full((*lead, G, N), (1 << bits) / 2.0 - 0.5 * centered, dtype=torch.float16, device=dev)
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
    experts_prestacked: bool = False,
    scale: float = 0.01,
    centered: bool = False,
    act_order: bool = False,
) -> Dict[str, Any]:
    """Random W-quantized params with dense embed/norm and, when
    ``quantize_lm_head``, a packed lm_head; ``scale`` and ``centered`` go
    to every packed weight, ``act_order`` to every layer's (see
    ``random_quantized_tensor``). MoE configs (``num_local_experts``)
    get an f32 router [D, E] and E expert MLPs of width
    ``intermediate_size`` per layer: a per-expert list, or with
    ``experts_prestacked`` raw [E]-leading ``experts_stacked`` tensors with
    gate|up fused, one draw per leaf (``models.moe.stack_experts`` prepares
    them). ``cfg.qk_norm`` adds the q/k head-norm weights."""
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
    E = cfg.num_local_experts
    mlp_names = ("gate_proj", "up_proj", "down_proj")
    names = [n for n in LINEAR_NAMES if n not in mlp_names] if E else LINEAR_NAMES
    layers = []
    for _ in range(cfg.num_hidden_layers):
        lp = {
            "input_layernorm": torch.ones((D,), dtype=dtype, device=dev),
            "post_attention_layernorm": torch.ones((D,), dtype=dtype, device=dev),
        }
        for name in names:
            Kf, Nf = shapes[name]
            lp[name] = random_quantized_tensor(gen, Kf, Nf, bits, group_size, scale, centered, act_order)
        if cfg.qk_norm:
            # rms: one [hd] weight shared by the heads; cohere: per head
            qs, ks = ((hd,), (hd,)) if cfg.qk_norm == "rms" else ((H, hd), (Hkv, hd))
            lp["q_norm"] = torch.ones(qs, dtype=dtype, device=dev)
            lp["k_norm"] = torch.ones(ks, dtype=dtype, device=dev)
        if E:
            lp["router"] = torch.randn((D, E), device=dev, generator=gen) * 0.02
            if experts_prestacked:
                lp["experts_stacked"] = {
                    "gateup_proj": random_stacked_expert_tensor(gen, E, D, 2 * I, bits, group_size, scale, centered),
                    "down_proj": random_stacked_expert_tensor(gen, E, I, D, bits, group_size, scale, centered),
                }
            else:
                lp["experts"] = [
                    {n: random_quantized_tensor(gen, *shapes[n], bits, group_size, scale, centered) for n in mlp_names}
                    for _ in range(E)
                ]
        layers.append(lp)
    embed = (torch.randn((V, D), device=dev, generator=gen) * 0.02).to(dtype)
    if quantize_lm_head:
        lm_head = random_quantized_tensor(gen, D, V, bits, group_size, scale, centered)
    else:
        lm_head = (torch.randn((D, V), device=dev, generator=gen) * 0.02).to(dtype)
    return {
        "embed_tokens": embed,
        "layers": layers,
        "norm": torch.ones((D,), dtype=dtype, device=dev),
        "lm_head": lm_head,
    }
