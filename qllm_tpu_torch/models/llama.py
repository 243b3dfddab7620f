"""Llama-family causal LM as plain functions over a params dict (the
counterpart of ``qllm_tpu/models/llama.py``).

Params keep the JAX pytree's shape: ``{"embed_tokens", "layers": [per-
layer dicts] or {stacked leaves}, "norm", "lm_head"}``, where every linear
leaf is a dense ``[in, out]`` tensor or a ``QuantizedTensor``. Numerics
follow the JAX package: bf16 activations, f32 norms, rope and softmax,
bf16 x bf16 products accumulated in f32.

This slice serves the llama family (GQA + neox RoPE + SwiGLU + RMSNorm)
and its MoE members, Mixtral (top-k softmax router) and Qwen3-MoE
(softmax-all router with top-k renormalisation, per-head RMS q/k norm).
``ModelConfig`` carries every field of the JAX config so configs pass
across unchanged; switches of other families raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..ops.attention import decode_attention, decode_attention_ring, kv_write_int8
from ..ops.flash_prefill import prefill_attention_flash
from ..ops.kv_cache import QuantizedKVCache
from ..ops.qmm import _mean_sq
from ..ops.ref_matmul import qmatmul
from ..quant.qtensor import QuantizedTensor
from ..utils.device import resolve_device

__all__ = [
    "ModelConfig",
    "forward",
    "alibi_slopes",
    "apply_linear",
    "rms_norm",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling_type: str = ""
    rope_scaling_factor: float = 1.0
    rope_orig_max_position: int = 0
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    arch: str = "llama"
    norm_type: str = "rmsnorm"
    pos_embedding: str = "rope"
    rope_style: str = "neox"
    rotary_dim: int = 0
    mlp_type: str = "gated"
    hidden_act: str = "silu"
    parallel_residual: bool = False
    shared_input_norm: bool = False
    learned_pos_offset: int = 0
    embed_layernorm: bool = False
    embedding_multiplier: float = 1.0
    logit_scale: float = 1.0
    alibi_style: str = "bloom"
    fused_qkv_layout: str = ""
    variant: str = ""
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    sliding_window: int = 0
    swa_pattern: str = "all"
    swa_min_layer: int = 0
    post_norms: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    attn_scale: float = 0.0
    residual_multiplier: float = 1.0
    qk_norm: str = ""
    attn_type: str = "mha"
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    moe_router: str = "mixtral"
    norm_topk_prob: bool = False
    topk_method: str = "greedy"
    n_group: int = 0
    topk_group: int = 0
    routed_scaling_factor: float = 1.0
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    moe_intermediate_size: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def n_rep(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def rot_dim(self) -> int:
        return self.rotary_dim or self.hd


LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")

# config values this slice serves; anything else belongs to a family
# that is not ported yet
_LLAMA_FAMILY = {
    "norm_type": "rmsnorm",
    "pos_embedding": "rope",
    "rope_style": "neox",
    "rotary_dim": 0,
    "rope_scaling_type": "",
    "mlp_type": "gated",
    "parallel_residual": False,
    "learned_pos_offset": 0,
    "embed_layernorm": False,
    "embedding_multiplier": 1.0,
    "logit_scale": 1.0,
    "num_local_experts": 0,
    "sliding_window": 0,
    "post_norms": False,
    "attn_logit_softcap": 0.0,
    "final_logit_softcap": 0.0,
    "attn_scale": 0.0,
    "residual_multiplier": 1.0,
    "qk_norm": "",
    "attn_type": "mha",
}


# the MoE members of the family: experts and the per-head q/k norm
_MOE_ARCHS = ("mixtral", "qwen3_moe")
_MOE_SWITCHES = ("num_local_experts", "qk_norm")


def check_llama_family(cfg: ModelConfig) -> None:
    """Raise on configuration switches outside the llama family (and its
    MoE members, Mixtral and Qwen3-MoE)."""
    off = {k: getattr(cfg, k) for k, v in _LLAMA_FAMILY.items() if getattr(cfg, k) != v}
    if cfg.arch in _MOE_ARCHS:
        for k in _MOE_SWITCHES:
            off.pop(k, None)
        if cfg.qk_norm not in ("", "rms", "cohere"):
            off["qk_norm"] = cfg.qk_norm
    if cfg.hidden_act not in ("silu", "gelu", "gelu_python", "relu"):
        off["hidden_act"] = cfg.hidden_act
    if off:
        raise NotImplementedError(f"not ported yet (llama family only): {off}")


def apply_linear(w, x: torch.Tensor, bias: Optional[torch.Tensor] = None, w4a8: bool = False) -> torch.Tensor:
    """x [..., K] @ w -> [..., N]; w is a dense [K, N] tensor or a
    QuantizedTensor (``w4a8``: int8 activations where the JAX package's
    W4A8 takes them; a dense weight ignores it)."""
    if isinstance(w, QuantizedTensor):
        return qmatmul(x, w, bias, w4a8=w4a8)
    y = (x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def _norm_input(pv, cfg: ModelConfig, h: torch.Tensor, name: str):
    """rms_norm(h, <name>), or a stacked-view NormedX marker that the next
    quantized matmul fuses into its kernel."""
    mk = getattr(pv, "fused_norm_arg", None)
    if mk is not None:
        nx = mk(h, name, cfg)
        if nx is not None:
            return nx
    return rms_norm(h, pv.get(name), cfg.rms_norm_eps)


def _mat(x):
    """Materialise a pending fused norm (stacked.NormedX) if present."""
    return x.materialize() if hasattr(x, "materialize") else x


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    return (xf * torch.rsqrt(_mean_sq(xf) + eps)).to(dt) * weight


def qk_head_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, kind: str = "cohere") -> torch.Tensor:
    """Per-head q/k normalisation over the head dim, x [B, T, H, hd]:
    ``rms`` is RMSNorm with one [hd] weight shared by the heads (Qwen3,
    before rope); ``cohere`` a mean-subtracting layernorm without bias
    and a per-head [H, hd] weight. f32 math, rounded to x.dtype once."""
    xf = x.to(torch.float32)
    w = weight.to(torch.float32)
    if kind == "rms":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w[None, None]).to(x.dtype)


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        # jax.nn.silu's op chain x * (1 / (1 + exp(-x))), each op rounded
        # to x.dtype (F.silu rounds once and differs in the last bf16 bit)
        return x * (1.0 / (1.0 + torch.exp(-x)))
    if name in ("gelu", "gelu_python"):
        return torch.nn.functional.gelu(x)
    if name == "relu":
        return torch.relu(x)
    raise NotImplementedError(f"hidden_act {name}")


def _rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions [B, T] -> neox (rotate-half) cos/sin [B, T, rot_dim]."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=positions.device) / rot_dim
    inv_freq = 1.0 / (theta**exps)
    freqs = positions[..., None].to(torch.float32) * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q [B,T,H,hd], k [B,T,Hkv,hd]; cos/sin [B,T,hd] (neox, full rotary)."""
    c, s = cos[:, :, None, :], sin[:, :, None, :]

    def rope1(x):
        xf = x.to(torch.float32)
        return (xf * c + _rotate_half(xf) * s).to(x.dtype)

    return rope1(q), rope1(k)


def alibi_slopes(n_heads: int, style: str = "bloom", device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """ALiBi head slopes, f32 [n_heads]. For power-of-two head counts both
    dialects give 2^(-8(i+1)/n); they order the extra slopes differently
    for other counts:

    bloom: closest (lower) pow2 slopes + even-indexed slopes of 2x
           (HF modeling_bloom.build_alibi_tensor)
    mpt:   slopes for the CEILING pow2, reordered odd-first
           (HF modeling_mpt.build_mpt_alibi_tensor, alibi_bias_max=8)
    """
    dev = resolve_device(device)

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if style == "mpt":
        n_ceil = 2 ** math.ceil(math.log2(n_heads))
        sl = [2.0 ** (-8.0 * (i + 1) / n_ceil) for i in range(n_ceil)]
        if n_ceil != n_heads:
            sl = (sl[1::2] + sl[0::2])[:n_heads]
    elif math.log2(n_heads).is_integer():
        sl = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        sl = pow2_slopes(closest)
        sl += pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(sl, dtype=torch.float32, device=dev)


def build_mask(
    cfg: ModelConfig, B: int, T: int, S: int, pos: Union[None, int, torch.Tensor], device
) -> torch.Tensor:
    """Additive causal bias [B, 1, T, S] (0 / -inf): key s is visible to
    query t iff s <= pos + t (pos per sequence when a [B] tensor)."""
    t = torch.arange(T, device=device)
    s_idx = torch.arange(S, device=device)
    if pos is None:
        q_pos = t[None, :, None]
    elif isinstance(pos, int) or pos.dim() == 0:
        q_pos = (torch.as_tensor(pos, device=device) + t)[None, :, None]
    else:
        q_pos = pos.to(device)[:, None, None] + t[None, :, None]
    keep = s_idx[None, None, :] <= q_pos
    zero = torch.zeros((), dtype=torch.float32, device=device)
    ninf = torch.full((), float("-inf"), dtype=torch.float32, device=device)
    mask = torch.where(keep, zero, ninf)
    return mask.expand(B, T, S)[:, None]


def _attention(q, k, v, mask, n_rep: int) -> torch.Tensor:
    """Plain causal attention: q [B,T,H,hd], k/v [B,S,Hkv,hd], bf16
    operands with f32 accumulation, f32 softmax."""
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    hd = q.shape[-1]
    qf = q.to(torch.bfloat16).to(torch.float32).transpose(1, 2)  # [B,H,T,hd]
    kf = k.to(torch.bfloat16).to(torch.float32).permute(0, 2, 3, 1)  # [B,H,hd,S]
    logits = (qf @ kf) * (hd**-0.5)
    probs = torch.softmax(logits + mask, dim=-1)
    vf = v.to(torch.bfloat16).to(torch.float32).transpose(1, 2)  # [B,H,S,hd]
    out = probs.to(torch.bfloat16).to(torch.float32) @ vf
    return out.transpose(1, 2).to(q.dtype)


FLASH_PREFILL_MIN_T = 256


def _flash_prefill_ok(cfg: ModelConfig, T: int, hd: int) -> bool:
    """Route attention through prefill_attention_flash (K5) when the
    shape qualifies, as the JAX package does (its ``_flash_prefill_ok``):
    T >= 256, no ALiBi bias, a head width that is a multiple of 128. The
    plain masked path serves everything else."""
    return T >= FLASH_PREFILL_MIN_T and cfg.pos_embedding != "alibi" and hd % 128 == 0


def _check_ring_cfg(cfg: ModelConfig) -> None:
    if cfg.attn_logit_softcap != 0.0 or cfg.pos_embedding == "alibi" or cfg.sliding_window > 0:
        raise NotImplementedError(
            "ring-fused decode applies neither the logit softcap, the alibi bias, nor "
            "sliding-window masking; create the cache with ring=False for such models"
        )


class LayerView:
    """Accessor for one layer's params in a per-layer dict; ``w4a8`` rides
    on the view to every quantized matmul of the layer (the grouped
    expert launches stay a16, as in the JAX package), ``moe_fused`` to the
    batch-1 sparse MoE block."""

    def __init__(self, lp: Dict[str, Any], w4a8: bool = False, moe_fused: bool = False):
        self.lp = lp
        self.w4a8 = w4a8
        self.moe_fused = moe_fused

    def get(self, name):
        return self.lp.get(name)

    def apply(self, name, x):
        return apply_linear(self.lp[name], x, self.lp.get(f"{name}_bias"), w4a8=self.w4a8)

    def apply_expert(self, name, e: int, x):
        """x @ experts_stacked[name][e] for a host-int expert index (the
        dense all-experts loop)."""
        from .moe import expert_linear

        return expert_linear(self.lp["experts_stacked"][name], e, x, w4a8=self.w4a8)

    def apply_experts_grouped(self, name, ids, x_rows, x_shared: bool = False):
        """y[i] = x_rows[i] @ W[ids[i]] for every selection in one launch;
        ``ids`` stays on the device."""
        from .moe import grouped_expert_linear

        return grouped_expert_linear(self.lp["experts_stacked"][name], ids, x_rows, x_shared)

    def fused_expert_mlp(self, ids, x_row, cfg):
        """One token's whole expert MLP for each of its selections in one K19
        launch where it takes the stacks, else None (the per-projection
        grouped path)."""
        from .moe import fused_expert_mlp

        est = self.lp.get("experts_stacked") or {}
        return fused_expert_mlp(est.get("gateup_proj"), est.get("down_proj"), ids, x_row, cfg.hidden_act)


def _pos_vector(pos: Union[int, torch.Tensor], B: int, device) -> torch.Tensor:
    if isinstance(pos, int):
        return torch.full((B,), pos, dtype=torch.int32, device=device)
    return torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1).expand(B).contiguous()


def _host_pos_range(pos) -> Optional[Tuple[int, int]]:
    """(min, max) of ``pos`` when the host holds it (an int, or a tensor on
    the CPU), else None: reading a device tensor would wait on the card."""
    if isinstance(pos, int):
        return pos, pos
    if isinstance(pos, torch.Tensor) and pos.device.type == "cpu":
        return int(pos.min()), int(pos.max())
    return None


def _check_fits(cache: Optional[QuantizedKVCache], pos, T: int) -> None:
    """Raise when T tokens written at a host-held ``pos`` run past the
    cache (on the card K3a would drop the write). A ``pos`` on the card is
    not checked: that would wait on the device."""
    rng = _host_pos_range(pos) if cache is not None else None
    if rng is not None and not (0 <= rng[0] and rng[1] <= cache.max_seq - T):
        raise ValueError(f"tokens [{rng[0]}, {rng[1] + T}) do not fit a cache of max_seq {cache.max_seq}")


def visible_len(cache: QuantizedKVCache, pos, T: int) -> int:
    """The cache rows a T-token forward at ``pos`` can see: pos + T (the
    largest, for per-slot offsets) when the host holds ``pos``, else all
    of them. The plain attention reads only these rows."""
    rng = _host_pos_range(pos)
    return cache.max_seq if rng is None else min(cache.max_seq, rng[1] + T)


def _attn_inputs(cfg: ModelConfig, B: int, T: int, cache, pos, device, kv_len: Optional[int] = None):
    """(mask, slots) for one forward, built once for all layers: a
    one-token step into the int8 cache gets slots = (write positions [B],
    lengths [B]) and no mask, with lengths = pos + 1 for K3a / K3b and
    lengths = pos (the past tokens) for the ring kernel; a call that
    flash prefill takes gets neither; every other call gets the causal
    mask (over the first ``kv_len`` cache rows, default all) and no slots."""
    if cache is not None and T == 1 and cache.quantized:
        pos_b = _pos_vector(pos, B, device)
        return None, (pos_b, pos_b if cache.ring_k is not None else pos_b + 1)
    if _flash_prefill_ok(cfg, T, cfg.hd):
        return None, None
    if cache is None:
        return build_mask(cfg, B, T, T, None, device), None
    return build_mask(cfg, B, T, cache.max_seq if kv_len is None else kv_len, pos, device), None


def _block_attn_mlp(
    pv,
    cfg: ModelConfig,
    h: torch.Tensor,
    cos,
    sin,
    mask,
    cache: Optional[QuantizedKVCache],
    layer_idx: int,
    pos,
    slots=None,
) -> Tuple[torch.Tensor, Optional[QuantizedKVCache]]:
    """One llama block. ``pv`` is a LayerView-like accessor (get/apply);
    ``mask`` and ``slots`` come from ``_attn_inputs`` (the mask's width is
    the number of cache rows the plain attention reads)."""
    B, T, D = h.shape
    H, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd

    x = _norm_input(pv, cfg, h, "input_layernorm")
    q = pv.apply("q_proj", x).reshape(B, T, H, hd)
    k = pv.apply("k_proj", x).reshape(B, T, Hkv, hd)
    v = pv.apply("v_proj", x).reshape(B, T, Hkv, hd)
    if cfg.qk_norm:
        q = qk_head_norm(q, pv.get("q_norm"), cfg.rms_norm_eps, cfg.qk_norm)
        k = qk_head_norm(k, pv.get("k_norm"), cfg.rms_norm_eps, cfg.qk_norm)
    q, k = apply_rope(q, k, cos, sin)

    flash = _flash_prefill_ok(cfg, T, hd)
    if slots is not None and cache.ring_k is not None:
        # ring-fused decode step: K6 appends this token to the bf16 ring
        # itself, no write launch; the driver (decode_loop) flushes full
        # rings into the int8 cache every 8 steps, or tokens drop
        _check_ring_cfg(cfg)
        _, lengths = slots
        attn = decode_attention_ring(
            q[:, 0], k[:, 0], v[:, 0], cache.k, cache.v, cache.k_scale, cache.v_scale,
            cache.ring_k, cache.ring_v, lengths, layer_idx,
        )[:, None].to(h.dtype)
    elif slots is not None:
        # decode step: K3a writes this token into the int8 cache in place,
        # K3b attends over the updated cache
        pos_b, lengths = slots
        kv_write_int8(
            k[:, 0], v[:, 0], cache.k, cache.v, cache.k_scale, cache.v_scale, layer_idx, pos_b
        )
        attn = decode_attention(
            q[:, 0], cache.k, cache.v, cache.k_scale, cache.v_scale, lengths, layer_idx
        )[:, None].to(h.dtype)
    elif cache is not None:
        cache.update(layer_idx, k, v, pos)
        if flash and cache.quantized:
            # K5 reads the int8 cache rows and scales directly
            kr, vr, ks, vs = cache.layer_kv_raw(layer_idx)
            attn = prefill_attention_flash(
                q, kr, vr, pos, cfg.n_rep, softcap=cfg.attn_logit_softcap, kv_native=True,
                kv_scales=(ks, vs), out_dtype=h.dtype,
            )
        else:
            k_all, v_all = cache.layer_kv(layer_idx, dtype=h.dtype, length=None if flash else mask.shape[-1])
            if flash:
                attn = prefill_attention_flash(
                    q, k_all, v_all, pos, cfg.n_rep, softcap=cfg.attn_logit_softcap, out_dtype=h.dtype
                )
            else:
                attn = _attention(q, k_all, v_all, mask, cfg.n_rep)
    elif flash:
        attn = prefill_attention_flash(
            q, k, v, 0, cfg.n_rep, softcap=cfg.attn_logit_softcap, out_dtype=h.dtype
        )
    else:
        attn = _attention(q, k, v, mask, cfg.n_rep)
    return _finish_block(pv, cfg, h, attn.reshape(B, T, H * hd), cache)


def _finish_block(pv, cfg: ModelConfig, h, attn_flat, cache):
    """o_proj -> residual -> gated MLP -> residual."""
    h = h + pv.apply("o_proj", attn_flat)
    x2 = _norm_input(pv, cfg, h, "post_attention_layernorm")
    h = h + _mlp_from_view(pv, cfg, x2)
    return h, cache


def _mlp_from_view(pv, cfg: ModelConfig, x) -> torch.Tensor:
    if pv.get("experts") is not None or pv.get("experts_stacked") is not None:
        if pv.get("shared_experts") is not None:
            raise NotImplementedError(
                "always-on shared experts (deepseek / qwen2-moe) are not ported yet"
            )
        # the router reads the normalised activation itself: no fused norm
        return _moe_forward(pv, cfg, _mat(x))
    gate = pv.apply("gate_proj", x)
    up = pv.apply("up_proj", x)
    return pv.apply("down_proj", act_fn(cfg.hidden_act, gate) * up)


def _routing_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k semantics: the k largest along the last axis, descending,
    ties to the lowest index (a stable descending sort keeps equal values
    in index order; torch.topk promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_topk(pv, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert routing -> ([B, T, k] f32 weights, [B, T, k] expert ids).

    mixtral: top-k of the logits, softmax over the selected k. deepseek
    (and qwen3-moe): softmax over all experts, top-k, then renormalised
    when ``norm_topk_prob`` (qwen renormalises at any k, deepseek-v2 only
    at k > 1), else scaled by ``routed_scaling_factor``."""
    if isinstance(pv, dict):
        pv = LayerView(pv)
    router = pv.get("router")
    logits = x.to(torch.float32) @ router.to(torch.float32)  # [B, T, E]
    E = router.shape[-1]
    k = min(cfg.num_experts_per_tok, E)
    if cfg.moe_router == "deepseek":
        if cfg.topk_method == "group_limited_greedy":
            raise NotImplementedError("group-limited greedy routing is not ported yet")
        scores = torch.softmax(logits, dim=-1)
        top_w, top_ids = _routing_topk(scores, k)
        if cfg.norm_topk_prob and (k > 1 or cfg.arch != "deepseek_v2"):
            top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-20)
        else:
            top_w = top_w * cfg.routed_scaling_factor
    else:
        top_w, top_ids = _routing_topk(logits, k)
        top_w = torch.softmax(top_w, dim=-1)
    return top_w, top_ids


def _router_weights(pv, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense [B, T, E] f32 combination weights (0 for unselected experts).
    The top-k ids are distinct, so a scatter gives the bits of the JAX
    package's one-hot sum, and unlike one_hot it never reads the ids on
    the host."""
    if isinstance(pv, dict):
        pv = LayerView(pv)
    top_w, top_ids = _router_topk(pv, cfg, x)
    E = pv.get("router").shape[-1]
    out = torch.zeros((*top_w.shape[:-1], E), dtype=torch.float32, device=top_w.device)
    return out.scatter_(-1, top_ids.to(torch.int64), top_w.to(torch.float32))


def _moe_forward(pv, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Top-k MoE block. Over [E]-stacked experts with B*T*k < E (decode,
    small batches) only the selected experts run (``_moe_sparse``);
    otherwise every expert runs on every row and the outputs are combined
    with the router's weights, accumulated in f32 in expert order."""
    if isinstance(pv, dict):
        pv = LayerView(pv)
    est = pv.get("experts_stacked")
    B, T, _ = x.shape
    E = pv.get("router").shape[-1]
    k = min(cfg.num_experts_per_tok, E)
    if est is not None and B * T * k < E:
        return _moe_sparse(pv, cfg, x, k)
    weights = _router_weights(pv, cfg, x)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if est is not None:
        fused_gu = "gateup_proj" in est
        for e in range(E):
            if fused_gu:
                gu = pv.apply_expert("gateup_proj", e, x)
                ii = gu.shape[-1] // 2
                gate, up = gu[..., :ii], gu[..., ii:]
            else:
                gate = pv.apply_expert("gate_proj", e, x)
                up = pv.apply_expert("up_proj", e, x)
            ye = pv.apply_expert("down_proj", e, act_fn(cfg.hidden_act, gate) * up)
            out = out + ye.to(torch.float32) * weights[..., e : e + 1]
        return out.to(x.dtype)
    a8 = pv.w4a8
    for e, ep in enumerate(pv.get("experts")):
        gate = apply_linear(ep["gate_proj"], x, w4a8=a8)
        up = apply_linear(ep["up_proj"], x, w4a8=a8)
        ye = apply_linear(ep["down_proj"], act_fn(cfg.hidden_act, gate) * up, w4a8=a8)
        out = out + ye.to(torch.float32) * weights[..., e : e + 1]
    return out.to(x.dtype)


def _grouped_expert_mlp(pv, cfg: ModelConfig, ids, x_rows, x_shared: bool) -> torch.Tensor:
    """gate|up (or gate and up), the activation, then down, each one
    grouped launch over every selection -> [n, D] in selection order."""
    if "gateup_proj" in pv.get("experts_stacked"):
        gu = pv.apply_experts_grouped("gateup_proj", ids, x_rows, x_shared=x_shared)
        ii = gu.shape[-1] // 2
        gate, up = gu[..., :ii], gu[..., ii:]
    else:
        gate = pv.apply_experts_grouped("gate_proj", ids, x_rows, x_shared=x_shared)
        up = pv.apply_experts_grouped("up_proj", ids, x_rows, x_shared=x_shared)
    return pv.apply_experts_grouped("down_proj", ids, act_fn(cfg.hidden_act, gate) * up)


def _moe_sparse(pv, cfg: ModelConfig, x: torch.Tensor, k: int) -> torch.Tensor:
    """Only the top-k experts' weights are read: all B*T*k (token,
    expert) selections go through two grouped launches per block
    (gate|up, then down). Nothing here waits on the host: the ids stay
    on the device from the router to the kernel.

    With more than one token the selections are sorted by expert id
    (stable: ties keep selection order) so that equal ids sit together,
    and the outputs are put back through an inverse permutation built by
    one scatter. A single token's k selections share its row (x_shared);
    with the view's ``moe_fused`` they run the whole expert MLP in one K19
    launch where it takes the stacks (JAX: llama.py:1313-1320, under
    ``QLLM_TPU_MOE_FUSED``), else the two grouped launches."""
    B, T, D = x.shape
    S = B * T
    top_w, top_ids = _router_topk(pv, cfg, x)
    xf = x.reshape(S, D)
    wf = top_w.reshape(S, k)
    ids_u = top_ids.reshape(S * k).to(torch.int32)
    if S > 1:
        order = torch.argsort(ids_u, stable=True)
        ids = ids_u.index_select(0, order)
        x_rows = xf.index_select(0, torch.div(order, k, rounding_mode="floor"))
    else:
        order = None
        ids = ids_u
        x_rows = xf
    ye_s = None
    if order is None and getattr(pv, "moe_fused", False):
        ye_s = pv.fused_expert_mlp(ids, x_rows, cfg)
    if ye_s is None:
        ye_s = _grouped_expert_mlp(pv, cfg, ids, x_rows, order is None)
    if order is not None:
        inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=order.device))
        ye = ye_s.index_select(0, inv)
    else:
        ye = ye_s
    out = torch.sum(ye.reshape(S, k, D).to(torch.float32) * wf[..., None].to(torch.float32), dim=1)
    return out.reshape(B, T, D).to(x.dtype)


def embed_tokens_forward(params: Dict[str, Any], cfg: ModelConfig, token_ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> first block's hidden input (ids clip into range)."""
    emb = params["embed_tokens"]
    return emb[token_ids.to(torch.int64).clamp(0, emb.shape[0] - 1)]


def final_logits(params: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor, w4a8: bool = False) -> torch.Tensor:
    h = rms_norm(h, params["norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        emb = params["embed_tokens"]
        logits = h.to(torch.bfloat16).to(torch.float32) @ emb.to(torch.bfloat16).to(torch.float32).T
    else:
        logits = apply_linear(params["lm_head"], h, params.get("lm_head_bias"), w4a8=w4a8)
    return logits.to(torch.float32)


def _positions(B: int, T: int, pos, device) -> torch.Tensor:
    t = torch.arange(T, device=device)[None, :]
    if pos is None:
        return t.expand(B, T)
    if isinstance(pos, int) or pos.dim() == 0:
        return (torch.as_tensor(pos, device=device) + t).expand(B, T)
    return pos.to(device)[:, None] + t


def forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    token_ids: torch.Tensor,  # [B, T]
    cache: Optional[QuantizedKVCache] = None,
    pos: Union[None, int, torch.Tensor] = None,  # write offset into the cache
    w4a8: bool = False,
    moe_fused: bool = False,
) -> Tuple[torch.Tensor, Optional[QuantizedKVCache]]:
    """Full forward -> (logits [B, T, V] float32, cache).

    Without a cache: causal attention over the T tokens. With a cache:
    tokens are written at offset ``pos`` (in place) and attention runs
    over cache positions [0, pos+T). ``pos`` is an int, or a [B] tensor of
    per-slot offsets; one that lies on the CPU is bounds-checked on the
    host and copied to the device once. Stacked params (models.stacked)
    take the stacked loop. ``w4a8``: per-token int8 activations into
    every quantized matmul where the JAX package's W4A8 (its
    ``QLLM_TPU_W4A8`` switch) takes them; an explicit argument here, read
    by nothing global. ``moe_fused``: a single token's sparse MoE block
    runs its whole expert MLP in one K19 launch where the stacks qualify
    (the JAX package's ``QLLM_TPU_MOE_FUSED``, off by default there too)."""
    check_llama_family(cfg)
    if not isinstance(params["layers"], list):
        if cache is None:
            raise ValueError(
                "stacked-layer forward requires a KV cache; use the per-layer "
                "(list) params for cacheless scoring"
            )
        from .stacked import forward_stacked

        return forward_stacked(params, cfg, token_ids, cache, pos, w4a8=w4a8, moe_fused=moe_fused)
    B, T = token_ids.shape
    device = token_ids.device
    kv_len = None
    if cache is not None:
        pos = 0 if pos is None else pos
        _check_fits(cache, pos, T)
        kv_len = visible_len(cache, pos, T)
        if isinstance(pos, torch.Tensor):
            pos = pos.to(device)  # one copy for every consumer below
    positions = _positions(B, T, pos if cache is not None else None, device)
    mask, slots = _attn_inputs(cfg, B, T, cache, pos, device, kv_len)
    h = embed_tokens_forward(params, cfg, token_ids)
    cos, sin = _rope_cos_sin(positions, cfg.rot_dim, cfg.rope_theta)
    for i, lp in enumerate(params["layers"]):
        h, cache = _block_attn_mlp(LayerView(lp, w4a8, moe_fused), cfg, h, cos, sin, mask, cache, i, pos, slots)
    return final_logits(params, cfg, h, w4a8), cache
