"""Stacked-layer execution (the counterpart of
``qllm_tpu/models/stacked.py``).

``stack_layer_params`` replaces the per-layer list with one dict of
[L]-leading leaves and prepares every quantized stack for serving
(``prepare_stacked_tensor``): q/k/v and gate/up fused column-wise where
they share their quantization, out-features padded to a multiple of 512,
4-bit words without act-order relaid out planar (kernel K4 on the card)
where the geometry admits it, every other stack (2/3/5/6/7/8 bits,
act-order, ``planar=False``) kept in its packed GPTQ-order or bit-plane
words, zero points pre-folded to ``zs = zeros * scales`` and scales / zs
stored in ``scale_store_dtype`` (f32 by default, as in the JAX package;
bf16 is the serving layout of ``bench.py`` and the engine). The stacked
buffers are bit-identical to the JAX package's for the same options.

``forward_stacked`` walks the layers in a Python loop (the JAX package's
``lax.scan`` over layer indices); every quantized matmul reads its layer
straight out of the stack (ops.qmm.qmatmul_stacked), and the pre-matmul
RMSNorms ride into the decode matmul kernel (NormedX) or run just before
it.

MoE models take ``stack_layer_params_hybrid``: the attention projections,
norms and routers stack to [L] leaves as above, and the experts, stacked
per layer to [E] (models.moe), concatenate into one [L*E] stack per name
whose expert ids the view biases by ``l * _moe_stride``. The same loop
serves them (``forward_hybrid``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..ops.qmm import _rms_norm_rows, planar_bk, planar_full_ok, qmatmul_stacked
from ..ops.repack import planarize_w4
from ..quant.qtensor import (
    QuantizedTensor,
    concat_columns,
    take_columns,
    unplanarize_packed,
)
from .llama import (
    ModelConfig,
    _attn_inputs,
    _block_attn_mlp,
    _check_fits,
    _mat,
    apply_linear,
    _positions,
    _rope_cos_sin,
    check_llama_family,
    embed_tokens_forward,
    final_logits,
    visible_len,
)

__all__ = [
    "stack_layer_params",
    "stack_layer_params_hybrid",
    "unstack_layer_params",
    "forward_stacked",
    "forward_hybrid",
    "is_stackable",
    "prepare_stacked_tensor",
    "prepare_lm_head",
    "fused_splits",
]


def _leaf_shapes(lp: Dict[str, Any]):
    out = []
    for k in sorted(lp):
        v = lp[k]
        if isinstance(v, QuantizedTensor):
            out.append((k, "qt", v.bits, v.group_size, tuple(v.qweight.shape), v.perm is None))
        elif isinstance(v, torch.Tensor):
            out.append((k, tuple(v.shape)))
        else:
            out.append((k, type(v).__name__))
    return out


def is_stackable(params: Dict[str, Any]) -> bool:
    """True when every layer has the same structure and shapes."""
    layers = params["layers"]
    if not isinstance(layers, list) or len(layers) < 2:
        return False
    if "experts" in layers[0] or "kv_a_proj_with_mqa" in layers[0]:
        return False  # MoE / MLA: not in this slice
    ref = _leaf_shapes(layers[0])
    return all(_leaf_shapes(lp) == ref for lp in layers[1:])


_FUSE_GROUPS = (
    ("qkv_proj", ("q_proj", "k_proj", "v_proj")),
    ("gateup_proj", ("gate_proj", "up_proj")),
)


def _fusable(lp: Dict[str, Any], names) -> bool:
    parts = [lp.get(n) for n in names]
    if not all(isinstance(p, QuantizedTensor) for p in parts):
        return False
    p0 = parts[0]
    return all(
        (p.bits, p.group_size, p.sym, p.in_features)
        == (p0.bits, p0.group_size, p0.sym, p0.in_features)
        and p.perm is None
        and not p.planar
        and not p.zeros_prefolded
        for p in parts
    )


def _fuse_layer_projections(lp: Dict[str, Any]) -> Dict[str, Any]:
    """Merge q/k/v (and gate/up) into one column-concatenated quantized
    tensor, so one kernel launch with a wider N serves the group."""
    lp = dict(lp)
    for fused_name, names in _FUSE_GROUPS:
        if not _fusable(lp, names):
            continue
        parts = [lp[n] for n in names]
        widths = [p.out_features for p in parts]
        offs = np.cumsum([0] + widths)
        lp[fused_name] = concat_columns(
            parts,
            [np.arange(offs[i], offs[i + 1]) for i in range(len(parts))],
            int(offs[-1]),
        )
        biases = [lp.get(f"{n}_bias") for n in names]
        if any(b is not None for b in biases):
            ref = next(b for b in biases if b is not None)
            lp[f"{fused_name}_bias"] = torch.cat(
                [
                    b if b is not None else torch.zeros((w,), dtype=ref.dtype, device=ref.device)
                    for b, w in zip(biases, widths)
                ]
            )
        for n in names:
            del lp[n]
            lp.pop(f"{n}_bias", None)
    return lp


def fused_splits(cfg: ModelConfig):
    """Column boundaries of the fused projections (logical widths)."""
    hd = cfg.hd
    nq = cfg.num_attention_heads * hd
    nkv = cfg.num_key_value_heads * hd
    ii = cfg.intermediate_size
    return {
        "qkv_proj": (0, nq, nq + nkv, nq + 2 * nkv),
        "gateup_proj": (0, ii, 2 * ii),
    }


def _stack_qt(vals) -> QuantizedTensor:
    q0 = vals[0]
    return dataclasses.replace(
        q0,
        qweight=torch.stack([q.qweight for q in vals]),
        scales=torch.stack([q.scales for q in vals]),
        zeros=torch.stack([q.zeros for q in vals]),
        perm=None if q0.perm is None else torch.stack([q.perm for q in vals]),
    )


LANE_QUANTUM = 512
# The default scale storage of the dense stacks, the JAX package's
# (qllm_tpu/models/stacked.py:145, :225, :324): f32, whose planar stacks
# run K17 / K18 with the correction outside; bf16 (the serving layout of
# bench.py:417-449 and of the engine) runs K1 / K2 with it fused.
SCALE_STORE_DTYPE = torch.float32


def stack_layer_params(
    params: Dict[str, Any], planar: bool = True, scale_store_dtype: torch.dtype = SCALE_STORE_DTYPE
) -> Dict[str, Any]:
    """Replace the per-layer list with one dict of [L, ...] leaves, every
    quantized stack in its serving layout (``prepare_stacked_tensor`` with
    ``planar`` and ``scale_store_dtype``)."""
    if not is_stackable(params):
        raise ValueError(
            "params are not stackable (heterogeneous layers or MoE); use the "
            "per-layer list path"
        )
    layers = [_fuse_layer_projections(lp) for lp in params["layers"]]
    prepared = {}
    for k in list(layers[0].keys()):
        vals = [lp[k] for lp in layers]
        if isinstance(vals[0], QuantizedTensor):
            prepared[k] = prepare_stacked_tensor(_stack_qt(vals), planar=planar, scale_store_dtype=scale_store_dtype)
        else:
            prepared[k] = torch.stack(vals)
    out = dict(params)
    out["layers"] = prepared
    return out


def prepare_stacked_tensor(
    node: QuantizedTensor,
    lane_quantum: int = LANE_QUANTUM,
    planar: bool = True,
    scale_store_dtype: torch.dtype = SCALE_STORE_DTYPE,
) -> QuantizedTensor:
    """Serving prep for one [L]-stacked QuantizedTensor, the JAX package's
    semantics: out-features padded to a multiple of ``lane_quantum`` (512;
    narrow expert stacks take 128, models.moe); with ``planar``, 4-bit
    words without act-order relaid out planar (K4 on the card) where the
    planar kernels admit the geometry (``planar_bk`` or ``planar_full_ok``);
    every other stack keeps its packed words; zero points pre-folded to
    ``zs = zeros * scales`` (in f32) and scales / zs stored in
    ``scale_store_dtype``. The JAX package's tuned wider padding
    (ops.autotune.padded_width_hint) holds TPU measurements and is not
    ported."""
    g = node.effective_group_size
    K = node.in_features
    is_planar = (
        planar
        and node.bits == 4
        and node.perm is None
        and (planar_bk(K, g) is not None or planar_full_ok(K, g))
    )
    scales = node.scales.to(torch.float32)
    zeros = node.zeros.to(torch.float32)
    qweight = node.qweight
    # the logical width stays in out_features and consumers slice
    pad = (-qweight.shape[-1]) % lane_quantum
    if pad:
        qweight = torch.nn.functional.pad(qweight, (0, pad))
        scales = torch.nn.functional.pad(scales, (0, pad), value=1.0)
        zeros = torch.nn.functional.pad(zeros, (0, pad))
    return dataclasses.replace(
        node,
        qweight=planarize_w4(qweight, K) if is_planar else qweight,
        scales=scales.to(scale_store_dtype),
        zeros=(zeros * scales).to(scale_store_dtype),
        planar=is_planar,
        zeros_prefolded=True,
    )


def prepare_lm_head(qt: QuantizedTensor, scale_store_dtype: torch.dtype = SCALE_STORE_DTYPE) -> QuantizedTensor:
    """Serving prep for a quantized lm_head as an L=1 stack (ops.qmatmul
    routes 3-D tensors through the stacked kernels with layer 0); an
    act-order head stays 2-D, as in the JAX package."""
    if qt.perm is not None:
        return qt
    return prepare_stacked_tensor(qt.map_arrays(lambda a: a[None]), scale_store_dtype=scale_store_dtype)


def unstack_layer_params(
    params: Dict[str, Any], n_layers: int, cfg: ModelConfig = None
) -> Dict[str, Any]:
    """Inverse of stack_layer_params: per-layer list with planar words
    unplanarized, zs un-prefolded (zeros = zs / scales in f32), the lane
    padding stripped, the act-order perm sliced and fused projections
    split back (``cfg`` gives the split boundaries)."""
    stacked = params["layers"]

    def split_fused(lp):
        for fused_name, names in _FUSE_GROUPS:
            qt = lp.pop(fused_name, None)
            if qt is None:
                continue
            if cfg is None:
                raise ValueError(f"unstacking fused '{fused_name}' needs cfg for the split boundaries")
            s = fused_splits(cfg)[fused_name]
            bias = lp.pop(f"{fused_name}_bias", None)
            for j, n in enumerate(names):
                lp[n] = take_columns(qt, np.arange(s[j], s[j + 1]))
                if bias is not None:
                    lp[f"{n}_bias"] = bias[s[j] : s[j + 1]]
        return lp

    def slice_layer(i):
        lp = {}
        for k, v in stacked.items():
            if isinstance(v, QuantizedTensor):
                N = v.out_features
                qw = v.qweight[i]
                if v.planar:
                    qw = unplanarize_packed(qw, v.in_features)
                scales = v.scales[i, :, :N].to(torch.float32)
                zeros = v.zeros[i, :, :N].to(torch.float32)
                if v.zeros_prefolded:
                    zeros = zeros / scales
                lp[k] = dataclasses.replace(
                    v,
                    qweight=qw[:, :N].contiguous(),
                    scales=scales,
                    zeros=zeros,
                    perm=None if v.perm is None else v.perm[i],
                    planar=False,
                    zeros_prefolded=False,
                )
            else:
                lp[k] = v[i]
        return split_fused(lp)

    out = dict(params)
    out["layers"] = [slice_layer(i) for i in range(n_layers)]
    return out


_FUSED_OF = {
    "q_proj": ("qkv_proj", 0),
    "k_proj": ("qkv_proj", 1),
    "v_proj": ("qkv_proj", 2),
    "gate_proj": ("gateup_proj", 0),
    "up_proj": ("gateup_proj", 1),
}


class NormedX:
    """An activation with a PENDING RMSNorm, fused into the next stacked
    quantized matmul (K1 normalises the row in-kernel, K11 in its
    quantizer prologue; at M > 32 the norm runs just before K2). Other
    consumers call ``materialize()``."""

    __slots__ = ("x", "w_stacked", "layer", "eps")

    def __init__(self, x, w_stacked, layer: int, eps: float):
        self.x = x
        self.w_stacked = w_stacked
        self.layer = layer
        self.eps = eps

    @property
    def shape(self):
        return self.x.shape

    @property
    def dtype(self):
        return self.x.dtype

    def materialize(self):
        return _rms_norm_rows(self.x, self.w_stacked[self.layer], self.eps)


class StackedLayerView:
    """llama.LayerView equivalent over [L]-stacked params + layer index;
    fused q/k/v and gate/up outputs are computed once per input and
    sliced per consumer. ``w4a8`` rides on the view to every stacked
    matmul (K11 where the JAX package's W4A8 takes int8 activations);
    ``moe_fused`` to the batch-1 sparse MoE block (K19)."""

    def __init__(self, slp: Dict[str, Any], l: int, cfg: ModelConfig, w4a8: bool = False, moe_fused: bool = False):
        self.lp = slp
        self.l = l
        self.cfg = cfg
        self.w4a8 = w4a8
        self.moe_fused = moe_fused
        self._fused_memo = {}

    def get(self, name):
        v = self.lp.get(name)
        if v is None or isinstance(v, (QuantizedTensor, dict)):
            # a dict is the full [L*E] expert stack (apply_expert biases
            # the ids by l * _moe_stride): a presence marker here
            return v
        return v[self.l]  # an [L]-stacked leaf or a per-layer list

    def fused_norm_arg(self, h, name: str, cfg):
        """NormedX marker for ``rms_norm(h, <name>)``; None -> the caller
        normalizes."""
        if cfg.norm_type != "rmsnorm" or self.lp.get(f"{name}_bias") is not None:
            return None
        w = self.lp.get(name)
        if w is None or isinstance(w, QuantizedTensor) or w.dim() != 2:
            return None
        return NormedX(h, w, self.l, cfg.rms_norm_eps)

    def apply(self, name, x):
        fused = _FUSED_OF.get(name)
        if fused is not None and fused[0] in self.lp:
            fused_name, part = fused
            key = (fused_name, id(x))
            y = self._fused_memo.get(key)
            if y is None:
                y = self._apply_name(fused_name, x)
                self._fused_memo[key] = y
            s = fused_splits(self.cfg)[fused_name]
            return y[..., s[part] : s[part + 1]]
        return self._apply_name(name, x)

    def _expert_stack(self, name):
        """(expert weight stack, id bias) of this layer: the full [L*E]
        stack biases ids by l * _moe_stride, a per-layer [E] stack by 0."""
        est = self.lp.get("experts_stacked")
        if isinstance(est, dict):
            return est[name], self.l * self.lp["_moe_stride"]
        return est[self.l][name], 0

    def apply_expert(self, name, e: int, x):
        from .moe import expert_linear

        w, bias = self._expert_stack(name)
        return expert_linear(w, bias + e, x, w4a8=self.w4a8)

    def apply_experts_grouped(self, name, ids, x_rows, x_shared: bool = False):
        from .moe import grouped_expert_linear

        w, bias = self._expert_stack(name)
        return grouped_expert_linear(w, ids + bias if bias else ids, x_rows, x_shared)

    def fused_expert_mlp(self, ids, x_row, cfg):
        """One token's whole expert MLP for each of its selections in one K19
        launch where it takes this layer's stacks (ids biased by l *
        _moe_stride on the full [L*E] stack, JAX's stacked.py:556-562), else
        None."""
        from .moe import fused_expert_mlp

        est = self.lp.get("experts_stacked")
        est_l = est if isinstance(est, dict) else est[self.l]
        if "gateup_proj" not in est_l or "down_proj" not in est_l:
            return None
        gu, bias = self._expert_stack("gateup_proj")
        dn, _ = self._expert_stack("down_proj")
        return fused_expert_mlp(gu, dn, ids + bias if bias else ids, x_row, cfg.hidden_act)

    def _apply_name(self, name, x):
        w = self.lp[name]
        if isinstance(w, list):
            # a heterogeneous entry of hybrid params stays per layer
            b = self.lp.get(f"{name}_bias")
            return apply_linear(w[self.l], _mat(x), None if b is None else b[self.l], w4a8=self.w4a8)
        b = self.lp.get(f"{name}_bias")
        bias = None if b is None else b[self.l]
        if isinstance(w, QuantizedTensor):
            norm_kw = {}
            if isinstance(x, NormedX):
                norm_kw = {"norm_w": x.w_stacked, "norm_eps": x.eps}
                x = x.x
            y = qmatmul_stacked(x, w, self.l, **norm_kw, w4a8=self.w4a8)
        else:
            if isinstance(x, NormedX):
                x = x.materialize()
            wl = w[self.l].to(torch.bfloat16).to(torch.float32)
            y = (x.to(torch.bfloat16).to(torch.float32) @ wl).to(x.dtype)
        if bias is not None:
            y = y + bias
        return y


def forward_stacked(
    params: Dict[str, Any],
    cfg: ModelConfig,
    token_ids: torch.Tensor,
    cache,
    pos,
    w4a8: bool = False,
    moe_fused: bool = False,
):
    """Decode/prefill forward over stacked params, layer by layer; the
    semantics of models.llama.forward with a cache (``w4a8`` and
    ``moe_fused`` as there)."""
    check_llama_family(cfg)
    B, T = token_ids.shape
    pos = 0 if pos is None else pos
    _check_fits(cache, pos, T)
    device = token_ids.device
    kv_len = visible_len(cache, pos, T)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device)
    positions = _positions(B, T, pos, device)
    mask, slots = _attn_inputs(cfg, B, T, cache, pos, device, kv_len)
    h = embed_tokens_forward(params, cfg, token_ids)
    cos, sin = _rope_cos_sin(positions, cfg.rot_dim, cfg.rope_theta)
    slp = params["layers"]
    for layer in range(cfg.num_hidden_layers):
        h, cache = _block_attn_mlp(
            StackedLayerView(slp, layer, cfg, w4a8, moe_fused), cfg, h, cos, sin, mask, cache, layer, pos, slots
        )
    return final_logits(params, cfg, h, w4a8), cache


# ---------------------------------------------------------------------------
# Hybrid stacking for MoE models: every homogeneous per-layer entry
# (attention projections, norms, routers) stacks to [L] and rides the
# stacked kernels with fused qkv; the experts keep per-layer [E] stacks
# (the sparse path selects experts per token) and, where every layer's
# stack is alike, concatenate into one [L*E] stack per name.
# ---------------------------------------------------------------------------


def _qt_stackable_across(vals) -> bool:
    q0 = vals[0]
    return all(
        isinstance(q, QuantizedTensor)
        and (q.bits, q.group_size, q.sym, q.in_features, q.out_features)
        == (q0.bits, q0.group_size, q0.sym, q0.in_features, q0.out_features)
        and q.perm is None
        and not q.planar
        and not q.zeros_prefolded
        for q in vals
    )


def _stack_meta(qt: QuantizedTensor):
    return (
        qt.bits, qt.group_size, qt.sym, qt.in_features, qt.out_features, qt.planar,
        qt.zeros_prefolded, tuple(qt.qweight.shape), qt.scales.dtype,
    )


def _concat_expert_stacks(ests, name: str, consume: bool) -> QuantizedTensor:
    """The per-layer [E] stacks of ``name`` concatenated into one [L*E]
    stack. ``consume``: each layer's stack is dropped from its dict as soon
    as it is copied, so the transient is one layer's stack, not a second
    full stack."""
    fields = ("qweight", "scales", "zeros")
    p0 = ests[0][name]
    rows = sum(e[name].qweight.shape[0] for e in ests)
    bufs = {
        f: torch.empty((rows, *getattr(p0, f).shape[1:]), dtype=getattr(p0, f).dtype, device=p0.qweight.device)
        for f in fields
    }
    out = dataclasses.replace(p0, **bufs)
    del p0
    off = 0
    for e in ests:
        part = e.pop(name) if consume else e[name]
        n = part.qweight.shape[0]
        for f in fields:
            bufs[f][off : off + n].copy_(getattr(part, f))
        off += n
        del part
    return out


def stack_layer_params_hybrid(
    params: Dict[str, Any], scale_store_dtype: torch.dtype = torch.float32, consume: bool = False
) -> Dict[str, Any]:
    """Serving prep for MoE models (per-layer list in, hybrid layers dict
    out). Homogeneous entries stack to [L] leaves with the serving prep of
    ``stack_layer_params``; experts stack per layer (models.moe.stack_experts)
    and, when every layer's stacks match and nothing else stayed per layer,
    concatenate into one [L*E] stack per name with ``_moe_stride = E``;
    heterogeneous entries stay per-layer lists. ``forward`` serves the
    result through ``forward_hybrid``. Every stack stores its scales and
    zs in ``scale_store_dtype``: f32 by default, as in the JAX package
    (served per selection, ``models.moe.grouped_expert_linear``), bf16 for
    the serving layout K8 and K19 take.

    ``consume``: the caller passes ownership. Each of the caller's layer
    dicts is emptied once its experts are stacked and its projections
    fused, and each entry of the working copies is dropped as its stacked
    copy lands, so the sources free progressively instead of doubling
    resident memory (the [L*E] concat included)."""
    from .moe import _stack_layer_experts

    src = params.get("layers")
    if not isinstance(src, list):
        raise ValueError("hybrid stacking expects per-layer (list) params")
    layers = []
    for lp in src:
        layers.append(_fuse_layer_projections(_stack_layer_experts(lp, scale_store_dtype)))  # always a new dict
        if consume:
            lp.clear()

    keys = []
    for lp in layers:
        keys.extend(k for k in lp if k not in keys)

    def consume_key(k):
        if consume:
            for lp in layers:
                lp.pop(k, None)

    slp: Dict[str, Any] = {}
    for k in keys:
        vals = [lp.get(k) for lp in layers]
        if k == "experts_stacked" or any(v is None for v in vals):
            slp[k] = vals  # per-layer (possibly sparse-only) entry
        elif isinstance(vals[0], QuantizedTensor):
            if _qt_stackable_across(vals):
                slp[k] = prepare_stacked_tensor(_stack_qt(vals), scale_store_dtype=scale_store_dtype)
                consume_key(k)
            else:
                slp[k] = vals
        elif all(isinstance(v, torch.Tensor) and v.shape == vals[0].shape for v in vals):
            slp[k] = torch.stack(vals)
            consume_key(k)
        else:
            slp[k] = vals

    ests = slp.get("experts_stacked")
    if (
        isinstance(ests, list)
        and all(isinstance(e, dict) for e in ests)
        and not any(isinstance(v, list) for k2, v in slp.items() if k2 != "experts_stacked")
    ):
        names = sorted(ests[0].keys())
        if all(
            sorted(e.keys()) == names
            and all(
                isinstance(e[nm], QuantizedTensor)
                and e[nm].perm is None
                and _stack_meta(e[nm]) == _stack_meta(ests[0][nm])
                for nm in names
            )
            for e in ests
        ):
            stride = int(ests[0][names[0]].qweight.shape[0])
            slp["experts_stacked"] = {nm: _concat_expert_stacks(ests, nm, consume) for nm in names}
            slp["_moe_stride"] = stride

    out = dict(params)
    out["layers"] = slp
    return out


# The JAX package runs hybrid params in a Python loop and dense stacks
# under lax.scan; here both are the same Python loop over StackedLayerView.
forward_hybrid = forward_stacked
