"""MoE serving prep: per-expert weights stacked into [E]-leading tensors
(the counterpart of ``qllm_tpu/models/moe.py``).

A dense all-experts loop reads E experts' weights to use k of them, an
E/k-fold weight stream in the memory-bound decode regime (4x on Mixtral
8x7B, 16x on Qwen3-30B-A3B). With every expert of a layer in one [E]
stack, selecting an expert is an index into the stack: the grouped
kernel (K8, ``ops.qmm.qmatmul_grouped_experts``) reads the selected
experts' words straight out of it, with the ids on the device, and
nothing is gathered or copied. ``models.llama._moe_forward`` takes that
sparse path whenever B*T*k < E and keeps the dense loop (K1 / K2 per
expert) for prefill and large batches, where every expert is hit anyway.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.qmm import grouped_experts_ok, qmatmul_grouped_experts, qmatmul_stacked
from ..quant.qtensor import QuantizedTensor, concat_columns
from .stacked import LANE_QUANTUM, _qt_stackable_across, _stack_qt, prepare_stacked_tensor

__all__ = [
    "stack_experts",
    "expert_linear",
    "grouped_expert_linear",
    "has_stackable_experts",
]

_EXPERT_LINEARS = ("gate_proj", "up_proj", "down_proj")


def _experts_homogeneous(experts) -> bool:
    """True when every expert carries the same fields with identical
    shapes and quantization metadata (required to stack them on [E])."""
    if not experts:
        return False
    e0 = experts[0]
    names = set(e0.keys())
    if not names.issubset(set(_EXPERT_LINEARS)):
        return False  # an unexpected per-expert field (e.g. act scales)
    if any(set(ep.keys()) != names for ep in experts):
        return False
    for n in names:
        vals = [ep[n] for ep in experts]
        if isinstance(vals[0], QuantizedTensor):
            if not _qt_stackable_across(vals):
                return False
        elif any(v is None or isinstance(v, QuantizedTensor) or v.shape != vals[0].shape for v in vals):
            return False
    return True


def _raw_prestacked(lp) -> bool:
    """A layer carrying raw (not yet prepared) [E]-leading expert stacks,
    as ``utils.testing.random_quantized_params(experts_prestacked=True)``
    emits them: ``stack_experts`` still runs the serving prep on them."""
    est = lp.get("experts_stacked") if isinstance(lp, dict) else None
    return (
        isinstance(est, dict)
        and "experts" not in lp
        and any(isinstance(v, QuantizedTensor) and not v.planar and not v.zeros_prefolded for v in est.values())
    )


def has_stackable_experts(params: Dict[str, Any]) -> bool:
    layers = params.get("layers")
    if not isinstance(layers, list):
        return False
    return any(
        (isinstance(lp, dict) and "experts" in lp and _experts_homogeneous(lp["experts"])) or _raw_prestacked(lp)
        for lp in layers
    )


def _prepare(v: QuantizedTensor) -> QuantizedTensor:
    """The serving prep with the adaptive lane quantum: padding a narrow
    expert stack to 512 columns streams real extra bytes (Qwen3-MoE's
    768 -> 1024 is +33%), so stacks narrower than 4 x 512 pad to 128."""
    return prepare_stacked_tensor(v, LANE_QUANTUM if v.out_features >= 4 * LANE_QUANTUM else 128)


def _stack_layer_experts(lp):
    """One layer's part of ``stack_experts``: a copy of ``lp`` with its
    experts in ``experts_stacked``, or ``lp`` itself when they do not stack."""
    if _raw_prestacked(lp):
        est = {
            n: _prepare(v) if isinstance(v, QuantizedTensor) and not v.planar else v
            for n, v in lp["experts_stacked"].items()
        }
        return {**lp, "experts_stacked": est}
    if not (isinstance(lp, dict) and "experts" in lp and _experts_homogeneous(lp["experts"])):
        return lp
    experts = lp["experts"]
    names = list(experts[0].keys())
    if "gate_proj" in names and "up_proj" in names and all(
        _qt_stackable_across([ep["gate_proj"], ep["up_proj"]]) for ep in experts
    ):
        fused = []
        for ep in experts:
            gqt, uqt = ep["gate_proj"], ep["up_proj"]
            ii = gqt.out_features
            fused.append(
                concat_columns(
                    [gqt, uqt], [np.arange(0, ii), np.arange(ii, ii + uqt.out_features)], ii + uqt.out_features
                )
            )
        experts = [{"gateup_proj": f, "down_proj": ep["down_proj"]} for f, ep in zip(fused, experts)]
        names = ["gateup_proj", "down_proj"]
    est = {}
    for n in names:
        vals = [ep[n] for ep in experts]
        est[n] = _prepare(_stack_qt(vals)) if isinstance(vals[0], QuantizedTensor) else torch.stack(vals)
    nlp = {k: v for k, v in lp.items() if k != "experts"}
    nlp["experts_stacked"] = est
    return nlp


def stack_experts(params: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``params`` in which each MoE layer's per-expert list is
    replaced by ``experts_stacked``: one dict of [E]-leading tensors, each
    quantized stack in the serving layout (``stacked.prepare_stacked_tensor``
    with the adaptive lane quantum). Each expert's gate and up fuse
    column-wise into ``gateup_proj`` where they can: two grouped launches
    per block instead of three. Layers whose experts are heterogeneous
    stay as they are (dense loop). ``stacked.stack_layer_params_hybrid``
    runs the same prep layer by layer and frees each layer's sources as
    it goes."""
    layers = params.get("layers")
    if not isinstance(layers, list):
        return params
    return {**params, "layers": [_stack_layer_experts(lp) for lp in layers]}


def grouped_expert_linear(w, ids: torch.Tensor, x_rows: torch.Tensor, x_shared: bool = False) -> torch.Tensor:
    """y[i] = x_rows[i] @ W[ids[i]] for [E]-stacked expert weights, every
    selection in one launch of K8 (``ops.qmm.qmatmul_grouped_experts``).
    ``x_shared``: every selection reads the single row x_rows[0] (one
    token's k experts). ``ids`` stays on the device; nothing here reads it
    on the host."""
    n = ids.shape[0]
    if isinstance(w, QuantizedTensor):
        if not grouped_experts_ok(w):
            raise NotImplementedError(
                "grouped expert matmul needs a 4-bit planar full-K stack (K % 256 == 0, "
                f"groups splitting at K/2; K={w.in_features}, g={w.effective_group_size}); the "
                "per-selection fallback would read the expert ids on the host"
            )
        return qmatmul_grouped_experts(x_rows, w, ids, x_shared=x_shared)
    if x_shared:
        x_rows = x_rows[:1].expand(n, -1)
    we = w.index_select(0, ids.to(torch.int64))  # [n, K, N] (dense test-scale stacks)
    y = torch.einsum(
        "nk,nkd->nd", x_rows.to(torch.bfloat16).to(torch.float32), we.to(torch.bfloat16).to(torch.float32)
    )
    return y.to(x_rows.dtype)


def expert_linear(w, e: int, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W[e] for one [E]-stacked expert weight and a host-int index
    (the dense loop): quantized stacks ride K1 / K2 with ``e`` as the
    stack index, dense stacks index directly."""
    if isinstance(w, QuantizedTensor):
        return qmatmul_stacked(x, w, e)
    y = x.to(torch.bfloat16).to(torch.float32) @ w[e].to(torch.bfloat16).to(torch.float32)
    return y.to(x.dtype)
