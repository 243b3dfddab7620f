"""Token sampling: temperature / top-k / top-p (nucleus) on the logits'
device (the counterpart of ``qllm_tpu/models/sampling.py``).

One descending sort per row feeds both truncations, per-row parameters
are tensors so one call serves a batch of requests with different
settings, and the noise comes from an explicit ``torch.Generator`` on
the logits' device: nothing is read back to the host. ``torch`` cannot
give ``jax.random``'s bits, so sampled streams agree with the JAX
package in distribution and support, not token for token; greedy rows
(temperature <= 0) are the exact argmax in both.

Rules (the de-facto HF/vLLM semantics, as in the JAX package):
  * temperature <= 0  -> greedy argmax for that row (top-k/p ignored)
  * top_k == 0        -> no top-k truncation
  * top_p >= 1        -> no nucleus truncation
  * the nucleus is the SMALLEST prefix of descending-prob tokens with
    cumulative probability >= top_p (the argmax token always survives)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

__all__ = ["SamplingParams", "sample_logits", "params_arrays"]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (0-temperature = greedy)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def params_arrays(
    params_list: Sequence[Optional[SamplingParams]], device: Union[str, torch.device] = "cpu"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack a list of SamplingParams (or None = greedy) into the
    (temperature [B] f32, top_k [B] int32, top_p [B] f32) tensors that
    sample_logits takes."""
    ps = [p or SamplingParams() for p in params_list]
    return (
        torch.tensor([p.temperature for p in ps], dtype=torch.float32, device=device),
        torch.tensor([p.top_k for p in ps], dtype=torch.int32, device=device),
        torch.tensor([p.top_p for p in ps], dtype=torch.float32, device=device),
    )


def sample_logits(
    logits: torch.Tensor,  # [B, V]
    generator: torch.Generator,  # on the logits' device
    temperature: torch.Tensor,  # [B] f32; <= 0 -> greedy row
    top_k: Optional[torch.Tensor] = None,  # [B] int; 0 -> off
    top_p: Optional[torch.Tensor] = None,  # [B] f32; >= 1 -> off
) -> torch.Tensor:
    """Sample one token per row -> [B] int32 on the logits' device.

    The top-k threshold is the k-th sorted (temperature-scaled) logit, the
    nucleus threshold the logit at the smallest index whose inclusive
    cumulative softmax mass reaches top_p; tokens strictly below the
    larger threshold are masked, and the survivors are sampled by
    Gumbel-max (argmax of logits plus Gumbel noise drawn from
    ``generator``), as ``jax.random.categorical`` does."""
    B, V = logits.shape
    dev = logits.device
    lf = logits.to(torch.float32)
    greedy_tok = torch.argmax(lf, dim=-1).to(torch.int32)
    temperature = temperature.to(device=dev, dtype=torch.float32)
    is_greedy = temperature <= 0.0

    # scale first so the sort is reusable for the nucleus mass
    lt = lf / torch.clamp(temperature, min=1e-6)[:, None]
    sl = torch.sort(lt, dim=-1, descending=True).values

    thresh = torch.full((B,), _NEG, dtype=torch.float32, device=dev)
    if top_k is not None:
        k = top_k.to(device=dev, dtype=torch.int64)
        k = torch.clamp(torch.where(k > 0, k, torch.full_like(k, V)), 1, V)
        thresh = torch.maximum(thresh, torch.gather(sl, 1, (k - 1)[:, None])[:, 0])
    if top_p is not None:
        top_p = top_p.to(device=dev, dtype=torch.float32)
        csum = torch.cumsum(torch.softmax(sl, dim=-1), dim=-1)
        reached = csum >= torch.clamp(top_p, max=1.0)[:, None]
        # the first True position is the nucleus boundary (argmax of a
        # bool row); none reached -> the last index
        idx = torch.argmax(reached.to(torch.float32), dim=-1)
        idx = torch.where(reached.any(dim=-1), idx, torch.full_like(idx, V - 1))
        pth = torch.gather(sl, 1, idx[:, None])[:, 0]
        thresh = torch.maximum(thresh, torch.where(top_p < 1.0, pth, torch.full_like(pth, _NEG)))

    masked = torch.where(lt >= thresh[:, None], lt, torch.full_like(lt, _NEG))
    u = torch.rand((B, V), generator=generator, device=dev, dtype=torch.float32)
    # Gumbel noise -log(-log(u)), u kept inside (0, 1)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny, max=1.0 - 2**-24)))
    sampled = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return torch.where(is_greedy, greedy_tok, sampled)
