"""Sequence-parallel decode attention over a ``torch.distributed`` group
(the counterpart of ``qllm_tpu/parallel/sp_attention.py``).

The int8 KV cache is sharded on its sequence axis: rank i holds rows
[i * S/n, (i + 1) * S/n) of every layer, contiguous. Each rank runs K21
(``ops.attention.decode_attention_partial``) on its shard with its local
lengths, and the exact softmax comes back from a log-sum-exp merge: one
all-reduce MAX of m [B, H, 1] and two all-reduce SUMs of den [B, H, 1]
and acc [B, H, D]. The group takes the place of the JAX mesh axis; the
collectives run on whatever backend it was made with (NCCL on the card,
gloo on the CPU), at every world size, one included.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..ops.attention import decode_attention_partial

__all__ = ["lse_merge", "sp_cache_shard", "sp_decode_attention"]

_SEQ_AXIS = 3  # k/v [L, B, Hkv, S, D], scales [L, B, Hkv, S]


def sp_cache_shard(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous shard of a global cache [L, B, Hkv, S, D]
    or scale [L, B, Hkv, S] tensor along the sequence axis (the
    counterpart of ``sp_cache_pspecs``)."""
    S = t.shape[_SEQ_AXIS]
    if S % world:
        raise ValueError(f"cache seq {S} not divisible by the world size {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    s_loc = S // world
    return t.narrow(_SEQ_AXIS, rank * s_loc, s_loc).contiguous()


def lse_merge(
    acc: torch.Tensor,
    m: torch.Tensor,
    den: torch.Tensor,
    pmax: Callable[[torch.Tensor], torch.Tensor],
    psum: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """The exact merge of per-shard partials: with m_g = pmax(m),
    out = psum(acc * e^(m - m_g)) / psum(den * e^(m - m_g)). ``pmax`` and
    ``psum`` reduce over the shards: all-reduces across a group, or a
    reduction over a leading shard axis when one process holds every
    shard's partials."""
    m_g = pmax(m)
    w = torch.exp(m - m_g)
    den_g = psum(den * w)
    acc_g = psum(acc * w)
    return acc_g / den_g


def _all_reduce(op, group):
    def reduce(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    return reduce


def sp_decode_attention(
    q: torch.Tensor,  # [B, H, D] bf16, the same on every rank
    k_shard: torch.Tensor,  # [L, B, Hkv, S/n, D] int8: this rank's rows of the sequence
    v_shard: torch.Tensor,
    ks_shard: torch.Tensor,  # [L, B, Hkv, S/n] f32
    vs_shard: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 GLOBAL valid lengths
    layer: int,
    group,
) -> torch.Tensor:
    """Exact decode attention with the KV sequence axis sharded over the
    ranks of ``group`` (rank r holds rows [r * S/n, (r + 1) * S/n)):
    f32 [B, H, D], the same on every rank."""
    if group is None:
        raise ValueError("sp_decode_attention: pass the torch.distributed group the cache is sharded over")
    idx = dist.get_rank(group)
    s_loc = k_shard.shape[_SEQ_AXIS]
    loc_len = (lengths.to(torch.int64) - idx * s_loc).clamp(0, s_loc).to(torch.int32)
    acc, m, den = decode_attention_partial(q, k_shard, v_shard, ks_shard, vs_shard, loc_len, layer)
    return lse_merge(acc, m, den, _all_reduce(dist.ReduceOp.MAX, group), _all_reduce(dist.ReduceOp.SUM, group))
