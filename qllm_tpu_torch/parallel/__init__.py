"""Multi-rank decode on ``torch.distributed`` (the counterpart of
``qllm_tpu/parallel``): sequence-parallel attention over a KV cache
sharded on its sequence axis."""

from .sp_attention import lse_merge, sp_cache_shard, sp_decode_attention

__all__ = ["lse_merge", "sp_cache_shard", "sp_decode_attention"]
