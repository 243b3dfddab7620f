"""One rank of the sequence-parallel decode test
(tests/test_torch_sp_attention.py), spawned by ``torch.multiprocessing``.
It imports only torch, numpy and the port: the rank reads the global
inputs, takes its contiguous shard with ``sp_cache_shard``, runs
``sp_decode_attention`` over a gloo group made from a FileStore and saves
its output and the names of any JAX module it loaded."""

import os
import sys


def run(rank, world, store_path, inputs_path, out_prefix):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the loopback: the ranks share one host
    import numpy as np
    import torch
    import torch.distributed as dist

    from qllm_tpu_torch.parallel import sp_cache_shard, sp_decode_attention

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        data = np.load(inputs_path)
        q = torch.from_numpy(data["q"]).to(torch.bfloat16)
        shards = [sp_cache_shard(torch.from_numpy(data[k]), rank, world) for k in ("k", "v", "ks", "vs")]
        lengths = torch.from_numpy(data["lengths"])
        out = sp_decode_attention(q, *shards, lengths, int(data["layer"]), dist.group.WORLD)
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "qllm_tpu")]
        np.savez(f"{out_prefix}{rank}.npz", out=out.numpy(), loaded=np.asarray(loaded, dtype=str))
    finally:
        dist.destroy_process_group()
