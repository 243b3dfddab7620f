"""Sequence-parallel decode attention: the port's K21 plain version and
``parallel.sp_decode_attention`` against the JAX package's
``decode_attention_partial`` (interpreted) and ``sp_decode_attention`` on
a 4-device CPU mesh.

The ranks of the 4-rank test are processes spawned by
``torch.multiprocessing`` (tests/torch_sp_worker.py, which imports only
the port) and joined into a gloo group through a FileStore in the test's
temporary directory. Tolerances: the partial statistics within 1e-2 of
max|JAX| for acc and den and 1e-5 relative for m (both run the same
one-shot arithmetic; m is one max of f32 dot products); the merged
attention within atol/rtol 2e-2, JAX's own bound for the merge
(tests/test_parallel.py:190)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh, NamedSharding

from qllm_tpu.ops.pallas_attention import decode_attention_partial as jax_partial
from qllm_tpu.parallel import sp_cache_pspecs
from qllm_tpu.parallel import sp_decode_attention as jax_sp
from qllm_tpu_torch.ops import attention as att
from qllm_tpu_torch.parallel import lse_merge, sp_cache_shard, sp_decode_attention

WORLD = 4
MERGE_TOL = 2e-2


def _inputs():
    """tests/test_parallel.py:150-190's shapes and lengths [100, 509] plus
    a row of length 37, which leaves shards 1-3 empty."""
    rng = np.random.default_rng(11)
    L, B, Hkv, S, d, n_rep = 2, 3, 2, 512, 128, 2
    q = np.asarray(jnp.asarray(rng.normal(size=(B, Hkv * n_rep, d)), jnp.bfloat16), np.float32)
    k = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    v = rng.integers(-127, 128, (L, B, Hkv, S, d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (L, B, Hkv, S)).astype(np.float32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, lengths=np.array([100, 509, 37], np.int32), layer=np.int32(1))


def _torch_args(x):
    return [torch.from_numpy(x["q"]).to(torch.bfloat16)] + [torch.from_numpy(x[n]) for n in ("k", "v", "ks", "vs")]


def _jax_sp(x):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("sp",))
    kv_spec, sc_spec = sp_cache_pspecs("sp")
    put = {n: jax.device_put(jnp.asarray(x[n]), NamedSharding(mesh, kv_spec if n in ("k", "v") else sc_spec))
           for n in ("k", "v", "ks", "vs")}
    out = jax_sp(jnp.asarray(x["q"], jnp.bfloat16), put["k"], put["v"], put["ks"], put["vs"],
                 jnp.asarray(x["lengths"]), jnp.int32(x["layer"]), mesh)
    return np.asarray(out), put


def test_partial_plain_matches_jax():
    """K21's plain version on one shard (rows [128, 256) of the global
    cache, the local lengths of shard 1) against JAX's partial kernel; the
    row of global length 37 leaves it empty: m = -1e30 exactly, acc and den 0."""
    x = _inputs()
    q, *cache = _torch_args(x)
    shard = [sp_cache_shard(t, 1, WORLD) for t in cache]
    loc = np.clip(x["lengths"] - 128, 0, 128).astype(np.int32)
    assert loc[2] == 0
    ref = jax_partial(jnp.asarray(x["q"], jnp.bfloat16), *[jnp.asarray(t.numpy()) for t in shard],
                      jnp.asarray(loc), jnp.int32(1))
    port = att.decode_attention_partial(q, *shard, torch.from_numpy(loc), 1)
    for name, a, r in zip(("acc", "m", "den"), port, ref):
        r = np.asarray(r)
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape, name
        a = a.numpy()
        if name == "m":
            np.testing.assert_allclose(a, r, rtol=1e-5, atol=0)
        else:
            assert np.abs(a - r).max() <= 1e-2 * np.abs(r).max(), name
    acc, m, den = (t.numpy() for t in port)
    assert (m[2] == np.float32(-1e30)).all() and (acc[2] == 0).all() and (den[2] == 0).all()


def test_cache_shard_is_the_mesh_shard():
    """``sp_cache_shard(t, i, n)`` is the block JAX's ``sp_cache_pspecs``
    place on device i of the mesh."""
    x = _inputs()
    _, put = _jax_sp(x)
    for name in ("k", "ks"):
        for shard in put[name].addressable_shards:
            i = jax.devices()[:WORLD].index(shard.device)
            mine = sp_cache_shard(torch.from_numpy(x[name]), i, WORLD)
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data))


def test_four_rank_gloo_group_matches_jax_mesh(tmp_path):
    """4 spawned ranks over gloo against JAX's shard_map on a 4-device
    mesh; every rank holds the same output, and no rank loaded JAX."""
    x = _inputs()
    np.savez(tmp_path / "inputs.npz", **x)
    ref, _ = _jax_sp(x)
    from torch_sp_worker import run

    ctx = mp.spawn(run, args=(WORLD, str(tmp_path / "store"), str(tmp_path / "inputs.npz"), str(tmp_path / "out")),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish in 240 s")
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(WORLD)]
    for o in outs:
        assert o["loaded"].size == 0, o["loaded"]
        np.testing.assert_array_equal(o["out"], outs[0]["out"])
    assert outs[0]["out"].shape == ref.shape
    np.testing.assert_allclose(outs[0]["out"], ref, atol=MERGE_TOL, rtol=MERGE_TOL)


def test_shards_merged_in_one_process_match_jax_mesh():
    """Every shard's K21 partials in one process, merged by ``lse_merge``
    over the shard axis (what the group's all-reduces compute)."""
    x = _inputs()
    ref, _ = _jax_sp(x)
    q, *cache = _torch_args(x)
    lengths = torch.from_numpy(x["lengths"])
    parts = []
    for r in range(WORLD):
        loc = (lengths - r * 128).clamp(0, 128).to(torch.int32)
        parts.append(att.decode_attention_partial(q, *[sp_cache_shard(t, r, WORLD) for t in cache], loc, 1))
    acc, m, den = (torch.stack(p) for p in zip(*parts))
    out = lse_merge(acc, m, den, lambda t: t.amax(0), lambda t: t.sum(0))
    np.testing.assert_allclose(out.numpy(), ref, atol=MERGE_TOL, rtol=MERGE_TOL)


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_one_rank_group_gives_k3b(one_rank_group):
    """One rank holds the whole cache: the merge of its single partial is
    K3b's plain output over every row; no group raises."""
    x = _inputs()
    args = _torch_args(x)
    lengths = torch.from_numpy(x["lengths"])
    out = sp_decode_attention(*args, lengths, 1, one_rank_group)
    ref = att.decode_attn_int8_plain(*args, lengths, 1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=MERGE_TOL, rtol=MERGE_TOL)
    with pytest.raises(ValueError, match="group"):
        sp_decode_attention(*args, lengths, 1, None)
