"""Port parity for the fused expert MLP (K19 ``w4_grouped_fused_mlp``,
the port of ``_qmm_kernel_grouped_fused``) against the JAX package, on
the CPU at tiny sizes:

  * K19's plain version through ``qmatmul_grouped_experts_fused`` against
    JAX's ``qmatmul_grouped_experts_fused`` interpreted
    (QLLM_TPU_FORCE_STACKED_KERNEL=1, QLLM_TPU_MOE_FUSED=1), E = 4, K1 =
    512, K2 = 256, ids with a repeat (tests/test_moe_sparse.py:368), silu
    and gelu (the kernel's tanh form), per-row and shared-row, within one
    bf16 ulp of max|y|;
  * ``grouped_fused_ok`` against JAX's gate on its chip (``default_backend``
    reporting "tpu"), refusals included (f32 scales among them);
  * a 2-layer tiny Qwen3-MoE hybrid-stacked with bf16 scales at batch 1
    with the switch on in both packages: K19 once a layer a step, K8 not
    at all, greedy tokens equal to JAX's, logits within 5e-2.

The JAX package reads its switches when it traces: every test that sets
one clears JAX's caches on the way in and out.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models import stacked as jstacked
from qllm_tpu.models.generate import decode_step as j_decode_step
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.models.generate import prefill as j_prefill
from qllm_tpu.ops import pallas_qmm as jpq
from qllm_tpu.quant.qtensor import quantize_tensor as j_quantize
from qllm_tpu_torch.interop import params_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models.decode_loop import decode_loop as t_decode_loop
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.models.generate import prefill as t_prefill
from qllm_tpu_torch.ops import qmm as tqmm
from test_torch_moe import TOL, _assert_identical, _hybrid_both, _moe_params

E, K1, K2 = 4, 512, 256
IDS = np.array([0, 2, 2, 3], np.int32)  # selection 2 repeats selection 1's expert


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    monkeypatch.setenv("QLLM_TPU_MOE_FUSED", "1")
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    jax.clear_caches()
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def _ulp_tol(y_ref):
    """One bf16 ulp at the output's magnitude."""
    return float(2.0 ** (np.floor(np.log2(np.abs(y_ref).max())) - 7))


@functools.lru_cache(maxsize=None)
def _stacks(seed=0, scale_dtype=jnp.bfloat16):
    """JAX's [E]-stacked gate|up (K1 -> 2*K2) and down (K2 -> K1) serving
    preps, as tests/test_moe_sparse.py:388-410 builds them, and the port's
    copies of the same bits (cached: the callers do not modify them)."""
    rng = np.random.default_rng(seed)

    def stack(K, N):
        parts = [
            j_quantize(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4, group_size=128)
            for _ in range(E)
        ]
        raw = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *parts)
        return jstacked.prepare_stacked_tensor(raw, lane_quantum=128, planar=True, scale_store_dtype=scale_dtype)

    jgu, jdn = stack(K1, 2 * K2), stack(K2, K1)
    tgu, tdn = (params_from_numpy(jax.tree_util.tree_map(np.asarray, s), device="cpu") for s in (jgu, jdn))
    return jgu, jdn, tgu, tdn


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("shared", [False, True])
def test_fused_plain_matches_interpreted_kernel(fused_env, act, shared):
    jgu, jdn, tgu, tdn = _stacks()
    rng = np.random.default_rng(1)
    n = len(IDS)
    x = rng.normal(size=(n, K1)).astype(np.float32)
    if shared:  # one token's selections: every row is the same row
        x[:] = x[0]
    assert jpq.grouped_fused_ok(jgu, jdn, n, act)
    assert tqmm.grouped_fused_ok(tgu, tdn, n, act)
    yj = np.asarray(jpq.qmatmul_grouped_experts_fused(jnp.asarray(x), jgu, jdn, jnp.asarray(IDS), act=act), np.float32)
    xt = torch.from_numpy(x[:1] if shared else x)
    yt = tqmm.qmatmul_grouped_experts_fused(xt, tgu, tdn, torch.from_numpy(IDS), act=act, x_shared=shared)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == (n, K1)
    yt = yt.float().numpy()
    np.testing.assert_allclose(yt, yj, atol=_ulp_tol(yj), rtol=0)
    if shared:  # the repeated (row, expert) pair gives the same bits
        np.testing.assert_array_equal(yt[1], yt[2])


def _variants(jgu, jdn, tgu, tdn):
    """(name, JAX args, port args) of the gate's cases: one it takes and
    one for each refusal."""

    def both(fn):
        return fn(jgu, jdn, jnp), fn(tgu, tdn, torch)

    def wide(gu, _, lib):  # a buffer of 2*K2 + 128 columns: K2 does not tile it
        q = gu.qweight
        pad = [(0, 0)] * (q.ndim - 1) + [(0, 128)]
        qw = jnp.pad(q, pad) if lib is jnp else torch.nn.functional.pad(q, (0, 128))
        return dataclasses.replace(gu, qweight=qw)

    def f32(qt, lib):
        return dataclasses.replace(qt, scales=qt.scales.astype(jnp.float32) if lib is jnp else qt.scales.float())

    def perm(qt, lib):
        p = (jnp.arange if lib is jnp else torch.arange)(K1)
        return dataclasses.replace(qt, perm=p)

    cases = {
        "ok": both(lambda gu, dn, lib: (gu, dn, 4, "silu")),
        "gelu": both(lambda gu, dn, lib: (gu, dn, 16, "gelu")),
        "relu": both(lambda gu, dn, lib: (gu, dn, 4, "relu")),
        "n17": both(lambda gu, dn, lib: (gu, dn, 17, "silu")),
        "gu_not_2k2": both(lambda gu, dn, lib: (dataclasses.replace(gu, out_features=2 * K2 - 128), dn, 4, "silu")),
        "k2_over_1024": both(lambda gu, dn, lib: (dataclasses.replace(gu, out_features=2 * 1280),
                                                  dataclasses.replace(dn, in_features=1280), 4, "silu")),
        "buffer_not_tiled": both(lambda gu, dn, lib: (wide(gu, dn, lib), dn, 4, "silu")),
        "group_sizes_differ": both(lambda gu, dn, lib: (gu, dataclasses.replace(dn, group_size=64), 4, "silu")),
        "gu_3bit": both(lambda gu, dn, lib: (dataclasses.replace(gu, bits=3), dn, 4, "silu")),
        "dn_not_planar": both(lambda gu, dn, lib: (gu, dataclasses.replace(dn, planar=False), 4, "silu")),
        "not_prefolded": both(lambda gu, dn, lib: (dataclasses.replace(gu, zeros_prefolded=False), dn, 4, "silu")),
        "act_order": both(lambda gu, dn, lib: (perm(gu, lib), dn, 4, "silu")),
        "gu_f32_scales": both(lambda gu, dn, lib: (f32(gu, lib), dn, 4, "silu")),
        "dn_f32_scales": both(lambda gu, dn, lib: (gu, f32(dn, lib), 4, "silu")),
        "not_full_k": both(lambda gu, dn, lib: (dataclasses.replace(gu, in_features=384), dn, 4, "silu")),
    }
    return cases


CASES = ["ok", "gelu", "relu", "n17", "gu_not_2k2", "k2_over_1024", "buffer_not_tiled", "group_sizes_differ",
         "gu_3bit", "dn_not_planar", "not_prefolded", "act_order", "gu_f32_scales", "dn_f32_scales", "not_full_k"]


@pytest.mark.parametrize("case", CASES)
def test_gate_mirrors_jax_chip_gate(fused_env, case):
    """grouped_fused_ok on JAX's chip (default_backend "tpu": the f32-scale
    refusal of :2347-2348 applies) against the port's gate, which is the
    chip's on every device."""
    jargs, targs = _variants(*_stacks())[case]
    fused_env.setattr(jax, "default_backend", lambda: "tpu")
    expected = jpq.grouped_fused_ok(*jargs)
    assert tqmm.grouped_fused_ok(*targs) == expected
    assert expected == (case in ("ok", "gelu"))


def _count(monkeypatch, name):
    """Count calls of a kernel's plain version (what a CPU tensor runs)."""
    calls = []
    plain = getattr(tqmm, name)

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(tqmm, name, counted)
    return calls


def test_tiny_qwen3_fused_decode_matches_jax(fused_env):
    """Prefill (the dense expert loop) then greedy steps at batch 1 with
    the fused expert MLP on in both packages (K19 once a layer a step, no
    K8), from the same bf16 hybrid stacks."""
    T, STEPS, MAX_SEQ, SEED = 16, 4, 32, 0
    jcfg, npp, rng = _moe_params("qwen3_moe", SEED, False)
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    assert jcfg.num_experts_per_tok < jcfg.num_local_experts  # decode is sparse
    js, ts = _hybrid_both(npp)
    _assert_identical(js["layers"], ts["layers"])
    est = js["layers"]["experts_stacked"]
    assert jpq.grouped_fused_ok(est["gateup_proj"], est["down_proj"], jcfg.num_experts_per_tok, jcfg.hidden_act)
    tokens = rng.integers(0, jcfg.vocab_size, (1, T)).astype(np.int32)

    jcache = j_make_cache(jcfg, 1, MAX_SEQ)
    jl, jcache = j_prefill(js, jcfg, jnp.asarray(tokens), jcache)
    j_logits = [np.asarray(jl)]
    tok = np.argmax(j_logits[0], axis=-1).astype(np.int32)[:, None]
    j_ids = []
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(tok), jcache, jnp.int32(T + i))
        j_logits.append(np.asarray(jl))
        tok = np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None]
        j_ids.append(tok[:, 0])
    for lg in j_logits:
        s = np.sort(lg, axis=-1)
        assert np.all(s[:, -1] - s[:, -2] > 2 * (TOL + TOL * np.abs(s[:, -1]))), "greedy decision too close"

    tcache = t_make_cache(tcfg, 1, MAX_SEQ, device="cpu")
    tl, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), tcache, device="cpu", moe_fused=True)
    np.testing.assert_allclose(tl.numpy(), j_logits[0], atol=TOL, rtol=TOL)
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    fused = _count(fused_env, "w4_grouped_fused_mlp_plain")
    grouped = _count(fused_env, "w4_grouped_gemv_plain")
    t_ids, _ = t_decode_loop(ts, tcfg, first, tcache, T, STEPS, device="cpu", moe_fused=True)
    assert len(fused) == jcfg.num_hidden_layers * STEPS and not grouped
    np.testing.assert_array_equal(t_ids.numpy(), np.stack(j_ids, axis=1))

    # the logits of each step on JAX's token stream, within 5e-2
    tcache = t_make_cache(tcfg, 1, MAX_SEQ, device="cpu")
    _, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), tcache, device="cpu", moe_fused=True)
    inputs = [np.argmax(j_logits[0], axis=-1)] + [i for i in j_ids[:-1]]
    for i, t_in in enumerate(inputs):
        lg, tcache = tllama.forward(ts, tcfg, torch.from_numpy(t_in.astype(np.int32))[:, None], tcache, pos=T + i,
                                    moe_fused=True)
        np.testing.assert_allclose(lg[:, -1].numpy(), j_logits[i + 1], atol=TOL, rtol=TOL)
