"""Port parity for planar 4-bit stacks whose zero-point correction is not
fused: f32 scales (the JAX package's default stacking) or zeros not
prefolded, served by K17 ``w4_planar_f32s_gemv`` (M <= 32) and K18
``w4_planar_f32s_gemm`` (M > 32), the port of ``_qmm_kernel_planar``.

  * Kernel contract: JAX's ``_qmm_2d_stacked(..., planar=True,
    fuse_corr=False)`` called directly (``_qmm_kernel_planar`` in
    interpret mode; ``qmatmul_pallas_stacked`` on the CPU would fuse an
    f32 prefolded stack, pallas_qmm.py:1615, and run #1) against K17's and
    K18's plain versions plus the port's correction, within one bf16 ulp
    of the output's magnitude.
  * Routing: ``stacked_route`` against the branch JAX's gate takes on its
    chip, written out from the chip's lines (pallas_qmm.py:1607-1664 and
    :1115-1168) and traced from JAX's own gate with ``default_backend``
    reporting "tpu" (``jax.eval_shape``: traced, never compiled), over
    scale dtype, prefolding, geometry, M and W4A8.
  * The three faults this slice repairs: g16 planar stacks through K1 /
    K2, non-prefolded planar stacks through K17 / K18, the f32 defaults.
  * The slice: a tiny llama (hidden 512, intermediate 2816, 4 heads, g =
    32, 2 layers, quantized lm_head) stacked with both packages'
    defaults (bit-identical), whose down_proj (K = 2816 = 256 * 11) has no
    ``planar_bk``, as the 7B's K = 11008: the fallback at decode, K18 with
    the relaxed k-block 256 at prefill. Prefill and 8 greedy
    ``decode_loop`` steps, the ring path and ``w4a8=True`` against JAX
    with its chip's branch (QLLM_TPU_FUSED_CORR=0 takes it on the CPU for
    these stacks; its per-layer fallback sent to ``qmatmul_pallas``, the
    port's to K9 / K12's plain versions, as on the chip), logits within
    5e-2; the unstack round trip.

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

import qllm_tpu.ops.pallas_qmm as pq
import qllm_tpu.ops.ref_matmul as j_ref_matmul
from qllm_tpu.models import llama as jllama
from qllm_tpu.models import stacked as jstacked
from qllm_tpu.models.generate import decode_step as j_decode_step
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.models.generate import prefill as j_prefill
from qllm_tpu.ops.pallas_attention import kv_ring_flush_pallas
from qllm_tpu.quant.qtensor import QuantizedTensor as JQT
from qllm_tpu.utils.testing import random_quantized_params as j_random_params
from qllm_tpu_torch.interop import cache_from_numpy, params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models import stacked as tstacked
from qllm_tpu_torch.models.decode_loop import decode_loop as t_decode_loop
from qllm_tpu_torch.models.generate import decode_step as t_decode_step
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.models.generate import prefill as t_prefill
from qllm_tpu_torch.ops import _build, qmm, qmm2d, qmm_planar
from qllm_tpu_torch.ops import attention as tat
from qllm_tpu_torch.ops import ref_matmul as t_ref_matmul
from test_torch_slice import TOL, _assert_separated, _assert_stacks_identical, _np

N = 256
# (K, g): planar_bk 2048 at g 128 and 64; K = 2816 has none (the relaxed
# k-block 256 at prefill, the fallback at decode: 7B's down_proj in
# small); g = 16 with bk 512
GEOMS = [(2048, 128), (2048, 64), (2816, 128), (512, 16)]


@pytest.fixture
def jax_env(monkeypatch):
    monkeypatch.setenv("QLLM_TPU_FORCE_STACKED_KERNEL", "1")
    monkeypatch.setenv("QLLM_TPU_WIDE_PAD", "0")
    jax.clear_caches()
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def _ulp_tol(y_ref):
    """One bf16 ulp at the output's magnitude."""
    return float(2.0 ** (np.floor(np.log2(np.abs(y_ref).max())) - 7))


@functools.lru_cache(maxsize=None)
def _stacks(K, g, sd, prefolded, seed, L=2):
    """One planar q_proj stack of L random layers: JAX's serving prep with
    ``sd`` scale storage; not ``prefolded``: the raw zeros put back (in
    ``sd``, padded) in place of zs, as tests/test_pallas_qmm.py:150-195
    builds such a stack. -> (JAX stack, the port's copy), cached."""
    js, zeros = _prefolded_stack(K, g, sd, seed, L)
    if not prefolded:
        jsd = jnp.float32 if sd == "f32" else jnp.bfloat16
        z = jnp.pad(zeros, ((0, 0), (0, 0), (0, js.qweight.shape[-1] - N))).astype(jsd)
        js = dataclasses.replace(js, zeros=z, zeros_prefolded=False)
    return js, params_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")


@functools.lru_cache(maxsize=None)
def _prefolded_stack(K, g, sd, seed, L):
    """The prefolded JAX stack of ``_stacks`` and its layers' raw zeros
    (f32 [L, G, N])."""
    rng = np.random.default_rng(seed)
    G = K // g
    layers = [
        {
            "q_proj": JQT(
                qweight=jnp.asarray(rng.integers(0, 2**32, (K // 8, N), dtype=np.uint32)),
                scales=jnp.asarray((rng.uniform(0.5, 1.5, (G, N)) * 0.01).astype(np.float16)),
                zeros=jnp.asarray(rng.integers(0, 16, (G, N)).astype(np.float16)),
                perm=None, bits=4, group_size=g, in_features=K, out_features=N,
            )
        }
        for _ in range(L)
    ]
    jsd = jnp.float32 if sd == "f32" else jnp.bfloat16
    js = jstacked.stack_layer_params({"layers": layers}, scale_store_dtype=jsd)["layers"]["q_proj"]
    assert js.planar
    return js, jnp.stack([lp["q_proj"].zeros for lp in layers]).astype(jnp.float32)


def _jax_unfused(js, x, layer):
    """_qmm_kernel_planar through _qmm_2d_stacked, interpreted, with the
    caller's padding of M to 8 rows (pallas_qmm.py:1729-1732)."""
    M, K = x.shape
    xp = jnp.pad(x, ((0, max(8, -(-M // 8) * 8) - M), (0, 0)))
    y = pq._qmm_2d_stacked(xp, jnp.int32(layer), js.qweight, js.scales, js.zeros, 4, js.group_size, K,
                           js.qweight.shape[-1], planar=True, prefolded=js.zeros_prefolded, fuse_corr=False)
    return np.asarray(y.astype(jnp.float32))[:M]


def _count_calls(monkeypatch, mod, names, seen=None):
    """Wrap ``mod.<name>`` with a call counter kept in ``seen`` (a new dict
    if None): -> {name: calls}."""
    seen = {} if seen is None else seen
    seen.update({n: 0 for n in names})

    def wrap(name, fn):
        def counted(*a, **k):
            seen[name] += 1
            return fn(*a, **k)

        return counted

    for n in names:
        monkeypatch.setattr(mod, n, wrap(n, getattr(mod, n)))
    return seen


# ---------------------------------------------------------------------------
# the kernel contract
# ---------------------------------------------------------------------------

KERNEL_CASES = [
    (K, g, M, p)
    for K, g in GEOMS
    for M in (1, 8, 32, 64, 256)
    for p in (True, False)
    # K = 2816 at M <= 32 has no k-block: JAX's kernel raises and its gate
    # takes the fallback (test_route_names_jax_chip_branch)
    if not (K == 2816 and M <= 32)
]


@pytest.mark.parametrize("K,g,M,prefolded", KERNEL_CASES)
def test_f32s_plain_versions_match_interpreted_kernel(monkeypatch, K, g, M, prefolded):
    """K17's (M <= 32) or K18's plain version plus the port's correction
    (``_planar_unfused_matmul``) against ``_qmm_kernel_planar`` at layer 1
    (no switch involved: the kernel is called directly)."""
    js, ts = _stacks(K, g, "f32", prefolded, seed=K + g)
    rng = np.random.default_rng(M)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    y_ref = _jax_unfused(js, x, 1)
    calls = _count_calls(monkeypatch, qmm_planar, ("w4_planar_f32s_gemv", "w4_planar_f32s_gemm"))
    y = qmm._planar_unfused_matmul(tensor_from_numpy(np.asarray(x), "cpu"), ts, 1, None, 1e-6, M, K, g)
    assert calls == {"w4_planar_f32s_gemv": int(M <= 32), "w4_planar_f32s_gemm": int(M > 32)}
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == y_ref.shape
    np.testing.assert_allclose(y.float().numpy(), y_ref, atol=_ulp_tol(y_ref), rtol=0)


# ---------------------------------------------------------------------------
# routing: stacked_route against JAX's chip gate
# ---------------------------------------------------------------------------

# The branch JAX's chip takes, written out from its lines: fuse = zeros
# prefolded and bf16 scales (:1607-1617, the CPU's "or cpu" left out);
# ok = planar_bk(K, g, K) or (fuse and the full-K geometry within the 4
# MiB cap), at M > 32 also planar_bk_relaxed (:1627-1653); not ok: the
# fallback; ok and not fused: _qmm_kernel_planar ("unfused"); fused: the
# full-K kernel (#1) at M <= 32 ("a8" under W4A8) and where no k-block
# exists, else the blocked fused kernel (#2) ("fused").
# Per (fused, K, g): (M <= 32, M > 32, M <= 32 under W4A8, M > 32 under W4A8).
CHIP_BRANCH = {
    (False, 2048, 128): ("unfused",) * 4,
    (False, 2048, 64): ("unfused",) * 4,
    (False, 2816, 128): ("fallback", "unfused") * 2,
    (False, 512, 16): ("unfused",) * 4,
    (False, 256, 8): ("unfused",) * 4,
    (True, 2048, 128): ("fused", "fused", "a8", "fused"),
    (True, 2048, 64): ("fused", "fused", "a8", "fused"),
    (True, 2816, 128): ("fused", "fused", "a8", "fused"),
    (True, 512, 16): ("fused", "fused", "a8", "fused"),
    (True, 256, 8): ("fused", "fused", "a8", "fused"),
}
# g = 8: JAX's planar kernels take it (planar_bk(256, 8) = 256), and so
# do the port's (a group closing inside a 16-k tile runs the tile once per
# group)


def _jax_chip_branches(monkeypatch, js, Ms, w4a8):
    """The kernel ``qmatmul_pallas_stacked`` traces with the chip's backend
    at each M: its planar kernels and the fallback's qmatmul wrapped with
    counters, ``jax.default_backend`` reporting "tpu", the call traced by
    ``jax.eval_shape`` (nothing compiles or runs). The traces of the gate's
    jitted functions are cleared before (a cached trace would not run the
    counters) and after (a trace made for the chip must not serve the
    CPU)."""
    seen = []

    def wrap(fn, tag):
        def counted(*a, **k):
            seen.append("a8" if k.get("a8") else tag)
            return fn(*a, **k)

        return counted

    with monkeypatch.context() as mp:
        for name, tag in (("_qmm_kernel_planar_full", "fused"), ("_qmm_kernel_planar_fused", "fused"),
                          ("_qmm_kernel_planar", "unfused")):
            mp.setattr(pq, name, wrap(getattr(pq, name), tag))
        mp.setattr(j_ref_matmul, "qmatmul", wrap(j_ref_matmul.qmatmul, "fallback"))
        if w4a8:
            mp.setenv("QLLM_TPU_W4A8", "1")
        # the default blocks, which also keep the tuned table out (the port
        # mirrors none)
        mp.setenv("QLLM_TPU_QMM_BN", "512")
        mp.setenv("QLLM_TPU_QMM_BK", "2048")
        mp.setattr(jax, "default_backend", lambda: "tpu")
        _clear_gate_traces()
        out = []
        for M in Ms:
            seen.clear()
            x = jax.ShapeDtypeStruct((M, js.in_features), jnp.bfloat16)
            jax.eval_shape(lambda x: pq.qmatmul_pallas_stacked(x, js, jnp.int32(1)), x)
            assert len(set(seen)) == 1, (M, seen)
            out.append(seen[0])
    _clear_gate_traces()
    return out


def _clear_gate_traces():
    """Drop the cached traces of the jitted functions the stacked gate and
    its fallback run (``_qmm_2d_stacked``, ``_qmm_2d``)."""
    pq._qmm_2d_stacked.clear_cache()
    pq._qmm_2d.clear_cache()


def _port_branch(monkeypatch, ts, M, w4a8):
    """The branch ``qmatmul_stacked`` takes, by the wrapper it calls; each
    wrapper is counted and returns zeros of its output's shape (the values
    are the kernel tests')."""
    seen = {}

    def stub(mod, name, cols):
        def called(x, w, *a, **k):
            seen[name] += 1
            return torch.zeros((*x.shape[:-1], cols(w)), dtype=x.dtype)

        seen[name] = 0
        mp.setattr(mod, name, called)

    with monkeypatch.context() as mp:
        for name in ("w4_planar_gemv", "w4_planar_gemm", "w4a8_planar_gemv"):
            stub(qmm, name, lambda qw: qw.shape[-1])
        for name in ("w4_planar_f32s_gemv", "w4_planar_f32s_gemm"):
            stub(qmm_planar, name, lambda qw: qw.shape[-1])
        stub(qmm2d, "qmatmul_2d", lambda qt: qt.out_features)
        stub(t_ref_matmul, "qmatmul_ref", lambda qt: qt.out_features)
        x = torch.zeros((M, ts.in_features), dtype=torch.bfloat16)
        qmm.qmatmul_stacked(x, ts, 1, w4a8=w4a8)
    tags = {"w4_planar_gemv": "fused", "w4_planar_gemm": "fused", "w4a8_planar_gemv": "a8",
            "w4_planar_f32s_gemv": "unfused", "w4_planar_f32s_gemm": "unfused", "qmatmul_2d": "fallback",
            "qmatmul_ref": "fallback"}
    taken = {tags[n] for n, c in seen.items() if c}
    assert len(taken) == 1 and sum(seen.values()) == 1, seen
    return taken.pop()


@pytest.mark.parametrize("K,g", GEOMS + [(256, 8)])
@pytest.mark.parametrize("sd,prefolded", [("f32", True), ("f32", False), ("bf16", True), ("bf16", False)])
def test_route_names_jax_chip_branch(jax_env, sd, prefolded, K, g):
    """stacked_route, the wrapper the port calls and the kernel JAX's chip
    gate traces agree with the chip's lines at M in (1, 32, 33, 256), with
    and without W4A8; g = 8 included."""
    js, ts = _stacks(K, g, sd, prefolded, seed=K + g)
    fused = prefolded and sd == "bf16"
    want = CHIP_BRANCH[(fused, K, g)]
    route_tag = {"planar": "fused", "planar_f32": "unfused", "fallback": "fallback"}
    Ms = (1, 32, 33, 256)
    for w4a8 in (False, True):
        assert _jax_chip_branches(jax_env, js, Ms, w4a8) == [want[2 * w4a8 + (M > 32)] for M in Ms], w4a8
    for w4a8, M in ((w, m) for w in (False, True) for m in Ms):
        expected = want[2 * w4a8 + (M > 32)]
        port = route_tag[qmm.stacked_route(ts, M, w4a8=w4a8)]
        if port == "fused" and w4a8 and M <= 32 and qmm.a8_full_k_ok(K, g, ts.qweight.shape[-1]):
            port = "a8"
        assert port == expected, (M, w4a8)
        if M in (1, 33):  # the wrapper each branch calls (the CPU's plain versions)
            assert _port_branch(jax_env, ts, M, w4a8) == expected, (M, w4a8)


# ---------------------------------------------------------------------------
# the faults this slice repairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [8, 40])
def test_g16_planar_stacks_take_k1_k2(jax_env, M):
    """A bf16 prefolded g = 16 planar stack takes K1 (M <= 32) / K2 (M > 32)
    as JAX takes its fused planar kernels, no longer the fallback; their
    plain versions match the interpreted kernels within
    tests/test_torch_qmm.py's 2e-2 * max|y|. So does the g = 8 stack,
    whose groups close inside a 16-k tile."""
    for K, g, branch in ((512, 16, "planar"), (256, 8, "planar")):
        js, ts = _stacks(K, g, "bf16", True, seed=K + g)
        rng = np.random.default_rng(M + g)
        assert qmm.stacked_route(ts, M) == branch
        x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
        y_ref = np.asarray(pq.qmatmul_pallas_stacked(x, js, jnp.int32(1)).astype(jnp.float32))
        with jax_env.context() as mp:
            _build_qmatmul_on_cpu(mp)
            y = qmm.qmatmul_stacked(tensor_from_numpy(np.asarray(x), "cpu"), ts, 1).float().numpy()
        scale = float(np.abs(y_ref).max())
        np.testing.assert_allclose(y, y_ref, atol=2e-2 * scale, rtol=2e-2)


def _build_qmatmul_on_cpu(mp):
    """Send the port's CPU fallback to qmatmul_2d (K9 / K10 / K12's plain
    versions, f32 weights), as the card runs it (chip_smoke.py's cross
    phase does the same); by default the CPU takes qmatmul_ref."""
    use_kernel = _build.use_kernel
    mp.setattr(_build, "use_kernel", lambda t, name: name == "qmatmul" or use_kernel(t, name))


@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_non_prefolded_planar_stacks_take_k17_k18(jax_env, sd):
    """Zeros not prefolded: K17 / K18 with ``zeros * scales`` folded in f32
    outside (bf16 scales cast to f32 for the layer), as JAX runs
    ``_qmm_kernel_planar`` for them at any scale dtype; within one bf16
    ulp of the interpreted kernel."""
    js, ts = _stacks(2048, 128, sd, False, seed=2048 + 128)
    rng = np.random.default_rng(5)
    for M in (4, 48):
        assert qmm.stacked_route(ts, M) == "planar_f32"
        x = jnp.asarray(rng.normal(size=(M, 2048)).astype(np.float32), jnp.bfloat16)
        y_ref = _jax_unfused(js, x, 1)[:, :N]
        y = qmm.qmatmul_stacked(tensor_from_numpy(np.asarray(x), "cpu"), ts, 1).float().numpy()
        np.testing.assert_allclose(y, y_ref, atol=_ulp_tol(y_ref), rtol=0)


def test_stacking_defaults_are_jax_defaults():
    """stack_layer_params, prepare_stacked_tensor, prepare_lm_head and the
    hybrid (MoE) prep with no options build JAX's default stacks (f32
    scales, planar where it fits) bit for bit."""
    _, _, npp, _, ts = _slice_stacks()  # both packages' defaults, asserted bit-identical
    for v in list(ts["layers"].values()) + [ts["lm_head"]]:
        if hasattr(v, "qweight"):
            assert v.planar and v.scales.dtype == v.zeros.dtype == torch.float32
    raw = npp["layers"][0]["o_proj"]
    jw = jstacked.prepare_stacked_tensor(jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], raw))
    tw = tstacked.prepare_stacked_tensor(params_from_numpy(jax.tree_util.tree_map(lambda a: np.asarray(a)[None], raw),
                                                           device="cpu"))
    _assert_stacks_identical({"o": jw}, {"o": tw})
    jh = jstacked.stack_layer_params_hybrid(jax.tree_util.tree_map(jnp.asarray, npp))
    th = tstacked.stack_layer_params_hybrid(params_from_numpy(npp, device="cpu"))
    _assert_stacks_identical(jh["layers"], th["layers"])
    assert all(v.scales.dtype == torch.float32 for v in th["layers"].values() if hasattr(v, "qweight"))


# ---------------------------------------------------------------------------
# the slice: a tiny llama stacked with the defaults
# ---------------------------------------------------------------------------

# 2 kv heads: the JAX package's XLA attention at n_rep = 1 runs a bf16 x bf16
# -> f32 dot the CPU's runtime does not implement
SLICE_CFG = dict(vocab_size=512, hidden_size=512, intermediate_size=2816, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=671)
G = 32


@pytest.fixture
def chip_branch(jax_env):
    """JAX on its chip's branch for f32-scale planar stacks (the
    fused-correction switch off: what its chip does for them), its kernels
    and attention forced, its per-layer fallback through qmatmul_pallas;
    the port's CPU fallback through K9 / K10 / K12's plain versions."""
    jax_env.setenv("QLLM_TPU_FUSED_CORR", "0")
    jax_env.setenv("QLLM_TPU_FORCE_PALLAS_ATTN", "1")
    jax_env.setattr(j_ref_matmul, "_use_pallas", lambda: True)
    _build_qmatmul_on_cpu(jax_env)
    jax.clear_caches()
    return jax_env


# a seed whose greedy decisions are all separated by more than twice the
# tolerance (the 8 scaled lm_head columns put the logits at 25-45, where
# the relative part of 5e-2 is 1.3-2.3), as tests/test_torch_slice.py picks
SEED = 17


@functools.lru_cache(maxsize=None)
def _slice_stacks():
    """The tiny llama at g = 32 (JAX's random params, the lm_head columns
    of 8 tokens scaled up 8x as in tests/test_torch_slice.py) stacked with
    both packages' defaults, asserted identical: (jcfg, tcfg, numpy params,
    JAX stacks, the port's). Built once for the module's tests."""
    jcfg = jllama.ModelConfig(**SLICE_CFG)
    npp = jax.tree_util.tree_map(
        np.asarray, j_random_params(jcfg, jax.random.key(SEED), bits=4, group_size=G, quantize_lm_head=True)
    )
    cols = np.random.default_rng(SEED).choice(SLICE_CFG["vocab_size"], 8, replace=False)
    sc = np.array(npp["lm_head"].scales)
    sc[:, cols] = (sc[:, cols].astype(np.float32) * 8.0).astype(np.float16)
    npp["lm_head"] = dataclasses.replace(npp["lm_head"], scales=sc)
    js = jstacked.stack_layer_params(jax.tree_util.tree_map(jnp.asarray, npp))
    js["lm_head"] = jstacked.prepare_lm_head(js["lm_head"])
    ts = tstacked.stack_layer_params(params_from_numpy(npp, device="cpu"))
    ts["lm_head"] = tstacked.prepare_lm_head(ts["lm_head"])
    _assert_stacks_identical(js["layers"], ts["layers"])
    _assert_stacks_identical({"lm_head": js["lm_head"]}, {"lm_head": ts["lm_head"]})
    return jcfg, tllama.ModelConfig(**dataclasses.asdict(jcfg)), npp, js, ts


def _slice(batch, prompt):
    """The slice's stacks and prompts of ``batch`` x ``prompt`` tokens."""
    jcfg, tcfg, npp, js, ts = _slice_stacks()
    rng = np.random.default_rng(SEED)
    rng.choice(SLICE_CFG["vocab_size"], 8, replace=False)  # the lm_head columns' draw
    tokens = rng.integers(0, SLICE_CFG["vocab_size"], (batch, prompt)).astype(np.int32)
    return jcfg, tcfg, npp, tokens, js, ts


def test_f32_slice_prefill_decode_loop_matches_jax(chip_branch):
    """B = 2, T = 24 (M = 48: K18 for every matmul and the lm_head,
    down_proj at bk 256), then 8 greedy steps
    (M = 2: K17 for qkv, o, gate|up and the lm_head, the fallback for
    down_proj); the launches of each are counted."""
    B, T, STEPS, MAX_SEQ = 2, 24, 8, 64
    jcfg, tcfg, _, tokens, js, ts = _slice(B, T)
    L = tcfg.num_hidden_layers
    jl, jcache = j_prefill(js, jcfg, jnp.asarray(tokens), j_make_cache(jcfg, B, MAX_SEQ))
    j_logits = [np.asarray(jl)]
    j_tokens = [np.argmax(j_logits[0], axis=-1).astype(np.int32)[:, None]]
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(j_tokens[-1]), jcache, jnp.int32(T + i))
        j_logits.append(np.asarray(jl))
        j_tokens.append(np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None])
    for lg in j_logits:
        _assert_separated(lg)

    calls = _count_calls(chip_branch, qmm_planar, ("w4_planar_f32s_gemv", "w4_planar_f32s_gemm"))
    _count_calls(chip_branch, qmm2d, ("gptq_gemv", "gptq_gemm"), calls)
    tl, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), t_make_cache(tcfg, B, MAX_SEQ, device="cpu"),
                           device="cpu")
    assert calls == {"w4_planar_f32s_gemv": 0, "w4_planar_f32s_gemm": 4 * L + 1, "gptq_gemv": 0, "gptq_gemm": 0}
    np.testing.assert_allclose(tl.numpy(), j_logits[0], atol=TOL, rtol=TOL)
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first.numpy(), j_tokens[0])
    t_ids, _ = t_decode_loop(ts, tcfg, first, tcache, T, STEPS, device="cpu")
    np.testing.assert_array_equal(t_ids.numpy(), np.concatenate(j_tokens[1:], axis=1))
    assert calls == {"w4_planar_f32s_gemv": (3 * L + 1) * STEPS, "w4_planar_f32s_gemm": 4 * L + 1,
                     "gptq_gemv": L * STEPS, "gptq_gemm": 0}
    # per step on JAX's tokens from the port's own prefill
    _, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), t_make_cache(tcfg, B, MAX_SEQ, device="cpu"),
                          device="cpu")
    for i in range(STEPS):
        tl, tcache = t_decode_step(ts, tcfg, torch.from_numpy(j_tokens[i]), tcache, T + i, device="cpu")
        np.testing.assert_allclose(tl.numpy(), j_logits[i + 1], atol=TOL, rtol=TOL, err_msg=f"step {i}")


def test_f32_slice_ring_matches_jax(chip_branch):
    """Batch 1: a T = 256 flash prefill into a ring cache, then 8
    ring-fused greedy steps (one flush) on both sides, the port's per-step
    logits from JAX's post-prefill cache (tests/test_torch_ring.py)."""
    T, STEPS, MAX_SEQ = 256, 8, 272
    jcfg, tcfg, _, tokens, js, ts = _slice(1, T)
    jl, jcache0 = j_prefill(js, jcfg, jnp.asarray(tokens), j_make_cache(jcfg, 1, MAX_SEQ, ring=True))
    j_logits = [np.asarray(jl)]
    j_tokens = [np.argmax(j_logits[0], axis=-1).astype(np.int32)[:, None]]
    jcache = jcache0
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(j_tokens[-1]), jcache, jnp.int32(T + i))
        j_logits.append(np.asarray(jl))
        j_tokens.append(np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None])
        if (T + i + 1) % tat.RING == 0:
            k2, v2, ks2, vs2 = kv_ring_flush_pallas(jcache.k, jcache.v, jcache.k_scale, jcache.v_scale,
                                                    jcache.ring_k, jcache.ring_v, jnp.full((1,), T + i + 1, jnp.int32))
            jcache = dataclasses.replace(jcache, k=k2, v=v2, k_scale=ks2, v_scale=vs2)
    for lg in j_logits:
        _assert_separated(lg)

    tl, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), t_make_cache(tcfg, 1, MAX_SEQ, ring=True, device="cpu"),
                           device="cpu")
    np.testing.assert_allclose(tl.numpy(), j_logits[0], atol=TOL, rtol=TOL)
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first.numpy(), j_tokens[0])
    t_ids, _ = t_decode_loop(ts, tcfg, first, tcache, T, STEPS, device="cpu")
    np.testing.assert_array_equal(t_ids.numpy(), np.concatenate(j_tokens[1:], axis=1))
    tcache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache0), device="cpu")
    for i in range(STEPS):
        tl, tcache = t_decode_step(ts, tcfg, torch.from_numpy(j_tokens[i]), tcache, T + i, device="cpu")
        np.testing.assert_allclose(tl.numpy(), j_logits[i + 1], atol=TOL, rtol=TOL, err_msg=f"step {i}")
        if (T + i + 1) % tat.RING == 0:
            pos = torch.full((1,), T + i + 1, dtype=torch.int32)
            tat.kv_ring_flush(tcache.k, tcache.v, tcache.k_scale, tcache.v_scale, tcache.ring_k, tcache.ring_v, pos)


def test_f32_slice_w4a8_matches_jax(chip_branch):
    """Under W4A8 the f32-scale planar matmuls stay a16 in K17 (JAX's a8
    branch lives in its fused full-K kernel) and the decode down_proj
    takes K12 in the fallback: prefill, then 6 greedy steps."""
    chip_branch.setenv("QLLM_TPU_W4A8", "1")
    jax.clear_caches()
    B, T, STEPS, MAX_SEQ = 2, 24, 6, 64
    jcfg, tcfg, _, tokens, js, ts = _slice(B, T)
    L = tcfg.num_hidden_layers
    jl, jcache = j_prefill(js, jcfg, jnp.asarray(tokens), j_make_cache(jcfg, B, MAX_SEQ))
    jcache0 = jax.tree_util.tree_map(np.asarray, jcache)
    j_tokens, j_logits = [np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]], []
    for i in range(STEPS):
        jl, jcache = j_decode_step(js, jcfg, jnp.asarray(j_tokens[-1]), jcache, jnp.int32(T + i))
        j_logits.append(np.asarray(jl))
        _assert_separated(j_logits[-1])
        j_tokens.append(np.argmax(j_logits[-1], axis=-1).astype(np.int32)[:, None])

    calls = _count_calls(chip_branch, qmm_planar, ("w4_planar_f32s_gemv",))
    _count_calls(chip_branch, qmm2d, ("gptq_w4a8_gemv", "gptq_gemv"), calls)
    _count_calls(chip_branch, qmm, ("w4a8_planar_gemv",), calls)
    tl, tcache = t_prefill(ts, tcfg, torch.from_numpy(tokens), t_make_cache(tcfg, B, MAX_SEQ, device="cpu"),
                           device="cpu", w4a8=True)
    first = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(first.numpy(), j_tokens[0])
    t_ids, _ = t_decode_loop(ts, tcfg, first, tcache, T, STEPS, device="cpu", w4a8=True)
    np.testing.assert_array_equal(t_ids.numpy(), np.concatenate(j_tokens[1:], axis=1))
    assert calls == {"w4_planar_f32s_gemv": (3 * L + 1) * STEPS, "gptq_w4a8_gemv": L * STEPS, "gptq_gemv": 0,
                     "w4a8_planar_gemv": 0}
    tcache = cache_from_numpy(jcache0, "cpu")
    for i in range(STEPS):
        tl, tcache = t_decode_step(ts, tcfg, torch.from_numpy(j_tokens[i]), tcache, T + i, device="cpu", w4a8=True)
        np.testing.assert_allclose(tl.numpy(), j_logits[i], atol=TOL, rtol=TOL, err_msg=f"step {i}")


def test_f32_unstack_round_trip():
    """unstack_layer_params inverts the f32 stacks: bit for bit JAX's
    unstack, the words and scales of the per-layer tensors, zeros within
    an f32 ulp (zs / scales), and stacking again gives the same buffers."""
    jcfg, tcfg, npp, _, js, ts = _slice(1, 8)
    jback = jstacked.unstack_layer_params(js, jcfg.num_hidden_layers, jcfg)
    tback = tstacked.unstack_layer_params(ts, tcfg.num_hidden_layers, tcfg)
    tp = params_from_numpy(npp, device="cpu")
    for jl, tl, lp0 in zip(jback["layers"], tback["layers"], tp["layers"]):
        assert set(jl) == set(tl) == set(lp0)
        for k, v in lp0.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(tl[k], v)
                continue
            for f in ("qweight", "scales", "zeros"):
                np.testing.assert_array_equal(_np(getattr(tl[k], f)), _np(getattr(jl[k], f)), err_msg=f"{k}.{f}")
            assert torch.equal(tl[k].qweight, v.qweight) and torch.equal(tl[k].scales, v.scales.float())
            torch.testing.assert_close(tl[k].zeros, v.zeros.float(), atol=0, rtol=2**-22)
    again = tstacked.stack_layer_params(tback)
    for k, v in ts["layers"].items():
        if hasattr(v, "qweight"):
            for f in ("qweight", "scales", "zeros"):
                assert torch.equal(getattr(again["layers"][k], f), getattr(v, f)), f"{k}.{f}"
