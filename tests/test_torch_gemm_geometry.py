"""K10 ``gptq_gemm`` and K18 ``w4_planar_f32s_gemm`` after their Hopper
redesign: what they take and how they split K.

  * K10's plain version at g = 16, M = 40 and 64, against the JAX
    package's ``qmatmul_pallas`` (``_qmm_2d`` in interpret mode), within
    tests/test_torch_qmm2d.py's 1e-2 * max|y|: the geometry K10 once
    refused (g % 32 != 0) and JAX computes.
  * The wrappers' geometry gates, run on the CPU with the C library
    replaced by a recorder (no card here): K10 takes every g that is a
    multiple of the pack factor and divides K (K9's geometry), K18 every
    planar g split at K/2, and each refuses the rest.
  * K10's split of K into segments: chosen from (K, N) alone, never from
    M; M decides only whether the segments spread over blocks (partial
    sums added in segment order by a second kernel) or stay in one.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.ops.pallas_qmm import qmatmul_pallas
from qllm_tpu.quant.qtensor import quantize_tensor
from qllm_tpu_torch.interop import params_from_numpy, tensor_from_numpy
from qllm_tpu_torch.ops import _build, qmm2d, qmm_planar

TOL = 1e-2


@pytest.mark.parametrize("bits,M", [(2, 64), (4, 64), (8, 64), (4, 40)])
def test_k10_plain_matches_jax_at_g16(bits, M):
    K, N, g = 512, 256, 16
    rng = np.random.default_rng(bits * 10 + M)
    jqt = quantize_tensor(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=bits, group_size=g)
    tqt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jqt), device="cpu")
    xb = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32), jnp.bfloat16)
    y_ref = np.asarray(qmatmul_pallas(xb, jqt).astype(jnp.float32))
    y = qmm2d.gptq_gemm_plain(tensor_from_numpy(np.asarray(xb), "cpu"), tqt.qweight, tqt.scales, tqt.zeros, bits, g)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (M, N)
    scale = float(np.abs(y_ref).max())
    np.testing.assert_allclose(y.float().numpy(), y_ref, atol=TOL * scale, rtol=TOL)
    y2 = qmm2d.qmatmul_2d(tensor_from_numpy(np.asarray(xb), "cpu"), tqt)
    assert torch.equal(y2, y)


class _Recorder:
    """Stands in for the kernel library: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: use_kernel answers yes,
    the library records, the stream and the SM count are the card's
    stand-ins (132 SMs, an H100's)."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda t, name: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(qmm2d, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return lib


def _gptq(bits, K, N, g, seed=0):
    rng = np.random.default_rng(seed)
    qw = torch.from_numpy(rng.integers(-(2**31), 2**31, (K * bits // 32, N), dtype=np.int64).astype(np.int32))
    sc = torch.from_numpy(rng.uniform(0.005, 0.015, (K // g, N)).astype(np.float32)).to(torch.float16)
    zr = torch.from_numpy(rng.integers(0, 2**bits, (K // g, N)).astype(np.float32)).to(torch.float16)
    return qw, sc, zr


# (bits, K, g, taken): K9's geometry (g a multiple of 32 / bits dividing K)
K10_GATES = [(4, 512, 16, True), (4, 512, 8, True), (2, 512, 16, True), (8, 1000, 40, True), (2, 512, 8, False),
             (4, 512, 24, False)]


@pytest.mark.parametrize("bits,K,g,taken", K10_GATES)
def test_k10_gate(recorder, bits, K, g, taken):
    M, N = 48, 256
    x = torch.randn((M, K), dtype=torch.float32)
    qw, sc, zr = _gptq(bits, K, N, g if K % g == 0 else 8)  # scales of some shape where g does not divide K
    if not taken:
        with pytest.raises(ValueError, match="group size"):
            qmm2d.gptq_gemm(x, qw, sc, zr, bits, g)
        assert recorder.calls == []
        return
    qmm2d.gptq_gemm(x, qw, sc, zr, bits, g)
    (name, args), = recorder.calls
    assert name == "qllm_gptq_gemm"
    Kp = args[1]
    assert Kp % 64 == 0 and K <= Kp < K + 64
    assert args[11:16] == (bits, M, K, N, g)


# (K, g, taken): planar K % 128 == 0, any g with (K / 2) % g == 0
K18_GATES = [(768, 8, True), (768, 24, True), (1280, 40, True), (768, 6, True), (768, 256, False), (576, 8, False)]


@pytest.mark.parametrize("K,g,taken", K18_GATES)
def test_k18_gate(recorder, K, g, taken):
    M, Np = 40, 256
    qw = torch.zeros((2, K // 8, Np), dtype=torch.int32)
    sc = torch.ones((2, K // g, Np), dtype=torch.float32)
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    if not taken:
        with pytest.raises(ValueError, match="geometry"):
            qmm_planar.w4_planar_f32s_gemm(x, qw, sc, 1)
        assert recorder.calls == []
        return
    qmm_planar.w4_planar_f32s_gemm(x, qw, sc, 1)
    (name, args), = recorder.calls
    assert name == "qllm_w4_planar_f32s_gemm" and args[5:9] == (M, K, Np, g)


def test_k10_segments_depend_on_k_and_n_alone():
    """The split of K is a function of (K, N): its parameters are K and N,
    every 64-k tile falls in one non-empty segment, and the Llama-2-7B
    projections split into 5 (q/k/v/o), 2 (gate/up), 5 (down) and 1
    (lm_head): about one block per SM of the H100's 132."""
    assert list(inspect.signature(qmm2d.gemm_segments).parameters) == ["K", "N"]
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000), (1000, 388), (64, 128)):
        segments, per = qmm2d.gemm_segments(K, N)
        tiles = -(-K // 64)
        assert segments * per >= tiles > (segments - 1) * per
    assert qmm2d.gemm_segments(4096, 4096) == (5, 13)
    assert qmm2d.gemm_segments(4096, 11008) == (2, 32)
    assert qmm2d.gemm_segments(11008, 4096) == (5, 35)
    assert qmm2d.gemm_segments(4096, 32000) == (1, 64)


@pytest.mark.parametrize("N", [4096, 11008])
def test_k10_launch_keeps_segments_across_m(recorder, N):
    """At every M the wrapper hands the kernel the same segments; M only
    decides whether they spread over blocks (at N = 11008: spread at the
    verify shape M = 40, one block each at M = 256)."""
    K = 4096
    qw, sc, zr = _gptq(4, K, N, 128)
    for M in (40, 256, 1024):
        qmm2d.gptq_gemm(torch.zeros((M, K), dtype=torch.bfloat16), qw, sc, zr, 4, 128)
    launches = [args for _, args in recorder.calls]
    assert {a[16:18] for a in launches} == {qmm2d.gemm_segments(K, N)}
    spread = [a[18] for a in launches]
    assert spread == ([1, 1, 0] if N == 4096 else [1, 0, 0])
