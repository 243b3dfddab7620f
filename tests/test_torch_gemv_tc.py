"""K9 ``gptq_gemv`` and K15 ``gptq_stacked_w4a8_gemv`` on the tensor-core
body (csrc/stacked_mma.cuh): how their wrappers split K and what they
hand the C entry points, on the CPU with the kernel library replaced by a
recorder (no card here; the kernels themselves are held to their plain
versions by tests/test_torch_cuda_kernels.py on the card, and the plain
versions to JAX by tests/test_torch_qmm2d.py and
tests/test_torch_stacked_widths.py).

  * Both split K by ``tc_plan.tc_splits`` of the word rows and the
    columns: every word row in one non-empty split, the blocks within
    the body's entry of ``TC_TARGET_BLOCKS``, the same plan at every M
    and x dtype (a row's bits never depend on M).
  * K9 hands its C entry a partial-sum buffer of splits * M * N floats
    whenever K is split; a second kernel adds the splits.
  * ``qmatmul_2d`` still routes by M, bits and ``w4a8``: K9 at M <= 32,
    K10 above, K12 for W4A8 2/4-bit weights in the per-group geometry.
"""

import pytest
import torch

from qllm_tpu_torch.ops import _build, qmm2d, qmm_stacked, tc_plan
from qllm_tpu_torch.quant.qtensor import QuantizedTensor


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


def _words(bits, K, N, L=None):
    shape = (K * bits // 32, N) if L is None else (L, K * bits // 32, N)
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("body", ["gptq", "bitplane"])
@pytest.mark.parametrize("units", [1, 15, 16, 17, 128, 256, 344, 512, 1376, 2752])
@pytest.mark.parametrize("N", [64, 202, 388, 1000, 4096, 11008, 22016, 32000])
def test_split_plan_covers_k(body, units, N):
    """Every word row falls in one split: all but the last hold ``per``
    rows, the last 1..per, none is empty; the blocks stay within the
    body's target unless K is not split."""
    target = tc_plan.TC_TARGET_BLOCKS[body]
    splits, per = tc_plan.tc_splits(units, N, target)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < units <= splits * per
    assert splits == 1 or per >= tc_plan.MIN_UNITS
    assert splits == 1 or splits * -(-N // 128) <= target


# K9's column of the C entry's arguments: (x, x_f32, qweight, scales, zeros,
# s_type, part, out, bits, M, K, N, g, splits, units a split, stream)
_K9_PART, _K9_SHAPE, _K9_PLAN = 6, slice(8, 13), slice(13, 15)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)])
def test_k9_plan_depends_on_k_and_n_alone(recorder, bits, K, N):
    """At the Llama-2-7B per-layer shapes, every M and both x dtypes hand
    the C entry the same (splits, word rows a split): tc_splits of the
    layer's word rows and N; and a partial-sum buffer whenever K is
    split."""
    g = 128
    qw = _words(bits, K, N)
    sc = torch.ones((K // g, N), dtype=torch.float16)
    for M in (1, 8, 17, 32):
        for dtype in (torch.bfloat16, torch.float32):
            qmm2d.gptq_gemv(torch.zeros((M, K), dtype=dtype), qw, sc, sc, bits, g)
    want = tc_plan.tc_splits(K * bits // 32, N, tc_plan.TC_TARGET_BLOCKS["gptq"])
    assert want[0] > 1  # every 7B projection splits K
    assert {name for name, _ in recorder.calls} == {"qllm_gptq_gemv"} and len(recorder.calls) == 8
    assert {tuple(args[_K9_PLAN]) for _, args in recorder.calls} == {want}
    assert all(args[_K9_PART] is not None for _, args in recorder.calls)
    assert [args[_K9_SHAPE] for _, args in recorder.calls][::2] == [(bits, M, K, N, g) for M in (1, 8, 17, 32)]


def test_k9_partial_sums_are_sized_from_the_plan(recorder, monkeypatch):
    """The partial-sum buffer K9 hands over holds splits * M * N floats of
    this launch's M; a launch whose K is not split gets none."""
    sizes = {}
    empty = torch.empty

    def recording_empty(shape, *args, **kwargs):
        t = empty(shape, *args, **kwargs)
        sizes[t.data_ptr()] = (tuple(shape), t)  # held, so that no later buffer takes its address
        return t

    monkeypatch.setattr(qmm2d.torch, "empty", recording_empty)
    K, N, bits, g = 4096, 11008, 4, 128
    qw = _words(bits, K, N)
    sc = torch.ones((K // g, N), dtype=torch.bfloat16)
    splits, _ = tc_plan.tc_splits(K * bits // 32, N, tc_plan.TC_TARGET_BLOCKS["gptq"])
    for M in (1, 8, 32):
        qmm2d.gptq_gemv(torch.zeros((M, K), dtype=torch.bfloat16), qw, sc, sc, bits, g)
    assert [sizes[args[_K9_PART]][0] for _, args in recorder.calls] == [(splits, M, N) for M in (1, 8, 32)]
    # 16 word rows: too few to split
    recorder.calls.clear()
    qmm2d.gptq_gemv(torch.zeros((4, 128), dtype=torch.bfloat16), _words(4, 128, 256),
                    torch.ones((1, 256), dtype=torch.bfloat16), torch.ones((1, 256), dtype=torch.bfloat16), 4, 128)
    (_, args), = recorder.calls
    assert args[_K9_PLAN] == (1, 16) and args[_K9_PART] is None


def test_k9_stages_x_from_an_aligned_copy(recorder):
    """The kernel stages x by 8- and 16-byte copies: an x that starts off
    a 16-byte boundary is handed over as an aligned copy."""
    K, N = 512, 256
    base = torch.zeros((4 * K + 1,), dtype=torch.bfloat16)
    x = base[1:].view(4, K)
    assert x.data_ptr() % 16
    qmm2d.gptq_gemv(x, _words(4, K, N), torch.ones((4, N), dtype=torch.float16),
                    torch.ones((4, N), dtype=torch.float16), 4, 128)
    (_, args), = recorder.calls
    assert args[0] % 16 == 0 and args[1] == 0


# K15's arguments: (x8, qweight, scales, s_type, part, out, layer, bits, M,
# K, Np, g, splits, rows a split, stream)
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("K,Np", [(4096, 22016), (4096, 12288), (11008, 4096), (4096, 32256)])
def test_k15_plan_depends_on_k_and_n_alone(recorder, bits, K, Np):
    """At the stacked 7B shapes every M hands K15's C entry tc_splits of
    the layer's word rows and Np, and a partial-sum buffer of splits * M *
    Np floats when K is split."""
    g = 128
    qw = _words(bits, K, Np, L=2)
    sc = torch.ones((2, K // g, Np), dtype=torch.float32)
    for M in (1, 8, 17, 32):
        qmm_stacked.gptq_stacked_w4a8_gemv(torch.zeros((M, K), dtype=torch.int8), qw, sc, 1, bits, g)
    want = tc_plan.tc_splits(K * bits // 32, Np, tc_plan.TC_TARGET_BLOCKS["gptq"])
    assert {name for name, _ in recorder.calls} == {"qllm_gptq_stacked_w4a8_gemv"}
    assert {tuple(args[12:14]) for _, args in recorder.calls} == {want}
    assert [args[8] for _, args in recorder.calls] == [1, 8, 17, 32]
    assert all((args[4] is None) == (want[0] == 1) for _, args in recorder.calls)


def _qt(bits, K, N, g):
    qw = _words(bits, K, N)
    sc = torch.full((K // g, N), 0.01, dtype=torch.float16)
    return QuantizedTensor(qweight=qw, scales=sc, zeros=torch.full_like(sc, 2 ** (bits - 1)), perm=None, bits=bits,
                           group_size=g, in_features=K, out_features=N)


# (M, bits, g, w4a8, entry point): K9 at M <= 32, K10 above; under W4A8,
# K12 for 2/4-bit words in the per-group geometry at M <= 32, K9 for 8-bit
# words and for groups outside that geometry, K10 above 32 rows
_ROUTES = [
    (1, 4, 128, False, "qllm_gptq_gemv"), (32, 4, 128, False, "qllm_gptq_gemv"), (33, 4, 128, False, "qllm_gptq_gemm"),
    (8, 2, 128, False, "qllm_gptq_gemv"), (8, 8, 128, False, "qllm_gptq_gemv"), (64, 8, 128, False, "qllm_gptq_gemm"),
    (8, 4, 128, True, "qllm_gptq_w4a8_gemv"), (32, 2, 128, True, "qllm_gptq_w4a8_gemv"),
    (8, 8, 128, True, "qllm_gptq_gemv"), (40, 4, 128, True, "qllm_gptq_gemm"), (8, 4, 8, True, "qllm_gptq_gemv"),
]


@pytest.mark.parametrize("M,bits,g,w4a8,entry", _ROUTES)
def test_qmatmul_2d_routes_by_m_bits_and_w4a8(recorder, M, bits, g, w4a8, entry):
    K, N = 1024, 256
    y = qmm2d.qmatmul_2d(torch.zeros((M, K), dtype=torch.bfloat16), _qt(bits, K, N, g), w4a8=w4a8)
    assert tuple(y.shape) == (M, N)
    assert [name for name, _ in recorder.calls] == [entry]
