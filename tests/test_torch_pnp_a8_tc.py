"""K11 ``w4a8_planar_gemv`` and K20 ``w4_pnp_gemv`` on the tensor-core body
(csrc/stacked_mma.cuh: K11 on its int8 planar consumer, K20 on the bf16
one, both products): what their wrappers hand the C entry points, on the
CPU with the kernel library replaced by a recorder (no card here; the
kernels themselves are held to their plain versions by
tests/test_torch_cuda_kernels.py on the card, and the plain versions to
JAX by tests/test_torch_w4a8.py and tests/test_torch_pnp.py).

  * K11 takes ``qmm.a8_splits`` (``tc_plan.tc_splits`` of the K/8 word
    rows on the planar target, each split widened to whole 4-row steps),
    K20 ``qmm.planar_splits`` of each of its products, the same plan at
    every M, with and without the norm: a row's bits never depend on M.
  * The plans cover K; every x, scratch and norm pointer handed over
    starts on a 16-byte boundary, also when the caller's views do not.
"""

import math

import pytest
import torch

from qllm_tpu_torch.ops import _build, qmm, tc_plan


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
    the library records, the stream and K20's barrier words are stand-ins."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda t, name: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(qmm, "_grid_barrier", lambda dev: torch.zeros(2, dtype=torch.int32))
    return lib


@pytest.fixture
def sizes(monkeypatch):
    """The shapes of the buffers the wrappers allocate, by address (each
    held, so that no later buffer takes its address)."""
    seen = {}
    empty = torch.empty

    def recording_empty(shape, *args, **kwargs):
        t = empty(shape, *args, **kwargs)
        seen[t.data_ptr()] = (tuple(shape), t)
        return t

    monkeypatch.setattr(qmm.torch, "empty", recording_empty)
    return seen


def _stack(K, Np, g=128):
    qw = torch.zeros((1, K // 8, Np), dtype=torch.int32)
    sc = torch.zeros((1, K // g, Np), dtype=torch.bfloat16)
    return qw, sc


def _misaligned(shape, dtype):
    """A contiguous view of ``shape`` whose data does not start on a
    16-byte boundary."""
    es = torch.empty((), dtype=dtype).element_size()
    n = math.prod(shape)
    base = torch.zeros(n + 16 // es, dtype=dtype)
    off = next(i for i in range(16 // es) if (base.data_ptr() + i * es) % 16)
    return base[off:off + n].view(shape)


# (projection, K, padded N): Llama-2-7B's decode GEMVs (config.json widths,
# N padded to 512 as the stacks pad it)
A8_SHAPES = [("qkv", 4096, 12288), ("o", 4096, 4096), ("gateup", 4096, 22016), ("down", 11008, 4096),
             ("lm_head", 4096, 32256)]
A8_MS = (1, 8, 17, 32)
# K11's C entry: (x, x_f32, x8, sx, qweight, scales, zs, norm_w, nw_f32, eps,
# part, out, layer, M, K, Np, g, splits, units a split, stream)
_A8_X, _A8_X8, _A8_NW, _A8_PART, _A8_M, _A8_PLAN = 0, 2, 7, 10, 13, slice(17, 19)


@pytest.mark.parametrize("pname,K,Np", A8_SHAPES)
def test_k11_plan_depends_on_k_and_np_alone(recorder, sizes, pname, K, Np):
    """At M = 1, 8, 17 and 32, with and without the norm (bf16 and f32
    weights), K11's C entry gets a8_splits(K, Np): planar_splits widened to
    whole 4-row steps; a partial-sum buffer of splits * M * Np floats when
    K is split; x, x8, the norm weight and the buffer 16-byte aligned even
    where the caller's x and norm weight are not."""
    qw, sc = _stack(K, Np)
    want = qmm.a8_splits(K, Np)
    base = qmm.planar_splits(K, Np)
    assert want[1] % 4 == 0 and want[1] >= base[1] and want[1] - base[1] < 4
    norms = (None, _misaligned((1, K), torch.bfloat16), _misaligned((1, K), torch.float32))
    for M in A8_MS:
        for nw in norms:
            qmm.w4a8_planar_gemv(_misaligned((M, K), torch.bfloat16), qw, sc, sc, 0, nw, 1e-5)
    assert {name for name, _ in recorder.calls} == {"qllm_w4a8_planar_gemv"}
    assert len(recorder.calls) == len(A8_MS) * len(norms)
    assert {tuple(args[_A8_PLAN]) for _, args in recorder.calls} == {want}
    for i, (_, args) in enumerate(recorder.calls):
        M, nw = A8_MS[i // len(norms)], norms[i % len(norms)]
        assert args[_A8_M] == M and (args[_A8_NW] is not None) == (nw is not None)
        assert sizes[args[_A8_X8]][0] == (M, K)
        if want[0] > 1:
            assert sizes[args[_A8_PART]][0] == (want[0], M, Np)
        else:
            assert args[_A8_PART] is None
        for j in (_A8_X, _A8_X8, _A8_NW, _A8_PART):
            assert args[j] is None or args[j] % 16 == 0, (j, args[j] % 16)


# (K1, D, padded Np2, g): Llama-2-7B's o_proj -> gate|up, and the small
# shapes of the card tests (g = 8 among them)
PNP_SHAPES = [(4096, 4096, 22016, 128), (512, 512, 1024, 128), (1024, 512, 640, 128), (512, 512, 512, 8)]
PNP_MS = (1, 8)
# K20's C entry: (x1, h, nw, nw_f32, qw1, s1, z1, qw2, s2, z2, hn, part1, x3,
# sq, part2, bar, y2, layer, M, K1, D, Np2, g1, g2, splits1, per1, splits2,
# per2, eps, stream)
_PNP_PTRS = {"x1": 0, "h": 1, "nw": 2, "hn": 10, "part1": 11, "x3": 12, "sq": 13, "part2": 14, "y2": 16}
_PNP_M, _PNP_PLAN1, _PNP_PLAN2 = 18, slice(24, 26), slice(26, 28)


@pytest.mark.parametrize("K1,D,Np2,g", PNP_SHAPES)
def test_k20_plan_depends_on_k_and_np_alone(recorder, sizes, K1, D, Np2, g):
    """At M = 1 and 8, with bf16 and f32 norm weights, K20's C entry gets
    planar_splits(K1, D) for o_proj and planar_splits(D, Np2) for gate|up;
    its scratch is both products' partial sums, x~'s three bf16 parts and
    the rows' sums of squares by 128-column tile; every pointer handed over
    is 16-byte aligned even where the caller's x1, h and norm weight are not."""
    q1, s1 = _stack(K1, D, g)
    q2, s2 = _stack(D, Np2, g)
    want1, want2 = qmm.planar_splits(K1, D), qmm.planar_splits(D, Np2)
    assert want1 == tc_plan.tc_splits(K1 // 8, D, tc_plan.TC_TARGET_BLOCKS["planar"])
    norms = (torch.bfloat16, torch.float32)
    for M in PNP_MS:
        for dt in norms:
            x1 = _misaligned((M, K1), torch.bfloat16)
            h = _misaligned((M, D), torch.float32)
            nw = _misaligned((1, D), dt)
            hn, y2 = qmm.w4_pnp_gemv(x1, h, q1, s1, s1, q2, s2, s2, nw, 0, 1e-6)
            assert tuple(hn.shape) == (M, D) and tuple(y2.shape) == (M, Np2)
    assert {name for name, _ in recorder.calls} == {"qllm_w4_pnp_gemv"}
    assert len(recorder.calls) == len(PNP_MS) * len(norms)
    assert {tuple(args[_PNP_PLAN1]) for _, args in recorder.calls} == {want1}
    assert {tuple(args[_PNP_PLAN2]) for _, args in recorder.calls} == {want2}
    for i, (_, args) in enumerate(recorder.calls):
        M = PNP_MS[i // len(norms)]
        assert args[_PNP_M] == M and args[3] == int(norms[i % len(norms)] == torch.float32)
        assert sizes[args[_PNP_PTRS["part1"]]][0] == (want1[0], M, D)
        assert sizes[args[_PNP_PTRS["x3"]]][0] == (M, 3, D)
        assert sizes[args[_PNP_PTRS["sq"]]][0] == (M, D // 128)
        if want2[0] > 1:
            assert sizes[args[_PNP_PTRS["part2"]]][0] == (want2[0], M, Np2)
        else:
            assert args[_PNP_PTRS["part2"]] is None
        for name, j in _PNP_PTRS.items():
            assert args[j] is None or args[j] % 16 == 0, (name, args[j] % 16)


def test_plans_cover_k():
    """Each plan covers its word rows, none empty; K11's in whole 4-row
    steps, within the planar target where the widening left the count."""
    for _, K, Np in A8_SHAPES:
        splits, per = qmm.a8_splits(K, Np)
        units = K // 8
        assert per % 4 == 0 and (splits - 1) * per < units <= splits * per
        assert splits * -(-Np // tc_plan.BLOCK_COLS) <= tc_plan.TC_TARGET_BLOCKS["planar"] or splits == 1
    for K1, D, Np2, _ in PNP_SHAPES:
        for K, N in ((K1, D), (D, Np2)):
            splits, per = qmm.planar_splits(K, N)
            assert (splits - 1) * per < K // 8 <= splits * per


def test_k20_refuses_more_than_32_rows(recorder):
    """K20's items take 8 rows each and its norm factors 32: M = 33 is
    refused before any launch."""
    q1, s1 = _stack(512, 512)
    q2, s2 = _stack(512, 1024)
    x1 = torch.zeros((33, 512), dtype=torch.bfloat16)
    h = torch.zeros((33, 512), dtype=torch.float32)
    nw = torch.ones((1, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="M <= 32"):
        qmm.w4_pnp_gemv(x1, h, q1, s1, s1, q2, s2, s2, nw, 0, 1e-6)
    assert recorder.calls == []
