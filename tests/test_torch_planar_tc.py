"""K1 ``w4_planar_gemv`` and K17 ``w4_planar_f32s_gemv`` on the tensor-core
body (csrc/stacked_mma.cuh, the planar consumer): how their wrappers split
K and what they hand the C entry points, on the CPU with the kernel
library replaced by a recorder (no card here; the kernels themselves are
held to their plain versions by tests/test_torch_cuda_kernels.py on the
card, and the plain versions to JAX by tests/test_torch_qmm_stacked.py,
tests/test_torch_planar_f32.py and tests/test_torch_planar_g8.py).

  * Both take ``tc_plan.tc_splits`` of the K/8 word rows over Np columns
    on the planar target, the same plan at every M and with or without
    the norm (a row's bits never depend on M).
  * Both hand their C entry a partial-sum buffer of splits * M * Np floats
    whenever K is split; K1 with the norm always (its second kernel
    applies the row factor as it adds the splits).
"""

import pytest
import torch

from qllm_tpu_torch.ops import _build, qmm, qmm_planar, tc_plan


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
    the library records, the stream is a stand-in."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda t, name: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return lib


# (model, projection, K, padded N): the decode GEMVs of Llama-2-7B,
# Mixtral-8x7B's dense gate|up and down and Qwen3-30B-A3B's attention and
# lm_head (config.json widths, N padded to 512 as the stacks pad it)
SHAPES = [
    ("7B", "qkv", 4096, 12288), ("7B", "o", 4096, 4096), ("7B", "gateup", 4096, 22016),
    ("7B", "down", 11008, 4096), ("7B", "lm_head", 4096, 32256),
    ("Mixtral", "gateup", 4096, 28672), ("Mixtral", "down", 14336, 4096),
    ("Qwen3", "qkv", 2048, 5120), ("Qwen3", "o", 4096, 2048), ("Qwen3", "lm_head", 2048, 152064),
]
MS = (1, 8, 17, 32)
# K1's C entry: (x, qweight, scales, zs, norm_w, part, out, layer, M, K, Np,
# g, splits, units a split, nw_f32, eps, stream); K17's: (x, qweight,
# scales, part, out, layer, M, K, Np, g, splits, units a split, stream)
_K1_PART, _K1_M, _K1_PLAN = 5, 8, slice(12, 14)
_K17_PART, _K17_M, _K17_PLAN = 3, 6, slice(10, 12)


def _stack(K, Np, dtype):
    qw = torch.zeros((1, K // 8, Np), dtype=torch.int32)
    sc = torch.zeros((1, K // 128, Np), dtype=dtype)
    return qw, sc


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


@pytest.mark.parametrize("model,pname,K,Np", SHAPES)
def test_k1_plan_depends_on_k_and_np_alone(recorder, sizes, model, pname, K, Np):
    """At every M, with and without the norm (bf16 and f32 weights), K1's
    C entry gets tc_splits(K/8, Np, planar target); a partial-sum buffer of
    splits * M * Np floats whenever K is split or the norm is on."""
    qw, sc = _stack(K, Np, torch.bfloat16)
    want = tc_plan.tc_splits(K // 8, Np, tc_plan.TC_TARGET_BLOCKS["planar"])
    assert qmm.planar_splits(K, Np) == want
    norms = (None, torch.ones((1, K), dtype=torch.bfloat16), torch.ones((1, K), dtype=torch.float32))
    for M in MS:
        for nw in norms:
            qmm.w4_planar_gemv(torch.zeros((M, K), dtype=torch.bfloat16), qw, sc, sc, 0, nw, 1e-5)
    assert {name for name, _ in recorder.calls} == {"qllm_w4_planar_gemv"}
    assert len(recorder.calls) == len(MS) * len(norms)
    assert {tuple(args[_K1_PLAN]) for _, args in recorder.calls} == {want}
    for i, (_, args) in enumerate(recorder.calls):
        M, nw = MS[i // len(norms)], norms[i % len(norms)]
        norm = nw is not None
        assert args[_K1_M] == M and (args[4] is not None) == norm
        if want[0] > 1 or norm:
            assert sizes[args[_K1_PART]][0] == (want[0], M, Np)
        else:
            assert args[_K1_PART] is None
        assert args[14] == int(norm and nw.dtype == torch.float32)


@pytest.mark.parametrize("model,pname,K,Np", SHAPES)
def test_k17_plan_depends_on_k_and_np_alone(recorder, sizes, model, pname, K, Np):
    """K17 takes K1's plan at every M, and a partial-sum buffer whenever K
    is split."""
    qw, sc = _stack(K, Np, torch.float32)
    want = qmm.planar_splits(K, Np)
    for M in MS:
        qmm_planar.w4_planar_f32s_gemv(torch.zeros((M, K), dtype=torch.bfloat16), qw, sc, 0)
    assert {name for name, _ in recorder.calls} == {"qllm_w4_planar_f32s_gemv"} and len(recorder.calls) == len(MS)
    assert {tuple(args[_K17_PLAN]) for _, args in recorder.calls} == {want}
    assert [args[_K17_M] for _, args in recorder.calls] == list(MS)
    for M, (_, args) in zip(MS, recorder.calls):
        assert (sizes[args[_K17_PART]][0] == (want[0], M, Np)) if want[0] > 1 else args[_K17_PART] is None


def test_plan_covers_k():
    """The plan covers the word rows, none empty, within the planar target
    where K is split; of the shapes above only Qwen3's lm_head (1188 column
    blocks) is not."""
    unsplit = []
    for model, pname, K, Np in SHAPES:
        splits, per = qmm.planar_splits(K, Np)
        units = K // 8
        assert (splits - 1) * per < units <= splits * per
        if splits > 1:
            assert splits * -(-Np // tc_plan.BLOCK_COLS) <= tc_plan.TC_TARGET_BLOCKS["planar"]
        else:
            unsplit.append((model, pname))
    assert unsplit == [("Qwen3", "lm_head")]


def test_unsplit_k_without_the_norm_gets_no_buffer(recorder):
    """300 column blocks fill the planar target without a split of K: no
    partial sums without the norm, a one-split buffer with it."""
    K, Np = 256, 300 * 128
    qw, sc = _stack(K, Np, torch.bfloat16)
    assert qmm.planar_splits(K, Np) == (1, 32)
    x = torch.zeros((4, K), dtype=torch.bfloat16)
    qmm.w4_planar_gemv(x, qw, sc, sc, 0)
    qmm.w4_planar_gemv(x, qw, sc, sc, 0, torch.ones((1, K), dtype=torch.bfloat16))
    qmm_planar.w4_planar_f32s_gemv(x, qw, sc.float(), 0)
    (_, a), (_, b), (_, c) = recorder.calls
    assert a[_K1_PART] is None and b[_K1_PART] is not None and c[_K17_PART] is None
    assert a[_K1_PLAN] == b[_K1_PLAN] == c[_K17_PLAN] == (1, 32)


def test_x_views_are_handed_over_aligned(recorder):
    """The kernels stage x (and the norm weight) by 8- and 16-byte copies:
    an x off a 16-byte boundary (the last position of a prefill) is handed
    over as an aligned copy."""
    K, Np = 512, 256
    qw, sc = _stack(K, Np, torch.bfloat16)
    h = torch.zeros((2, 3, K + 1), dtype=torch.bfloat16)
    x = h[:, -1, 1:]
    assert x.data_ptr() % 16
    qmm.w4_planar_gemv(x, qw, sc, sc, 0, torch.ones((1, K), dtype=torch.bfloat16))
    qmm_planar.w4_planar_f32s_gemv(x, qw, sc.float(), 0)
    assert all(args[0] % 16 == 0 for _, args in recorder.calls)
