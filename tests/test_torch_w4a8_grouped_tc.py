"""K12 ``gptq_w4a8_gemv`` and K8 ``w4_grouped_gemv`` on the tensor-core
body (csrc/stacked_mma.cuh; K8 in csrc/grouped_mma.cu): what their
wrappers hand the C entry points, on the CPU with the kernel library
replaced by a recorder, and K8's plan of runs (no card here; the kernels
themselves are held to their plain versions by
tests/test_torch_cuda_kernels.py on the card, and the plain versions to
JAX by tests/test_torch_qmm2d.py, tests/test_torch_w4a8.py and
tests/test_torch_moe.py).

  * K12 splits K by ``tc_plan.tc_group_splits``: from (K, N, bits, g)
    alone, at group boundaries; its partial-sum buffer (at any split count)
    and the quantizer's scratch are sized from the plan and the launch.
  * On act-order weights ``qmatmul_2d`` hands K12 the perm (its quantizer
    gathers x) and gathers nothing itself; K9 / K10 still take x gathered.
  * K8's plan of runs, ``grouped_run_rows``, against a numpy reference;
    its split plan from (K, Np) alone, the same at every n, and the most
    rows a head takes.
"""

import numpy as np
import pytest
import torch

from qllm_tpu_torch.ops import _build, qmm, qmm2d, tc_plan
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


@pytest.fixture
def sizes(monkeypatch):
    """The shape and dtype of every buffer the wrappers allocate, by its
    address (each buffer held, so that no later one takes its address)."""
    seen = {}
    empty = torch.empty

    def recording_empty(shape, *args, **kwargs):
        t = empty(shape, *args, **kwargs)
        seen[t.data_ptr()] = (tuple(shape), t.dtype, t)
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    return seen


# K12's C entry: (x, x_f32, perm, x8, sx, xsum, qweight, scales, zeros,
# s_type, part, out, bits, M, K, N, g, splits, units a split, stream)
_PERM, _X8, _SX, _XSUM, _PART, _SHAPE, _PLAN = 2, 3, 4, 5, 10, slice(12, 17), slice(17, 19)


def _gptq(bits, K, N, g, dtype=torch.float16, perm=None):
    qw = torch.empty((K * bits // 32, N), dtype=torch.int32)  # never read: no pages touched
    sc = torch.ones((K // g, N), dtype=dtype)
    return QuantizedTensor(qweight=qw, scales=sc, zeros=sc.clone(), perm=perm, bits=bits, group_size=g,
                           in_features=K, out_features=N)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)])
def test_k12_plan_depends_on_k_n_and_g_alone(recorder, bits, g, K, N):
    """Every M, x dtype and scale dtype hands the C entry the same (splits,
    word rows a split): whole groups a split, every word row in one split,
    the blocks within the GPTQ-order target."""
    pf = 32 // bits
    for M in (1, 8, 17, 32):
        for xd, sd in ((torch.bfloat16, torch.float16), (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
            qt = _gptq(bits, K, N, g, sd)
            qmm2d.gptq_w4a8_gemv(torch.zeros((M, K), dtype=xd), qt.qweight, qt.scales, qt.zeros, bits, g)
    plans = {tuple(args[_PLAN]) for _, args in recorder.calls}
    assert {name for name, _ in recorder.calls} == {"qllm_gptq_w4a8_gemv"} and len(plans) == 1
    (splits, per), = plans
    units = K // pf
    assert (splits, per) == qmm2d.w4a8_splits(K, N, bits, g) == tc_plan.tc_group_splits(
        units, N, tc_plan.TC_TARGET_BLOCKS["gptq"], g // pf)
    assert per % (g // pf) == 0 and (splits - 1) * per < units <= splits * per
    assert splits == 1 or splits * -(-N // 128) <= tc_plan.TC_TARGET_BLOCKS["gptq"]
    assert [args[_SHAPE] for _, args in recorder.calls][::3] == [(bits, M, K, N, g) for M in (1, 8, 17, 32)]


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("K,N,bits,g", [(4096, 4096, 4, 128), (11008, 4096, 2, 128), (256, 512, 4, 16)])
def test_k12_buffers_are_sized_from_the_plan(recorder, sizes, M, K, N, bits, g):
    """The partial sums: splits * M * N floats at any split count (the
    epilogue adds them, one split too); the quantizer's x8 [M, K] int8, sx
    [M] f32 and xsum [M, K / g] int32 (the epilogue's corr)."""
    qt = _gptq(bits, K, N, g)
    qmm2d.gptq_w4a8_gemv(torch.zeros((M, K), dtype=torch.bfloat16), qt.qweight, qt.scales, qt.zeros, bits, g)
    (_, args), = recorder.calls
    splits, _ = qmm2d.w4a8_splits(K, N, bits, g)
    assert sizes[args[_PART]][:2] == ((splits, M, N), torch.float32)
    assert sizes[args[_X8]][:2] == ((M, K), torch.int8)
    assert sizes[args[_SX]][:2] == ((M,), torch.float32)
    assert sizes[args[_XSUM]][:2] == ((M, K // g), torch.int32)
    assert args[_PERM] is None


def test_k12_one_split_still_hands_over_partial_sums(recorder, sizes):
    """16 word rows: too few to split, and the body still writes its
    partial sums for the epilogue (three launches at every shape)."""
    qt = _gptq(4, 128, 256, 128)
    qmm2d.gptq_w4a8_gemv(torch.zeros((4, 128), dtype=torch.bfloat16), qt.qweight, qt.scales, qt.zeros, 4, 128)
    (_, args), = recorder.calls
    assert args[_PLAN] == (1, 16) and sizes[args[_PART]][0] == (1, 4, 256)


@pytest.mark.parametrize("perm_dtype", [torch.int32, torch.int64])
def test_k12_act_order_hands_the_perm_to_the_quantizer(recorder, monkeypatch, perm_dtype):
    """Under w4a8 an act-order weight's perm goes to K12's C entry (int32,
    contiguous) and qmatmul_2d gathers nothing; without w4a8, K9 takes x
    gathered by qmatmul_2d and no perm."""
    gathers = []
    index_select = torch.index_select

    def counting(*args, **kwargs):
        gathers.append(args[1] if len(args) > 1 else kwargs.get("dim"))
        return index_select(*args, **kwargs)

    monkeypatch.setattr(torch, "index_select", counting)
    K, N = 1024, 256
    perm = torch.randperm(K, generator=torch.Generator().manual_seed(3)).to(perm_dtype)
    qt = _gptq(4, K, N, 128, perm=perm)
    x = torch.zeros((8, K), dtype=torch.bfloat16)
    y = qmm2d.qmatmul_2d(x, qt, w4a8=True)
    assert tuple(y.shape) == (8, N) and gathers == []
    (name, args), = recorder.calls
    assert name == "qllm_gptq_w4a8_gemv"
    if perm_dtype == torch.int32:
        assert args[_PERM] == perm.data_ptr()
    else:
        assert args[_PERM] is not None and args[_PERM] != perm.data_ptr()
    recorder.calls.clear()
    qmm2d.qmatmul_2d(x, qt, w4a8=False)
    (name, args), = recorder.calls
    assert name == "qllm_gptq_gemv" and gathers == [-1]


def test_k12_refuses_a_perm_of_another_length(recorder):
    qt = _gptq(4, 1024, 256, 128)
    with pytest.raises(ValueError, match="perm"):
        qmm2d.gptq_w4a8_gemv(torch.zeros((2, 1024), dtype=torch.bfloat16), qt.qweight, qt.scales, qt.zeros, 4, 128,
                             perm=torch.arange(512, dtype=torch.int32))
    assert recorder.calls == []


def _run_rows_numpy(ids):
    """The rule the K8 blocks apply, one selection at a time: find the
    run's start, head every GROUPED_RUN_ROWS selections from it, take the
    run's next (at most GROUPED_RUN_ROWS) selections."""
    ids = list(ids)
    out = np.zeros(len(ids), dtype=np.int32)
    for i, e in enumerate(ids):
        start = i
        while start > 0 and ids[start - 1] == e:
            start -= 1
        if (i - start) % qmm.GROUPED_RUN_ROWS:
            continue
        end = i
        while end < len(ids) and ids[end] == e:
            end += 1
        out[i] = min(qmm.GROUPED_RUN_ROWS, end - i)
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sort", [True, False])
def test_k8_run_plan_matches_numpy(seed, sort):
    """Random ids over few and many experts, sorted (runs past 8 among
    them) and not: every selection in exactly one head's rows."""
    rng = np.random.default_rng(seed)
    for E, n in ((3, 64), (8, 2), (128, 64), (5, 200), (1, 17)):
        ids = rng.integers(0, E, n)
        if sort:
            ids = np.sort(ids)
        got = qmm.grouped_run_rows(torch.from_numpy(ids.astype(np.int32))).numpy()
        want = _run_rows_numpy(ids)
        np.testing.assert_array_equal(got, want)
        assert got.sum() == n and got.max() <= qmm.GROUPED_RUN_ROWS
        if sort and E <= 5:
            assert (np.bincount(ids, minlength=E) > qmm.GROUPED_RUN_ROWS).any()


def test_k8_run_plan_of_a_long_run():
    ids = torch.tensor([7] * 20 + [2] + [7] * 3, dtype=torch.int32)
    assert qmm.grouped_run_rows(ids).tolist() == [8] + [0] * 7 + [8] + [0] * 7 + [4, 0, 0, 0, 1, 3, 0, 0]


# K8's C entry: (x, qweight, scales, zs, ids, part, out, n, E, x_shared, K,
# Np, g, splits, units a split, run rows, stream)
_K8_PART, _K8_N, _K8_SHARED, _K8_GEOM, _K8_PLAN, _K8_RUN = 5, 7, 9, slice(10, 13), slice(13, 15), 15


def _expert_stack(E, K, Np, g=128):
    qw = torch.empty((E, K // 8, Np), dtype=torch.int32)  # never read: no pages touched
    sc = torch.ones((E, K // g, Np), dtype=torch.bfloat16)
    return qw, sc, sc.clone()


@pytest.mark.parametrize("K,Np,E", [(4096, 28672, 2), (14336, 4096, 2), (2048, 1536, 4), (768, 2048, 4)])
def test_k8_hands_the_split_plan_at_every_n(recorder, sizes, K, Np, E):
    """At the Mixtral and Qwen3 expert shapes, every selection count hands
    the C entry the same grouped_splits(K, Np), so that a row's bits do not
    depend on n: every word row in one split, the blocks (columns x
    grouped_plan_heads x splits) within the planar target when K is
    split, a partial-sum buffer of splits * n * Np floats exactly when it
    is, and heads of up to GROUPED_RUN_ROWS rows."""
    qw, sc, zs = _expert_stack(E, K, Np)
    ns = (1, 2, 8, 64, 200)
    for n in ns:
        ids = torch.zeros((n,), dtype=torch.int32)
        for shared in (True, False):
            x = torch.zeros((1 if shared else n, K), dtype=torch.bfloat16)
            y = qmm.w4_grouped_gemv(x, qw, sc, zs, ids, shared)
            assert tuple(y.shape) == (n, Np)
    assert {name for name, _ in recorder.calls} == {"qllm_w4_grouped_gemv"} and len(recorder.calls) == 2 * len(ns)
    target = tc_plan.TC_TARGET_BLOCKS["planar"]
    heads = qmm.grouped_plan_heads(K, Np)
    plan = qmm.grouped_splits(K, Np)
    assert plan == tc_plan.tc_splits(K // 8, Np, target, row_blocks=heads)
    for (_, args), n in zip(recorder.calls, [n for n in ns for _ in (0, 1)]):
        splits, per = args[_K8_PLAN]
        assert (splits, per) == plan
        assert args[_K8_N] == n and args[_K8_GEOM] == (K, Np, 128) and args[_K8_RUN] == qmm.GROUPED_RUN_ROWS
        assert (splits - 1) * per < K // 8 <= splits * per
        assert splits == 1 or splits * heads * -(-Np // 128) <= target
        if splits == 1:
            assert args[_K8_PART] is None
        else:
            assert sizes[args[_K8_PART]][:2] == ((splits, n, Np), torch.float32)
    assert [args[_K8_SHARED] for _, args in recorder.calls] == [1, 0] * len(ns)


def test_k8_splits_the_qwen3_gateup_and_not_mixtral():
    """One wave on 132 SMs for the planned heads: Mixtral's gate|up has 224
    column blocks a head already; Qwen3's only 12 and splits K."""
    assert qmm.grouped_splits(4096, 28672)[0] == 1
    heads = qmm.grouped_plan_heads(2048, 1536)
    splits, per = qmm.grouped_splits(2048, 1536)
    assert splits > 1 and splits * 12 * heads <= tc_plan.TC_TARGET_BLOCKS["planar"]


@pytest.mark.parametrize(
    "K,Np,heads,splits",
    [(4096, 28672, 2, 1), (14336, 4096, 2, 8), (2048, 1536, 8, 5), (768, 2048, 8, 4)],
    ids=["mixtral-gateup", "mixtral-down", "qwen3-gateup", "qwen3-down"],
)
def test_k8_plans_its_heads_from_the_expert_bytes(K, Np, heads, splits):
    """The planned heads follow the expert's words (64 MiB over its bytes,
    within 2-8): Mixtral's 29-59 MB experts plan for 2, Qwen3's 0.8-1.6 MB
    for 8, and the splits are the ones measured fastest on the H100."""
    assert qmm.grouped_plan_heads(K, Np) == heads
    assert qmm.grouped_splits(K, Np)[0] == splits
    lo, hi = qmm.GROUPED_PLAN_HEADS
    assert lo <= qmm.grouped_plan_heads(K, Np) <= hi


def test_k8_plain_version_gives_nan_rows_for_ids_outside_the_stack():
    """The contract's NaN row, in the plain version too (the card test
    holds the kernel to it): the other rows as with valid ids alone."""
    g = torch.Generator().manual_seed(5)
    E, K, Np = 3, 256, 64
    qw = torch.randint(-(2**31), 2**31, (E, K // 8, Np), dtype=torch.int32, generator=g)
    sc = ((torch.rand((E, K // 128, Np), generator=g) + 0.5) * 0.01).to(torch.bfloat16)
    zs = (sc.float() * 8).to(torch.bfloat16)
    x = torch.randn((5, K), generator=g).to(torch.bfloat16)
    ids = torch.tensor([2, 3, 0, -1, 2], dtype=torch.int32)
    y = qmm.w4_grouped_gemv_plain(x, qw, sc, zs, ids)
    bad = torch.tensor([False, True, False, True, False])
    assert bool(torch.isnan(y[bad].float()).all()) and bool(torch.isfinite(y[~bad].float()).all())
    assert torch.equal(y[~bad], qmm.w4_grouped_gemv_plain(x[~bad], qw, sc, zs, ids[~bad]))
