"""K19 ``w4_grouped_fused_mlp`` on the tensor-core body and K3a
``kv_write_int8`` as one warp a row: what their wrappers hand the C entry
points, on the CPU with the kernel library replaced by a recorder (no card
here; the kernels themselves are held to their plain versions by
tests/test_torch_cuda_kernels.py on the card, and the plain versions to
JAX by tests/test_torch_moe_fused.py and tests/test_torch_attention.py).

  * K19 takes ``qmm.grouped_splits`` of each of its stacks, (K1, Np1) for
    gate|up and (K2, Np2) for down, the same plans at n = 1, 8 and 16:
    a selection's bits depend neither on n nor on the other selections.
  * The plans cover K; the scratch is both products' partial sums and the
    activation's three bf16 parts; every x, scratch and output pointer
    handed over starts on a 16-byte boundary, also when the caller's x
    does not.
  * chip_k19_timeline.py's stamped copy of the kernel has each of its
    phase-edge stamps once.
  * K3a gets the cache's B, Hkv, S and D and the input's dtype code, its
    k and v on a 16-byte boundary; a head width that is not a multiple of
    4, or above 512, is refused before any launch.
"""

import math
from pathlib import Path

import pytest
import torch

from qllm_tpu_torch.ops import _build, attention, qmm


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
    the library records, the stream and K19's barrier words are stand-ins."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda t, name: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(qmm, "_grid_barrier", lambda dev: torch.zeros(2, dtype=torch.int32))
    return lib


@pytest.fixture
def sizes(monkeypatch):
    """The shapes of the buffers K19's wrapper allocates, by address (each
    held, so that no later buffer takes its address)."""
    seen = {}
    empty = torch.empty

    def recording_empty(shape, *args, **kwargs):
        t = empty(shape, *args, **kwargs)
        seen[t.data_ptr()] = (tuple(shape), t)
        return t

    monkeypatch.setattr(qmm.torch, "empty", recording_empty)
    return seen


def _stack(E, K, Np, g=128):
    qw = torch.zeros((E, K // 8, Np), dtype=torch.int32)
    sc = torch.zeros((E, K // g, Np), dtype=torch.bfloat16)
    return qw, sc


def _misaligned(shape, dtype):
    """A contiguous view of ``shape`` whose data does not start on a
    16-byte boundary."""
    es = torch.empty((), dtype=dtype).element_size()
    n = math.prod(shape)
    base = torch.zeros(n + 16 // es, dtype=dtype)
    off = next(i for i in range(16 // es) if (base.data_ptr() + i * es) % 16)
    return base[off:off + n].view(shape)


# (K1, K2, padded Np1, padded Np2, g): Qwen3-30B-A3B's and OLMoE-1B-7B's
# experts (config.json widths), and the small shapes of the card tests
# (a down width that is not a multiple of 128, g = 8 among them)
K19_SHAPES = [(2048, 768, 1536, 2048, 128), (2048, 1024, 2048, 2048, 128), (512, 256, 512, 512, 128),
              (512, 256, 512, 384, 128), (512, 256, 512, 512, 8)]
K19_NS = (1, 8, 16)
# K19's C entry: (x, gqw, gsc, gzs, dqw, dsc, dzs, ids, part1, a3, part2,
# bar, out, n, E, x_shared, K1, K2, Np1, Np2, g, splits1, per1, splits2,
# per2, gelu, stream)
_K19_PTRS = {"x": 0, "ids": 7, "part1": 8, "a3": 9, "part2": 10, "out": 12}
_K19_N, _K19_SHARED, _K19_GELU = 13, 15, 25
_K19_PLAN1, _K19_PLAN2 = slice(21, 23), slice(23, 25)


@pytest.mark.parametrize("K1,K2,Np1,Np2,g", K19_SHAPES)
def test_k19_plans_depend_on_the_stacks_alone(recorder, sizes, K1, K2, Np1, Np2, g):
    """At n = 1, 8 and 16, with a shared x row and one row a selection,
    silu and gelu, K19's C entry gets grouped_splits(K1, Np1) for gate|up
    and grouped_splits(K2, Np2) for down; its scratch is the gate|up
    partial sums [splits1, n, 2 K2], the activation's parts [n, 3, K2] and,
    when down is split, its partial sums [splits2, n, Np2]; every pointer
    handed over is 16-byte aligned even where the caller's x is not."""
    E = 2
    gq, gs = _stack(E, K1, Np1, g)
    dq, ds = _stack(E, K2, Np2, g)
    want1, want2 = qmm.grouped_splits(K1, Np1), qmm.grouped_splits(K2, Np2)
    cases = [(n, shared, act) for n in K19_NS for shared, act in ((True, "silu"), (False, "gelu"))]
    for n, shared, act in cases:
        x = _misaligned((1 if shared else n, K1), torch.bfloat16)
        ids = torch.zeros(n, dtype=torch.int64)
        y = qmm.w4_grouped_fused_mlp(x, gq, gs, gs, dq, ds, ds, ids, K2, act, shared)
        assert tuple(y.shape) == (n, Np2) and y.dtype == torch.bfloat16
    assert {name for name, _ in recorder.calls} == {"qllm_w4_grouped_fused_mlp"}
    assert len(recorder.calls) == len(cases)
    assert {tuple(args[_K19_PLAN1]) for _, args in recorder.calls} == {want1}
    assert {tuple(args[_K19_PLAN2]) for _, args in recorder.calls} == {want2}
    for (n, shared, act), (_, args) in zip(cases, recorder.calls):
        assert args[_K19_N] == n and args[_K19_SHARED] == int(shared) and args[_K19_GELU] == int(act == "gelu")
        assert args[16:21] == (K1, K2, Np1, Np2, g)
        assert sizes[args[_K19_PTRS["part1"]]][0] == (want1[0], n, 2 * K2)
        assert sizes[args[_K19_PTRS["a3"]]][0] == (n, 3, K2)
        if want2[0] > 1:
            assert sizes[args[_K19_PTRS["part2"]]][0] == (want2[0], n, Np2)
        else:
            assert args[_K19_PTRS["part2"]] is None
        assert sizes[args[_K19_PTRS["out"]]][0] == (n, Np2)
        for name, j in _K19_PTRS.items():
            assert args[j] is None or args[j] % 16 == 0, (name, args[j] % 16)


def test_k19_plans_cover_k():
    """Each plan covers its stack's word rows, none empty, and splits the
    phase into no more blocks than the planar target holds for
    grouped_plan_heads heads (one split where the stack is too short)."""
    for K1, K2, Np1, Np2, _ in K19_SHAPES:
        for K, Np in ((K1, Np1), (K2, Np2)):
            splits, per = qmm.grouped_splits(K, Np)
            assert (splits - 1) * per < K // 8 <= splits * per
            heads = qmm.grouped_plan_heads(K, Np)
            assert splits == 1 or splits * -(-Np // 128) * heads <= qmm.TC_TARGET_BLOCKS["planar"]


def test_k19_qwen3_plan_splits_both_products():
    """At Qwen3-30B-A3B's batch-1 shape both products are split (gate|up
    5 ways, down 4), so the four phases of the launch all run."""
    assert qmm.grouped_splits(2048, 1536) == (5, 52)
    assert qmm.grouped_splits(768, 2048) == (4, 24)


def test_k19_timeline_stamps_every_phase_edge():
    """chip_k19_timeline.py's stamped copy of csrc/fused_mlp.cu puts each
    of its ten stamps once into fused_mlp_kernel (the start, both sides of
    the three grid barriers, the end, and the producer's two phase ends)
    and adds the stamps' reader, so the tool follows the kernel's code."""
    import chip_k19_timeline as tl

    src = (Path(qmm.__file__).resolve().parent.parent / "csrc" / "fused_mlp.cu").read_text()
    out = tl.stamped(src)
    k, e = out.index("fused_mlp_kernel("), out.index("// K20: one layer's pointers")
    for i in range(len(tl.EDGES)):
        assert out[k:e].count(f"stamp({i});") == 1, i
    assert out.count("stamp(") == len(tl.EDGES) + 1 and "qllm_k19_stamps" in out
    assert out.replace(tl.STAMP, "", 1).replace(tl.READ, "").count("stamp") == len(tl.EDGES)


# K3a's C entry: (k_new, v_new, k_cache, v_cache, k_scale, v_scale, pos,
# in_f32, layer, B, H, S, D, stream)
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3a_hands_over_the_cache_shape_and_dtype(recorder, D, dtype):
    """K3a's C entry gets (B, Hkv, S, D) of the cache, the layer, the
    input's dtype code (1 for f32) and k / v rows on a 16-byte boundary
    even where the caller's views are not."""
    L, B, H, S = 2, 3, 4, 40
    kc = torch.zeros((L, B, H, S, D), dtype=torch.int8)
    ks = torch.zeros((L, B, H, S), dtype=torch.float32)
    kn, vn = _misaligned((B, H, D), dtype), _misaligned((B, H, D), dtype)
    pos = torch.tensor([0, 17, S], dtype=torch.int64)
    attention.kv_write_int8(kn, vn, kc, kc.clone(), ks, ks.clone(), 1, pos)
    assert [name for name, _ in recorder.calls] == ["qllm_kv_write_int8"]
    args = recorder.calls[0][1]
    assert args[7:13] == (int(dtype == torch.float32), 1, B, H, S, D)
    assert args[0] % 16 == 0 and args[1] % 16 == 0


@pytest.mark.parametrize("D", [66, 516])
def test_k3a_refuses_head_widths_it_does_not_serve(recorder, D):
    """A head width that is not a multiple of 4, or above four 128-wide
    chunks a lane, is refused before any launch."""
    kc = torch.zeros((1, 1, 2, 8, D), dtype=torch.int8)
    ks = torch.zeros((1, 1, 2, 8), dtype=torch.float32)
    kn = torch.zeros((1, 2, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        attention.kv_write_int8(kn, kn, kc, kc.clone(), ks, ks.clone(), 0, torch.zeros(1, dtype=torch.int32))
    assert recorder.calls == []
