"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes. Marked ``cuda``: they skip where no CUDA
device is present (the CPU tests hold the plain versions against the
JAX package). On a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import pytest
import torch

from qllm_tpu_torch.ops import attention as att
from qllm_tpu_torch.ops import flash_prefill as fp
from qllm_tpu_torch.ops import qmm, qmm2d, qmm_planar, repack

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _stack(gen, K, Np, L=2):
    qw = torch.randint(-(2**31), 2**31, (L, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
    sc = ((torch.rand((L, K // 128, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
    return qw, sc, (sc.float() * 8).to(torch.bfloat16)


@pytest.mark.parametrize("M,K,Np,norm", [(1, 256, 512, False), (5, 768, 1024, True), (32, 512, 512, False)])
def test_gemv_kernel_matches_plain(gen, M, K, Np, norm):
    qw, sc, zs = _stack(gen, K, Np)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    nw = (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(torch.bfloat16) if norm else None
    y = qmm.w4_planar_gemv(x, qw, sc, zs, 1, nw, 1e-5).float()
    ref = qmm.w4_planar_gemv_plain(x, qw, sc, zs, 1, nw, 1e-5).float()
    torch.testing.assert_close(y, ref, atol=2e-2 * float(ref.abs().max()), rtol=2e-2)


@pytest.mark.parametrize("M,K,Np", [(33, 256, 512), (200, 768, 640)])
def test_gemm_kernel_matches_plain(gen, M, K, Np):
    qw, sc, zs = _stack(gen, K, Np)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm.w4_planar_gemm(x, qw, sc, zs, 1).float()
    ref = qmm.w4_planar_gemm_plain(x, qw, sc, zs, 1).float()
    torch.testing.assert_close(y, ref, atol=2e-2 * float(ref.abs().max()), rtol=2e-2)


@pytest.mark.parametrize("n_rep,D", [(1, 128), (4, 64)])
def test_attention_kernels_match_plain(gen, n_rep, D):
    L, B, Hkv, S = 2, 3, 2, 300
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
    ks = torch.rand((L, B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    vs = torch.rand((L, B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    pos = torch.tensor([0, 130, 299], dtype=torch.int32, device="cuda")
    kn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    vn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    a = [t.clone() for t in (kc, vc, ks, vs)]
    b = [t.clone() for t in (kc, vc, ks, vs)]
    att.kv_write_int8(kn, vn, *a, 1, pos)
    att.kv_write_int8_plain(kn, vn, *b, 1, pos)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    out = att.decode_attn_int8(q, *a, pos + 1, 1)
    ref = att.decode_attn_int8_plain(q, *a, pos + 1, 1)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


def test_planarize_kernel_is_bit_exact(gen):
    w = torch.randint(-(2**31), 2**31, (3, 64, 384), dtype=torch.int32, device="cuda", generator=gen)
    assert torch.equal(repack.planarize_w4(w, 512), repack.planarize_w4_plain(w, 512))


@pytest.mark.parametrize("n_rep,pos", [(1, [5, 130, 299]), (4, [0, 64, 171])])
def test_ring_kernels_match_plain(gen, n_rep, pos):
    L, B, Hkv, S, D = 2, 3, 2, 304, 128
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
    ks = torch.rand((L, B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    vs = torch.rand((L, B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    rk = torch.randn((L, B, Hkv, att.RING, D), device="cuda", generator=gen).to(torch.bfloat16)
    rv = torch.randn((L, B, Hkv, att.RING, D), device="cuda", generator=gen).to(torch.bfloat16)
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    kn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    vn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor(pos, dtype=torch.int32, device="cuda")
    a, b = [t.clone() for t in (rk, rv)], [t.clone() for t in (rk, rv)]
    out = att.decode_attention_ring(q, kn, vn, kc, vc, ks, vs, *a, lengths, 1)
    ref = att.decode_attention_ring_plain(q, kn, vn, kc, vc, ks, vs, *b, lengths, 1)
    torch.testing.assert_close(out, ref, atol=1e-2, rtol=1e-2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    flush = torch.full((B,), 16, dtype=torch.int32, device="cuda") * torch.tensor([1, 2, 19], device="cuda").int()
    c = [t.clone() for t in (kc, vc, ks, vs)]
    d = [t.clone() for t in (kc, vc, ks, vs)]
    att.kv_ring_flush(*c, rk, rv, flush)
    att.kv_ring_flush_plain(*d, rk, rv, flush)
    for x, y in zip(c, d):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "B,T,S,Hkv,n_rep,pos,int8",
    [(2, 100, 300, 2, 1, [0, 170], True), (1, 130, 130, 2, 4, [0], False), (2, 37, 256, 1, 3, [64, 219], True)],
)
def test_flash_prefill_kernel_matches_plain(gen, B, T, S, Hkv, n_rep, pos, int8):
    H, d = Hkv * n_rep, 128
    q = torch.randn((B, T, H, d), device="cuda", generator=gen).to(torch.bfloat16)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    if int8:
        k = torch.randint(-127, 128, (B, Hkv, S, d), dtype=torch.int8, device="cuda", generator=gen)
        v = torch.randint(-127, 128, (B, Hkv, S, d), dtype=torch.int8, device="cuda", generator=gen)
        ks = torch.rand((B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
        vs = torch.rand((B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    else:  # [B, S, Hkv, d] seen as [B, Hkv, S, d]: strided rows
        k = torch.randn((B, S, Hkv, d), device="cuda", generator=gen).to(torch.bfloat16).transpose(1, 2)
        v = torch.randn((B, S, Hkv, d), device="cuda", generator=gen).to(torch.bfloat16).transpose(1, 2)
        ks = vs = None
    for out_dtype in (torch.bfloat16, torch.float32):
        out = fp.flash_prefill(q, k, v, ks, vs, pos, out_dtype).float()
        ref = fp.flash_prefill_plain(q, k, v, ks, vs, pos, out_dtype).float()
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize(
    "K,Np,ids,shared",
    [(2048, 1536, [5, 1, 7, 5], True), (768, 2048, [0, 0, 2, 3, 3, 3, 6, 7], False)],
    ids=["shared", "sorted-repeats"],
)
def test_grouped_gemv_kernel_matches_plain(gen, K, Np, ids, shared):
    qw, sc, zs = _stack(gen, K, Np, L=8)
    n = len(ids)
    x = torch.randn((1 if shared else n, K), device="cuda", generator=gen).to(torch.bfloat16)
    if not shared:
        x[4] = x[3]  # an equal (row, id) pair must give equal bits
    ids = torch.tensor(ids, dtype=torch.int32, device="cuda")
    y = qmm.w4_grouped_gemv(x, qw, sc, zs, ids, shared).float()
    ref = qmm.w4_grouped_gemv_plain(x, qw, sc, zs, ids, shared).float()
    assert (y - ref).abs().max() < 2e-2 * ref.abs().max() + 1e-3
    # an equal (row, id) pair within one launch: the shared row read twice
    # by expert 5, or rows 3 and 4 (made equal above) by expert 3
    i, j = (0, 3) if shared else (3, 4)
    assert torch.equal(y[i], y[j])


@pytest.mark.parametrize(
    "ids",
    [[2] * 11 + [0] * 3 + [5] * 17 + [1], [3, 3, 9, 3, 3, 3, 3, 3, 3, 3, 3, 3, 1, 3], [4] * 20],
    ids=["sorted-runs", "unsorted", "one-run"],
)
@pytest.mark.parametrize("K,Np", [(768, 2048), (2048, 512)])
def test_k8_runs_longer_than_8_rows(gen, ids, K, Np):
    """Runs of equal ids past the 8 rows a block takes, sorted or not: the
    plain version's outputs, and equal (row, id) pairs bit-equal inside a
    block and across the heads of one run (rows 8 apart)."""
    qw, sc, zs = _stack(gen, K, Np, L=10)
    n = len(ids)
    x = torch.randn((n, K), device="cuda", generator=gen).to(torch.bfloat16)
    pairs = [(j - 1, j) for j in range(1, n) if ids[j] == ids[j - 1]][:2]
    pairs += [(j - 8, j) for j in range(8, n) if all(ids[i] == ids[j] for i in range(j - 8, j))][:2]
    for i, j in pairs:
        x[j] = x[i]
    t = torch.tensor(ids, dtype=torch.int32, device="cuda")
    before = qmm.w4_grouped_gemv.launches
    y = qmm.w4_grouped_gemv(x, qw, sc, zs, t).float()
    assert qmm.w4_grouped_gemv.launches == before + 1
    ref = qmm.w4_grouped_gemv_plain(x, qw, sc, zs, t).float()
    assert (y - ref).abs().max() < 2e-2 * ref.abs().max() + 1e-3
    for i, j in pairs:
        assert torch.equal(y[i], y[j]), (i, j)


@pytest.mark.parametrize("n", [5, 40])  # fewer selections than a head takes, and more
def test_k8_id_outside_the_stack_gives_nan_rows(gen, n):
    K, Np, E = 768, 2048, 8
    qw, sc, zs = _stack(gen, K, Np, L=E)
    ids = ([1, 8, 8, 2, -1] * 8)[:n]
    x = torch.randn((n, K), device="cuda", generator=gen).to(torch.bfloat16)
    t = torch.tensor(ids, dtype=torch.int32, device="cuda")
    y = qmm.w4_grouped_gemv(x, qw, sc, zs, t).float()
    bad = torch.tensor([not 0 <= e < E for e in ids], device="cuda")
    assert bool(torch.isnan(y[bad]).all()) and bool(torch.isfinite(y[~bad]).all())
    ref = qmm.w4_grouped_gemv_plain(x[~bad], qw, sc, zs, t[~bad]).float()
    assert (y[~bad] - ref).abs().max() < 2e-2 * ref.abs().max() + 1e-3


@pytest.mark.parametrize("K,Np", [(2048, 1536), (768, 2048)])  # Qwen3's gate|up and down: K split
def test_k8_rows_do_not_depend_on_n(gen, K, Np):
    """A token's (row, expert) pair gives the same bits at batch 1 (its 8
    selections sharing its row) and at batch 8 (64 sorted selections, runs
    among them): the split of K comes from (K, Np) alone."""
    E = 16
    qw, sc, zs = _stack(gen, K, Np, L=E)
    assert qmm.grouped_splits(K, Np)[0] > 1
    x = torch.randn((8, K), device="cuda", generator=gen).to(torch.bfloat16)
    top = [torch.randperm(E, generator=gen, device="cuda")[:8] for _ in range(8)]
    ids_b1 = top[0].to(torch.int32)
    y_b1 = qmm.w4_grouped_gemv(x[:1], qw, sc, zs, ids_b1, True)
    flat = torch.cat(top)
    order = torch.argsort(flat, stable=True)
    ids_b8 = flat[order].to(torch.int32)
    tok = torch.div(order, 8, rounding_mode="floor")
    y_b8 = qmm.w4_grouped_gemv(x.index_select(0, tok), qw, sc, zs, ids_b8)
    ref = qmm.w4_grouped_gemv_plain(x.index_select(0, tok), qw, sc, zs, ids_b8).float()
    assert (y_b8.float() - ref).abs().max() < 2e-2 * ref.abs().max() + 1e-3
    assert int(torch.unique(ids_b8).numel()) < 64  # some expert repeats: runs longer than 1
    for j in torch.nonzero(tok == 0).flatten().tolist():
        i = int(torch.nonzero(ids_b1 == ids_b8[j]).item())
        assert torch.equal(y_b8[j], y_b1[i]), (j, i)


def test_k8_rows_do_not_depend_on_the_runs(gen):
    """K8's C entry with heads of up to 8 rows and with every selection
    on its own (run rows 1): the same bits, runs past 8 included."""
    from qllm_tpu_torch.ops import _build

    K, Np, E = 768, 2048, 8
    qw, sc, zs = _stack(gen, K, Np, L=E)
    ids = torch.tensor([1] * 11 + [4, 4, 6] + [7] * 9, dtype=torch.int32, device="cuda")
    n = ids.shape[0]
    x = torch.randn((n, K), device="cuda", generator=gen).to(torch.bfloat16)
    splits, per = qmm.grouped_splits(K, Np)
    outs = []
    for rows in (qmm.GROUPED_RUN_ROWS, 1):
        part = torch.empty((splits, n, Np), dtype=torch.float32, device="cuda")
        out = torch.empty((n, Np), dtype=torch.bfloat16, device="cuda")
        code = _build.load_library().qllm_w4_grouped_gemv(
            x.data_ptr(), qw.data_ptr(), sc.data_ptr(), zs.data_ptr(), ids.data_ptr(), part.data_ptr(),
            out.data_ptr(), n, E, 0, K, Np, 128, splits, per, rows, _build.stream(x))
        _build.check("w4_grouped_gemv", code)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], qmm.w4_grouped_gemv(x, qw, sc, zs, ids))


def test_grouped_gemv_kernel_offsets_past_2_31_bytes(gen):
    """Expert 71 of a [72, 256, 32768] stack starts 2.4 GB into the words."""
    K, Np, E = 2048, 32768, 72
    qw = torch.randint(-(2**31), 2**31, (E, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
    sc = ((torch.rand((E, K // 128, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
    zs = (sc.float() * 8).to(torch.bfloat16)
    ids = torch.tensor([71, 0, 70], dtype=torch.int32, device="cuda")
    assert 71 * (K // 8) * Np * 4 > 2**31
    x = torch.randn((3, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm.w4_grouped_gemv(x, qw, sc, zs, ids).float()
    ref = qmm.w4_grouped_gemv_plain(x, qw, sc, zs, ids).float()
    assert (y - ref).abs().max() < 2e-2 * ref.abs().max() + 1e-3


def test_decode_attention_kernel_at_16384_rows(gen):
    """K3b past the JAX package's one-shot limit (its chunked path). The
    outputs are small here (about 0.015 RMS), so the limit scales with
    them, and a control shows it catches K3b with one 128-row tile
    missing."""
    L, B, Hkv, S, D, n_rep = 1, 2, 2, 16384, 128, 4
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
    ks = torch.rand((L, B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    vs = torch.rand((L, B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([S, 9001], dtype=torch.int32, device="cuda")
    out = att.decode_attention(q, kc, vc, ks, vs, lengths, 0)
    ref = att.decode_attn_int8_plain(q, kc, vc, ks, vs, lengths, 0)
    limit = 2e-2 * ref.abs().max() + 1e-4
    assert (out - ref).abs().max() <= limit
    short = att.decode_attention(q, kc, vc, ks, vs, lengths - 128, 0)
    assert (short - ref).abs().max() > limit


def _gptq(gen, K, N, bits, g, sdtype=torch.float16):
    G = K // g
    qw = torch.randint(-(2**31), 2**31, (K * bits // 32, N), dtype=torch.int32, device="cuda", generator=gen)
    sc = ((torch.rand((G, N), device="cuda", generator=gen) + 0.5) * 0.01).to(sdtype)
    zr = torch.randint(0, 2**bits, (G, N), device="cuda", generator=gen).to(sdtype)
    return qw, sc, zr


@pytest.mark.parametrize(
    "M,K,N,bits,g,sdtype,xdtype",
    [
        (1, 512, 1000, 4, 128, torch.float16, torch.bfloat16),  # ragged N
        (8, 1024, 640, 2, 32, torch.bfloat16, torch.bfloat16),
        (5, 768, 384, 8, 64, torch.float32, torch.float32),
        (32, 256, 512, 4, 256, torch.float16, torch.bfloat16),  # one group over K
    ],
)
def test_gptq_gemv_kernel_matches_plain(gen, M, K, N, bits, g, sdtype, xdtype):
    qw, sc, zr = _gptq(gen, K, N, bits, g, sdtype)
    x = torch.randn((M, K), device="cuda", generator=gen).to(xdtype)
    y = qmm2d.gptq_gemv(x, qw, sc, zr, bits, g).float()
    ref = qmm2d.gptq_gemv_plain(x, qw, sc, zr, bits, g).float()
    torch.testing.assert_close(y, ref, atol=1e-2 * float(ref.abs().max()), rtol=1e-2)


def test_gptq_gemv_rows_do_not_depend_on_m(gen):
    """Batch invariance: a row's K9 output is the same bits alone (M = 1)
    as inside M = 8, for every bit width."""
    for bits in (2, 4, 8):
        qw, sc, zr = _gptq(gen, 4096, 4096, bits, 128)
        x = torch.randn((8, 4096), device="cuda", generator=gen).to(torch.bfloat16)
        y8 = qmm2d.gptq_gemv(x, qw, sc, zr, bits, 128)
        for m in (0, 5):
            assert torch.equal(qmm2d.gptq_gemv(x[m : m + 1], qw, sc, zr, bits, 128)[0], y8[m]), (bits, m)


def _gptq_tc(gen, K, N, bits, g, sdtype, heavy):
    """K9's weights for the one-ulp cases. ``heavy``: every field in the
    top of its range (4 bits: 14 or 15; 8 bits: 240-255) with zero points
    at its middle, so y is small beside sum x q s (the zero-point mass):
    rounding q * s to bf16 first then misses one bf16 ulp of max|y| by a
    few ulps. At 2 bits no such spread leaves room for it."""
    qw, sc, zr = _gptq(gen, K, N, bits, g, sdtype)
    if heavy:
        top = {4: (0xEEEEEEEE, (14, 16)), 8: (0xF0F0F0F0, (247, 249))}[bits]
        qw = qw | torch.tensor(top[0], dtype=torch.int64).to(torch.int32).item()
        zr = torch.randint(*top[1], zr.shape, device="cuda", generator=gen).to(sdtype)
    return qw, sc, zr


def _bf16_weight_control(x, qw, sc, zr, bits, g):
    """The function with the weight q * s rounded to bf16 before the dot
    (a dequantize-then-dot kernel), x unrounded: bf16(x @ bf16(q s) -
    xsum_g @ (z s))."""
    from qllm_tpu_torch.quant.qtensor import unpack_rows

    K, N = x.shape[1], qw.shape[1]
    s, z = sc.float(), zr.float()
    w = (unpack_rows(qw, bits, K).float().reshape(K // g, g, N) * s[:, None]).reshape(K, N).to(torch.bfloat16)
    xf = x.float()
    return (xf @ w.float() - xf.reshape(x.shape[0], K // g, g).sum(dim=2) @ (z * s)).to(torch.bfloat16)


# (bits, M, K, N, g, scale / zero dtype, x dtype, heavy): 2, 4 and 8 bits at
# M = 1-32, an f32 x bf16 cannot hold (the three-way split), groups that
# close inside an MMA step (4 bits g = 8 and 24, 2 bits g = 16, 8 bits g =
# 4 and 12), ragged N (1000, 388, and 202: not a multiple of 4, the scalar
# path), one group over K, scales and zeros in f32, fp16 and bf16
_K9_TC = [
    (4, 8, 1024, 512, 128, torch.float16, torch.bfloat16, False),
    (8, 8, 1024, 512, 64, torch.bfloat16, torch.bfloat16, False),
    (4, 8, 1024, 512, 128, torch.float16, torch.bfloat16, True),
    (4, 32, 1024, 512, 128, torch.bfloat16, torch.bfloat16, True),
    (8, 8, 1024, 512, 128, torch.float16, torch.bfloat16, True),
    (8, 17, 768, 384, 64, torch.float32, torch.float32, True),
    (2, 8, 1024, 640, 32, torch.bfloat16, torch.bfloat16, False),
    (2, 32, 2048, 256, 128, torch.float16, torch.float32, False),
    (4, 3, 1024, 512, 64, torch.float32, torch.float32, True),
    (4, 8, 512, 384, 8, torch.float16, torch.bfloat16, True),
    (4, 16, 768, 256, 24, torch.bfloat16, torch.float32, True),
    (2, 5, 512, 384, 16, torch.float16, torch.bfloat16, False),
    (8, 8, 512, 256, 4, torch.bfloat16, torch.bfloat16, True),
    (8, 32, 768, 256, 12, torch.float16, torch.float32, True),
    (4, 1, 512, 1000, 128, torch.float16, torch.bfloat16, True),
    (8, 32, 768, 388, 64, torch.bfloat16, torch.bfloat16, True),
    (4, 8, 512, 202, 64, torch.float32, torch.bfloat16, True),
    (4, 32, 2048, 256, 2048, torch.float16, torch.bfloat16, True),
    (8, 1, 1024, 128, 1024, torch.float32, torch.bfloat16, True),
    (4, 8, 4096, 4096, 128, torch.float16, torch.bfloat16, True),
]


@pytest.mark.parametrize("bits,M,K,N,g,sdtype,xdtype,heavy", _K9_TC)
def test_k9_tensor_cores_match_plain(gen, bits, M, K, N, g, sdtype, xdtype, heavy):
    """K9 on the tensor cores within one bf16 ulp of max|plain|; where the
    weights carry the zero-point mass (``heavy``), the product over the
    weight q * s rounded to bf16 misses that limit (the control)."""
    qw, sc, zr = _gptq_tc(gen, K, N, bits, g, sdtype, heavy)
    x = torch.randn((M, K), device="cuda", generator=gen, dtype=torch.float32)
    if xdtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    else:  # values that bf16 cannot hold: the kernel's three-way split
        assert not torch.equal(x, x.to(torch.bfloat16).float())
    y = qmm2d.gptq_gemv(x, qw, sc, zr, bits, g)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (M, N)
    ref = qmm2d.gptq_gemv_plain(x, qw, sc, zr, bits, g).float()
    limit = _bf16_ulp(ref)
    assert float((y.float() - ref).abs().max()) <= limit
    if heavy:
        assert float((_bf16_weight_control(x, qw, sc, zr, bits, g).float() - ref).abs().max()) > limit


def test_k9_split_sum_is_deterministic(gen):
    """K9's splits of a column tile, added in split order by the second
    kernel: 20 back-to-back calls give the same bits, and a call on a
    second stream gives them too."""
    from qllm_tpu_torch.ops import tc_plan

    K, N, M, g = 4096, 4096, 8, 128
    assert tc_plan.tc_splits(K // 8, N, tc_plan.TC_TARGET_BLOCKS["gptq"])[0] > 1
    qw, sc, zr = _gptq(gen, K, N, 4, g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    first = qmm2d.gptq_gemv(x, qw, sc, zr, 4, g)
    runs = [qmm2d.gptq_gemv(x, qw, sc, zr, 4, g) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(y, first) for y in runs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y_side = qmm2d.gptq_gemv(x, qw, sc, zr, 4, g)
    side.synchronize()
    assert torch.equal(y_side, first)


@pytest.mark.parametrize(
    "M,K,N,bits,g,sdtype,xdtype",
    [
        (33, 512, 512, 4, 128, torch.float16, torch.bfloat16),
        (200, 1024, 640, 2, 32, torch.bfloat16, torch.bfloat16),
        (130, 768, 388, 8, 64, torch.float32, torch.float32),  # N not a multiple of 128
        (64, 256, 256, 4, 256, torch.float16, torch.bfloat16),
    ],
)
def test_gptq_gemm_kernel_matches_plain(gen, M, K, N, bits, g, sdtype, xdtype):
    qw, sc, zr = _gptq(gen, K, N, bits, g, sdtype)
    x = torch.randn((M, K), device="cuda", generator=gen).to(xdtype)
    y = qmm2d.gptq_gemm(x, qw, sc, zr, bits, g).float()
    ref = qmm2d.gptq_gemm_plain(x, qw, sc, zr, bits, g).float()
    torch.testing.assert_close(y, ref, atol=1e-2 * float(ref.abs().max()), rtol=1e-2)


def _a8_close(y, ref):
    """Within one bf16 ulp of the plain version plus 1e-3 * max|y|."""
    y, ref = y.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    assert bool(((y - ref).abs() <= ulp + 1e-3 * ref.abs().max()).all()), float((y - ref).abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantizer_kernel_is_bit_exact(gen, dtype):
    x = (torch.randn((9, 1280), device="cuda", generator=gen) * 3).to(dtype)
    x[2] = 0
    for a, b in zip(qmm.quantize_rows_int8(x, 64), qmm.quantize_rows_int8_plain(x, 64)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M,K,Np,g,norm", [(1, 1024, 512, 128, False), (8, 1280, 384, 64, True),
                                           (20, 2048, 1024, 128, True), (32, 512, 640, 32, False),
                                           (8, 512, 512, 16, False), (5, 768, 384, 48, True)])
def test_w4a8_planar_gemv_kernel_matches_plain(gen, M, K, Np, g, norm):
    L = 2
    qw = torch.randint(-(2**31), 2**31, (L, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
    sc = ((torch.rand((L, K // g, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
    zs = (sc.float() * 8).to(torch.bfloat16)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    nw = (torch.rand((L, K), device="cuda", generator=gen) + 0.5).to(torch.bfloat16) if norm else None
    args = (x, qw, sc, zs, 1, nw, 1e-5)
    _a8_close(qmm.w4a8_planar_gemv(*args), qmm.w4a8_planar_gemv_plain(*args))


@pytest.mark.parametrize(
    "M,K,N,bits,g,sdtype",
    [(1, 512, 1000, 4, 128, torch.float16), (8, 1024, 640, 2, 64, torch.bfloat16),
     (32, 4096, 384, 4, 128, torch.float32), (5, 256, 512, 4, 16, torch.float16),
     (8, 1024, 202, 4, 32, torch.float32),  # N % 4 != 0: the body's word-by-word copies
     (3, 11008, 512, 4, 128, torch.float32)]  # the f32 stacks' down_proj fallback: K = 11008, f32 scales
    + [(M, 2048, 1000, bits, g, sdtype) for M in (1, 8, 32) for bits in (2, 4) for g in (32, 128)
       for sdtype in (torch.float32, torch.float16, torch.bfloat16)],
)
def test_gptq_w4a8_gemv_kernel_matches_plain(gen, M, K, N, bits, g, sdtype):
    qw, sc, zr = _gptq(gen, K, N, bits, g, sdtype)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    before = qmm2d.gptq_w4a8_gemv.launches
    _a8_close(qmm2d.gptq_w4a8_gemv(x, qw, sc, zr, bits, g), qmm2d.gptq_w4a8_gemv_plain(x, qw, sc, zr, bits, g))
    assert qmm2d.gptq_w4a8_gemv.launches == before + 1


def test_gptq_w4a8_gemv_rows_do_not_depend_on_m(gen):
    """Batch invariance, as K9's: a row alone (M = 1) and inside M = 8 and
    M = 32 give the same bits (the engine's bucket-length requests rely on
    it)."""
    for bits in (2, 4):
        qw, sc, zr = _gptq(gen, 4096, 4096, bits, 128)
        x = torch.randn((32, 4096), device="cuda", generator=gen).to(torch.bfloat16)
        for M in (8, 32):
            y = qmm2d.gptq_w4a8_gemv(x[:M], qw, sc, zr, bits, 128)
            for m in (0, 5):
                assert torch.equal(qmm2d.gptq_w4a8_gemv(x[m : m + 1], qw, sc, zr, bits, 128)[0], y[m]), (bits, M, m)


@pytest.mark.parametrize("bits", [2, 4])
def test_k12_act_order_gathers_in_the_quantizer(gen, bits):
    """qmatmul_2d hands an act-order weight's perm to K12, whose quantizer
    gathers x as it reads it: the plain version on the gathered x, one K12
    launch."""
    from qllm_tpu_torch.utils.testing import random_quantized_tensor

    qt = random_quantized_tensor(gen, 2048, 640, bits, 128, act_order=True)
    x = torch.randn((8, 2048), device="cuda", generator=gen).to(torch.bfloat16)
    before = qmm2d.gptq_w4a8_gemv.launches
    y = qmm2d.qmatmul_2d(x, qt, w4a8=True)
    assert qmm2d.gptq_w4a8_gemv.launches == before + 1
    xp = x.index_select(1, qt.perm.long())
    _a8_close(y, qmm2d.gptq_w4a8_gemv_plain(xp, qt.qweight, qt.scales, qt.zeros, bits, 128))


def test_stream_pass_kernel_is_exact(gen):
    from qllm_tpu_torch.ops import stream_bench

    words = torch.randint(0, 255, (3, 512, 2200), dtype=torch.int32, device="cuda", generator=gen)
    for layer, passes in ((0, 1), (2, 5)):
        got = stream_bench.stream_pass(words, layer, passes)
        assert torch.equal(got, stream_bench.stream_pass_plain(words, layer, passes))


def _packed_stack(gen, bits, K, Np, g, L=3, dtype=torch.float32):
    """Random GPTQ-order (2/4 bits) or bit-plane (3/5/6/7) words, scales and
    zs = zeros * scales for a zero-mean stack, in ``dtype``."""
    rows = K * bits // 32
    qw = torch.randint(-(2**31), 2**31, (L, rows, Np), dtype=torch.int32, device="cuda", generator=gen)
    G = K // g
    sc = (torch.rand((L, G, Np), device="cuda", generator=gen) + 0.5) * 0.01
    zs = sc * ((1 << bits) / 2.0 - 0.5)
    return qw, sc.to(dtype), zs.to(dtype)


def _close_to_plain_not_to_next_layer(y, ref, ref_next):
    """Within 1e-2 * max|plain| of layer 1's plain version, and outside it
    against layer 2's (the kernel reads the layer it is told to)."""
    y, ref, ref_next = y.float(), ref.float(), ref_next.float()
    limit = 1e-2 * float(ref.abs().max())
    assert float((y - ref).abs().max()) <= limit
    assert float((y - ref_next).abs().max()) > limit


@pytest.mark.parametrize(
    "bits,K,Np,g,M,fused,dtype",
    [(2, 1024, 640, 128, 1, False, torch.float32), (4, 512, 512, 64, 8, True, torch.bfloat16),
     (2, 2048, 384, 64, 32, True, torch.bfloat16), (4, 768, 1024, 128, 5, False, torch.float32)],
)
def test_k14_gptq_stacked_gemv_matches_plain(gen, bits, K, Np, g, M, fused, dtype):
    from qllm_tpu_torch.ops import qmm_stacked as qs

    qw, sc, zs = _packed_stack(gen, bits, K, Np, g, dtype=dtype)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qs.gptq_stacked_gemv(x, qw, sc, zs, 1, bits, g, fused)
    assert y.dtype == (torch.bfloat16 if fused else torch.float32)
    _close_to_plain_not_to_next_layer(y, qs.gptq_stacked_gemv_plain(x, qw, sc, zs, 1, bits, g, fused),
                                      qs.gptq_stacked_gemv_plain(x, qw, sc, zs, 2, bits, g, fused))


@pytest.mark.parametrize("bits,K,Np,g,M", [(2, 1024, 640, 128, 1), (4, 512, 512, 64, 8), (4, 2048, 256, 2048, 32)])
def test_k15_gptq_stacked_w4a8_gemv_matches_plain(gen, bits, K, Np, g, M):
    from qllm_tpu_torch.ops import qmm_stacked as qs

    qw, sc, _ = _packed_stack(gen, bits, K, Np, g)
    x8, _, _ = qmm.quantize_rows_int8(torch.randn((M, K), device="cuda", generator=gen), g)
    y = qs.gptq_stacked_w4a8_gemv(x8, qw, sc, 1, bits, g)
    _close_to_plain_not_to_next_layer(y, qs.gptq_stacked_w4a8_gemv_plain(x8, qw, sc, 1, bits, g),
                                      qs.gptq_stacked_w4a8_gemv_plain(x8, qw, sc, 2, bits, g))


# (bits, K, Np, g): groups ending inside an MMA's k span (4 bits g = 8,
# 2 bits g = 16: one word row a group), ragged Np (200; 202, not a multiple
# of 4: the scalar path), one group over K
_K15_TC = [(2, 1024, 640, 128), (4, 1024, 512, 128), (4, 512, 384, 8), (2, 512, 256, 16), (4, 512, 200, 64),
           (2, 768, 202, 48), (4, 2048, 256, 2048)]


@pytest.mark.parametrize("M", [1, 8, 17, 32])
@pytest.mark.parametrize("bits,K,Np,g", _K15_TC)
def test_k15_tensor_cores_match_plain(gen, bits, K, Np, g, M):
    """K15 on the int8 tensor cores: within 1e-2 * max|plain| of layer 1's
    plain version and outside it against layer 2's, within one bf16 ulp
    plus 1e-3 * max|plain| (the exact s32 dots leave only the f32 order),
    and its rows equal the same rows at M = 32, alone as well."""
    from qllm_tpu_torch.ops import qmm_stacked as qs

    qw, sc, _ = _packed_stack(gen, bits, K, Np, g)
    x8, _, _ = qmm.quantize_rows_int8(torch.randn((32, K), device="cuda", generator=gen), g)
    y32 = qs.gptq_stacked_w4a8_gemv(x8, qw, sc, 1, bits, g)
    y = qs.gptq_stacked_w4a8_gemv(x8[:M], qw, sc, 1, bits, g)
    ref = qs.gptq_stacked_w4a8_gemv_plain(x8[:M], qw, sc, 1, bits, g)
    _close_to_plain_not_to_next_layer(y, ref, qs.gptq_stacked_w4a8_gemv_plain(x8[:M], qw, sc, 2, bits, g))
    _a8_close(y, ref)
    assert torch.equal(y, y32[:M])
    for m in {0, M - 1}:
        assert torch.equal(qs.gptq_stacked_w4a8_gemv(x8[m : m + 1], qw, sc, 1, bits, g)[0], y32[m]), m


@pytest.mark.parametrize(
    "bits,K,Np,g,M,fused",
    [(3, 1024, 640, 128, 1, False), (3, 512, 512, 512, 8, True), (5, 768, 384, 64, 32, True),
     (6, 1024, 256, 32, 3, False), (7, 256, 512, 128, 8, True), (3, 512, 256, 16, 2, False)],
)
def test_k16_bitplane_stacked_gemv_matches_plain(gen, bits, K, Np, g, M, fused):
    from qllm_tpu_torch.ops import qmm_stacked as qs

    dtype = torch.bfloat16 if fused else torch.float32
    qw, sc, zs = _packed_stack(gen, bits, K, Np, g, dtype=dtype)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qs.bitplane_stacked_gemv(x, qw, sc, zs, 1, bits, g, fused)
    _close_to_plain_not_to_next_layer(y, qs.bitplane_stacked_gemv_plain(x, qw, sc, zs, 1, bits, g, fused),
                                      qs.bitplane_stacked_gemv_plain(x, qw, sc, zs, 2, bits, g, fused))


def test_stacked_gemv_rows_do_not_depend_on_m(gen):
    """Batch invariance of K14 and K16, as K9's: a row alone and inside M =
    8 and M = 32 give the same bits, fused and unfused (their K splits
    depend on K and N alone, and a tensor-core product's column depends on
    its own B column only)."""
    from qllm_tpu_torch.ops import qmm_stacked as qs

    x = torch.randn((32, 4096), device="cuda", generator=gen).to(torch.bfloat16)
    for bits, fn in ((2, qs.gptq_stacked_gemv), (3, qs.bitplane_stacked_gemv)):
        qw, sc, zs = _packed_stack(gen, bits, 4096, 4096, 128, dtype=torch.bfloat16)
        for fused in (True, False):
            y8 = fn(x[:8], qw, sc, zs, 1, bits, 128, fused)
            y32 = fn(x, qw, sc, zs, 1, bits, 128, fused)
            for m in (0, 5, 31):
                alone = fn(x[m : m + 1], qw, sc, zs, 1, bits, 128, fused)[0]
                assert torch.equal(alone, y32[m]), (bits, fused, m)
                if m < 8:
                    assert torch.equal(alone, y8[m]), (bits, fused, m)


def _stacked_tight(y, ref, x, qw, sc, layer, bits, g, fused):
    """K14 / K16 against their plain version at the tensor cores' rounding:
    fused (bf16) outputs within one bf16 ulp of max|plain|; unfused (f32)
    outputs within 1e-4 * max|plain|, which the product with the weight q
    * s rounded to bf16 first (a dequantize-then-dot kernel) misses."""
    from qllm_tpu_torch.quant.qtensor import unpack_rows

    y, ref = y.float(), ref.float()
    if fused:
        assert float((y - ref).abs().max()) <= _bf16_ulp(ref)
        return
    scale = float(ref.abs().max())
    torch.testing.assert_close(y, ref, atol=1e-4 * scale, rtol=0)
    K, Np = x.shape[1], qw.shape[-1]
    w = unpack_rows(qw[layer], bits, K).float().reshape(K // g, g, Np) * sc[layer].float()[:, None]
    w = w.reshape(K, Np).to(torch.bfloat16)
    assert float((x.float() @ w.float() - ref).abs().max()) > 1e-4 * scale


# (bits, K, Np, g, M, fused, x dtype, layer): M = 16 / 32 at every width,
# groups that end inside one MMA step (K14 4-bit g = 8, 2-bit g = 16, K16
# g = 8 and 16), g = K, f32 x whose values are not bf16, a layer other
# than 1, Np not a multiple of 64 (and not of 4: the scalar-load path)
_K14_TC = [
    (2, 1024, 640, 128, 16, False, torch.bfloat16, 1), (2, 1024, 640, 128, 32, True, torch.bfloat16, 1),
    (4, 1024, 512, 128, 16, True, torch.bfloat16, 1), (4, 1024, 512, 128, 32, False, torch.bfloat16, 1),
    (4, 512, 384, 8, 8, False, torch.bfloat16, 1), (4, 512, 384, 8, 32, True, torch.bfloat16, 1),
    (2, 512, 384, 16, 8, True, torch.bfloat16, 1), (2, 512, 384, 16, 32, False, torch.bfloat16, 1),
    (2, 2048, 256, 2048, 5, False, torch.bfloat16, 1), (4, 2048, 256, 2048, 32, True, torch.bfloat16, 1),
    (2, 1024, 512, 64, 8, False, torch.float32, 1), (4, 768, 256, 32, 32, True, torch.float32, 1),
    (2, 1024, 200, 128, 8, True, torch.bfloat16, 2), (4, 512, 202, 64, 17, False, torch.bfloat16, 0),
    (2, 768, 202, 48, 3, True, torch.float32, 2),
]
_K16_TC = [
    (b, 1024, 384, 128, M, fused, torch.bfloat16, 1) for b in (3, 5, 6, 7) for M, fused in ((16, False), (32, True))
] + [
    (3, 512, 384, 8, 8, False, torch.bfloat16, 1), (5, 512, 384, 8, 32, True, torch.bfloat16, 1),
    (7, 512, 256, 16, 1, True, torch.bfloat16, 1), (6, 512, 256, 16, 32, False, torch.bfloat16, 1),
    (3, 1024, 256, 1024, 32, False, torch.bfloat16, 1), (7, 2048, 256, 2048, 8, True, torch.bfloat16, 1),
    (3, 1024, 512, 64, 8, False, torch.float32, 1), (6, 768, 256, 24, 32, True, torch.float32, 1),
    (3, 1024, 200, 128, 8, True, torch.bfloat16, 2), (5, 640, 202, 40, 12, False, torch.bfloat16, 0),
]


def _tc_case(gen, bits, K, Np, g, M, fused, xdtype, layer, fn, plain):
    dtype = torch.bfloat16 if fused else torch.float32
    qw, sc, zs = _packed_stack(gen, bits, K, Np, g, L=4, dtype=dtype)
    x = torch.randn((M, K), device="cuda", generator=gen, dtype=torch.float32)
    if xdtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    else:  # values that bf16 cannot hold: the kernel's three-way split
        assert not torch.equal(x, x.to(torch.bfloat16).float())
    y = fn(x, qw, sc, zs, layer, bits, g, fused)
    assert y.dtype == (torch.bfloat16 if fused else torch.float32)
    ref = plain(x, qw, sc, zs, layer, bits, g, fused)
    _close_to_plain_not_to_next_layer(y, ref, plain(x, qw, sc, zs, layer + 1, bits, g, fused))
    _stacked_tight(y, ref, x, qw, sc, layer, bits, g, fused)


@pytest.mark.parametrize("bits,K,Np,g,M,fused,xdtype,layer", _K14_TC)
def test_k14_tensor_cores_match_plain(gen, bits, K, Np, g, M, fused, xdtype, layer):
    from qllm_tpu_torch.ops import qmm_stacked as qs

    _tc_case(gen, bits, K, Np, g, M, fused, xdtype, layer, qs.gptq_stacked_gemv, qs.gptq_stacked_gemv_plain)


@pytest.mark.parametrize("bits,K,Np,g,M,fused,xdtype,layer", _K16_TC)
def test_k16_tensor_cores_match_plain(gen, bits, K, Np, g, M, fused, xdtype, layer):
    from qllm_tpu_torch.ops import qmm_stacked as qs

    _tc_case(gen, bits, K, Np, g, M, fused, xdtype, layer, qs.bitplane_stacked_gemv, qs.bitplane_stacked_gemv_plain)


def _f32s_stack(gen, K, Np, g, L=3):
    qw = torch.randint(-(2**31), 2**31, (L, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
    sc = (torch.rand((L, K // g, Np), device="cuda", generator=gen) + 0.5) * 0.01
    return qw, sc


def _f32s_close(y, x, qw, sc):
    """K17 / K18 against their plain version on layer 1: within 1e-2 *
    max|plain|, which the next layer's plain version misses, and within
    1e-4 * max|plain|, which the product with the weight q * s rounded to
    bf16 first (a dequantize-then-dot kernel) misses."""
    ref = qmm_planar.w4_planar_f32s_gemv_plain(x, qw, sc, 1)
    scale = float(ref.abs().max())
    torch.testing.assert_close(y, ref, atol=1e-2 * scale, rtol=0)
    assert float((y - qmm_planar.w4_planar_f32s_gemv_plain(x, qw, sc, 2)).abs().max()) > 1e-2 * scale
    torch.testing.assert_close(y, ref, atol=1e-4 * scale, rtol=0)
    K, Np = x.shape[1], qw.shape[-1]
    G = sc.shape[1]
    w = (qmm._planar_values(qw[1], K).reshape(G, K // G, Np) * sc[1][:, None]).reshape(K, Np).to(torch.bfloat16)
    assert float((x.float() @ w.float() - ref).abs().max()) > 1e-4 * scale


@pytest.mark.parametrize(
    "M,K,Np,g",
    [(1, 2048, 512, 128), (8, 512, 1024, 16), (32, 2816, 512, 128), (3, 768, 640, 64)],
)
def test_k17_planar_f32s_gemv_matches_plain(gen, M, K, Np, g):
    qw, sc = _f32s_stack(gen, K, Np, g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm_planar.w4_planar_f32s_gemv(x, qw, sc, 1)
    assert y.dtype == torch.float32
    _f32s_close(y, x, qw, sc)


@pytest.mark.parametrize(
    "M,K,Np,g",
    [(33, 2048, 512, 128), (200, 2816, 640, 128), (64, 512, 512, 16), (130, 1024, 256, 32)],
)
def test_k18_planar_f32s_gemm_matches_plain(gen, M, K, Np, g):
    qw, sc = _f32s_stack(gen, K, Np, g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm_planar.w4_planar_f32s_gemm(x, qw, sc, 1)
    _f32s_close(y, x, qw, sc)


def test_k17_rows_do_not_depend_on_m(gen):
    qw, sc = _f32s_stack(gen, 4096, 1024, 128)
    x = torch.randn((32, 4096), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm_planar.w4_planar_f32s_gemv(x, qw, sc, 1)
    for m in (1, 8, 17):
        assert torch.equal(qmm_planar.w4_planar_f32s_gemv(x[:m], qw, sc, 1), y[:m])


@pytest.mark.parametrize("nw_dtype", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,Np", [(4096, 1024), (11008, 512)])
def test_k1_rows_do_not_depend_on_m(gen, K, Np, nw_dtype):
    """K1's rows at M = 1, 8 and 17 are bit-equal to those rows of one
    M = 32 launch, with and without the norm (K split: the plan comes from
    (K, Np) alone)."""
    assert qmm.planar_splits(K, Np)[0] > 1
    qw, sc, zs = _stack(gen, K, Np)
    nw = None if nw_dtype is None else (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(nw_dtype)
    x = torch.randn((32, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm.w4_planar_gemv(x, qw, sc, zs, 1, nw, 1e-5)
    for m in (1, 8, 17):
        assert torch.equal(qmm.w4_planar_gemv(x[:m], qw, sc, zs, 1, nw, 1e-5), y[:m]), m


# (g, K, Np, M, norm weight dtype): the group sizes the smoke's stacks take
# (128, 16, 8, and 6 at Phi-3-mini's K = 3072) and the down_proj K of the
# 7B (11008) and of Mixtral (14336)
_PLANAR_TC = [(128, 4096, 1024, 8, torch.bfloat16), (128, 4096, 1024, 1, None), (16, 1024, 512, 17, None),
              (16, 1024, 512, 8, torch.float32), (8, 768, 512, 32, torch.bfloat16), (8, 768, 640, 5, None),
              (6, 3072, 512, 8, torch.bfloat16), (6, 768, 512, 32, None), (128, 11008, 512, 8, None),
              (128, 11008, 512, 32, torch.bfloat16), (128, 14336, 512, 1, None), (128, 14336, 512, 8, torch.float32)]


@pytest.mark.parametrize("g,K,Np,M,nw_dtype", _PLANAR_TC)
def test_k1_tensor_cores_match_plain(gen, g, K, Np, M, nw_dtype):
    """K1 against its plain version within QMM_TOL (atol 2e-2 * max|plain|,
    rtol 2e-2), which the plain version of the other layer misses."""
    qw, sc, zs = _stack_g(gen, K, Np, g)
    nw = None if nw_dtype is None else (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(nw_dtype)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm.w4_planar_gemv(x, qw, sc, zs, 1, nw, 1e-5).float()
    ref = qmm.w4_planar_gemv_plain(x, qw, sc, zs, 1, nw, 1e-5).float()
    atol = 2e-2 * float(ref.abs().max())
    torch.testing.assert_close(y, ref, atol=atol, rtol=2e-2)
    other = qmm.w4_planar_gemv_plain(x, qw, sc, zs, 0, nw, 1e-5).float()
    assert not torch.allclose(y, other, atol=atol, rtol=2e-2)


@pytest.mark.parametrize("g,K,Np,M", [(g, K, Np, M) for g, K, Np, M, _ in _PLANAR_TC])
def test_k17_tensor_cores_match_plain(gen, g, K, Np, M):
    """K17 against its plain version (the limits and controls of
    _f32s_close) at K1's cases."""
    qw, sc = _f32s_stack(gen, K, Np, g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    _f32s_close(qmm_planar.w4_planar_f32s_gemv(x, qw, sc, 1), x, qw, sc)


def test_k1_k17_x_views(gen):
    """A decode x that is a view off a 16-byte boundary (the last position
    of a prefill) gives the rows of a contiguous copy."""
    K, Np = 1024, 512
    qw, sc, zs = _stack(gen, K, Np)
    fq, fs = _f32s_stack(gen, K, Np, 128)
    nw = (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    h = torch.randn((3, 5, K + 1), device="cuda", generator=gen).to(torch.bfloat16)
    x = h[:, -1, 1:]
    assert x.data_ptr() % 16 and not x.is_contiguous()
    xc = x.contiguous()
    assert torch.equal(qmm.w4_planar_gemv(x, qw, sc, zs, 1, nw, 1e-5), qmm.w4_planar_gemv(xc, qw, sc, zs, 1, nw, 1e-5))
    assert torch.equal(qmm_planar.w4_planar_f32s_gemv(x, fq, fs, 1), qmm_planar.w4_planar_f32s_gemv(xc, fq, fs, 1))


@pytest.mark.parametrize("M", [8, 40])
def test_planar_kernels_take_g16(gen, M):
    """K1 (M <= 32) and K2 (M > 32) on a g = 16 planar stack."""
    K, Np = 512, 512
    qw = torch.randint(-(2**31), 2**31, (2, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
    sc = ((torch.rand((2, K // 16, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
    zs = (sc.float() * 8).to(torch.bfloat16)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    fn, plain = (qmm.w4_planar_gemv, qmm.w4_planar_gemv_plain) if M <= 32 else (qmm.w4_planar_gemm,
                                                                               qmm.w4_planar_gemm_plain)
    y, ref = fn(x, qw, sc, zs, 1).float(), plain(x, qw, sc, zs, 1).float()
    torch.testing.assert_close(y, ref, atol=2e-2 * float(ref.abs().max()), rtol=2e-2)


def test_w4a8_g16_full_k_stack_launches_k11(gen):
    """W4A8 at M <= 32 on a bf16 prefolded g = 16 planar stack in the
    full-K geometry: qmatmul_stacked takes K11, as the JAX package takes
    its a8 full-K kernel there, within one bf16 ulp plus 1e-3 * max|y| of
    K11's plain version."""
    from qllm_tpu_torch.models.stacked import prepare_stacked_tensor
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    K, N, g, L, M = 512, 512, 16, 2, 8
    raw = QuantizedTensor(
        qweight=torch.randint(-(2**31), 2**31, (L, K // 8, N), dtype=torch.int32, device="cuda", generator=gen),
        scales=((torch.rand((L, K // g, N), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.float16),
        zeros=torch.randint(0, 16, (L, K // g, N), device="cuda", generator=gen).to(torch.float16),
        perm=None, bits=4, group_size=g, in_features=K, out_features=N,
    )
    st = prepare_stacked_tensor(raw, scale_store_dtype=torch.bfloat16)
    assert st.planar and qmm.stacked_route(st, M, w4a8=True) == "planar"
    assert qmm.a8_full_k_ok(K, g, st.qweight.shape[-1])
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    before = qmm.w4a8_planar_gemv.launches
    y = qmm.qmatmul_stacked(x, st, 1, w4a8=True)
    assert qmm.w4a8_planar_gemv.launches == before + 1
    _a8_close(y, qmm.w4a8_planar_gemv_plain(x, st.qweight, st.scales, st.zeros, 1)[:, :N])


def _bf16_ulp(ref):
    """One bf16 ulp at the output's magnitude."""
    return float(2.0 ** (torch.floor(torch.log2(ref.abs().max())) - 7))


@pytest.mark.parametrize(
    "E,K1,K2,Np2,n,shared,act",
    [(8, 512, 256, 512, 4, False, "silu"), (16, 2048, 768, 2048, 8, True, "silu"), (4, 512, 256, 384, 3, True, "gelu")],
)
def test_k19_grouped_fused_mlp_matches_plain(gen, E, K1, K2, Np2, n, shared, act):
    """K19 against its plain version within one bf16 ulp of max|plain| (both
    sum f32 products, in another order); a repeated (row, expert) pair gives
    the same bits, an id outside the stack a row of NaN."""
    gq, gs, gz = _stack(gen, K1, 2 * K2, L=E)
    dq, ds, dz = _stack(gen, K2, Np2, L=E)
    ids = torch.randperm(E, generator=gen, device="cuda")[:n].to(torch.int32)
    ids[-1] = ids[0]
    x = torch.randn((1 if shared else n, K1), device="cuda", generator=gen).to(torch.bfloat16)
    if not shared:
        x[-1] = x[0]
    args = (x, gq, gs, gz, dq, ds, dz, ids, K2, act, shared)
    before = qmm.w4_grouped_fused_mlp.launches
    y = qmm.w4_grouped_fused_mlp(*args)
    torch.cuda.synchronize()
    assert qmm.w4_grouped_fused_mlp.launches == before + 1
    ref = qmm.w4_grouped_fused_mlp_plain(*args).float()
    torch.testing.assert_close(y.float(), ref, atol=_bf16_ulp(ref), rtol=0)
    assert torch.equal(y[0], y[-1])
    bad = ids.clone()
    bad[1] = E
    yb = qmm.w4_grouped_fused_mlp(x, gq, gs, gz, dq, ds, dz, bad, K2, act, shared)
    keep = [i for i in range(n) if i != 1]
    assert bool(torch.isnan(yb[1].float()).all()) and torch.equal(yb[keep], y[keep])


@pytest.mark.parametrize("shared,act", [(True, "silu"), (False, "gelu")])
def test_k19_rows_do_not_depend_on_n(gen, shared, act):
    """At Qwen3-30B-A3B's expert shape (both products split: the plans
    come from the stacks alone) the rows of an n = 8 launch are bit-equal
    to n = 1 launches of the same selections and to the first 8 rows of an
    n = 16 launch, which holds within one bf16 ulp of its plain version."""
    E, K1, K2, Np2 = 16, 2048, 768, 2048
    assert qmm.grouped_splits(K1, 2 * K2)[0] > 1 and qmm.grouped_splits(K2, Np2)[0] > 1
    gq, gs, gz = _stack(gen, K1, 2 * K2, L=E)
    dq, ds, dz = _stack(gen, K2, Np2, L=E)
    ids = torch.randperm(E, generator=gen, device="cuda").to(torch.int32)
    x = torch.randn((1 if shared else 16, K1), device="cuda", generator=gen).to(torch.bfloat16)

    def rows(lo, hi):
        xs = x if shared else x[lo:hi]
        return qmm.w4_grouped_fused_mlp(xs, gq, gs, gz, dq, ds, dz, ids[lo:hi], K2, act, shared)

    y16 = rows(0, 16)
    ref = qmm.w4_grouped_fused_mlp_plain(x, gq, gs, gz, dq, ds, dz, ids, K2, act, shared).float()
    torch.testing.assert_close(y16.float(), ref, atol=_bf16_ulp(ref), rtol=0)
    y8 = rows(0, 8)
    assert torch.equal(y8, y16[:8])
    for i in range(8):
        assert torch.equal(rows(i, i + 1)[0], y8[i]), i


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3a_bit_equal_to_plain(gen, D, dtype):
    """K3a against its plain version bit for bit (int8 rows and scales) at
    head widths 64, 128 and 256 in bf16 and f32; the sequences whose pos
    lies outside [0, S) keep their rows untouched."""
    L, B, Hkv, S = 2, 6, 3, 40
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
    ks = torch.rand((L, B, Hkv, S), device="cuda", generator=gen)
    vs = torch.rand((L, B, Hkv, S), device="cuda", generator=gen)
    pos = torch.tensor([0, 17, S - 1, S, -1, 5], dtype=torch.int32, device="cuda")
    kn = (torch.randn((B, Hkv, D), device="cuda", generator=gen) * 3).to(dtype)
    vn = (torch.randn((B, Hkv, D), device="cuda", generator=gen) * 0.01).to(dtype)
    kn[5] = 0  # a zero row: the scale's floor
    got = [t.clone() for t in (kc, vc, ks, vs)]
    want = [t.clone() for t in (kc, vc, ks, vs)]
    att.kv_write_int8(kn, vn, *got, 1, pos)
    for b in (0, 1, 2, 5):  # the plain version on each sequence in range, through views
        att.kv_write_int8_plain(kn[b : b + 1], vn[b : b + 1], *(t[:, b : b + 1] for t in want), 1, pos[b : b + 1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,M,K1,D,Np2", [(2, 1, 512, 512, 1024), (3, 8, 1024, 512, 640), (2, 11, 512, 256, 512)])
def test_k20_pnp_gemv_matches_plain(gen, L, M, K1, D, Np2):
    """K20 against its plain version: hn within 1e-5 * max|hn| (an f32 sum
    of K1 products in another order), y2 within one bf16 ulp of max|y2|;
    M = 11 takes two 8-row chunks."""
    q1, s1, z1 = _stack(gen, K1, D, L=L)
    q2, s2, z2 = _stack(gen, D, Np2, L=L)
    nw = (torch.rand((L, D), device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    x1 = torch.randn((M, K1), device="cuda", generator=gen).to(torch.bfloat16)
    h = torch.randn((M, D), device="cuda", generator=gen) * 4.0
    args = (x1, h, q1, s1, z1, q2, s2, z2, nw, L - 1, 1e-6)
    hn, y2 = qmm.w4_pnp_gemv(*args)
    torch.cuda.synchronize()
    hn_ref, y2_ref = qmm.w4_pnp_gemv_plain(*args)
    torch.testing.assert_close(hn, hn_ref, atol=1e-5 * float(hn_ref.abs().max()), rtol=0)
    torch.testing.assert_close(y2.float(), y2_ref.float(), atol=_bf16_ulp(y2_ref.float()), rtol=0)


_SOFTCAP = 30.0


def _int8_cache(gen, shape, softcap=0.0):
    """An int8 cache of ``shape`` and its f32 scales, on the card. With a
    softcap the key scales give scores of RMS 0.5-1.5 x the cap (an int8
    draw has RMS 127 / sqrt(3), q ~ N(0, 1) is pre-scaled by D**-0.5), where
    cap * tanh(s / cap) bends far from s."""
    kc = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
    vc = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
    u = torch.rand(shape[:-1], device="cuda", generator=gen)
    ks = (u + 0.5) * (softcap * 3**0.5 / 127) if softcap else u * 0.01 + 0.005
    vs = torch.rand(shape[:-1], device="cuda", generator=gen) * 0.01 + 0.005
    return kc, vc, ks, vs


def _softcap_control(out, ref, plain, kw):
    """With a softcap, the plain version without it must miss the one-ulp
    limit ten times over: a kernel that dropped the cap cannot pass."""
    if "softcap" in kw:
        bare = plain(**{k: v for k, v in kw.items() if k != "softcap"})
        assert (out - bare).abs().max() > 10 * _bf16_ulp(ref)


def _options(opts, H):
    from qllm_tpu_torch.models.llama import alibi_slopes

    kw = {}
    if "softcap" in opts:
        kw["softcap"] = _SOFTCAP
    if "alibi" in opts:
        kw["alibi_slopes"] = alibi_slopes(H, "mpt", device="cuda")
    if "window" in opts:
        kw["window"] = torch.tensor([130], dtype=torch.int32, device="cuda")
    return kw


_OPTS = ["none", "softcap", "alibi", "window", "softcap+alibi+window"]


@pytest.mark.parametrize("opts", _OPTS)
@pytest.mark.parametrize("n_rep,D", [(1, 128), (3, 256)])
def test_k3b_options_match_plain(gen, opts, n_rep, D):
    """K3b with the logit softcap, ALiBi (6 or 2 heads: mpt's non-power-of-
    two order) and a window that starts mid-tile, against its plain version
    within one bf16 ulp of max|plain|; lengths 1, mid-tile and full. The
    softcap cases put the scores in the cap's range, with a control."""
    L, B, Hkv, S = 2, 3, 2, 600
    cache = _int8_cache(gen, (L, B, Hkv, S, D), _SOFTCAP if "softcap" in opts else 0.0)
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([1, 300, 600], dtype=torch.int32, device="cuda")
    kw = _options(opts, Hkv * n_rep)
    out = att.decode_attention(q, *cache, lengths, 1, **kw)
    torch.cuda.synchronize()
    ref = att.decode_attn_int8_plain(q, *cache, lengths, 1, **kw)
    torch.testing.assert_close(out, ref, atol=_bf16_ulp(ref), rtol=0)
    _softcap_control(out, ref, lambda **k: att.decode_attn_int8_plain(q, *cache, lengths, 1, **k), kw)


@pytest.mark.parametrize("opts", _OPTS)
def test_k22_4d_cache_matches_plain_and_k3b(gen, opts):
    """K22 on a per-layer 4-D cache against its plain version (one bf16
    ulp of max|plain|), and bit-equal to K3b on the same cache as a
    one-layer stack; its own launch counter moves, K3b's does not. The
    softcap cases put the scores in the cap's range, with a control."""
    B, Hkv, S, D, n_rep = 3, 2, 700, 128, 4
    cache = _int8_cache(gen, (B, Hkv, S, D), _SOFTCAP if "softcap" in opts else 0.0)
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([5, 333, 700], dtype=torch.int32, device="cuda")
    kw = _options(opts, Hkv * n_rep)
    k22, k3b = att.decode_attn_int8_4d.launches, att.decode_attn_int8.launches
    out = att.decode_attention(q, *cache, lengths, **kw)
    torch.cuda.synchronize()
    assert (att.decode_attn_int8_4d.launches, att.decode_attn_int8.launches) == (k22 + 1, k3b)
    ref = att.decode_attn_int8_4d_plain(q, *cache, lengths, **kw)
    torch.testing.assert_close(out, ref, atol=_bf16_ulp(ref), rtol=0)
    _softcap_control(out, ref, lambda **k: att.decode_attn_int8_4d_plain(q, *cache, lengths, **k), kw)
    stacked = att.decode_attn_int8(q, *[t[None] for t in cache], lengths, 0, **kw)
    assert torch.equal(out, stacked)


def test_window_and_options_need_no_host_sync(gen):
    """The window, the softcap and the ALiBi slopes reach K3b and K22
    without a host sync (the window is read on the device)."""
    cache = _int8_cache(gen, (1, 2, 2, 512, 128))
    q = torch.randn((2, 4, 128), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([400, 512], dtype=torch.int32, device="cuda")
    kw = _options("softcap+alibi+window", 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = att.decode_attention(q, *cache, lengths, 0, **kw)
        b = att.decode_attention(q, *[t[0] for t in cache], lengths, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a, b)


@pytest.mark.parametrize("n_rep,D", [(4, 128), (2, 256)])
def test_k21_partial_matches_plain(gen, n_rep, D):
    """K21 against its plain version: acc and den within 1e-2 of
    max|plain|, m within 1e-5 relative; a zero-length row gives exactly
    m = -1e30, acc = 0, den = 0."""
    L, B, Hkv, S = 2, 4, 2, 384
    cache = _int8_cache(gen, (L, B, Hkv, S, D))
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([0, 1, 200, 384], dtype=torch.int32, device="cuda")
    acc, m, den = att.decode_attention_partial(q, *cache, lengths, 1)
    torch.cuda.synchronize()
    r_acc, r_m, r_den = att.decode_attn_int8_partial_plain(q, *cache, lengths, 1)
    assert (acc - r_acc).abs().max() <= 1e-2 * r_acc.abs().max()
    assert (den - r_den).abs().max() <= 1e-2 * r_den.abs().max()
    torch.testing.assert_close(m, r_m, rtol=1e-5, atol=0)
    assert bool((m[0] == -1e30).all()) and bool((acc[0] == 0).all()) and bool((den[0] == 0).all())


def test_k21_shards_merge_to_k3b(gen):
    """Four shards' K21 partials merged by ``lse_merge`` equal K3b over the
    whole cache within 2e-2 * max|K3b| + 1e-4 (lengths stop mid-shard, on a
    boundary, and leave shards empty)."""
    from qllm_tpu_torch.parallel import lse_merge, sp_cache_shard

    L, B, Hkv, S, D, n_rep, n = 1, 4, 2, 2048, 128, 4, 4
    cache = _int8_cache(gen, (L, B, Hkv, S, D))
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([37, 512, 1500, 2048], dtype=torch.int32, device="cuda")
    parts = []
    for r in range(n):
        loc = (lengths - r * (S // n)).clamp(0, S // n).to(torch.int32)
        parts.append(att.decode_attention_partial(q, *[sp_cache_shard(t, r, n) for t in cache], loc, 0))
    acc, m, den = (torch.stack(t) for t in zip(*parts))
    out = lse_merge(acc, m, den, lambda t: t.amax(0), lambda t: t.sum(0))
    ref = att.decode_attn_int8(q, *cache, lengths, 0)
    assert (out - ref).abs().max() <= 2e-2 * ref.abs().max() + 1e-4


_C = att.SPLIT_KEYS  # the rows a block of the decode attention body takes


def _m_close(m, ref):
    """K21's running max against its plain version: within 1e-5 of the
    largest |m| of a non-empty row (an f32 dot product's rounding follows
    the size of its terms, not of a sum near 0); empty rows (-1e30) exact."""
    live = ref > -1e29
    assert torch.equal(m[~live], ref[~live])
    assert (m[live] - ref[live]).abs().max() <= 1e-5 * ref[live].abs().max()


@pytest.mark.parametrize("n_rep,D", [(48, 128), (71, 64)])
def test_decode_attention_body_at_large_n_rep(gen, n_rep, D):
    """StarCoder's (48 query heads on one kv head) and Falcon-7B's (71, head
    width 64) groups through K3b, K22, K21 and K6, each against its plain
    version within one bf16 ulp of max|plain| (K21: acc and den within one
    ulp of their max, m within 1e-5 relative), over several splits."""
    L, B, Hkv, S = 2, 3, 1, 3 * _C + 40
    cache = _int8_cache(gen, (L, B, Hkv, S, D))
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([7, _C + 9, S], dtype=torch.int32, device="cuda")
    out = att.decode_attention(q, *cache, lengths, 1)
    ref = att.decode_attn_int8_plain(q, *cache, lengths, 1)
    torch.testing.assert_close(out, ref, atol=_bf16_ulp(ref), rtol=0)
    one = [t[1] for t in cache]
    out = att.decode_attention(q, *one, lengths)
    ref = att.decode_attn_int8_4d_plain(q, *one, lengths)
    torch.testing.assert_close(out, ref, atol=_bf16_ulp(ref), rtol=0)
    got = att.decode_attention_partial(q, *cache, lengths, 0)
    want = att.decode_attn_int8_partial_plain(q, *cache, lengths, 0)
    for name, a, r in zip(("acc", "m", "den"), got, want):
        if name == "m":
            _m_close(a, r)
        else:
            torch.testing.assert_close(a, r, atol=_bf16_ulp(r), rtol=0)
    rk = torch.randn((L, B, Hkv, att.RING, D), device="cuda", generator=gen).to(torch.bfloat16)
    rv = torch.randn((L, B, Hkv, att.RING, D), device="cuda", generator=gen).to(torch.bfloat16)
    kn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    vn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    a, b = [rk.clone(), rv.clone()], [rk.clone(), rv.clone()]
    ring_len = torch.tensor([5, _C + 3, S - 1], dtype=torch.int32, device="cuda")
    out = att.decode_attention_ring(q, kn, vn, *cache, *a, ring_len, 1)
    ref = att.decode_attention_ring_plain(q, kn, vn, *cache, *b, ring_len, 1)
    torch.testing.assert_close(out, ref, atol=_bf16_ulp(ref), rtol=0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_decode_attention_lengths_around_a_split_edge(gen):
    """Lengths 0, 1, C - 1, C and C + 1 (C = SPLIT_KEYS) and past two splits:
    K21 (the length-0 row exactly m = -1e30, acc = 0, den = 0), K3b (from
    length 1) and K6 (pos 0 attends to the current token alone) against
    their plain versions within one bf16 ulp of max|plain|."""
    L, B, Hkv, S, D, n_rep = 1, 6, 2, 3 * _C, 128, 4
    cache = _int8_cache(gen, (L, B, Hkv, S, D))
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([0, 1, _C - 1, _C, _C + 1, 2 * _C + 5], dtype=torch.int32, device="cuda")
    acc, m, den = att.decode_attention_partial(q, *cache, lengths, 0)
    r_acc, r_m, r_den = att.decode_attn_int8_partial_plain(q, *cache, lengths, 0)
    torch.testing.assert_close(acc, r_acc, atol=_bf16_ulp(r_acc), rtol=0)
    torch.testing.assert_close(den, r_den, atol=_bf16_ulp(r_den), rtol=0)
    _m_close(m, r_m)
    assert bool((m[0] == -1e30).all()) and bool((acc[0] == 0).all()) and bool((den[0] == 0).all())
    sub = [t[:, 1:].contiguous() for t in cache]  # K3b from length 1
    out = att.decode_attention(q[1:], *sub, lengths[1:], 0)
    ref = att.decode_attn_int8_plain(q[1:], *sub, lengths[1:], 0)
    torch.testing.assert_close(out, ref, atol=_bf16_ulp(ref), rtol=0)
    rk = torch.randn((L, B, Hkv, att.RING, D), device="cuda", generator=gen).to(torch.bfloat16)
    rv = torch.randn((L, B, Hkv, att.RING, D), device="cuda", generator=gen).to(torch.bfloat16)
    kn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    vn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    a, b = [rk.clone(), rv.clone()], [rk.clone(), rv.clone()]
    out = att.decode_attention_ring(q, kn, vn, *cache, *a, lengths, 0)
    ref = att.decode_attention_ring_plain(q, kn, vn, *cache, *b, lengths, 0)
    torch.testing.assert_close(out, ref, atol=_bf16_ulp(ref), rtol=0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_decode_attention_window_past_whole_splits(gen):
    """A window whose first row lies past several whole splits: K3b and K22
    against their plain versions (one bf16 ulp of max|plain|), and the
    same output as a cache whose rows below the window are garbage."""
    L, B, Hkv, S, D, n_rep = 1, 2, 2, 6 * _C, 128, 2
    cache = _int8_cache(gen, (L, B, Hkv, S, D))
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([5 * _C + 3, 6 * _C], dtype=torch.int32, device="cuda")
    window = torch.tensor([_C + 10], dtype=torch.int32, device="cuda")
    out = att.decode_attention(q, *cache, lengths, 0, window=window)
    ref = att.decode_attn_int8_plain(q, *cache, lengths, 0, window=window)
    torch.testing.assert_close(out, ref, atol=_bf16_ulp(ref), rtol=0)
    junk = [t.clone() for t in cache]
    for t in junk[:2]:
        t[..., : 3 * _C, :] = 127
    for t in junk[2:]:
        t[..., : 3 * _C] = float("nan")
    assert torch.equal(att.decode_attention(q, *junk, lengths, 0, window=window), out)
    four = att.decode_attention(q, *[t[0] for t in cache], lengths, window=window)
    assert torch.equal(four, out)


def test_decode_attention_rows_do_not_depend_on_the_batch(gen):
    """A sequence's K3b and K6 outputs are bit-equal whether it is decoded
    in a batch of 8 or alone (its splits depend on its own length only)."""
    L, B, Hkv, S, D, n_rep = 2, 8, 2, 4 * _C, 128, 4
    cache = _int8_cache(gen, (L, B, Hkv, S, D))
    q = torch.randn((B, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([1, 100, _C, _C + 1, 2 * _C + 17, 3 * _C, 4 * _C - 3, 4 * _C], dtype=torch.int32,
                           device="cuda")
    rk = torch.randn((L, B, Hkv, att.RING, D), device="cuda", generator=gen).to(torch.bfloat16)
    rv = torch.randn((L, B, Hkv, att.RING, D), device="cuda", generator=gen).to(torch.bfloat16)
    kn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    vn = torch.randn((B, Hkv, D), device="cuda", generator=gen).to(torch.bfloat16)
    full = att.decode_attention(q, *cache, lengths, 1)
    ring_len = lengths - 1
    full_ring = att.decode_attention_ring(q, kn, vn, *cache, rk.clone(), rv.clone(), ring_len, 1)
    for b in range(B):
        one = [t[:, b : b + 1].contiguous() for t in cache]
        assert torch.equal(att.decode_attention(q[b : b + 1], *one, lengths[b : b + 1], 1), full[b : b + 1])
        rings = [rk[:, b : b + 1].clone(), rv[:, b : b + 1].clone()]
        alone = att.decode_attention_ring(q[b : b + 1], kn[b : b + 1], vn[b : b + 1], *one, *rings,
                                          ring_len[b : b + 1], 1)
        assert torch.equal(alone, full_ring[b : b + 1])


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("D,n_rep,softcap,window", [(256, 2, 50.0, 300), (256, 1, 0.0, 64), (128, 12, 30.0, 90)])
def test_flash_prefill_kernel_options_match_plain(gen, int8, D, n_rep, softcap, window):
    """K5 with the logit softcap and the window at head width 256 (Gemma-2)
    and at n_rep 12 against its plain version (atol/rtol 2e-2, as the K5
    test above); the softcap cases draw scores of RMS 0.5-1.5 x the cap,
    and the plain version without the softcap misses ten times the limit."""
    B, T, S, Hkv = 2, 200, 520, 2
    q = torch.randn((B, T, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    pos = torch.tensor([0, 320], dtype=torch.int32, device="cuda")
    spread = torch.rand((B, Hkv, S), device="cuda", generator=gen) + 0.5
    if int8:
        k = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
        v = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
        ks = spread * (softcap * 3**0.5 / 127) if softcap else spread * 0.01
        vs = torch.rand((B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    else:
        k = torch.randn((B, Hkv, S, D), device="cuda", generator=gen) * (spread * (softcap or 1.0))[..., None]
        k, v = k.to(torch.bfloat16), torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(torch.bfloat16)
        ks = vs = None
    win = torch.tensor([window], dtype=torch.int32, device="cuda")
    before = fp.flash_prefill.launches
    out = fp.flash_prefill(q, k, v, ks, vs, pos, torch.float32, softcap, win)
    torch.cuda.synchronize()
    assert fp.flash_prefill.launches == before + 1
    ref = fp.flash_prefill_plain(q, k, v, ks, vs, pos, torch.float32, softcap, win)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
    if softcap:
        bare = fp.flash_prefill_plain(q, k, v, ks, vs, pos, torch.float32, 0.0, win)
        assert not torch.allclose(out, bare, atol=0.2, rtol=0.2)


# ---------------------------------------------------------------------------
# K10 and K18 on wgmma; the planar kernels at g % 16 != 0; K5 at d = 384 / 512
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("g", [16, 32, 128, -1])
@pytest.mark.parametrize("M", [33, 40, 64, 256, 1024])
def test_k10_wgmma_matches_plain(gen, M, bits, g):
    """K10 at every bit width and group size it serves against its plain
    version, within the K10 test's limit above (1e-2 * max|plain|, rtol
    1e-2); g = -1 is one group over K."""
    K, N = 1024, 384
    qw, sc, zr = _gptq(gen, K, N, bits, K if g == -1 else g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    before = qmm2d.gptq_gemm.launches
    y = qmm2d.gptq_gemm(x, qw, sc, zr, bits, g).float()
    assert qmm2d.gptq_gemm.launches == before + 1
    ref = qmm2d.gptq_gemm_plain(x, qw, sc, zr, bits, g).float()
    torch.testing.assert_close(y, ref, atol=1e-2 * float(ref.abs().max()), rtol=1e-2)


@pytest.mark.parametrize(
    "M,K,N,bits,g",
    [(40, 1000, 388, 8, 40), (70, 960, 390, 4, 32), (300, 4112, 256, 2, 16)],
    ids=["K-not-64", "N-not-4", "K-pad-2bit"],
)
def test_k10_wgmma_ragged_shapes(gen, M, K, N, bits, g):
    """K not a multiple of 64 (x padded, word rows masked) and N not a
    multiple of 4 (4-byte word copies) against the plain version."""
    qw, sc, zr = _gptq(gen, K, N, bits, g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.float32)
    y = qmm2d.gptq_gemm(x, qw, sc, zr, bits, g).float()
    ref = qmm2d.gptq_gemm_plain(x, qw, sc, zr, bits, g).float()
    torch.testing.assert_close(y, ref, atol=1e-2 * float(ref.abs().max()), rtol=1e-2)


@pytest.mark.parametrize("N", [4096, 11008])
def test_k10_rows_do_not_depend_on_m(gen, N):
    """The verify shape (M = 40, one block per K segment, partial sums added
    by a second kernel) gives the same bits for its rows as M = 256 (at N =
    11008 every segment in one block) and M = 1024: the segments are fixed
    by (K, N) and added in one order."""
    K = 4096
    qw, sc, zr = _gptq(gen, K, N, 4, 128)
    x = torch.randn((1024, K), device="cuda", generator=gen).to(torch.bfloat16)
    y40 = qmm2d.gptq_gemm(x[:40], qw, sc, zr, 4, 128)
    y256 = qmm2d.gptq_gemm(x[:256], qw, sc, zr, 4, 128)
    y1024 = qmm2d.gptq_gemm(x, qw, sc, zr, 4, 128)
    assert torch.equal(y40, y256[:40])
    assert torch.equal(y256, y1024[:256])


def test_k10_serves_g16_per_layer_weight_past_32_rows(gen):
    """A per-layer g = 16 weight at M > 32 (an engine prefill dispatch or a
    verify step) runs K10 through qmatmul_2d."""
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    K, N, g = 512, 256, 16
    qw, sc, zr = _gptq(gen, K, N, 4, g)
    qt = QuantizedTensor(qweight=qw, scales=sc, zeros=zr, perm=None, bits=4, group_size=g, in_features=K,
                         out_features=N)
    x = torch.randn((48, K), device="cuda", generator=gen).to(torch.bfloat16)
    before = qmm2d.gptq_gemm.launches
    y = qmm2d.qmatmul_2d(x, qt).float()
    assert qmm2d.gptq_gemm.launches == before + 1
    ref = qmm2d.gptq_gemm_plain(x, qw, sc, zr, 4, g).float()
    torch.testing.assert_close(y, ref, atol=1e-2 * float(ref.abs().max()), rtol=1e-2)


@pytest.mark.parametrize("g", [8, 24, 32, 128])
@pytest.mark.parametrize("M", [33, 64, 1024])
def test_k18_wgmma_matches_plain(gen, M, g):
    """K18 on wgmma at the group sizes JAX's planar gate admits, with the
    existing limits (_f32s_close: 1e-2, and 1e-4 with the bf16-weight
    control missing)."""
    K, Np = 1536, 512
    qw, sc = _f32s_stack(gen, K, Np, g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    before = qmm_planar.w4_planar_f32s_gemm.launches
    y = qmm_planar.w4_planar_f32s_gemm(x, qw, sc, 1)
    assert qmm_planar.w4_planar_f32s_gemm.launches == before + 1
    _f32s_close(y, x, qw, sc)


def _stack_g(gen, K, Np, g, L=2):
    qw = torch.randint(-(2**31), 2**31, (L, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
    sc = ((torch.rand((L, K // g, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
    return qw, sc, (sc.float() * 8).to(torch.bfloat16)


@pytest.mark.parametrize("g", [8, 24])
def test_planar_kernels_at_g8_and_g24(gen, g):
    """K1 (with and without the norm), K2, K17 and K8 on stacks whose groups
    close inside a 16-k tile, against their plain versions (the limits of
    the tests above)."""
    K, Np = 768, 512
    qw, sc, zs = _stack_g(gen, K, Np, g)
    for M, norm in ((5, False), (8, True)):
        x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
        nw = (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(torch.bfloat16) if norm else None
        y = qmm.w4_planar_gemv(x, qw, sc, zs, 1, nw, 1e-5).float()
        ref = qmm.w4_planar_gemv_plain(x, qw, sc, zs, 1, nw, 1e-5).float()
        torch.testing.assert_close(y, ref, atol=2e-2 * float(ref.abs().max()), rtol=2e-2)
    for M in (40, 200):
        x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
        y, ref = qmm.w4_planar_gemm(x, qw, sc, zs, 1).float(), qmm.w4_planar_gemm_plain(x, qw, sc, zs, 1).float()
        torch.testing.assert_close(y, ref, atol=2e-2 * float(ref.abs().max()), rtol=2e-2)
    fq, fs = _f32s_stack(gen, K, Np, g)
    x = torch.randn((8, K), device="cuda", generator=gen).to(torch.bfloat16)
    _f32s_close(qmm_planar.w4_planar_f32s_gemv(x, fq, fs, 1), x, fq, fs)
    eq, es, ez = _stack_g(gen, K, Np, g, L=4)
    ids = torch.tensor([3, 0, 3], dtype=torch.int32, device="cuda")
    x = torch.randn((3, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm.w4_grouped_gemv(x, eq, es, ez, ids, False).float()
    ref = qmm.w4_grouped_gemv_plain(x, eq, es, ez, ids, False).float()
    assert (y - ref).abs().max() < 2e-2 * ref.abs().max() + 1e-3


@pytest.mark.parametrize("g,norm", [(8, False), (8, True), (24, True)])
def test_k11_at_g8(gen, g, norm):
    """K11 on a g = 8 (and 24) planar stack in the full-K geometry, within
    one bf16 ulp plus 1e-3 * max|y| of its plain version."""
    K, Np, M = 768, 384, 8
    qw, sc, zs = _stack_g(gen, K, Np, g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    nw = (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(torch.bfloat16) if norm else None
    args = (x, qw, sc, zs, 1, nw, 1e-5)
    _a8_close(qmm.w4a8_planar_gemv(*args), qmm.w4a8_planar_gemv_plain(*args))


def test_k19_k20_at_g8(gen):
    """K19 (n = 3 silu, and n = 16 gelu on a shared row) and K20 on g = 8
    stacks, with the limits of their tests above."""
    E, K1, K2, Np2, n = 4, 512, 256, 512, 3
    gq, gs, gz = _stack_g(gen, K1, 2 * K2, 8, L=E)
    dq, ds, dz = _stack_g(gen, K2, Np2, 8, L=E)
    ids = torch.tensor([2, 0, 3], dtype=torch.int32, device="cuda")
    x = torch.randn((n, K1), device="cuda", generator=gen).to(torch.bfloat16)
    args = (x, gq, gs, gz, dq, ds, dz, ids, K2, "silu", False)
    y = qmm.w4_grouped_fused_mlp(*args)
    ref = qmm.w4_grouped_fused_mlp_plain(*args).float()
    torch.testing.assert_close(y.float(), ref, atol=_bf16_ulp(ref), rtol=0)
    # n = 16 selections of a 16-expert g = 8 stack, gelu, one shared row
    E, n = 16, 16
    gq, gs, gz = _stack_g(gen, K1, 2 * K2, 8, L=E)
    dq, ds, dz = _stack_g(gen, K2, Np2, 8, L=E)
    ids = torch.randperm(E, generator=gen, device="cuda").to(torch.int32)
    args = (x[:1], gq, gs, gz, dq, ds, dz, ids, K2, "gelu", True)
    y = qmm.w4_grouped_fused_mlp(*args)
    ref = qmm.w4_grouped_fused_mlp_plain(*args).float()
    torch.testing.assert_close(y.float(), ref, atol=_bf16_ulp(ref), rtol=0)
    L, M, D = 2, 8, 512
    q1, s1, z1 = _stack_g(gen, K1, D, 8, L=L)
    q2, s2, z2 = _stack_g(gen, D, Np2, 8, L=L)
    nw = (torch.rand((L, D), device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    x1 = torch.randn((M, K1), device="cuda", generator=gen).to(torch.bfloat16)
    h = torch.randn((M, D), device="cuda", generator=gen) * 4.0
    args = (x1, h, q1, s1, z1, q2, s2, z2, nw, 1, 1e-6)
    hn, y2 = qmm.w4_pnp_gemv(*args)
    hn_ref, y2_ref = qmm.w4_pnp_gemv_plain(*args)
    torch.testing.assert_close(hn, hn_ref, atol=1e-5 * float(hn_ref.abs().max()), rtol=0)
    torch.testing.assert_close(y2.float(), y2_ref.float(), atol=_bf16_ulp(y2_ref.float()), rtol=0)


@pytest.mark.parametrize("nw_dtype", [None, torch.bfloat16, torch.float32])
def test_k11_rows_do_not_depend_on_m(gen, nw_dtype):
    """K11's rows at M = 1 and 8 are bit-equal to those rows of one M = 32
    launch, with and without the norm (K split: the plan comes from (K,
    Np) alone)."""
    K, Np = 4096, 1024
    assert qmm.a8_splits(K, Np)[0] > 1
    qw, sc, zs = _stack(gen, K, Np)
    nw = None if nw_dtype is None else (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(nw_dtype)
    x = torch.randn((32, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm.w4a8_planar_gemv(x, qw, sc, zs, 1, nw, 1e-5)
    for m in (1, 8):
        assert torch.equal(qmm.w4a8_planar_gemv(x[:m], qw, sc, zs, 1, nw, 1e-5), y[:m]), m


def _pnp_args(gen, L, M, K1, D, Np2, g=128, nw_dtype=torch.bfloat16):
    q1, s1, z1 = _stack_g(gen, K1, D, g, L=L)
    q2, s2, z2 = _stack_g(gen, D, Np2, g, L=L)
    nw = (torch.rand((L, D), device="cuda", generator=gen) + 0.5).to(nw_dtype)
    x1 = torch.randn((M, K1), device="cuda", generator=gen).to(torch.bfloat16)
    h = torch.randn((M, D), device="cuda", generator=gen) * 4.0
    return x1, h, q1, s1, z1, q2, s2, z2, nw, L - 1, 1e-6


def _pnp_close(hn, y2, hn_ref, y2_ref):
    torch.testing.assert_close(hn, hn_ref, atol=1e-5 * float(hn_ref.abs().max()), rtol=0)
    torch.testing.assert_close(y2.float(), y2_ref.float(), atol=_bf16_ulp(y2_ref.float()), rtol=0)


@pytest.mark.parametrize("K1,D,Np2", [(1024, 1024, 2048), (4096, 4096, 22016)])
def test_k20_rows_do_not_depend_on_m(gen, K1, D, Np2):
    """K20's row at M = 1 is bit-equal to that row of an M = 8 launch, hn
    and y2 (both products split: the plans come from the shapes alone)."""
    args = _pnp_args(gen, 2, 8, K1, D, Np2)
    assert qmm.planar_splits(K1, D)[0] > 1 and qmm.planar_splits(D, Np2)[0] > 1
    hn, y2 = qmm.w4_pnp_gemv(*args)
    hn1, y21 = qmm.w4_pnp_gemv(args[0][:1], args[1][:1], *args[2:])
    assert torch.equal(hn1, hn[:1]) and torch.equal(y21, y2[:1])


def test_k20_twice_and_after_k19_on_the_same_barrier(gen):
    """K20 twice back to back, then K19 and K20 again, all on the device's
    one barrier word: each K20 call gives the same bits, within its limits
    of the plain version, and each launch leaves the word ready for the
    next (its 64-bit arrival count moved on to the next multiple of 2^16)."""
    args = _pnp_args(gen, 2, 8, 1024, 1024, 2048)
    word = qmm._grid_barrier(torch.device("cuda")).view(torch.int64)
    before = int(word[0])
    first = qmm.w4_pnp_gemv(*args)
    second = qmm.w4_pnp_gemv(*args)
    E, K1, K2, Np2, n = 4, 512, 256, 512, 3
    gq, gs, gz = _stack(gen, K1, 2 * K2, L=E)
    dq, ds, dz = _stack(gen, K2, Np2, L=E)
    ids = torch.tensor([2, 0, 3], dtype=torch.int32, device="cuda")
    x = torch.randn((n, K1), device="cuda", generator=gen).to(torch.bfloat16)
    fargs = (x, gq, gs, gz, dq, ds, dz, ids, K2, "silu", False)
    y = qmm.w4_grouped_fused_mlp(*fargs)
    third = qmm.w4_pnp_gemv(*args)
    torch.cuda.synchronize()
    ref = qmm.w4_grouped_fused_mlp_plain(*fargs).float()
    torch.testing.assert_close(y.float(), ref, atol=_bf16_ulp(ref), rtol=0)
    for got in (second, third):
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
    _pnp_close(*first, *qmm.w4_pnp_gemv_plain(*args))
    assert before % (1 << 16) == 0 and int(word[0]) == before + 4 * (1 << 16)


@pytest.mark.parametrize("M,nw_dtype", [(1, torch.float32), (8, torch.float32), (5, torch.bfloat16)])
def test_k20_at_g8_with_either_norm_weight(gen, M, nw_dtype):
    """K20 on g = 8 stacks with bf16 and f32 norm weights, at M = 1, 5 and
    8, against its plain version (hn 1e-5 * max|hn|, y2 one bf16 ulp)."""
    args = _pnp_args(gen, 2, M, 512, 768, 640, g=8, nw_dtype=nw_dtype)
    _pnp_close(*qmm.w4_pnp_gemv(*args), *qmm.w4_pnp_gemv_plain(*args))


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("D,n_rep,softcap,window", [(384, 2, 0.0, 0), (512, 1, 50.0, 0), (512, 2, 0.0, 90)])
def test_flash_prefill_kernel_at_d384_and_d512(gen, int8, D, n_rep, softcap, window):
    """K5 at head widths 384 and 512 (each block writes a slice of the
    width) against its plain version (atol/rtol 2e-2, as above); the
    softcap case draws scores of RMS 0.5-1.5 x the cap, and the plain
    version without the softcap misses ten times the limit."""
    B, T, S, Hkv = 2, 150, 400, 2
    q = torch.randn((B, T, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    pos = torch.tensor([0, 250], dtype=torch.int32, device="cuda")
    spread = torch.rand((B, Hkv, S), device="cuda", generator=gen) + 0.5
    if int8:
        k = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
        v = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
        ks = spread * (softcap * 3**0.5 / 127) if softcap else spread * 0.01
        vs = torch.rand((B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    else:
        k = torch.randn((B, Hkv, S, D), device="cuda", generator=gen) * (spread * (softcap or 1.0))[..., None]
        k, v = k.to(torch.bfloat16), torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(torch.bfloat16)
        ks = vs = None
    win = torch.tensor([window], dtype=torch.int32, device="cuda") if window else None
    before = fp.flash_prefill.launches
    out = fp.flash_prefill(q, k, v, ks, vs, pos, torch.float32, softcap, win)
    torch.cuda.synchronize()
    assert fp.flash_prefill.launches == before + 1
    ref = fp.flash_prefill_plain(q, k, v, ks, vs, pos, torch.float32, softcap, win)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
    if softcap:
        bare = fp.flash_prefill_plain(q, k, v, ks, vs, pos, torch.float32, 0.0, win)
        assert not torch.allclose(out, bare, atol=0.2, rtol=0.2)


# ---------------------------------------------------------------------------
# K2 and K5 on wgmma; the planar kernels at any group size (g % 4 != 0)
# ---------------------------------------------------------------------------


def _k2_close(y, ref):
    """K2 against its plain version: within one bf16 ulp of max|plain| (the
    same bf16 weights and exact products, f32 sums in another order)."""
    torch.testing.assert_close(y.float(), ref.float(), atol=_bf16_ulp(ref.float()), rtol=0)


@pytest.mark.parametrize("M", [33, 64, 65, 1000, 2048])
def test_k2_wgmma_matches_plain_at_every_m(gen, M):
    K, Np = 1536, 512
    qw, sc, zs = _stack(gen, K, Np)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    before = qmm.w4_planar_gemm.launches
    y = qmm.w4_planar_gemm(x, qw, sc, zs, 1)
    assert qmm.w4_planar_gemm.launches == before + 1
    _k2_close(y, qmm.w4_planar_gemm_plain(x, qw, sc, zs, 1))


@pytest.mark.parametrize("K,N", [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)],
                         ids=["qkv", "o", "gateup", "down"])
def test_k2_wgmma_at_7b_shapes(gen, K, N):
    qw, sc, zs = _stack(gen, K, N)
    x = torch.randn((128, K), device="cuda", generator=gen).to(torch.bfloat16)
    _k2_close(qmm.w4_planar_gemm(x, qw, sc, zs, 1), qmm.w4_planar_gemm_plain(x, qw, sc, zs, 1))


@pytest.mark.parametrize("g", [3, 6, 8, 24, 128])
def test_k2_wgmma_at_every_group_size(gen, g):
    K, Np, M = 1536, 384, 200
    qw, sc, zs = _stack_g(gen, K, Np, g)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    _k2_close(qmm.w4_planar_gemm(x, qw, sc, zs, 1), qmm.w4_planar_gemm_plain(x, qw, sc, zs, 1))


@pytest.mark.parametrize("g", [6, 128])
def test_k2_rows_do_not_depend_on_m(gen, g):
    """K2's rows at M = 64 (one 64-row chunk a block) equal the same rows
    at M = 1024 (two a block) bit for bit: no split of K, one k order."""
    K, Np = 3072, 1024
    qw, sc, zs = _stack_g(gen, K, Np, g)
    x = torch.randn((1024, K), device="cuda", generator=gen).to(torch.bfloat16)
    assert torch.equal(qmm.w4_planar_gemm(x[:64], qw, sc, zs, 1), qmm.w4_planar_gemm(x, qw, sc, zs, 1)[:64])


@pytest.mark.parametrize("g", [6, 3])
def test_planar_kernels_at_g_not_multiple_of_4(gen, g):
    """K1 (with and without the norm), K17, K18, K8, K11, K19 and K20 on
    stacks whose groups end inside a planar word's quadruple, against their
    plain versions with the limits of the tests above."""
    K, Np = 768, 512
    qw, sc, zs = _stack_g(gen, K, Np, g)
    for M, norm in ((5, False), (8, True)):
        x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
        nw = (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(torch.bfloat16) if norm else None
        y = qmm.w4_planar_gemv(x, qw, sc, zs, 1, nw, 1e-5).float()
        ref = qmm.w4_planar_gemv_plain(x, qw, sc, zs, 1, nw, 1e-5).float()
        torch.testing.assert_close(y, ref, atol=2e-2 * float(ref.abs().max()), rtol=2e-2)
        args = (x, qw, sc, zs, 1, nw, 1e-5)
        _a8_close(qmm.w4a8_planar_gemv(*args), qmm.w4a8_planar_gemv_plain(*args))
    fq, fs = _f32s_stack(gen, K, Np, g)
    for M, fn in ((8, qmm_planar.w4_planar_f32s_gemv), (40, qmm_planar.w4_planar_f32s_gemm),
                  (130, qmm_planar.w4_planar_f32s_gemm)):
        x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
        _f32s_close(fn(x, fq, fs, 1), x, fq, fs)
    eq, es, ez = _stack_g(gen, K, Np, g, L=4)
    ids = torch.tensor([3, 0, 3], dtype=torch.int32, device="cuda")
    x = torch.randn((3, K), device="cuda", generator=gen).to(torch.bfloat16)
    y = qmm.w4_grouped_gemv(x, eq, es, ez, ids, False).float()
    ref = qmm.w4_grouped_gemv_plain(x, eq, es, ez, ids, False).float()
    assert (y - ref).abs().max() < 2e-2 * ref.abs().max() + 1e-3
    E, K1, K2, Np2, n = 4, 768, 768, 512, 3
    gq, gs, gz = _stack_g(gen, K1, 2 * K2, g, L=E)
    dq, ds, dz = _stack_g(gen, K2, Np2, g, L=E)
    x = torch.randn((n, K1), device="cuda", generator=gen).to(torch.bfloat16)
    args = (x, gq, gs, gz, dq, ds, dz, ids, K2, "silu", False)
    ref = qmm.w4_grouped_fused_mlp_plain(*args).float()
    torch.testing.assert_close(qmm.w4_grouped_fused_mlp(*args).float(), ref, atol=_bf16_ulp(ref), rtol=0)
    L, M, D = 2, 8, 768
    q1, s1, z1 = _stack_g(gen, K1, D, g, L=L)
    q2, s2, z2 = _stack_g(gen, D, Np2, g, L=L)
    nw = (torch.rand((L, D), device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    x1 = torch.randn((M, K1), device="cuda", generator=gen).to(torch.bfloat16)
    h = torch.randn((M, D), device="cuda", generator=gen) * 4.0
    args = (x1, h, q1, s1, z1, q2, s2, z2, nw, 1, 1e-6)
    hn, y2 = qmm.w4_pnp_gemv(*args)
    hn_ref, y2_ref = qmm.w4_pnp_gemv_plain(*args)
    torch.testing.assert_close(hn, hn_ref, atol=1e-5 * float(hn_ref.abs().max()), rtol=0)
    torch.testing.assert_close(y2.float(), y2_ref.float(), atol=_bf16_ulp(y2_ref.float()), rtol=0)


def _flash_inputs(gen, B, T, S, Hkv, n_rep, D, int8, softcap=0.0):
    q = torch.randn((B, T, Hkv * n_rep, D), device="cuda", generator=gen).to(torch.bfloat16)
    spread = torch.rand((B, Hkv, S), device="cuda", generator=gen) + 0.5
    if int8:
        k = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
        v = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device="cuda", generator=gen)
        ks = spread * (softcap * 3**0.5 / 127) if softcap else spread * 0.01
        vs = torch.rand((B, Hkv, S), device="cuda", generator=gen) * 0.01 + 0.005
    else:
        k = torch.randn((B, Hkv, S, D), device="cuda", generator=gen) * (spread * (softcap or 1.0))[..., None]
        k, v = k.to(torch.bfloat16), torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(torch.bfloat16)
        ks = vs = None
    return q, k, v, ks, vs


@pytest.mark.parametrize("n_rep", [1, 4, 12])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_k5_wgmma_matches_plain(gen, D, int8, n_rep):
    """K5 on wgmma at every head width, int8 and bf16 K/V, n_rep 1 / 4 / 12,
    T = 150 (no multiple of 64 or 128), pos 0 and 517, bf16 and f32 out,
    within FLASH_TOL (atol/rtol 2e-2) of its plain version."""
    B, T, S, Hkv = 2, 150, 700, 1 if n_rep == 12 else 2
    q, k, v, ks, vs = _flash_inputs(gen, B, T, S, Hkv, n_rep, D, int8)
    pos = torch.tensor([0, 517], dtype=torch.int32, device="cuda")
    for out_dtype in (torch.bfloat16, torch.float32):
        before = fp.flash_prefill.launches
        out = fp.flash_prefill(q, k, v, ks, vs, pos, out_dtype).float()
        torch.cuda.synchronize()
        assert fp.flash_prefill.launches == before + 1
        ref = fp.flash_prefill_plain(q, k, v, ks, vs, pos, out_dtype).float()
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_k5_wgmma_softcap_and_window(gen, D, int8):
    """K5 with the softcap 50 (scores of RMS 0.5-1.5 x the cap; the plain
    version without the cap misses ten times the limit) and a window of 512
    keys over T = S = 1100, within FLASH_TOL of its plain version."""
    B, T, S, Hkv, n_rep = 1, 1100, 1100, 2, 2
    q, k, v, ks, vs = _flash_inputs(gen, B, T, S, Hkv, n_rep, D, int8, softcap=50.0)
    pos = torch.zeros((B,), dtype=torch.int32, device="cuda")
    win = torch.tensor([512], dtype=torch.int32, device="cuda")
    out = fp.flash_prefill(q, k, v, ks, vs, pos, torch.float32, 50.0, win)
    ref = fp.flash_prefill_plain(q, k, v, ks, vs, pos, torch.float32, 50.0, win)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
    bare = fp.flash_prefill_plain(q, k, v, ks, vs, pos, torch.float32, 0.0, win)
    assert not torch.allclose(out, bare, atol=0.2, rtol=0.2)
    whole = fp.flash_prefill_plain(q, k, v, ks, vs, pos, torch.float32, 50.0, None)
    assert not torch.allclose(out, whole, atol=0.2, rtol=0.2)
