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
from qllm_tpu_torch.ops import qmm, repack

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
