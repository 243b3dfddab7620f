"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes. Marked ``cuda``: they skip where no CUDA
device is present (the CPU tests hold the plain versions against the
JAX package). On a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""

import pytest
import torch

from qllm_tpu_torch.ops import attention as att
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
