"""Port parity for the fused o_proj -> residual + RMSNorm -> gate|up entry
point (K20 ``w4_pnp_gemv``, the port of ``_qmm_kernel_pnp``) against the
JAX package, on the CPU at the shapes of tests/test_pnp_kernel.py (L = 3,
g = 128, K1 = D = 512, N2 = 1024):

  * ``qmatmul_pnp_stacked`` (K20's plain version) against JAX's
    ``qmatmul_pnp_stacked`` interpreted, at every layer and at M = 2 and 8:
    hn within 4 f32 ulps of max|hn| (both sum the same f32 products of
    exact nibbles and bf16 inputs, in another order), y2 within one bf16
    ulp of max|y2|;
  * ``pnp_stacked_ok`` against JAX's gate on its chip (``default_backend``
    reporting "tpu"): the guards of test_pnp_eligibility_guards and the
    other refusals, f32 scales among them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import jax.tree_util as tu
import numpy as np
import pytest
import torch

from qllm_tpu.ops import pallas_qmm as jpq
from qllm_tpu.quant.qtensor import planarize_packed, quantize_tensor
from qllm_tpu_torch.interop import params_from_numpy
from qllm_tpu_torch.ops import qmm as tqmm

L, G = 3, 128
K1, D, N2 = 512, 512, 1024
EPS = 1e-6


def _build(rng, K, N):
    """A planar prefolded bf16-scale [L]-stack of one quantized layer, as
    tests/test_pnp_kernel.py:_build makes it, and the port's copy."""
    qt = quantize_tensor(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05), bits=4, group_size=G)
    st = tu.tree_map(lambda a: jnp.stack([a] * L), qt)
    zs = st.zeros * st.scales
    pqw = jnp.stack([planarize_packed(st.qweight[i], K) for i in range(L)])
    js = dataclasses.replace(st, qweight=pqw, scales=st.scales.astype(jnp.bfloat16), zeros=zs.astype(jnp.bfloat16),
                             planar=True, zeros_prefolded=True)
    return js, params_from_numpy(tu.tree_map(np.asarray, js), device="cpu")


@functools.lru_cache(maxsize=None)
def _stacks():
    rng = np.random.default_rng(0)
    j1, t1 = _build(rng, K1, D)
    j2, t2 = _build(rng, D, N2)
    nw = rng.normal(size=(L, D)).astype(np.float32) * 0.1 + 1.0
    return j1, j2, t1, t2, nw


def _ulp(x, bits):
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - bits))


@pytest.mark.parametrize("M", [2, 8])
@pytest.mark.parametrize("layer", range(L))
def test_pnp_plain_matches_interpreted_kernel(layer, M):
    j1, j2, t1, t2, nw = _stacks()
    assert jpq.pnp_stacked_ok(j1, j2) and tqmm.pnp_stacked_ok(t1, t2)
    rng = np.random.default_rng(10 + M)
    x1 = rng.normal(size=(M, K1)).astype(np.float32)
    h = rng.normal(size=(M, D)).astype(np.float32)
    hn_j, y2_j = jpq.qmatmul_pnp_stacked(jnp.asarray(x1), jnp.asarray(h), j1, j2, jnp.asarray(nw), jnp.int32(layer), EPS)
    hn_j, y2_j = np.asarray(hn_j), np.asarray(y2_j, np.float32)
    hn_t, y2_t = tqmm.qmatmul_pnp_stacked(torch.from_numpy(x1), torch.from_numpy(h), t1, t2, torch.from_numpy(nw),
                                          layer, EPS)
    assert hn_t.dtype == torch.float32 and tuple(hn_t.shape) == (M, D)
    assert y2_t.dtype == torch.bfloat16 and tuple(y2_t.shape) == (M, N2)
    np.testing.assert_allclose(hn_t.numpy(), hn_j, atol=4 * _ulp(hn_j, 23), rtol=0)
    np.testing.assert_allclose(y2_t.float().numpy(), y2_j, atol=_ulp(y2_j, 7), rtol=0)


def _variants(j1, j2, t1, t2):
    """The gate's cases for both packages: (JAX args, port args)."""
    rng = np.random.default_rng(1)
    jn, tn = _build(rng, 256, N2)  # proj2 narrower than proj1's output

    def f32(qt, lib):
        return dataclasses.replace(qt, scales=qt.scales.astype(jnp.float32) if lib is jnp else qt.scales.float())

    def both(fn):
        return fn(j1, j2, jnp, jn), fn(t1, t2, torch, tn)

    return {
        "ok": both(lambda a, b, lib, n: (a, b)),
        # padded proj1 columns would corrupt the residual stream
        "proj1_padded": both(lambda a, b, lib, n: (dataclasses.replace(a, out_features=D - 128), b)),
        # width mismatch between proj1 out and proj2 in
        "width_mismatch": both(lambda a, b, lib, n: (a, n)),
        "proj2_3bit": both(lambda a, b, lib, n: (a, dataclasses.replace(b, bits=3))),
        "proj1_not_planar": both(lambda a, b, lib, n: (dataclasses.replace(a, planar=False), b)),
        "not_prefolded": both(lambda a, b, lib, n: (a, dataclasses.replace(b, zeros_prefolded=False))),
        "proj1_f32_scales": both(lambda a, b, lib, n: (f32(a, lib), b)),
        "proj2_f32_scales": both(lambda a, b, lib, n: (a, f32(b, lib))),
        "not_full_k": both(lambda a, b, lib, n: (dataclasses.replace(a, in_features=384), b)),
    }


@pytest.mark.parametrize("case", ["ok", "proj1_padded", "width_mismatch", "proj2_3bit", "proj1_not_planar",
                                  "not_prefolded", "proj1_f32_scales", "proj2_f32_scales", "not_full_k"])
def test_pnp_gate_mirrors_jax_chip_gate(monkeypatch, case):
    jargs, targs = _variants(*_stacks()[:4])[case]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    expected = jpq.pnp_stacked_ok(*jargs)
    assert tqmm.pnp_stacked_ok(*targs) == expected
    assert expected == (case == "ok")
