"""K14's and K16's plain versions against the interpreted JAX kernels at an
f32 x that bf16 cannot hold: the contract the kernels' three-way bf16
split of such an x must meet (JAX hands its stacked kernels x in f32,
``_qmm_2d_stacked`` :1394, :1477, and their dots keep all of it).

The JAX kernel's own f32 output is taken from inside
``qmatmul_pallas_stacked`` (``pallas_call`` wrapped, the jit off, so the
kernel runs eagerly in interpret mode):

  * unfused (``_qmm_kernel_v3_stacked``, ``_qmm_kernel_odd_stacked``):
    the plain version's f32 output within 1e-5 * max|JAX|, and the same
    plain version on x rounded to bf16 outside 1e-4 * max|JAX|;
  * fused (``_qmm_kernel_v4_stacked``, the odd kernel with
    ``fuse_corr``): the plain version's bf16 output within one bf16 ulp
    of max|JAX| of the JAX kernel's f32 output, and outside it on x
    rounded to bf16, where x leans half an ulp from its bf16 value with
    the sign of one column's q - z, so that the rounding adds up there.

The stacks are the ones ``tests/test_torch_stacked_widths.py`` prepares in
both packages (asserted bit-identical). JAX reads its switches when it
traces: the ``jax_env`` fixture clears its caches on the way in and out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qllm_tpu.ops.pallas_qmm as pq
from qllm_tpu_torch.interop import tensor_from_numpy
from qllm_tpu_torch.ops import qmm, qmm_stacked, tc_plan
from qllm_tpu_torch.quant.qtensor import unpack_rows

from test_torch_stacked_widths import _stacks, jax_env  # noqa: F401

M = 8


def _jax_kernel_out(monkeypatch, js, x):
    """The f32 output of the JAX stacked kernel that ``qmatmul_pallas_stacked``
    runs for layer 1 on x (f32)."""
    outs = []
    orig = pq.pl.pallas_call

    def capture(*a, **k):
        f = orig(*a, **k)

        def run(*args):
            o = f(*args)
            outs.append(np.asarray(o))
            return o

        return run

    monkeypatch.setattr(pq.pl, "pallas_call", capture)
    with jax.disable_jit():
        pq.qmatmul_pallas_stacked(jnp.asarray(x), js, jnp.int32(1))
    monkeypatch.setattr(pq.pl, "pallas_call", orig)
    assert len(outs) == 1 and outs[0].dtype == np.float32
    return outs[0][:M]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _leaning_x(rng, ts, bits, K, fused):
    """f32 x off the bf16 grid. Fused: each value half an ulp (0.45) from
    its bf16 value, on the side of sign(q - z) of column 0, so that x
    rounded to bf16 moves that column by a sum of like-signed terms."""
    if not fused:
        return rng.normal(size=(M, K)).astype(np.float32)
    b = _bf16(rng.normal(size=(M, K)).astype(np.float32))
    q = unpack_rows(ts.qweight[1], bits, K).float().numpy()[:, 0]
    g = ts.effective_group_size
    z = (ts.zeros[1].float() / ts.scales[1].float()).numpy()[:, 0].repeat(g)
    ulp = np.exp2(np.floor(np.log2(np.abs(b) + 1e-30)) - 7).astype(np.float32)
    return (b + np.sign(q - z)[None, :] * 0.45 * ulp).astype(np.float32)


@pytest.mark.parametrize("bits,fused", [(b, f) for b in (2, 4, 3, 7) for f in (False, True)])
def test_plain_versions_keep_an_f32_x(jax_env, bits, fused):
    K, g = 1024, 128
    js, ts, rng = _stacks(bits, g, K, False, "bf16" if fused else "f32", False, seed=500 + 10 * bits + fused)
    route = qmm.stacked_route(ts, M)
    assert route == {(True, True): "v4", (True, False): "v3", (False, True): "odd_fused", (False, False): "odd"}[
        (bits in (2, 4), fused)]
    x = _leaning_x(rng, ts, bits, K, fused)
    assert not np.array_equal(x, _bf16(x))
    ref = _jax_kernel_out(jax_env, js, x)
    plain = qmm_stacked.gptq_stacked_gemv_plain if bits in (2, 4) else qmm_stacked.bitplane_stacked_gemv_plain

    def port(xv):
        y = plain(tensor_from_numpy(xv, "cpu"), ts.qweight, ts.scales, ts.zeros, 1, bits, ts.group_size, fused)
        return y.float().numpy()[:, : ref.shape[1]]

    scale = float(np.abs(ref).max())
    err, err_bf16 = float(np.abs(port(x) - ref).max()), float(np.abs(port(_bf16(x)) - ref).max())
    if fused:
        limit = 2.0 ** (np.floor(np.log2(scale)) - 7)  # one bf16 ulp of max|JAX|
        assert err <= limit < err_bf16, (err, limit, err_bf16)
    else:
        assert err <= 1e-5 * scale, (err, scale)
        assert err_bf16 > 1e-4 * scale, (err_bf16, scale)


# ---------------------------------------------------------------------------
# K14's and K16's split of K (ops.tc_plan.tc_splits)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("units", [1, 15, 16, 17, 128, 256, 344, 688, 2752])
@pytest.mark.parametrize("N", [64, 200, 4096, 12288, 22016, 32000])
def test_tc_splits_cover_k(units, N):
    """The splits cover every unit once: all but the last hold ``per``
    units, the last 1..per, and no split is empty; the blocks stay within
    the kernel's target unless K is not split."""
    for name, target in tc_plan.TC_TARGET_BLOCKS.items():
        splits, per = tc_plan.tc_splits(units, N, target)
        assert splits >= 1 and per >= 1
        assert (splits - 1) * per < units <= splits * per
        assert splits == 1 or per >= tc_plan.MIN_UNITS
        assert splits == 1 or splits * -(-N // 128) <= target, name


class _Recorder:
    """Stands in for the kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.mark.parametrize("fn,bits", [("gptq_stacked_gemv", 2), ("gptq_stacked_gemv", 4), ("bitplane_stacked_gemv", 3),
                                     ("bitplane_stacked_gemv", 7)])
def test_tc_launch_splits_depend_on_k_and_n_alone(monkeypatch, fn, bits):
    """The wrappers' launch on the CPU with the library replaced by a
    recorder: the same (splits, units a split) at every M and x dtype,
    fused or not, equal to tc_splits of the layer's shape (word rows for
    K14, words a plane for K16)."""
    from qllm_tpu_torch.ops import _build

    lib = _Recorder()
    monkeypatch.setattr(_build, "use_kernel", lambda t, name: True)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    K, Np, g = 4096, 22016, 128
    rows = K * bits // 32
    qw = torch.zeros((2, rows, Np), dtype=torch.int32)
    sc = torch.ones((2, K // g, Np), dtype=torch.bfloat16)
    for M in (1, 8, 17, 32):
        for dtype in (torch.bfloat16, torch.float32):
            for fused in (False, True):
                getattr(qmm_stacked, fn)(torch.zeros((M, K), dtype=dtype), qw, sc, sc, 1, bits, g, fused)
    units = rows if bits in (2, 4) else K // 32
    want = tc_plan.tc_splits(units, Np, tc_plan.TC_TARGET_BLOCKS["gptq" if bits in (2, 4) else "bitplane"])
    assert want[0] > 1  # the 7B gate|up splits K
    assert {tuple(args[-3:-1]) for _, args in lib.calls} == {want}
    assert len(lib.calls) == 16
