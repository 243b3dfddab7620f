"""Port parity for the streaming microbench (ops/stream_bench.py): K13's
plain version against the JAX package's ``_stream_kernel`` driven through
``pallas_call`` in interpret mode as ``stream_pass_seconds`` drives it
(layer by scalar prefetch, [8, N] f32 out), on per-column totals; the
layer cycling of a multi-pass call; the GB/s byte count; and the refusal
to measure anything but the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qllm_tpu.ops import stream_bench as jsb
from qllm_tpu_torch.ops import stream_bench as tsb


def _jax_pass(qweight, layer, bk, bn, pf=8):
    """One call of stream_pass_seconds' nested ``call`` (stream_bench.py:66-91)."""
    _, rows, N = qweight.shape
    K = rows * pf
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(1, N // bn, K // bk),
        in_specs=[pl.BlockSpec((1, bk // pf, bn), lambda i, j, k, l: (l[0], k, j), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, bn), lambda i, j, k, l: (0, j), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((8, bn), jnp.float32)],
    )
    return pl.pallas_call(
        jsb._stream_kernel,
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((8, N), jnp.float32),
        interpret=True,
    )(jnp.asarray([layer], jnp.int32), qweight)


@pytest.mark.parametrize("K,N,bk,bn", [(512, 256, 512, 128), (1024, 384, 512, 128)])
def test_stream_pass_plain_matches_jax_stream_kernel(K, N, bk, bn):
    """Words in 0..254, as measure_stream_gbps draws them: the per-column
    totals are exact on both sides (bk < K accumulates over k steps)."""
    L = 3
    rng = np.random.default_rng(K + N)
    words = rng.integers(0, 255, (L, K // 8, N), dtype=np.uint8).astype(np.int32)
    for layer in (0, 2):
        ref = np.asarray(_jax_pass(jnp.asarray(words), layer, bk, bn)).sum(axis=0)
        got = tsb.stream_pass(torch.from_numpy(words), layer)  # a CPU tensor: the plain version
        assert got.dtype == torch.int32 and tuple(got.shape) == (N,)
        np.testing.assert_array_equal(got.numpy().astype(np.float32), ref)


def test_stream_pass_cycles_layers_and_wraps():
    """passes > 1 sum the layers from ``layer`` on, cycling; the totals are
    modulo 2^32, as the kernel's integer atomics give them."""
    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(-(2**31), 2**31, (3, 64, 128), dtype=np.int64).astype(np.int32))
    got = tsb.stream_pass_plain(words, 2, passes=5)
    tot = sum(words[i].numpy().astype(np.int64).sum(axis=0) for i in (2, 0, 1, 2, 0))
    np.testing.assert_array_equal(got.numpy(), (tot % 2**32).astype(np.uint32).view(np.int32))


def test_gbps_counts_the_jax_bytes():
    """K * N / 2 bytes a pass (stream_bench.py:141): the default 7B gate|up
    pass is 45.1 MB, 0.0135 ms at 3.35 TB/s."""
    K, N, sec = 4096, 22016, 1.5e-5
    assert tsb.stream_gbps(K, N, sec) == K * N * 4 / 8 / sec / 1e9
    assert K * N // 2 == 45_088_768
    assert abs(K * N / 2 / 3.35e12 * 1e3 - 0.01346) < 1e-5


def test_measurement_needs_the_card():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsb.stream_pass_seconds(torch.zeros((2, 8, 16), dtype=torch.int32))
    with pytest.raises((RuntimeError, ValueError)):
        tsb.measure_stream_gbps(K=256, N=128, L=2, iters=2, device="cuda" if not torch.cuda.is_available() else "cpu")
