"""Port parity: qllm_tpu_torch.quant.qtensor and ops.repack (kernel K4's
plain version) against the JAX package, bit for bit, on random ints."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.ops.pallas_repack import planarize_packed_pallas
from qllm_tpu.quant import qtensor as jq
from qllm_tpu_torch.ops import repack as trp
from qllm_tpu_torch.quant import qtensor as tq


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _bits(j):
    """JAX uint32 words -> int32 numpy with the same bits (a writable copy)."""
    return np.array(j).view(np.int32)


@pytest.mark.parametrize("bits,K,N", [(4, 256, 64), (4, 128, 24), (2, 128, 16), (8, 64, 8)])
def test_pack_unpack_rows_bit_identical(bits, K, N):
    rng = np.random.default_rng(bits * 100 + K)
    q = rng.integers(0, 1 << bits, size=(K, N)).astype(np.int32)
    jw = jq.pack_rows(jnp.asarray(q), bits)
    tw = tq.pack_rows(torch.from_numpy(q), bits)
    np.testing.assert_array_equal(tw.numpy(), _bits(jw))
    back = tq.unpack_rows(torch.from_numpy(_bits(jw)), bits, K)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jq.unpack_rows(jw, bits, K)))
    np.testing.assert_array_equal(back.numpy(), q)


@pytest.mark.parametrize("lead,K,N", [((), 256, 40), ((3,), 512, 16), ((2, 2), 128, 8)])
def test_planarize_roundtrip_bit_identical(lead, K, N):
    rng = np.random.default_rng(K + N)
    w = _words(rng, (*lead, K // 8, N))
    jp = jq.planarize_packed(jnp.asarray(w), K)
    tp = tq.planarize_packed(torch.from_numpy(w.view(np.int32)), K)
    np.testing.assert_array_equal(tp.numpy(), _bits(jp))
    tu = tq.unplanarize_packed(tp, K)
    np.testing.assert_array_equal(tu.numpy(), w.view(np.int32))
    np.testing.assert_array_equal(tu.numpy(), _bits(jq.unplanarize_packed(jp, K)))


@pytest.mark.parametrize("E,K,N", [(1, 256, 128), (2, 512, 256), (3, 2048, 128)])
def test_k4_plain_matches_pallas_repack(E, K, N):
    rng = np.random.default_rng(E * K + N)
    w = _words(rng, (E, K // 8, N))
    jp = planarize_packed_pallas(jnp.asarray(w), K)  # interpret mode on CPU
    assert jp is not None
    ti = torch.from_numpy(w.view(np.int32))
    np.testing.assert_array_equal(trp.planarize_w4_plain(ti, K).numpy(), _bits(jp))
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(trp.planarize_w4(ti, K).numpy(), _bits(jp))
    np.testing.assert_array_equal(tq.planarize_packed(ti, K).numpy(), _bits(jp))


def _jax_qt_numpy(qt):
    return {
        "qweight": _bits(qt.qweight),
        "scales": np.asarray(qt.scales),
        "zeros": np.asarray(qt.zeros),
    }


@pytest.mark.parametrize("bits,g,sym", [(4, 32, False), (4, -1, False), (8, 64, True), (2, 32, False)])
def test_quantize_tensor_bit_identical(bits, g, sym):
    rng = np.random.default_rng(bits + (g if g > 0 else 7))
    w = (rng.normal(size=(128, 48)) * 0.05).astype(np.float32)
    jqt = jq.quantize_tensor(jnp.asarray(w), bits=bits, group_size=g, sym=sym)
    tqt = tq.quantize_tensor(torch.from_numpy(w), bits=bits, group_size=g, sym=sym)
    ref = _jax_qt_numpy(jqt)
    np.testing.assert_array_equal(tqt.qweight.numpy(), ref["qweight"])
    np.testing.assert_array_equal(tqt.scales.numpy(), ref["scales"])
    np.testing.assert_array_equal(tqt.zeros.numpy(), ref["zeros"])
    np.testing.assert_allclose(
        tq.dequantize_tensor(tqt).numpy(), np.asarray(jq.dequantize_tensor(jqt)), rtol=0, atol=0
    )


def test_take_and_concat_columns_bit_identical():
    rng = np.random.default_rng(5)
    parts_np = [(rng.normal(size=(64, n)) * 0.05).astype(np.float32) for n in (16, 8, 8)]
    jparts = [jq.quantize_tensor(jnp.asarray(w), bits=4, group_size=32) for w in parts_np]
    tparts = [tq.quantize_tensor(torch.from_numpy(w), bits=4, group_size=32) for w in parts_np]
    idx = [np.arange(0, 16), np.arange(16, 24), np.arange(24, 32)]
    jf = jq.concat_columns(jparts, idx, 32)
    tf = tq.concat_columns(tparts, idx, 32)
    ref = _jax_qt_numpy(jf)
    np.testing.assert_array_equal(tf.qweight.numpy(), ref["qweight"])
    np.testing.assert_array_equal(tf.scales.numpy(), ref["scales"])
    np.testing.assert_array_equal(tf.zeros.numpy(), ref["zeros"])
    cols = np.array([3, 17, 30, 0])
    jt = _jax_qt_numpy(jq.take_columns(jf, cols))
    tt = tq.take_columns(tf, cols)
    np.testing.assert_array_equal(tt.qweight.numpy(), jt["qweight"])
    np.testing.assert_array_equal(tt.scales.numpy(), jt["scales"])
    assert tt.out_features == 4
