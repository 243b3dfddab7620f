"""Port parity for K5 at head widths 384 and 512, which both packages'
model gates send to flash prefill (every multiple of 128): the port's
``prefill_attention_flash`` (K5's plain version on the CPU) against the
JAX package's (interpret mode), int8 cache-native and bf16 K/V, n_rep 1
and 2, one softcap case and one window case, within FLASH_TOL = 2e-2
(tests/test_torch_attention_split.py). The softcap case draws scores of
RMS 0.5-1.5 x the cap (K_RMS), and the port without the cap must miss ten
times the limit; without the window it must miss the limit."""

import jax.numpy as jnp
import numpy as np
import pytest

from qllm_tpu.ops.pallas_attention import prefill_attention_flash as j_flash
from qllm_tpu_torch.ops import flash_prefill as tfp
from test_torch_attention_split import FLASH_TOL, _flash_inputs, _port_flash


@pytest.mark.parametrize(
    "form,d,n_rep,pos,softcap,window",
    [
        ("int8", 384, 1, [0], 0.0, None),
        ("bf16", 384, 2, [5], 0.0, None),
        ("int8", 512, 2, [17], 0.0, None),
        ("bf16", 512, 1, [0], 0.0, None),
        ("int8", 512, 2, [0], 50.0, None),  # Gemma-2's cap
        ("bf16", 384, 2, [9], 0.0, 20),
    ],
)
def test_wide_heads_match_jax(form, d, n_rep, pos, softcap, window):
    assert d in tfp._KERNEL_D
    B, T, S, Hkv = 1, 40, 60, 1
    rng = np.random.default_rng(d + n_rep + pos[0])
    q, k, v, scales = _flash_inputs(rng, form, B, T, S, Hkv, n_rep, d, softcap)
    pos = np.asarray(pos, np.int32)
    jkw = dict(kv_native=True, kv_scales=tuple(map(jnp.asarray, scales))) if scales is not None else {}
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), n_rep, softcap=softcap,
                             window=None if window is None else jnp.int32(window), **jkw))
    out = _port_flash(q, k, v, pos, n_rep, scales, softcap, window)
    assert out.shape == (B, T, Hkv * n_rep, d)
    np.testing.assert_allclose(out, ref, atol=FLASH_TOL, rtol=FLASH_TOL)
    if softcap:  # the control: leaving the cap out cannot pass
        bare = _port_flash(q, k, v, pos, n_rep, scales, 0.0, window)
        assert not np.allclose(bare, ref, atol=10 * FLASH_TOL, rtol=10 * FLASH_TOL), "the softcap changes nothing"
    if window is not None:
        wide = _port_flash(q, k, v, pos, n_rep, scales, softcap, None)
        assert not np.allclose(wide, ref, atol=FLASH_TOL, rtol=FLASH_TOL), "the window changes nothing"
