"""Decode attention with the logit softcap, ALiBi and a sliding window:
the port's plain versions against the JAX package's kernels, interpreted
on the CPU.

  * the 4-D per-layer cache (K22's plain version, ``_attn_kernel``) on the
    shapes and lengths of tests/test_pallas_attention.py:340-520;
  * the layer-stacked cache (K3b's plain version, ``_attn_kernel_stacked``);
  * past the one-shot limit (``_attn_kernel_stacked_chunked``, forced at a
    small S by ``QLLM_TPU_ATTN_ONESHOT_S`` as in
    tests/test_pallas_attention.py:662-690), where ALiBi raises in both.

Tolerance: atol/rtol 2e-2, the port's K3b bound against the JAX kernel
(tests/test_torch_attention.py); JAX's own tests hold these kernels to
3e-2 against numpy. With a softcap the key scales put the scores in the
cap's range, and the port without the softcap must miss ten times that
limit (the control: a softcap left out cannot pass)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models.llama import alibi_slopes as jax_alibi_slopes
from qllm_tpu.ops.pallas_attention import decode_attention_pallas
from qllm_tpu_torch.models.llama import alibi_slopes
from qllm_tpu_torch.ops import attention as att

TOL = 2e-2
# An int8 draw in [-127, 127] has RMS 127 / sqrt(3); q ~ N(0, 1) is
# pre-scaled by d**-0.5, so the scores' RMS is about K_RMS * ks.
K_RMS = 127 / 3**0.5


def _case(seed, shape, n_rep, lengths, softcap=0.0):
    """q [B, H, d] (f32 holding bf16 values) and an int8 cache of ``shape``
    (4-D or 5-D) with its scales, and the lengths, as numpy arrays. With a
    softcap the key scales give scores of RMS 0.5-1.5 x the cap, where
    cap * tanh(s / cap) bends far from s."""
    rng = np.random.default_rng(seed)
    B, Hkv, d = shape[-4], shape[-3], shape[-1]
    q = np.asarray(jnp.asarray(rng.normal(size=(B, Hkv * n_rep, d)), jnp.bfloat16), np.float32)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    if softcap:
        ks = (rng.uniform(0.5, 1.5, shape[:-1]) * softcap / K_RMS).astype(np.float32)
    else:
        ks = rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32)
    return [q, k, v, ks, vs, np.asarray(lengths, np.int32)]


def _torch(arrays):
    t = [torch.from_numpy(a) for a in arrays]
    t[0] = t[0].to(torch.bfloat16)
    return t


def _both(arrays, layer=None, softcap=0.0, slopes=None, window=None):
    """(JAX's decode_attention_pallas, the port's decode_attention) on the same inputs."""
    jx = decode_attention_pallas(
        jnp.asarray(arrays[0], jnp.bfloat16),
        *[jnp.asarray(a) for a in arrays[1:]],
        layer=None if layer is None else jnp.int32(layer),
        softcap=softcap,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        window=None if window is None else jnp.int32(window),
    )
    port = att.decode_attention(
        *_torch(arrays),
        layer,
        softcap=softcap,
        alibi_slopes=None if slopes is None else torch.from_numpy(np.asarray(slopes)),
        window=None if window is None else torch.tensor([window], dtype=torch.int32),
    )
    assert port.dtype == torch.float32 and tuple(port.shape) == jx.shape
    jx, port = np.asarray(jx), port.numpy()
    if softcap:
        bare = att.decode_attention(
            *_torch(arrays),
            layer,
            alibi_slopes=None if slopes is None else torch.from_numpy(np.asarray(slopes)),
            window=None if window is None else torch.tensor([window], dtype=torch.int32),
        )
        assert not np.allclose(bare.numpy(), jx, atol=10 * TOL, rtol=10 * TOL), "the softcap changes nothing"
    return jx, port


@pytest.mark.parametrize("n", [1, 6, 8, 12, 32])
@pytest.mark.parametrize("style", ["bloom", "mpt"])
def test_alibi_slopes_equal_jax(n, style):
    np.testing.assert_array_equal(alibi_slopes(n, style, device="cpu").numpy(), np.array(jax_alibi_slopes(n, style)))


_OPTIONS_4D = {
    "none": dict(n_rep=2, Hkv=2),
    "softcap": dict(n_rep=2, Hkv=2, softcap=30.0),
    "alibi-bloom-rep1": dict(n_rep=1, Hkv=6, alibi="bloom"),
    "alibi-mpt-rep1": dict(n_rep=1, Hkv=6, alibi="mpt"),
    "alibi-bloom-rep2": dict(n_rep=2, Hkv=3, alibi="bloom"),
    "alibi-mpt-rep2": dict(n_rep=2, Hkv=3, alibi="mpt"),
    "window": dict(n_rep=2, Hkv=2, window=16),
}


@pytest.mark.parametrize("name", list(_OPTIONS_4D))
def test_4d_cache_matches_jax(name):
    """K22's plain version against the 4-D ``_attn_kernel``: B=2, S=128,
    d=128, lengths [100, 37] (ALiBi with 6 heads: bloom and mpt order
    their slopes apart), atol/rtol 2e-2."""
    o = _OPTIONS_4D[name]
    arrays = _case(40 + len(name), (2, o["Hkv"], 128, 128), o["n_rep"], [100, 37], o.get("softcap", 0.0))
    slopes = None
    if "alibi" in o:
        slopes = np.array(jax_alibi_slopes(o["Hkv"] * o["n_rep"], o["alibi"]))
    jx, port = _both(arrays, softcap=o.get("softcap", 0.0), slopes=slopes, window=o.get("window"))
    np.testing.assert_allclose(port, jx, atol=TOL, rtol=TOL)


def test_window_masks_the_rows_before_it():
    """The window changes the result (a control for the 4-D window case),
    and a window past the lengths changes nothing."""
    t = _torch(_case(7, (2, 2, 128, 128), 2, [100, 37]))
    full = att.decode_attention(*t)
    win = att.decode_attention(*t, window=torch.tensor([16], dtype=torch.int32))
    assert np.abs((full - win).numpy()).max() > 10 * TOL
    wide = att.decode_attention(*t, window=torch.tensor([100], dtype=torch.int32))
    np.testing.assert_array_equal(wide.numpy(), full.numpy())


_OPTIONS_5D = {
    "softcap": dict(softcap=50.0),
    "alibi": dict(alibi="bloom"),
    "window": dict(window=40),
    "all": dict(softcap=30.0, alibi="mpt", window=64),
}


@pytest.mark.parametrize("name", list(_OPTIONS_5D))
def test_stacked_cache_options_match_jax(name):
    """K3b's plain version with the options against ``_attn_kernel_stacked``
    (L=2, layer 1, B=2, Hkv=2, n_rep=3, S=256, d=64)."""
    o = _OPTIONS_5D[name]
    arrays = _case(50 + len(name), (2, 2, 2, 256, 64), 3, [200, 77], o.get("softcap", 0.0))
    slopes = np.array(jax_alibi_slopes(6, o["alibi"])) if "alibi" in o else None
    jx, port = _both(arrays, layer=1, softcap=o.get("softcap", 0.0), slopes=slopes, window=o.get("window"))
    np.testing.assert_allclose(port, jx, atol=TOL, rtol=TOL)


@pytest.fixture
def chunked_jax(monkeypatch):
    """JAX's decode past its one-shot limit at S = 640: the key-chunked
    kernel over five 128-row chunks (the limit is read at trace time, so
    the traces are cleared around the switch)."""
    jax.clear_caches()
    monkeypatch.setenv("QLLM_TPU_ATTN_ONESHOT_S", "256")
    yield
    monkeypatch.delenv("QLLM_TPU_ATTN_ONESHOT_S")
    jax.clear_caches()


@pytest.mark.parametrize("softcap,window", [(50.0, None), (0.0, 100), (30.0, 300)], ids=["softcap", "window", "both"])
def test_chunked_options_match_jax(chunked_jax, softcap, window):
    """K3b's plain version against ``_attn_kernel_stacked_chunked`` with
    softcap and window (lengths stop mid-chunk, fill the cache, and leave
    whole chunks outside the window)."""
    arrays = _case(61, (1, 3, 2, 640, 128), 2, [300, 640, 37], softcap)
    jx, port = _both(arrays, layer=0, softcap=softcap, window=window)
    np.testing.assert_allclose(port, jx, atol=TOL, rtol=TOL)


def test_alibi_past_the_one_shot_limit_raises_in_both():
    """ALiBi on a layer-stacked cache longer than 8192 rows: both packages
    refuse it (the key-chunked kernel takes no bias)."""
    S = att.ONESHOT_S + 128
    q = np.zeros((1, 2, 16), np.float32)
    kv = np.zeros((1, 1, 1, S, 16), np.int8)
    sc = np.ones((1, 1, 1, S), np.float32)
    lengths = np.array([S], np.int32)
    slopes = np.array(jax_alibi_slopes(2))
    with pytest.raises(NotImplementedError, match="alibi"):
        decode_attention_pallas(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(sc), jnp.asarray(sc),
            jnp.asarray(lengths), layer=jnp.int32(0), alibi_slopes=jnp.asarray(slopes),
        )
    t = [torch.from_numpy(a) for a in (kv, kv, sc, sc, lengths)]
    with pytest.raises(NotImplementedError, match="alibi"):
        att.decode_attention(torch.from_numpy(q).to(torch.bfloat16), *t, 0, alibi_slopes=torch.from_numpy(slopes))


@pytest.mark.parametrize("window", [16, np.int32(16)], ids=["int", "numpy"])
def test_window_not_a_tensor_raises_a_clear_error(window):
    """The port takes the window as a tensor on q's device (it is read in
    the kernel, never on the host); a Python or numpy integer is refused
    with an error that says so."""
    t = _torch(_case(7, (2, 2, 128, 128), 2, [100, 37]))
    with pytest.raises(ValueError, match="window must be a tensor"):
        att.decode_attention(*t, window=window)


def test_softcap_kernel_uses_exact_tanh():
    """The card's softcap is the exact ``tanhf``, with no ``tanh.approx`` and
    no fast-math build flag. On the H100 the approximation moves decode
    outputs by far less than one bf16 ulp at caps of 30-50, so no output
    comparison can tell the two apart; this pins the source instead."""
    from pathlib import Path

    from qllm_tpu_torch.ops import _build

    src = (Path(att.__file__).parents[1] / "csrc" / "attention.cu").read_text()
    assert "tanhf(__fmul_rn(score, x.inv_cap))" in src and "tanh.approx" not in src
    assert not any("fast" in f and "math" in f for f in _build._FLAGS)
