"""Port speculative decoding against the JAX package, case for case with
tests/test_speculative.py: ngram_draft gives JAX's drafts integer for
integer; n-gram and draft-model speculation give exactly the greedy
stream (the port's greedy_generate and JAX's speculative_generate) on
the tiny per-layer W4 model of tests/test_torch_serve.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models.speculative import ngram_draft as j_ngram_draft
from qllm_tpu.models.speculative import speculative_generate as j_speculative_generate
from qllm_tpu_torch.models.generate import greedy_generate, make_cache
from qllm_tpu_torch.models.speculative import (
    draft_speculative_generate,
    ngram_draft,
    speculative_decode_loop,
    speculative_generate,
)

from test_torch_serve import SEED, _model


@pytest.mark.parametrize(
    "hist,hlen,gamma,ngram",
    [
        ([[5, 9, 7, 3, 5, 9, 4, 0]], [6], 3, 2),  # continues the earlier "9"
        ([[1, 2, 3, 8, 9, 1, 2, 3, 0]], [8], 2, 3),  # trigram key (2, 3)
        ([[1, 2, 3, 4, 0, 0]], [4], 3, 2),  # no match: repeat the last token
    ],
)
def test_ngram_draft_examples_match_jax(hist, hlen, gamma, ngram):
    want = np.asarray(j_ngram_draft(jnp.asarray(hist, jnp.int32), jnp.asarray(hlen), gamma=gamma, ngram=ngram))
    got = ngram_draft(torch.tensor(hist, dtype=torch.int32), torch.tensor(hlen), gamma, ngram)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ngram_draft_random_histories_match_jax():
    """Small alphabets (many matches), every history length, matches near
    the end of the buffer (the draft window clipped to H - gamma)."""
    rng = np.random.default_rng(0)
    for ngram in (2, 3, 4):
        for gamma in (1, 4):
            hist = rng.integers(0, 4, size=(16, 24)).astype(np.int32)
            hlen = rng.integers(1, 25, size=16).astype(np.int32)
            want = np.asarray(j_ngram_draft(jnp.asarray(hist), jnp.asarray(hlen), gamma=gamma, ngram=ngram))
            got = ngram_draft(torch.from_numpy(hist), torch.from_numpy(hlen), gamma, ngram)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"ngram {ngram} gamma {gamma}")


@pytest.mark.parametrize("gamma,ngram", [(4, 2), (2, 3)])
def test_speculative_equals_greedy_and_jax(gamma, ngram):
    jcfg, jp, tcfg, tp = _model()
    rng = np.random.default_rng(0)
    for _ in range(2):
        prompt = rng.integers(1, 512, (1, int(rng.integers(4, 10)))).astype(np.int32)
        n = 12
        ref = greedy_generate(tp, tcfg, torch.from_numpy(prompt), n, max_seq=64, device="cpu")
        out, rounds = speculative_generate(tp, tcfg, torch.from_numpy(prompt), n, max_seq=64, gamma=gamma,
                                           ngram=ngram, device="cpu")
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        j_out, j_rounds = j_speculative_generate(jp, jcfg, jnp.asarray(prompt), n, max_seq=64, gamma=gamma,
                                                 ngram=ngram)
        np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
        assert 1 <= rounds <= n and rounds == j_rounds


def test_speculative_batched_rows_independent():
    """Rows finish in different rounds; each still equals its own greedy
    stream (a finished row rides along without writing past its cache)."""
    _, _, tcfg, tp = _model()
    prompts = torch.from_numpy(np.random.default_rng(1).integers(1, 512, (3, 6)).astype(np.int32))
    n = 10
    out, _ = speculative_generate(tp, tcfg, prompts, n, max_seq=64, device="cpu")
    for b in range(3):
        ref = greedy_generate(tp, tcfg, prompts[b : b + 1], n, max_seq=64, device="cpu")
        torch.testing.assert_close(out[b], ref[0], rtol=0, atol=0)


def test_speculative_accepts_on_repetitive_prompt():
    _, _, tcfg, tp = _model()
    prompt = torch.tensor([[7, 8, 7, 8, 7, 8, 7, 8]], dtype=torch.int32)
    n = 16
    ref = greedy_generate(tp, tcfg, prompt, n, max_seq=64, device="cpu")
    out, rounds = speculative_generate(tp, tcfg, prompt, n, max_seq=64, gamma=4, device="cpu")
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert rounds <= n


def test_speculative_rejects_ring_cache():
    _, _, tcfg, tp = _model()
    cache = make_cache(tcfg, 1, 32, ring=True, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        speculative_decode_loop(
            tp, tcfg, torch.ones((1, 1), dtype=torch.int32), cache, torch.tensor([4]), 8,
            torch.zeros((1, 32), dtype=torch.int32), torch.tensor([5]),
        )


def test_draft_model_speculative_equals_greedy():
    """The target itself as draft (every draft accepted up to the gamma - 1
    cap) and another model as draft (few accepted), batched rows included."""
    _, _, tcfg, tp = _model()
    _, _, _, other = _model(seed=SEED + 1)
    rng = np.random.default_rng(10)
    for draft in (tp, other):
        prompt = torch.from_numpy(rng.integers(1, 512, (2, 6)).astype(np.int32))
        n = 12
        out, rounds = draft_speculative_generate(tp, tcfg, draft, tcfg, prompt, n, max_seq=64, gamma=3, device="cpu")
        for b in range(2):
            ref = greedy_generate(tp, tcfg, prompt[b : b + 1], n, max_seq=64, device="cpu")
            torch.testing.assert_close(out[b], ref[0], rtol=0, atol=0)
        assert 1 <= rounds <= n
        if draft is tp:  # 2 accepted + 1 bonus per round
            assert rounds <= 6
