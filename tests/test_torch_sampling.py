"""Port sampling (temperature / top-k / top-p) against the JAX package's
semantics, case for case with tests/test_sampling.py. torch cannot give
jax.random's bits, so sampled rows are held to their support (top-k set,
nucleus) and to reproducibility from a seed; greedy rows are the exact
argmax in both packages, alone and inside mixed batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models.sampling import SamplingParams as JSamplingParams
from qllm_tpu.models.sampling import params_arrays as j_params_arrays
from qllm_tpu.models.sampling import sample_logits as j_sample_logits
from qllm_tpu_torch.models.generate import greedy_generate
from qllm_tpu_torch.models.sampling import SamplingParams, params_arrays, sample_logits
from qllm_tpu_torch.serve import ContinuousBatchingEngine, ServeConfig

from test_torch_serve import _model, _prompts


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _draws(lg, params, n, start=0):
    """n draws per row from the port, one generator seed each -> [n, B]."""
    t, k, p = params_arrays(params)
    x = torch.tensor(np.asarray(lg, np.float32))
    return np.stack([sample_logits(x, _gen(start + s), t, k, p).numpy() for s in range(n)])


def _jax_draws(lg, params, n):
    t, k, p = j_params_arrays([None if q is None else JSamplingParams(q.temperature, q.top_k, q.top_p) for q in params])
    x = jnp.asarray(np.asarray(lg, np.float32))
    return np.stack([np.asarray(j_sample_logits(x, jax.random.key(s), t, k, p)) for s in range(n)])


def test_zero_temperature_and_top_k_1_are_greedy():
    lg = [[0.1, 2.0, -1.0, 0.5], [3.0, 0.0, 0.0, 0.0]]
    for params in ([SamplingParams(0.0), None], [SamplingParams(temperature=1.0, top_k=1)] * 2):
        out = _draws(lg, params, 8)
        assert (out == [1, 0]).all()
        assert (_jax_draws(lg, params, 4) == [1, 0]).all()


def test_top_k_restricts_support_like_jax():
    rng = np.random.default_rng(0)
    lg = [rng.normal(size=32)]
    top3 = set(np.argsort(lg[0])[-3:].tolist())
    params = [SamplingParams(temperature=2.0, top_k=3)]
    seen = set(_draws(lg, params, 64)[:, 0].tolist())
    assert seen <= top3 and len(seen) >= 2
    assert set(_jax_draws(lg, params, 64)[:, 0].tolist()) <= top3


def test_top_p_nucleus_restricts_support_like_jax():
    # softmax of [5, 4, 0*6]: p0 ~ 0.710, p1 ~ 0.261 -> nucleus(0.7) = {0},
    # nucleus(0.9) = {0, 1}
    lg = [[5.0, 4.0] + [0.0] * 6]
    assert set(_draws(lg, [SamplingParams(temperature=1.0, top_p=0.7)], 16)[:, 0]) == {0}
    params = [SamplingParams(temperature=1.0, top_p=0.9)]
    assert set(_draws(lg, params, 64)[:, 0]) == {0, 1} == set(_jax_draws(lg, params, 64)[:, 0])


def test_sampled_frequencies_follow_the_distribution():
    """The Gumbel-max draws follow softmax(logits / T) within the top-k
    support: frequencies within 4 sigma of the probabilities."""
    lg = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32))
    n = 2000
    t, k, p = params_arrays([SamplingParams(temperature=1.0, top_k=3)])
    out = sample_logits(torch.tensor(lg).expand(n, 4).contiguous(), _gen(3), t.expand(n), k.expand(n), p.expand(n))
    freq = np.bincount(out.numpy(), minlength=4) / n
    want = np.array([0.5, 0.3, 0.15, 0.0]) / 0.95
    assert freq[3] == 0.0
    assert np.all(np.abs(freq - want) <= 4 * np.sqrt(want * (1 - want) / n) + 1e-9)


def test_mixed_rows_keep_greedy_rows_exact():
    rng = np.random.default_rng(1)
    lg = rng.normal(size=(3, 16))
    params = [None, SamplingParams(5.0), SamplingParams(temperature=1.0, top_k=1)]
    greedy = np.argmax(lg, axis=-1)
    out = _draws(lg, params, 32)
    assert (out[:, 0] == greedy[0]).all() and (out[:, 2] == greedy[2]).all()
    assert len(set(out[:, 1].tolist())) > 1  # the hot row really samples


def test_same_generator_seed_is_deterministic():
    rng = np.random.default_rng(2)
    lg = rng.normal(size=(2, 64))
    params = [SamplingParams(1.0)] * 2
    np.testing.assert_array_equal(_draws(lg, params, 1, start=7), _draws(lg, params, 1, start=7))
    assert not np.array_equal(_draws(lg, params, 8, start=7), _draws(lg, params, 8, start=8))


def test_engine_mixed_sampling_keeps_greedy_rows_exact():
    _, _, tcfg, tp = _model()
    p_greedy, p_hot = _prompts(3, (5, 7))
    eng = ContinuousBatchingEngine(tp, tcfg, ServeConfig(max_batch=2, max_seq=64, prefill_buckets=(16,)), device="cpu")
    rg = eng.submit(p_greedy, max_new_tokens=6)
    rh = eng.submit(p_hot, max_new_tokens=6, sampling=SamplingParams(temperature=2.0))
    eng.run()
    ref = greedy_generate(tp, tcfg, torch.from_numpy(p_greedy[None]), 6, max_seq=64, device="cpu")
    assert rg.output == ref[0, len(p_greedy) :].tolist()
    assert len(rh.output) == 6


def test_engine_top_k1_sampled_equals_greedy():
    _, _, tcfg, tp = _model()
    p = _prompts(4, (6,))[0]
    eng = ContinuousBatchingEngine(tp, tcfg, ServeConfig(max_batch=1, max_seq=64, prefill_buckets=(16,)), device="cpu")
    r = eng.submit(p, max_new_tokens=5, sampling=SamplingParams(temperature=1.0, top_k=1))
    eng.run()
    ref = greedy_generate(tp, tcfg, torch.from_numpy(p[None]), 5, max_seq=64, device="cpu")
    assert r.output == ref[0, len(p) :].tolist()


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_engine_sampled_reproducible_by_seed(decode_chunk):
    """A sampled request's stream is a function of ServeConfig.seed: the
    same seed repeats it, another seed changes it (hot temperature)."""
    _, _, tcfg, tp = _model()
    p = _prompts(5, (6,))[0]

    def run(seed):
        eng = ContinuousBatchingEngine(
            tp,
            tcfg,
            ServeConfig(max_batch=2, max_seq=64, prefill_buckets=(16,), decode_chunk=decode_chunk, seed=seed),
            device="cpu",
        )
        r = eng.submit(p, max_new_tokens=8, sampling=SamplingParams(temperature=8.0))
        eng.run()
        return r.output

    assert run(11) == run(11)
    assert run(11) != run(12)
