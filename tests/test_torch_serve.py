"""Port parity for the continuous-batching engine: the port's engine and
the JAX package's engine serve the same requests on the same tiny
per-layer W4 model (the JAX params carried across leaf by leaf, the
lm_head columns of 8 tokens scaled up so that no greedy decision is
close), and their greedy token streams must be equal, case for case with
tests/test_serve.py: mixed prompts, slot reuse, eos, decode_chunk > 1,
chunked prefill, prefix caching and speculation; a tiny Mixtral takes
the MoE branch. The caches' insert_slot / insert_seq are bit-equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qllm_tpu.models import llama as jllama
from qllm_tpu.models.generate import greedy_generate as j_greedy_generate
from qllm_tpu.models.generate import make_cache as j_make_cache
from qllm_tpu.serve import ContinuousBatchingEngine as JEngine
from qllm_tpu.serve import ServeConfig as JServeConfig
from qllm_tpu.utils.testing import random_quantized_params as j_random_params
from qllm_tpu_torch.interop import cache_from_numpy, params_from_numpy
from qllm_tpu_torch.models import llama as tllama
from qllm_tpu_torch.models.generate import greedy_generate as t_greedy_generate
from qllm_tpu_torch.models.generate import make_cache as t_make_cache
from qllm_tpu_torch.serve import ContinuousBatchingEngine as TEngine
from qllm_tpu_torch.serve import SamplingParams, ServeConfig

# a max_position_embeddings no other test uses: the JAX steps are jitted
# with cfg static
CFG_KW = dict(
    vocab_size=512,
    hidden_size=128,
    intermediate_size=256,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    max_position_embeddings=643,
)
SEED = 21


def separated_lm_head(npp, vocab, seed):
    """Scale the lm_head columns of 8 tokens up 8x (as tests/test_torch_slice.py
    does): greedy picks among them with wide margins, so both packages'
    summation orders give the same ids."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(vocab, 8, replace=False)
    sc = np.array(npp["lm_head"].scales)
    sc[:, cols] = (sc[:, cols].astype(np.float32) * 8.0).astype(sc.dtype)
    npp["lm_head"] = dataclasses.replace(npp["lm_head"], scales=sc)
    return npp


@functools.lru_cache(maxsize=None)
def _model(seed=SEED):
    """(jcfg, jax params, port cfg, port params) of a per-layer W4 g64 model."""
    jcfg = jllama.ModelConfig(**CFG_KW)
    npp = jax.tree_util.tree_map(
        np.asarray, j_random_params(jcfg, jax.random.key(seed), bits=4, group_size=64, quantize_lm_head=True)
    )
    npp = separated_lm_head(npp, CFG_KW["vocab_size"], seed)
    tcfg = tllama.ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, npp), tcfg, params_from_numpy(npp, device="cpu")


def _serve(requests, scfg_kw, prefix=None, model=None):
    """Run both engines on ``requests`` ([(prompt, max_new)] plus, when
    ``prefix`` is given, prompts that extend it) -> (jax outputs, port
    outputs, port requests)."""
    jcfg, jp, tcfg, tp = model or _model()
    outs, treqs = [], None
    for Engine, Cfg, params, cfg, kw in (
        (JEngine, JServeConfig, jp, jcfg, {}),
        (TEngine, ServeConfig, tp, tcfg, {"device": "cpu"}),
    ):
        eng = Engine(params, cfg, Cfg(**scfg_kw), **kw)
        pid = None if prefix is None else eng.register_prefix(prefix)
        reqs = [eng.submit(p, max_new_tokens=n, prefix_id=pid if prefix is not None else None) for p, n in requests]
        done = eng.run()
        assert len(done) == len(requests)
        outs.append([r.output for r in reqs])
        treqs = reqs
    return outs[0], outs[1], treqs


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG_KW["vocab_size"], size=n).astype(np.int32) for n in lengths]


def test_engine_matches_jax_engine_and_greedy_generate():
    prompts = _prompts(0, (5, 9, 3))
    j_out, t_out, _ = _serve([(p, 6) for p in prompts], dict(max_batch=2, max_seq=64, prefill_buckets=(16,)))
    assert t_out == j_out
    _, _, tcfg, tp = _model()
    for p, out in zip(prompts, t_out):
        ref = t_greedy_generate(tp, tcfg, torch.from_numpy(p[None]), 6, max_seq=64, device="cpu")
        assert out == ref[0, len(p) :].tolist()


def test_engine_slot_reuse_more_requests_than_slots():
    j_out, t_out, treqs = _serve(
        [(p, 3) for p in _prompts(1, (4,) * 5)], dict(max_batch=2, max_seq=32, prefill_buckets=(8,))
    )
    assert t_out == j_out
    assert all(len(o) == 3 for o in t_out) and all(r.finished_at is not None for r in treqs)


@pytest.mark.parametrize("decode_chunk,nth", [(1, 0), (8, 1)])
def test_engine_eos_stops_early(decode_chunk, nth):
    """eos = the greedy stream's (nth+1)-th token: the request stops there,
    step by step and inside an on-device chunk."""
    jcfg, jp, tcfg, tp = _model()
    prompt = _prompts(2, (4,))[0]
    ref = np.asarray(j_greedy_generate(jp, jcfg, jnp.asarray(prompt[None]), max_new_tokens=3))[0, len(prompt) :]
    eos = int(ref[nth])
    kw = dict(max_batch=1, max_seq=32, prefill_buckets=(8,), eos_token_id=eos, decode_chunk=decode_chunk)
    j_out, t_out, treqs = _serve([(prompt, 10)], kw)
    assert t_out == j_out
    assert treqs[0].finished and t_out[0] == ref[: ref.tolist().index(eos) + 1].tolist()


def test_engine_chunked_decode_matches_jax():
    j_out, t_out, _ = _serve(
        [(p, 7) for p in _prompts(3, (5, 9, 3))], dict(max_batch=2, max_seq=64, prefill_buckets=(16,), decode_chunk=4)
    )
    assert t_out == j_out


def test_engine_chunked_prefill_matches_one_shot():
    """A 40-token prompt admitted in 16-token chunks (3 chunks) gives the
    one-shot admission's tokens, and the JAX engine's."""
    rng = np.random.default_rng(5)
    long_prompt = rng.integers(0, CFG_KW["vocab_size"], 40).astype(np.int32)
    short_prompt = rng.integers(0, CFG_KW["vocab_size"], 6).astype(np.int32)
    reqs = [(short_prompt, 6), (long_prompt, 6)]
    base = dict(max_batch=2, max_seq=128)
    j_chunked, t_chunked, _ = _serve(reqs, dict(base, prefill_chunk=16))
    assert t_chunked == j_chunked
    eng = TEngine(_model()[3], _model()[2], ServeConfig(**base, prefill_chunk=1024), device="cpu")
    one_shot = [eng.submit(p, n) for p, n in reqs]
    eng.run()
    assert [r.output for r in one_shot] == t_chunked


def test_engine_chunked_prefill_does_not_stall_active():
    """While a long prompt admits chunk by chunk, the active slot keeps
    producing tokens between chunks."""
    _, _, tcfg, tp = _model()
    rng = np.random.default_rng(6)
    eng = TEngine(tp, tcfg, ServeConfig(max_batch=2, max_seq=128, prefill_chunk=8), device="cpu")
    a = eng.submit(rng.integers(0, CFG_KW["vocab_size"], 4).astype(np.int32), 32)
    eng.step()
    assert len(a.output) >= 1
    b = eng.submit(rng.integers(0, CFG_KW["vocab_size"], 40).astype(np.int32), 4)
    during = 0
    for _ in range(5):  # 40 tokens at chunk 8: 5 admission iterations
        before = len(a.output)
        eng.step()
        during += len(a.output) - before
    assert during >= 4, "active stream stalled during chunked admission"
    eng.run()
    assert len(b.output) == 4


@pytest.mark.parametrize(
    "lengths,scfg_kw",
    [
        ((3, 5, 2), dict(max_batch=2, max_seq=64, prefill_buckets=(16, 32))),
        ((11,), dict(max_batch=1, max_seq=64, prefill_buckets=(16, 32), prefill_chunk=4)),  # long suffix
    ],
)
def test_prefix_caching_matches_jax_and_plain_admission(lengths, scfg_kw):
    rng = np.random.default_rng(12 + len(lengths))
    prefix = rng.integers(1, CFG_KW["vocab_size"], size=7 if len(lengths) > 1 else 5).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, CFG_KW["vocab_size"], size=t).astype(np.int32)]) for t in lengths]
    j_out, t_out, _ = _serve([(p, 6) for p in prompts], scfg_kw, prefix=prefix)
    assert t_out == j_out
    _, _, tcfg, tp = _model()
    eng = TEngine(tp, tcfg, ServeConfig(**scfg_kw), device="cpu")
    plain = [eng.submit(p, 6) for p in prompts]
    eng.run()
    assert [r.output for r in plain] == t_out


def test_prefix_caching_rejects_mismatched_prompt():
    _, _, tcfg, tp = _model()
    eng = TEngine(tp, tcfg, ServeConfig(max_batch=1, max_seq=64), device="cpu")
    pid = eng.register_prefix(np.asarray([3, 4, 5], np.int32))
    with pytest.raises(ValueError, match="extend the registered prefix"):
        eng.submit(np.asarray([3, 9, 5, 6], np.int32), 4, prefix_id=pid)
    with pytest.raises(ValueError, match="extend the registered prefix"):
        eng.submit(np.asarray([3, 4, 5], np.int32), 4, prefix_id=pid)
    with pytest.raises(ValueError, match="do not fit"):
        eng.submit(np.arange(1, 61, dtype=np.int32), 8)


def test_engine_speculative_matches_jax_and_plain():
    prompts = _prompts(7, (5, 9, 3))
    kw = dict(max_batch=2, max_seq=64, prefill_buckets=(16,))
    j_spec, t_spec, treqs = _serve([(p, 10) for p in prompts], dict(kw, speculative=True, spec_gamma=3))
    assert t_spec == j_spec
    for r in treqs:
        assert r.spec_forwards > 0 and r.spec_tokens_per_forward >= 1.0
    _, _, tcfg, tp = _model()
    eng = TEngine(tp, tcfg, ServeConfig(**kw), device="cpu")
    plain = [eng.submit(p, 10) for p in prompts]
    eng.run()
    assert [r.output for r in plain] == t_spec


def test_engine_speculative_eos_and_sampled_fallback():
    """Speculation stops at eos like the plain stream; a sampled request
    in the batch turns speculation off for those steps while the greedy
    row stays exact."""
    jcfg, jp, tcfg, tp = _model()
    p = _prompts(8, (6,))[0]
    ref = np.asarray(j_greedy_generate(jp, jcfg, jnp.asarray(p[None]), 12, max_seq=64))[0, len(p) :]
    eos = int(ref[2])
    kw = dict(max_batch=1, max_seq=64, prefill_buckets=(16,), eos_token_id=eos, speculative=True)
    j_out, t_out, _ = _serve([(p, 12)], kw)
    assert t_out == j_out and t_out[0] == ref[: t_out[0].index(eos) + 1].tolist()

    pg, ph = _prompts(9, (5, 4))
    eng = TEngine(tp, tcfg, ServeConfig(max_batch=2, max_seq=64, prefill_buckets=(16,), speculative=True), device="cpu")
    rg = eng.submit(pg, 6)
    rh = eng.submit(ph, 6, sampling=SamplingParams(temperature=2.0))
    eng.run()
    greedy = t_greedy_generate(tp, tcfg, torch.from_numpy(pg[None]), 6, max_seq=64, device="cpu")
    assert rg.output == greedy[0, len(pg) :].tolist() and len(rh.output) == 6


def test_chunked_admission_window_past_the_admission_cache():
    """max_seq 40 is not a multiple of prefill_chunk 16, so a 36-token
    prompt's last chunk [32, 48) runs past the 40-row admission cache. The
    port cuts that window to [32, 40) and serves the one-shot prefill's
    tokens (JAX's greedy_generate on the same params). JAX's engine moves
    the window back to [24, 40) instead (dynamic_update_slice clamps,
    qllm_tpu/serve/engine.py:480-497) and writes the chunk's K/V over
    prompt rows 24-31: recorded on the layer-0 keys, which hold each
    row's own token alone, against a one-shot prefill's."""
    jcfg, jp, tcfg, tp = _model()
    prompt = _prompts(31, (36,))[0]
    T, S, new = len(prompt), 40, 4
    scfg = dict(max_batch=1, max_seq=S, prefill_chunk=16)
    ref = np.asarray(j_greedy_generate(jp, jcfg, jnp.asarray(prompt[None]), new, max_seq=S))[0, T:].tolist()
    teng = TEngine(tp, tcfg, ServeConfig(**scfg), device="cpu")
    treq = teng.submit(prompt, new)
    teng.run()
    assert treq.output == ref

    jeng = JEngine(jp, jcfg, JServeConfig(**scfg))
    jeng.submit(prompt, new)
    jeng.run()
    _, one_shot = jllama.forward(jp, jcfg, jnp.asarray(prompt[None]), j_make_cache(jcfg, 1, S), pos=0)
    k_ref = np.asarray(one_shot.k[0, 0, :, :T], np.int32)
    k_jax = np.asarray(jeng.cache.k[0, 0, :, :T], np.int32)
    k_port = teng.cache.k[0, 0, :, :T].numpy().astype(np.int32)
    assert np.abs(k_port - k_ref).max() <= 1  # the same rows, up to one int8 step
    assert np.array_equal(k_jax[:, :24], k_ref[:, :24])
    assert np.abs(k_jax[:, 24:32] - k_ref[:, 24:32]).max() > 16  # rows 24-31 hold other tokens


def test_engine_params_must_live_on_its_device():
    _, _, tcfg, tp = _model()
    with pytest.raises((RuntimeError, ValueError)):
        TEngine(tp, tcfg, ServeConfig(max_batch=1, max_seq=32))  # device="cuda"


def test_tiny_mixtral_engine_matches_jax_engine():
    """MoE params are hybrid-stacked by both engines (bf16 scales) and
    served through the stacked path: decode at max_batch 2 takes the
    sparse grouped-expert branch (B * k < E)."""
    kw = dict(
        vocab_size=256,
        hidden_size=256,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        arch="mixtral",
        num_local_experts=8,
        num_experts_per_tok=2,
        max_position_embeddings=647,
    )
    jcfg = jllama.ModelConfig(**kw)
    npp = jax.tree_util.tree_map(
        np.asarray, j_random_params(jcfg, jax.random.key(3), bits=4, group_size=128, quantize_lm_head=True)
    )
    npp = separated_lm_head(npp, kw["vocab_size"], 3)
    model = (
        jcfg,
        jax.tree_util.tree_map(jnp.asarray, npp),
        tllama.ModelConfig(**dataclasses.asdict(jcfg)),
        params_from_numpy(npp, device="cpu"),
    )
    prompts = _prompts(10, (5, 9, 3))
    j_out, t_out, _ = _serve([(p % kw["vocab_size"], 5) for p in prompts],
                             dict(max_batch=2, max_seq=32, prefill_buckets=(16,)), model=model)
    assert t_out == j_out


def test_insert_slot_and_insert_seq_match_jax():
    """Both write in place and give the JAX package's caches bit for bit,
    insert_seq's clamped window (offset past max_seq - S) included."""
    jcfg = jllama.ModelConfig(**CFG_KW)
    rng = np.random.default_rng(4)

    def filled(B, S):
        c = j_make_cache(jcfg, B, S)
        shp = c.k.shape
        return dataclasses.replace(
            c,
            k=jnp.asarray(rng.integers(-127, 128, shp), jnp.int8),
            v=jnp.asarray(rng.integers(-127, 128, shp), jnp.int8),
            k_scale=jnp.asarray(rng.uniform(0.01, 0.02, shp[:4]), jnp.float32),
            v_scale=jnp.asarray(rng.uniform(0.01, 0.02, shp[:4]), jnp.float32),
        )

    def np_cache(c):
        return jax.tree_util.tree_map(np.asarray, c)

    def same(tc, jc):
        for f in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)

    big, mini = filled(3, 24), filled(1, 16)
    tbig = cache_from_numpy(np_cache(big), "cpu")
    k_before = tbig.k
    out = tbig.insert_slot(1, cache_from_numpy(np_cache(mini), "cpu"))
    assert out is tbig and out.k is k_before  # in place
    same(tbig, big.insert_slot(1, mini))

    for offset in (0, 5, 12):  # 12 + 16 > 24: JAX moves the window to 8
        dst, src = filled(2, 24), filled(2, 16)
        tdst = cache_from_numpy(np_cache(dst), "cpu")
        assert tdst.insert_seq(cache_from_numpy(np_cache(src), "cpu"), offset) is tdst
        same(tdst, dst.insert_seq(src, offset))
    with pytest.raises(ValueError):
        t_make_cache(tllama.ModelConfig(**CFG_KW), 1, 8, device="cpu").insert_slot(0, tbig)
