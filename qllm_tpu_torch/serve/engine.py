"""Continuous-batching serving engine over the quantized KV cache (the
counterpart of ``qllm_tpu/serve/engine.py``).

  * a fixed pool of B slots shares one [L, B, H, S_max, D] int8 KV cache,
    updated IN PLACE (admission copies a prefill's rows into a slot,
    ``QuantizedKVCache.insert_slot``);
  * admission: a new request is prefilled alone, its prompt right-padded
    to a bucket length, at most ``prefill_chunk`` tokens per engine
    iteration; its first generated token joins the next batched step;
  * every decode step advances ALL slots with per-slot positions; finished
    slots are masked out on the host and immediately reusable;
  * per-request sampling (temperature / top-k / top-p), prefix caching
    (a registered prompt prefix's KV is stamped in and only the suffix is
    prefilled) and n-gram speculation for all-greedy batches.

PyTorch runs eagerly, so the buckets no longer bound a compile count;
they still decide each prefill's M (K9 at M <= 32, K10 above), and so
which kernel branch it takes, as on the TPU. Dense params are served as
they come (per-layer 2-D weights through ``ops.qmm2d``), MoE params are
hybrid-stacked with bf16 scales at construction, as the JAX engine does.
``ServeConfig(w4a8=True)`` passes the choice of per-token int8
activations to every dispatch's forward (K12 on per-layer weights, K11
on stacks, where the JAX package's W4A8 takes them); the JAX engine sets
a process-wide environment switch instead, so there two engines in one
process cannot differ, while here each keeps its own numerics.
The engine's random numbers come from a ``torch.Generator`` seeded per
dispatch from (ServeConfig.seed, dispatch count), so a run is
reproducible from its seed; they are not ``jax.random``'s bits.

Positions and token histories live on the host (numpy) and reach the
forward as CPU tensors: the forward bounds-checks them and sizes its
attention there, then copies them to the card once per step.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.generate import make_cache
from ..models.llama import ModelConfig, forward
from ..models.sampling import SamplingParams, sample_logits
from ..models.speculative import _accept_len, ngram_draft
from ..ops.kv_cache import QuantizedKVCache
from ..utils.device import resolve_device

__all__ = ["ServeConfig", "Request", "ContinuousBatchingEngine", "SamplingParams"]


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 2048
    quantized_kv: bool = True
    eos_token_id: Optional[int] = None
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024)
    # >1: this many decode steps per dispatch with eos-aware freezing on
    # the device and one host read per chunk; admission between chunks
    decode_chunk: int = 1
    # admission prefill runs at most this many prompt tokens per engine
    # iteration, interleaved with decode steps
    prefill_chunk: int = 256
    # engine-level seed for sampled requests (per-request sampling
    # params live on Request.sampling)
    seed: int = 0
    # n-gram speculative decoding for all-greedy batches: each dispatch
    # drafts spec_gamma tokens from the slot's own token history and
    # emits 1..spec_gamma+1 verified tokens (the exact greedy stream);
    # sampled batches and near-full caches take normal steps
    speculative: bool = False
    spec_gamma: int = 4
    spec_ngram: int = 2
    # W4A8: per-token int8 activations in the decode-size matmuls (2/4-bit
    # per-layer weights through K12, full-K planar stacks through K11);
    # prefills of more than 32 rows and 8-bit weights keep bf16
    # activations, as in the JAX package. This engine's choice only.
    w4a8: bool = False


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int = 128
    # None = greedy; SamplingParams enables temperature/top-k/top-p for
    # this request only
    sampling: Optional[SamplingParams] = None
    # id from engine.register_prefix: the prompt must start with that
    # prefix; admission stamps the cached prefix KV and prefills only the
    # suffix
    prefix_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # speculative-decoding telemetry: one "forward" = one verify dispatch
    # for this request's slot; emitted counts the tokens that round
    # produced (accepted draft prefix + the bonus token)
    spec_forwards: int = 0
    spec_emitted: int = 0

    @property
    def spec_tokens_per_forward(self) -> Optional[float]:
        """Mean verified tokens per speculative forward (None when the
        request never took a speculative step)."""
        if not self.spec_forwards:
            return None
        return self.spec_emitted / self.spec_forwards


Sampling = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


@torch.no_grad()
def _batched_decode_step(
    params, cfg: ModelConfig, tokens, cache, positions, sampling: Sampling = None, generator=None, w4a8=False
):
    """tokens [B, 1], positions [B] -> (next tokens [B] int32 on the
    device, cache). ``sampling``: (temperature, top_k, top_p) per slot
    (None = all greedy: no sort in the step)."""
    logits, cache = forward(params, cfg, tokens, cache, pos=positions, w4a8=w4a8)
    last = logits[:, -1, :]
    if sampling is None:
        return torch.argmax(last, dim=-1).to(torch.int32), cache
    return sample_logits(last, generator, *sampling), cache


@torch.no_grad()
def _batched_decode_multi(
    params,
    cfg: ModelConfig,
    tokens,
    cache,
    positions,
    active,
    steps: int,
    eos: Optional[int],
    sampling: Sampling = None,
    generator=None,
    w4a8: bool = False,
):
    """``steps`` decode steps with no host read between them: next tokens
    (greedy, or sampled) chained per slot, eos-aware freezing.
    Inactive/finished slots keep decoding into their own positions but
    their outputs are masked (-1).

    Returns (token trace [B, steps], final tokens [B, 1], cache,
    positions, active), all on the device."""
    dev = cache.device
    tokens = tokens.to(dev)
    positions = positions.to(dev).to(torch.int32)
    active = active.to(dev)
    trace = []
    for _ in range(steps):
        logits, cache = forward(params, cfg, tokens, cache, pos=positions, w4a8=w4a8)
        last = logits[:, -1, :]
        if sampling is None:
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
        else:
            nxt = sample_logits(last, generator, *sampling)
        trace.append(torch.where(active, nxt, torch.full_like(nxt, -1)))
        positions = positions + active.to(torch.int32)
        if eos is not None:
            active = active & (nxt != eos)
        tokens = torch.where(active[:, None], nxt[:, None], tokens)
    return torch.stack(trace, dim=1), tokens, cache, positions, active


def _spec_accept(nxt, draft, tokens, positions, active, eos: Optional[int]):
    """Speculative acceptance: the longest agreeing prefix + the bonus
    token, cut at eos. Returns (emit_len, next tokens, positions, active)."""
    B = tokens.shape[0]
    el = _accept_len(draft, nxt) + 1  # [B] in [1, gamma + 1]
    finished_now = torch.zeros((B,), dtype=torch.bool, device=nxt.device)
    if eos is not None:
        iseos = nxt == eos
        eos_idx = torch.argmax(iseos.to(torch.float32), dim=1)  # the first eos
        hit = iseos.any(dim=1) & (eos_idx < el)
        el = torch.where(hit, eos_idx + 1, el)
        finished_now = hit
    el = torch.where(active, el, torch.zeros_like(el))
    last = torch.gather(nxt, 1, torch.clamp(el - 1, min=0)[:, None].to(torch.int64))
    positions = positions + el.to(positions.dtype)
    active2 = active & ~finished_now
    tokens = torch.where(active2, last[:, 0], tokens[:, 0])[:, None]
    return el, tokens, positions, active2


@torch.no_grad()
def _batched_spec_step(
    params,
    cfg: ModelConfig,
    tokens,  # [B, 1] last emitted token per slot (host)
    cache,
    positions,  # [B] cache offset of `tokens` (host)
    active,  # [B] bool (host)
    history,  # [B, S] int32 token history, prompt + emitted (host)
    hist_len,  # [B] int32 (host)
    gamma: int,
    ngram: int,
    eos: Optional[int],
    w4a8: bool = False,
):
    """One speculative round for the whole batch: draft gamma tokens per
    slot from its history (on the host), verify them in ONE forward over
    gamma + 1 positions, emit the agreeing prefix + bonus token (cut at
    eos). The verify argmax is read back once. Returns (emit [B, gamma+1],
    emit_len [B], next tokens, cache, positions, active), on the host
    apart from the cache."""
    draft = ngram_draft(history, hist_len, gamma, ngram)
    seq = torch.cat([tokens.to(torch.int32), draft], dim=1)
    logits, cache = forward(params, cfg, seq.to(cache.device), cache, pos=positions, w4a8=w4a8)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu()  # [B, 1 + gamma]
    el, tokens, positions, active2 = _spec_accept(nxt, draft, tokens, positions, active, eos)
    return nxt, el, tokens, cache, positions, active2


@torch.no_grad()
def _prefill_one(params, cfg: ModelConfig, tokens, cache, length: int, w4a8: bool = False):
    """Right-padded prompt [1, Tb]; only positions < length are real.
    Returns (the last real position's logits [1, V], cache); the first
    token is picked outside (greedy or sampled per request)."""
    logits, cache = forward(params, cfg, tokens, cache, pos=0, w4a8=w4a8)
    return logits[:, length - 1], cache


@torch.no_grad()
def _prefill_chunk(params, cfg: ModelConfig, tokens, cache, offset: int, length: int, w4a8: bool = False):
    """One chunk [1, C] of a long prompt at position ``offset``; returns
    the logits after the LAST REAL position (meaningful on the final
    chunk only) and the cache."""
    logits, cache = forward(params, cfg, tokens, cache, pos=offset, w4a8=w4a8)
    return logits[:, min(max(length - offset - 1, 0), tokens.shape[1] - 1)], cache


def _pick_first(last, generator, t, k, p) -> torch.Tensor:
    """First-token pick from prefill logits [1, V]; t <= 0 -> greedy."""
    return sample_logits(last, generator, t, k, p)


def _params_device(node) -> Optional[torch.device]:
    """The device of the first tensor in a params tree."""
    if isinstance(node, torch.Tensor):
        return node.device
    if dataclasses.is_dataclass(node) and hasattr(node, "qweight"):
        return node.qweight.device
    items = node.values() if isinstance(node, dict) else node if isinstance(node, (list, tuple)) else ()
    for v in items:
        d = _params_device(v)
        if d is not None:
            return d
    return None


class ContinuousBatchingEngine:
    def __init__(
        self,
        params: Dict[str, Any],
        cfg: ModelConfig,
        serve_cfg: ServeConfig,
        device: Union[str, torch.device] = "cuda",
    ):
        from ..models.moe import has_stackable_experts
        from ..models.stacked import stack_layer_params_hybrid

        self.device = resolve_device(device)
        pdev = _params_device(params)
        if pdev is None or pdev.type != self.device.type:
            raise ValueError(f"the params live on {pdev}, not on {self.device}")
        if has_stackable_experts(params):
            # MoE serving: [L]-stacked attention with per-layer [E]-stacked
            # experts, bf16 scales as the JAX engine stacks them (its
            # QLLM_TPU_SCALES_BF16 default), so decode reads only the top-k
            # experts through K8
            params = stack_layer_params_hybrid(
                {**params, "layers": [dict(lp) for lp in params["layers"]]}, scale_store_dtype=torch.bfloat16
            )
        self.params = params
        self.cfg = cfg
        self.scfg = serve_cfg
        B = serve_cfg.max_batch
        self.cache = make_cache(cfg, B, serve_cfg.max_seq, serve_cfg.quantized_kv, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.positions = np.zeros(B, np.int32)  # next write offset per slot
        self.tokens = np.zeros((B, 1), np.int32)  # next token to feed
        # per-slot sampling params (temperature <= 0 = greedy slot)
        self.samp_t = np.zeros(B, np.float32)
        self.samp_k = np.zeros(B, np.int32)
        self.samp_p = np.ones(B, np.float32)
        self._dispatches = 0  # seeds one generator per dispatch
        if serve_cfg.speculative:
            # per-slot token history for n-gram drafting; sized so a final
            # gamma+1 write at hist_len == max_seq still fits
            self.history = np.zeros((B, serve_cfg.max_seq + serve_cfg.spec_gamma + 1), np.int32)
            self.hist_len = np.zeros(B, np.int32)
        self.queue: deque[Request] = deque()
        self._uid = 0
        # prefix cache: id -> (tokens, mini KV cache with [0, Tp) filled)
        self._prefixes: Dict[int, tuple] = {}
        # in-flight chunked admission: (req, slot, mini_cache, done_toks)
        self._admitting: Optional[tuple] = None

    # ----------------------------------------------------------------- API

    def submit(
        self,
        prompt,
        max_new_tokens: int = 128,
        sampling: Optional[SamplingParams] = None,
        prefix_id: Optional[int] = None,
    ) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prefix_id is not None:
            ptoks, _ = self._prefixes[prefix_id]  # KeyError = unknown id
            Tp = len(ptoks)
            if len(prompt) <= Tp or not np.array_equal(prompt[:Tp], ptoks):
                raise ValueError(
                    "prompt must extend the registered prefix by >= 1 "
                    "token (prefix caching reuses its KV verbatim)"
                )
        # a slot's decode steps write rows below len(prompt) + max_new_tokens
        if len(prompt) < 1 or max_new_tokens < 1 or len(prompt) + max_new_tokens > self.scfg.max_seq:
            raise ValueError(
                f"a {len(prompt)}-token prompt and {max_new_tokens} new tokens do not fit "
                f"max_seq {self.scfg.max_seq}"
            )
        self._uid += 1
        req = Request(
            uid=self._uid,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            sampling=sampling,
            prefix_id=prefix_id,
            submitted_at=time.time(),
        )
        self.queue.append(req)
        return req

    def register_prefix(self, tokens) -> int:
        """Prefill a shared prompt prefix (e.g. a system prompt) ONCE and
        cache its KV; later submit(prefix_id=...) admissions stamp it in
        and prefill only the suffix. Returns the prefix id."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        Tp = len(toks)
        if Tp < 1:
            raise ValueError("empty prefix")
        Tb = self._bucket(Tp)
        padded = np.zeros((1, Tb), np.int32)
        padded[0, :Tp] = toks
        mini = self._make_mini_cache(Tb)
        _, mini = _prefill_one(self.params, self.cfg, self._dev(padded), mini, Tp, w4a8=self.scfg.w4a8)
        pid = len(self._prefixes)
        self._prefixes[pid] = (toks, mini)
        return pid

    def run(self, on_token: Optional[Callable] = None) -> List[Request]:
        """Drive until queue and slots drain. Returns finished requests."""
        done: List[Request] = []
        while self.queue or any(r is not None for r in self.slot_req):
            self._admit()
            self._step(on_token)
            done.extend(self._reap())
        return done

    def step(self, on_token: Optional[Callable] = None) -> List[Request]:
        """One admission + one batched decode step (for external loops)."""
        self._admit()
        self._step(on_token)
        return self._reap()

    # ------------------------------------------------------------ internals

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _make_mini_cache(self, Tcap: int) -> QuantizedKVCache:
        return make_cache(self.cfg, 1, Tcap, self.scfg.quantized_kv, device=self.device)

    def _bucket(self, t: int) -> int:
        for b in self.scfg.prefill_buckets:
            if t <= b:
                return b
        return self.scfg.max_seq

    def _next_generator(self) -> torch.Generator:
        """A generator seeded from (seed, dispatch count), the counterpart
        of jax.random.fold_in(key, dispatch)."""
        self._dispatches += 1
        state = np.random.SeedSequence([self.scfg.seed, self._dispatches]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state) & ((1 << 63) - 1))
        return gen

    def _prefill_window(self, req: Request, mini: QuantizedKVCache, done: int, width: int):
        """Prefill prompt tokens [done, done + n) through a window of
        ``width`` right-padded tokens at offset ``done``. A window that
        would run past the admission cache is cut to fit (JAX's
        dynamic_update_slice would instead move it back over earlier rows);
        the engine sizes its caches so that only a max_seq that is not a
        multiple of prefill_chunk can reach that."""
        T = len(req.prompt)
        width = min(width, mini.max_seq - done)
        n = min(width, T - done)
        window = np.zeros((1, width), np.int32)
        window[0, :n] = req.prompt[done : done + n]
        last_logits, mini = _prefill_chunk(self.params, self.cfg, self._dev(window), mini, done, T, w4a8=self.scfg.w4a8)
        return last_logits, mini, done + n

    def _finish_admission(self, req: Request, slot: int, mini: QuantizedKVCache, last_logits) -> None:
        self.cache.insert_slot(slot, mini)
        T = len(req.prompt)
        sp = req.sampling or SamplingParams()
        self.samp_t[slot] = sp.temperature
        self.samp_k[slot] = sp.top_k
        self.samp_p[slot] = sp.top_p
        first_tok = _pick_first(
            last_logits,
            self._next_generator(),
            torch.tensor([sp.temperature], dtype=torch.float32, device=self.device),
            torch.tensor([sp.top_k], dtype=torch.int32, device=self.device),
            torch.tensor([sp.top_p], dtype=torch.float32, device=self.device),
        )
        tok = int(first_tok[0])
        req.first_token_at = time.time()
        req.output.append(tok)
        self.slot_req[slot] = req
        self.positions[slot] = T
        self.tokens[slot, 0] = tok
        if self.scfg.speculative:
            self.history[slot, :T] = req.prompt
            self.history[slot, T] = tok
            self.history[slot, T + 1 :] = 0
            self.hist_len[slot] = T + 1

    def _admit(self) -> None:
        """Admission with CHUNKED prefill: at most ``prefill_chunk`` prompt
        tokens are processed per engine iteration, so a long prompt's
        prefill interleaves with decode steps instead of stalling every
        active stream until it completes."""
        C = max(1, self.scfg.prefill_chunk)
        # continue an in-flight chunked admission (one chunk per call)
        if self._admitting is not None:
            req, slot, mini, done = self._admitting
            last_logits, mini, done = self._prefill_window(req, mini, done, C)
            if done >= len(req.prompt):
                self._finish_admission(req, slot, mini, last_logits)
                self._admitting = None
            else:
                self._admitting = (req, slot, mini, done)
            return  # at most one chunk of prefill work per iteration
        while self.queue and None in self.slot_req:
            slot = self.slot_req.index(None)
            req = self.queue.popleft()
            T = len(req.prompt)
            Tb = self._bucket(T)
            if req.prefix_id is not None:
                # stamp the cached prefix KV, then prefill ONLY the suffix
                ptoks, pmini = self._prefixes[req.prefix_id]
                Tp = len(ptoks)
                rem = T - Tp
                if rem <= C:
                    # one suffix window, bucketed
                    Sb = self._bucket(rem)
                    if Tp + Sb > self.scfg.max_seq:
                        Sb = rem  # exact window (rare near-full case)
                    Tcap = min(max(Tb, Tp + Sb, pmini.max_seq), self.scfg.max_seq)
                    mini = self._make_mini_cache(Tcap).insert_seq(pmini, 0)
                    last_logits, mini, _ = self._prefill_window(req, mini, Tp, Sb)
                    self._finish_admission(req, slot, mini, last_logits)
                    continue
                # long suffix: the chunk windows start at Tp (not C-aligned);
                # size the cache so that the last [Tp+k*C, +C) window fits
                span = Tp + -(-rem // C) * C
                Tcap = min(max(Tb, span), self.scfg.max_seq)
                mini = self._make_mini_cache(Tcap).insert_seq(pmini, 0)
                self.slot_req[slot] = req  # reserve the slot
                self.positions[slot] = 0
                self._admitting = (req, slot, mini, Tp)
                self._admit()  # process the first suffix chunk now
                return
            if T > C:
                # long prompt: chunked admission over the next calls; pad
                # the admission cache to a whole number of chunks
                Tcap = min(max(Tb, -(-T // C) * C), self.scfg.max_seq)
                self.slot_req[slot] = req  # reserve the slot
                self.positions[slot] = 0
                self._admitting = (req, slot, self._make_mini_cache(Tcap), 0)
                self._admit()  # process the first chunk now
                return
            padded = np.zeros((1, Tb), np.int32)
            padded[0, :T] = req.prompt
            mini = self._make_mini_cache(Tb)
            last_logits, mini = _prefill_one(self.params, self.cfg, self._dev(padded), mini, T, w4a8=self.scfg.w4a8)
            self._finish_admission(req, slot, mini, last_logits)

    def _step(self, on_token) -> None:
        adm_slot = None if self._admitting is None else self._admitting[1]
        act = [s for s, r in enumerate(self.slot_req) if r is not None and not r.finished and s != adm_slot]
        if not act:
            return
        if (
            self.scfg.speculative
            and not any(self.samp_t[s] > 0 for s in act)
            and all(self.positions[s] + self.scfg.spec_gamma + 1 <= self.scfg.max_seq for s in act)
        ):
            self._step_spec(act, on_token)
            return
        chunk = max(1, self.scfg.decode_chunk)
        steps = 1
        if chunk > 1:
            rem = min(self.slot_req[s].max_new_tokens - len(self.slot_req[s].output) for s in act)
            room = min(self.scfg.max_seq - 1 - int(self.positions[s]) for s in act)
            steps = max(1, min(chunk, rem, room))
        if steps > 1:
            self._step_multi(act, steps, on_token)
            return
        next_tokens, self.cache = _batched_decode_step(
            self.params,
            self.cfg,
            self._dev(self.tokens),
            self.cache,
            torch.from_numpy(self.positions.copy()),
            *self._sampling_args(act),
            w4a8=self.scfg.w4a8,
        )
        next_np = next_tokens.cpu().numpy()
        for slot in act:
            req = self.slot_req[slot]
            self.positions[slot] += 1
            if self._req_done(req):
                continue
            tok = int(next_np[slot])
            req.output.append(tok)
            self.tokens[slot, 0] = tok
            if on_token is not None:
                on_token(req, tok)

    def _sampling_args(self, act) -> tuple:
        """(sampling, generator) for the steps: (None, None) when every
        active slot is greedy, which keeps the [B, V] sort out of the step."""
        if not any(self.samp_t[s] > 0 for s in act):
            return (None, None)
        return (
            (self._dev(self.samp_t), self._dev(self.samp_k), self._dev(self.samp_p)),
            self._next_generator(),
        )

    def _step_spec(self, act, on_token) -> None:
        """One speculative round: up to spec_gamma+1 verified greedy tokens
        per active slot from a single forward."""
        B = self.scfg.max_batch
        active = np.zeros(B, bool)
        active[act] = True
        emit, el, toks, self.cache, pos, _ = _batched_spec_step(
            self.params,
            self.cfg,
            torch.from_numpy(self.tokens.copy()),
            self.cache,
            torch.from_numpy(self.positions.copy()),
            torch.from_numpy(active),
            torch.from_numpy(self.history),
            torch.from_numpy(self.hist_len),
            self.scfg.spec_gamma,
            self.scfg.spec_ngram,
            self.scfg.eos_token_id,
            w4a8=self.scfg.w4a8,
        )
        emit_np, el_np, toks_np, pos_np = emit.numpy(), el.numpy(), toks.numpy(), pos.numpy()
        for s in act:
            req = self.slot_req[s]
            n = int(el_np[s])
            req.spec_forwards += 1
            req.spec_emitted += n
            hl = int(self.hist_len[s])
            self.history[s, hl : hl + n] = emit_np[s, :n]
            self.hist_len[s] = hl + n
            for t in emit_np[s, :n]:
                if self._req_done(req):
                    break
                req.output.append(int(t))
                if on_token is not None:
                    on_token(req, int(t))
            self.positions[s] = int(pos_np[s])
            self.tokens[s, 0] = int(toks_np[s, 0])
            self._req_done(req)

    def _step_multi(self, act, steps: int, on_token) -> None:
        B = self.scfg.max_batch
        active = np.zeros(B, bool)
        active[act] = True
        trace, toks, self.cache, pos, _ = _batched_decode_multi(
            self.params,
            self.cfg,
            self._dev(self.tokens),
            self.cache,
            self._dev(self.positions),
            self._dev(active),
            steps,
            self.scfg.eos_token_id,
            *self._sampling_args(act),
            w4a8=self.scfg.w4a8,
        )
        trace_np = trace.cpu().numpy()  # the one host read of the chunk
        pos_np, toks_np = pos.cpu().numpy(), toks.cpu().numpy()
        for s in act:
            req = self.slot_req[s]
            for t in trace_np[s]:
                if t < 0 or self._req_done(req):
                    break
                req.output.append(int(t))
                if on_token is not None:
                    on_token(req, int(t))
            self.positions[s] = int(pos_np[s])
            self.tokens[s, 0] = int(toks_np[s, 0])
            self._req_done(req)

    def _req_done(self, req: Request) -> bool:
        eos = self.scfg.eos_token_id
        if len(req.output) >= req.max_new_tokens:
            req.finished = True
        elif eos is not None and req.output and req.output[-1] == eos:
            req.finished = True
        return req.finished

    def _reap(self) -> List[Request]:
        out = []
        adm_slot = None if self._admitting is None else self._admitting[1]
        for slot, req in enumerate(self.slot_req):
            if slot == adm_slot:
                continue  # mid-prefill: no KV in the main cache yet
            if req is not None and self._req_done(req):
                req.finished_at = time.time()
                self.slot_req[slot] = None
                self.positions[slot] = 0
                out.append(req)
        return out
