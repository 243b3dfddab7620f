"""Speculative decoding with n-gram (prompt-lookup) drafts or a draft
model: exact greedy (the counterpart of ``qllm_tpu/models/speculative.py``).

Each round drafts ``gamma`` tokens, verifies them with ONE forward over
[last_token, draft...] (gamma + 1 positions), and accepts the longest
prefix that agrees with the model's own argmax plus the model's "bonus"
token at the first disagreement, so the output is exactly the greedy
stream. Rejected drafts leave stale KV rows at [pos+a+1, pos+gamma]; the
next round's write starts at pos+a+1 and spans gamma + 1 rows, and the
forward writes the cache before it attends, so a stale row is never
visible.

The JAX package runs each round inside a ``lax.while_loop``; here the
rounds are a Python loop whose condition reads the per-row progress back
to the host once per round. A row that has emitted its ``steps`` tokens
keeps riding along (the batch shape is fixed) with its cache offset held
where it finished, so its writes stay inside the cache; JAX clamps them
there instead. Neither touches the tokens a row returns. Ring caches are
refused, as in JAX (the ring append assumes one token per step).
``w4a8`` reaches every forward of a loop, the draft model's included
(in the JAX package one process-wide switch covers both); a verify over
gamma + 1 rows at batch B keeps bf16 activations once B (gamma + 1) > 32.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .llama import ModelConfig, _pos_vector, forward

__all__ = [
    "ngram_draft",
    "speculative_decode_loop",
    "speculative_generate",
    "draft_speculative_decode_loop",
    "draft_speculative_generate",
]

Device = Union[str, torch.device]


def ngram_draft(
    history: torch.Tensor,  # [B, H] int tokens (prompt + generated)
    hist_len: torch.Tensor,  # [B] int valid length (>= 1)
    gamma: int,
    ngram: int = 2,
) -> torch.Tensor:
    """[B, gamma] int32 drafts: continue the most recent earlier
    occurrence of the trailing (ngram-1)-gram; repeat the last token when
    there is none. A pure function of the visible history, on its device
    (a length past H reads the last column, as JAX's gather clamps)."""
    B, H = history.shape
    dev = history.device
    hist = history.to(torch.int64)
    hl = hist_len.to(device=dev, dtype=torch.int64)
    idx = torch.arange(H, device=dev)[None, :]
    # ok[b, j]: history[b, j-t] == history[b, hlen-1-t] for t < ngram-1
    ok = torch.ones((B, H), dtype=torch.bool, device=dev)
    for t in range(ngram - 1):
        key_t = torch.gather(hist, 1, torch.clamp(hl - 1 - t, 0, H - 1)[:, None])
        shifted = torch.gather(hist, 1, torch.clamp(idx - t, min=0).expand(B, H))
        ok &= (shifted == key_t) & (idx >= t)
    # j must end strictly before the trailing key itself
    valid = ok & (idx < (hl - 1)[:, None])
    j = torch.where(valid, idx, torch.full_like(idx, -1).expand(B, H)).amax(dim=1)
    start = torch.clamp(j + 1, 0, H - gamma)
    draft = torch.gather(hist, 1, start[:, None] + torch.arange(gamma, device=dev)[None, :])
    last = torch.gather(hist, 1, torch.clamp(hl - 1, 0, H - 1)[:, None])
    return torch.where((j >= 0)[:, None], draft, last).to(torch.int32)


def _write_rows(buf: torch.Tensor, rows: torch.Tensor, at: torch.Tensor) -> None:
    """buf[b, at[b] : at[b] + w] = rows[b] in place, each window moved back
    to fit (JAX's dynamic_update_slice clamps it the same way)."""
    w = rows.shape[1]
    start = torch.clamp(at.to(torch.int64), 0, buf.shape[1] - w)
    buf.scatter_(1, start[:, None] + torch.arange(w, device=buf.device)[None, :], rows.to(buf.dtype))


def _no_ring(*caches) -> None:
    for c in caches:
        if getattr(c, "ring_k", None) is not None:
            raise ValueError("speculative decode does not support ring caches")


def _accept_len(draft: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """The number of leading drafts that agree with the model's argmax."""
    match = (draft == nxt[:, :-1]).to(torch.int32)
    return torch.cumprod(match, dim=1).sum(dim=1)


@torch.no_grad()
def speculative_decode_loop(
    params,
    cfg: ModelConfig,
    token: torch.Tensor,  # [B, 1] int32: the last emitted token (in history)
    cache,
    pos0,  # [B] or scalar: token's cache position
    steps: int,
    history: torch.Tensor,  # [B, H] with the prompt + token already placed
    hist_len: torch.Tensor,  # [B] int32
    gamma: int = 4,
    ngram: int = 2,
    w4a8: bool = False,
) -> Tuple[torch.Tensor, object, int]:
    """Greedy-decode >= ``steps`` tokens with n-gram speculation. Returns
    (tokens [B, steps], exactly the greedy stream; cache; rounds, the
    number of verify forwards)."""
    _no_ring(cache)
    B, H = history.shape
    if H < steps + gamma + 1:
        raise ValueError(
            f"history buffer too small: need >= hist_len + steps + gamma "
            f"({H} < {steps + gamma + 1} beyond the prompt)"
        )
    dev = cache.device
    token = token.to(dev).to(torch.int32)
    pos = _pos_vector(pos0, B, dev)
    history = history.to(dev).clone()
    hist_len = hist_len.to(device=dev, dtype=torch.int32).clone()
    outbuf = torch.zeros((B, steps + gamma + 1), dtype=torch.int32, device=dev)
    cursor = torch.zeros((B,), dtype=torch.int32, device=dev)
    rounds = 0
    while int(cursor.min()) < steps:
        draft = ngram_draft(history, hist_len, gamma, ngram)
        logits, cache = forward(params, cfg, torch.cat([token, draft], dim=1), cache, pos=pos, w4a8=w4a8)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, 1 + gamma]
        acc = _accept_len(draft, nxt)
        emit = (acc + 1).to(torch.int32)
        _write_rows(outbuf, nxt, cursor)
        _write_rows(history, nxt, hist_len)
        token = torch.gather(nxt, 1, acc[:, None].to(torch.int64))
        pos = torch.where(cursor + emit < steps, pos + emit, pos)
        hist_len = hist_len + emit
        cursor = cursor + emit
        rounds += 1
    return outbuf[:, :steps], cache, rounds


def speculative_generate(
    params,
    cfg: ModelConfig,
    prompt: torch.Tensor,  # [B, T]
    max_new_tokens: int,
    max_seq: Optional[int] = None,
    quantized_kv: bool = True,
    gamma: int = 4,
    ngram: int = 2,
    device: Device = "cuda",
    w4a8: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Prefill + speculative greedy decode. Returns ([B, T +
    max_new_tokens] ids, identical to greedy_generate's, and the number
    of forwards that produced tokens)."""
    from .generate import make_cache, prefill

    B, T = prompt.shape
    # gamma + 1 writes per round may run past the last emitted position
    max_seq = max_seq or (T + max_new_tokens)
    cache = make_cache(cfg, B, max_seq + gamma + 1, quantized_kv, device=device)
    prompt = prompt.to(cache.device).to(torch.int32)
    logits, cache = prefill(params, cfg, prompt, cache, device=device, w4a8=w4a8)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    history = torch.zeros((B, T + max_new_tokens + gamma + 1), dtype=torch.int32, device=cache.device)
    history[:, :T] = prompt
    history[:, T : T + 1] = first
    hist_len = torch.full((B,), T + 1, dtype=torch.int32, device=cache.device)
    toks, _, rounds = speculative_decode_loop(
        params, cfg, first, cache, T, max_new_tokens - 1, history, hist_len, gamma=gamma, ngram=ngram, w4a8=w4a8
    )
    return torch.cat([prompt, first, toks], dim=1), rounds + 1  # + the prefill's first token


@torch.no_grad()
def draft_speculative_decode_loop(
    params,
    cfg: ModelConfig,
    draft_params,
    draft_cfg: ModelConfig,
    token: torch.Tensor,  # [B, 1] int32: the last emitted token
    cache,
    draft_cache,
    pos0,  # [B] or scalar
    steps: int,
    gamma: int = 4,
    w4a8: bool = False,
) -> Tuple[torch.Tensor, object, object, int]:
    """Greedy decode with a DRAFT MODEL proposing gamma tokens per round:
    gamma draft-model steps, ONE target forward over gamma + 1 positions,
    exact greedy acceptance, at most gamma - 1 drafts accepted (the draft
    chain wrote its own KV only for the gamma tokens it was fed, so a full
    accept would leave a hole at pos + gamma in the draft cache). Returns
    (tokens [B, steps], exactly the target's greedy stream; cache;
    draft_cache; rounds)."""
    _no_ring(cache, draft_cache)
    B = token.shape[0]
    dev = cache.device
    token = token.to(dev).to(torch.int32)
    pos = _pos_vector(pos0, B, dev)
    outbuf = torch.zeros((B, steps + gamma + 1), dtype=torch.int32, device=dev)
    cursor = torch.zeros((B,), dtype=torch.int32, device=dev)
    rounds = 0
    while int(cursor.min()) < steps:
        tok, drafts = token, []
        for i in range(gamma):
            dlogits, draft_cache = forward(draft_params, draft_cfg, tok, draft_cache, pos=pos + i, w4a8=w4a8)
            tok = torch.argmax(dlogits[:, -1], dim=-1).to(torch.int32)[:, None]
            drafts.append(tok)
        draft = torch.cat(drafts, dim=1)
        logits, cache = forward(params, cfg, torch.cat([token, draft], dim=1), cache, pos=pos, w4a8=w4a8)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        acc = torch.clamp(_accept_len(draft, nxt), max=gamma - 1)
        emit = (acc + 1).to(torch.int32)
        _write_rows(outbuf, nxt, cursor)
        token = torch.gather(nxt, 1, acc[:, None].to(torch.int64))
        pos = torch.where(cursor + emit < steps, pos + emit, pos)
        cursor = cursor + emit
        rounds += 1
    return outbuf[:, :steps], cache, draft_cache, rounds


def draft_speculative_generate(
    params,
    cfg: ModelConfig,
    draft_params,
    draft_cfg: ModelConfig,
    prompt: torch.Tensor,  # [B, T]
    max_new_tokens: int,
    max_seq: Optional[int] = None,
    quantized_kv: bool = True,
    gamma: int = 4,
    device: Device = "cuda",
    w4a8: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Prefill both models + draft-model speculative greedy decode.
    Returns ([B, T + max_new_tokens] ids, identical to the target's
    greedy_generate, and the number of target forwards)."""
    from .generate import make_cache, prefill

    B, T = prompt.shape
    max_seq = max_seq or (T + max_new_tokens)
    cache = make_cache(cfg, B, max_seq + gamma + 1, quantized_kv, device=device)
    dcache = make_cache(draft_cfg, B, max_seq + gamma + 1, quantized_kv, device=device)
    prompt = prompt.to(cache.device).to(torch.int32)
    logits, cache = prefill(params, cfg, prompt, cache, device=device, w4a8=w4a8)
    _, dcache = prefill(draft_params, draft_cfg, prompt, dcache, device=device, w4a8=w4a8)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    toks, _, _, rounds = draft_speculative_decode_loop(
        params, cfg, draft_params, draft_cfg, first, cache, dcache, T, max_new_tokens - 1, gamma=gamma, w4a8=w4a8
    )
    return torch.cat([prompt, first, toks], dim=1), rounds + 1
