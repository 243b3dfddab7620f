#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (qllm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each of which fails the run on any error or disagreement:

  1. build: nvcc compiles qllm_tpu_torch/csrc/*.cu for sm_90a into
     build/qllm_tpu_torch/ (qllm_tpu_torch/ops/_build.py);
  2. kernels: each hand-written kernel at the Llama-2-7B shapes of the
     main path against its plain PyTorch version on the same inputs,
     with the kernel's, the plain version's and (where one exists) a
     single PyTorch library call's time (CUDA events, median of 20 runs
     after warm-up, L2 flushed before each run);
  3. main: a Llama-2-7B-shape W4 g128 model (32 layers, random weights
     drawn on the card, quantized lm_head) is stacked for serving,
     prefills 8 prompts of 128 tokens into an int8 KV cache (max_seq
     256) and decodes 64 greedy steps, with every kernel's launch count
     set to 0 before and read after;
  4. main1: the same model at batch 1: a 512-token prompt flash-prefilled
     into a ring-fused cache (max_seq 640), 64 ring-fused greedy steps,
     then a 2048-token prompt flash-prefilled into a 2048-row int8
     cache, counts again set to 0 before and read after;
  5. moe: Mixtral-8x7B (32 layers, 8 experts, top-2, W4 g128, random
     weights drawn on the card), hybrid-stacked: (a) batch 1, a 512-token
     flash prefill into a ring cache (max_seq 640) and 64 ring-fused steps,
     the experts through the grouped kernel K8 with a shared row; (b)
     batch 8, 128-token prompts and 64 steps on the plain cache, where
     B*k >= E sends every expert through K1 (the dense loop);
  6. long: the same Mixtral at batch 8 on a 16384-row cache whose rows
     [0, 12288) are filled on the card, 16 steps from position 12288 (K3b
     past S = 8192, the JAX package's key-chunked path);
  7. moe_qwen3: Qwen3-30B-A3B (48 layers, 128 experts, top-8, q/k RMS
     norm), batch 1 as (a) and batch 8 with 64 sorted selections per
     step through K8;
  8. cross: the 7B widths at 2 layers on the card and on the CPU (plain
     versions), B=2, T=32, 8 steps on the plain cache, then B=1, T=256
     (flash), 16 steps on a ring cache; then 2 layers at Mixtral and at
     Qwen3 width, a short prompt and sparse steps: logits within
     tolerance, the same greedy ids.

Each model path runs with every kernel's launch count set to 0 just
before it and read just after; the peak device memory of each is
printed. One sparse MoE block per sparse path runs under
torch.cuda.set_sync_debug_mode("error"): it never waits on the host.

The line before the last is a JSON object listing every kernel; the last
line is {"ok": true, "device": {...}}. Without CUDA, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor-core
# flop/s (the operands of every kernel here are bf16, int8 or 4-bit)
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

SEVEN_B = dict(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=11008,
    num_attention_heads=32,
    num_key_value_heads=32,
    max_position_embeddings=2048,
)
# (name, K, N) of the stacked projections at 7B
PROJECTIONS = (
    ("qkv", 4096, 12288),
    ("o", 4096, 4096),
    ("gateup", 4096, 22016),
    ("down", 11008, 4096),
    ("lm_head", 4096, 32000),
)
# the main path: batch, prompt length, decode steps, cache length, depth
MAIN = dict(B=8, T=128, STEPS=64, MAX_SEQ=256, LAYERS=32)
# the batch-1 main path: prompt, ring decode steps, ring cache length,
# and the long prompt (bench.py's prefill_512 / prefill_2048 shapes)
MAIN1 = dict(T=512, STEPS=64, MAX_SEQ=640, T_LONG=2048)
# the card-vs-CPU cross-check at full width, plain cache then ring cache
CROSS = dict(B=2, T=32, STEPS=8, MAX_SEQ=64, LAYERS=2)
CROSS1 = dict(T=256, STEPS=16, MAX_SEQ=280)
# the K3a / K3b phase: layers, batch, kv heads, cache length, head width
ATTN_SHAPE = dict(L=2, B=8, Hkv=32, S=256, D=128)
K4_SHAPE = (32, 512, 22016)  # the gateup stack, [L, 4096/8, N]
# K1 / K2 rows per case: (kernel, M, projection or None for all)
QMM_CASES = (
    ("w4_planar_gemv", 8, None),
    ("w4_planar_gemv", 1, None),
    ("w4_planar_gemm", 1024, None),
    ("w4_planar_gemm", 512, "gateup"),
    ("w4_planar_gemm", 2048, "gateup"),
)
# K5 at batch 1, 32 heads: (T, S, K/V form), pos 0
FLASH_CASES = ((512, 640, "int8"), (2048, 2048, "int8"), (2048, 2048, "bf16"))
# K6: a layer-1 step of a 2-layer ring cache at pos 571 (3 ring rows);
# K7: every layer's ring of a 32-layer cache into rows [568, 576)
RING_SHAPE = dict(L=2, B=1, Hkv=32, S=640, D=128, pos=571)
FLUSH_SHAPE = dict(L=32, B=1, Hkv=32, S=640, D=128, pos=576)
# the MoE models' published configs (Mixtral-8x7B, Qwen3-30B-A3B
# config.json), full width and depth; Qwen3's expert width goes in
# intermediate_size (bench.py:131-146)
MIXTRAL = dict(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    arch="mixtral",
    num_local_experts=8,
    num_experts_per_tok=2,
    rope_theta=1e6,
    rms_norm_eps=1e-5,
    max_position_embeddings=32768,
)
QWEN3 = dict(
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=768,
    num_hidden_layers=48,
    num_attention_heads=32,
    num_key_value_heads=4,
    head_dim=128,
    arch="qwen3_moe",
    num_local_experts=128,
    num_experts_per_tok=8,
    moe_router="deepseek",
    norm_topk_prob=True,
    qk_norm="rms",
    rope_theta=1e6,
    rms_norm_eps=1e-6,
    max_position_embeddings=40960,
)
# the MoE paths: batch 1 (prompt, ring steps, ring cache length) and
# batch 8 (prompt, steps, cache length), for both models
MOE = dict(T1=512, STEPS1=64, MAX1=640, B=8, T=128, STEPS=64, MAX_SEQ=256)
# the long-context path: batch 8, cache length, filled rows, steps
LONG = dict(B=8, MAX_SEQ=16384, POS=12288, STEPS=16)
# the MoE cross-check legs: (config, batch, prompt, sparse steps)
CROSS_MOE = (("Mixtral", MIXTRAL, 2, 16, 4), ("Qwen3", QWEN3, 4, 16, 8))
# K8 cases: (name, K, padded N, experts in the stack, selections, mode)
K8_CASES = (
    ("mixtral gateup", 4096, 28672, 8, 2, "shared"),
    ("qwen3 gateup", 2048, 1536, 128, 8, "shared"),
    ("qwen3 down", 768, 2048, 128, 64, "sorted"),
)
# K3b past the one-shot limit: layers, batch, kv heads, rows, head width, n_rep
LONG_ATTN_SHAPE = dict(L=1, B=8, Hkv=8, S=16384, D=128, n_rep=4)
DEV = "cuda"
QMM_TOL = 2e-2  # atol 2e-2 * max|y|, rtol 2e-2 (tests/test_pallas_qmm.py)
K8_TOL = (2e-2, 1e-3)  # |y - plain| <= 2e-2 * max|plain| + 1e-3 (tests/test_moe_sparse.py:174)
ATTN_TOL = 2e-2  # tests/test_pallas_attention.py:59
# past 8192 rows the outputs shrink (about 0.015 RMS), so the limit scales
# with them: |out - plain| <= 2e-2 * max|plain| + 1e-4. A K3b that skips one
# 128-row tile misses it several times over (the control in k3b_long_check).
LONG_ATTN_TOL = (2e-2, 1e-4)
RING_TOL = 1e-2  # tests/test_torch_ring.py (JAX: 3e-2 against numpy)
FLASH_TOL = 2e-2  # tests/test_torch_flash_prefill.py (JAX: 3e-2 against numpy)
LOGIT_TOL = 5e-2  # tests/test_pallas_attention.py:83


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(bytes_moved: float, flops: float = 0.0):
    """The least time (ms) for the work and what sets it."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """CUDA-event timing, median over runs, L2 flushed before each run."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def gpu_name_and_limit() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return r.stdout.strip().splitlines()[0]


def phase_kernels(torch, timer):
    """Every kernel at the main path's 7B shapes against its plain version."""
    from qllm_tpu_torch.ops import attention as att
    from qllm_tpu_torch.ops import flash_prefill as fp
    from qllm_tpu_torch.ops import qmm, repack

    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    dev = DEV
    rows = []

    def stack(Kf, Np, L=2):
        qw = torch.randint(-(2**31), 2**31, (L, Kf // 8, Np), dtype=torch.int32, device=dev, generator=gen)
        sc = ((torch.rand((L, Kf // 128, Np), device=dev, generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
        zs = (sc.float() * 8.0).to(torch.bfloat16)
        return qw, sc, zs

    def dequant(qw, sc, zs, layer, Kf):
        v = qmm._planar_values(qw[layer], Kf).reshape(Kf // 128, 128, -1)
        w = v * sc[layer].float()[:, None, :] - zs[layer].float()[:, None, :]
        return w.reshape(Kf, -1).to(torch.bfloat16)

    # K1 / K2: M = 8 and 1 decode rows, M = 1024 (8 x 128), 512 and 2048 prefill rows
    fns = {
        "w4_planar_gemv": (qmm.w4_planar_gemv, qmm.w4_planar_gemv_plain),
        "w4_planar_gemm": (qmm.w4_planar_gemm, qmm.w4_planar_gemm_plain),
    }
    for kname, M, only in QMM_CASES:
        fn, plain = fns[kname]
        for pname, Kf, N in PROJECTIONS:
            if only is not None and pname != only:
                continue
            Np = -(-N // 512) * 512
            qw, sc, zs = stack(Kf, Np)
            x = torch.randn((M, Kf), device=dev, generator=gen).to(torch.bfloat16)
            norms = (False, True) if kname == "w4_planar_gemv" else (False,)
            for norm in norms:
                nw = (torch.rand((2, Kf), device=dev, generator=gen) + 0.5).to(torch.bfloat16) if norm else None
                args = (x, qw, sc, zs, 1) + ((nw, 1e-5) if kname == "w4_planar_gemv" else ())
                y = fn(*args)
                torch.cuda.synchronize()
                y_ref = plain(*args)
                scale = float(y_ref.float().abs().max())
                err = float((y.float() - y_ref.float()).abs().max())
                ok = torch.allclose(y.float(), y_ref.float(), atol=QMM_TOL * scale, rtol=QMM_TOL)
                w = dequant(qw, sc, zs, 1, Kf)
                xin = qmm._rms_norm_rows(x, nw[1], 1e-5) if norm else x
                lib_ms = timer(lambda: torch.matmul(xin, w))
                del w
                ms = timer(lambda: fn(*args))
                plain_ms = timer(lambda: plain(*args), reps=5, warmup=1)
                nbytes = qw[1].numel() * 4 + 2 * sc[1].numel() * 2 + M * Kf * 2 + M * Np * 2
                nbytes += Kf * 2 if norm else 0
                b_ms, b_by = bound(nbytes, 2.0 * M * Kf * Np)
                rows.append(
                    dict(kernel=kname, case=f"{pname} K={Kf} N={Np} M={M}" + (" +norm" if norm else ""),
                         max_abs_err=err, tol=f"atol {QMM_TOL}*{scale:.4g} rtol {QMM_TOL}", ok=bool(ok),
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
                )
                log(f"[kernel] {json.dumps(rows[-1])}")
                if not ok:
                    raise AssertionError(f"{kname} {pname}: max_abs_err {err} outside tolerance")
            del qw, sc, zs, x

    # K3a / K3b: B=8, Hkv=32, d=128, S=256, layer 1 of 2
    L, B, Hkv, S, D = (ATTN_SHAPE[k] for k in ("L", "B", "Hkv", "S", "D"))
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=dev, generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=dev, generator=gen)
    ks = (torch.rand((L, B, Hkv, S), device=dev, generator=gen) * 0.015 + 0.005)
    vs = (torch.rand((L, B, Hkv, S), device=dev, generator=gen) * 0.015 + 0.005)
    pos = torch.randint(S // 2, 3 * S // 4, (B,), dtype=torch.int32, device=dev, generator=gen)
    k_new = torch.randn((B, Hkv, D), device=dev, generator=gen).to(torch.bfloat16)
    v_new = torch.randn((B, Hkv, D), device=dev, generator=gen).to(torch.bfloat16)
    caches = [t.clone() for t in (kc, vc, ks, vs)]
    att.kv_write_int8(k_new, v_new, *caches, 1, pos)
    torch.cuda.synchronize()
    refs = [t.clone() for t in (kc, vc, ks, vs)]
    att.kv_write_int8_plain(k_new, v_new, *refs, 1, pos)
    err_q = max(float((a.float() - b.float()).abs().max()) for a, b in zip(caches[:2], refs[:2]))
    err_s = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(caches[2:], refs[2:]))
    ok = err_q == 0.0 and err_s <= 1e-6
    ms = timer(lambda: att.kv_write_int8(k_new, v_new, *caches, 1, pos))
    plain_ms = timer(lambda: att.kv_write_int8_plain(k_new, v_new, *refs, 1, pos))
    b_ms, b_by = bound(2 * B * Hkv * D * 2 + 2 * B * Hkv * D + 2 * B * Hkv * 4 + B * 4)
    rows.append(dict(kernel="kv_write_int8", case=f"B={B} Hkv={Hkv} D={D} S={S}", max_abs_err=err_q,
                     tol="int8 exact, scales rtol 1e-6", scale_rel_err=err_s, ok=bool(ok), ms=ms,
                     plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if not ok:
        raise AssertionError(f"kv_write_int8: int8 err {err_q}, scale rel err {err_s}")

    lengths = pos + 1
    q = torch.randn((B, Hkv, D), device=dev, generator=gen).to(torch.bfloat16)
    args = (q, kc, vc, ks, vs, lengths, 1)
    out = att.decode_attn_int8(*args)
    torch.cuda.synchronize()
    ref = att.decode_attn_int8_plain(*args)
    err = float((out - ref).abs().max())
    ok = torch.allclose(out, ref, atol=ATTN_TOL, rtol=ATTN_TOL)
    kd = (kc[1].float() * ks[1][..., None]).to(torch.bfloat16)
    vd = (vc[1].float() * vs[1][..., None]).to(torch.bfloat16)
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(q[:, :, None, :], kd, vd, attn_mask=mask))
    ms = timer(lambda: att.decode_attn_int8(*args))
    plain_ms = timer(lambda: att.decode_attn_int8_plain(*args))
    n_rows = int(lengths.sum()) * Hkv
    b_ms, b_by = bound(n_rows * (2 * D + 8) + B * Hkv * D * 2 + B * Hkv * D * 4 + B * 4,
                       4.0 * n_rows * D)
    rows.append(dict(kernel="decode_attn_int8", case=f"B={B} H=Hkv={Hkv} D={D} S={S} lengths {int(lengths.min())}-{int(lengths.max())}",
                     max_abs_err=err, tol=f"atol/rtol {ATTN_TOL}", ok=bool(ok), ms=ms, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if not ok:
        raise AssertionError(f"decode_attn_int8: max_abs_err {err}")
    del kc, vc, ks, vs, caches, refs, kd, vd

    # K6 decode_attention_ring: one batch-1 step at pos 571 (flushed 568, 3 ring rows)
    L, B, Hkv, S, D, p = (RING_SHAPE[k] for k in ("L", "B", "Hkv", "S", "D", "pos"))
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=dev, generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=dev, generator=gen)
    ks = torch.rand((L, B, Hkv, S), device=dev, generator=gen) * 0.015 + 0.005
    vs = torch.rand((L, B, Hkv, S), device=dev, generator=gen) * 0.015 + 0.005
    rk = torch.randn((L, B, Hkv, att.RING, D), device=dev, generator=gen).to(torch.bfloat16)
    rv = torch.randn((L, B, Hkv, att.RING, D), device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn((B, Hkv, D), device=dev, generator=gen).to(torch.bfloat16)
    k_new = torch.randn((B, Hkv, D), device=dev, generator=gen).to(torch.bfloat16)
    v_new = torch.randn((B, Hkv, D), device=dev, generator=gen).to(torch.bfloat16)
    lengths = torch.full((B,), p, dtype=torch.int32, device=dev)
    mine, theirs = [rk.clone(), rv.clone()], [rk.clone(), rv.clone()]
    cache_args = (kc, vc, ks, vs)
    out = att.decode_attention_ring(q, k_new, v_new, *cache_args, *mine, lengths, 1)
    torch.cuda.synchronize()
    ref = att.decode_attention_ring_plain(q, k_new, v_new, *cache_args, *theirs, lengths, 1)
    err = float((out - ref).abs().max())
    rings_same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
    ok = bool(torch.allclose(out, ref, atol=RING_TOL, rtol=RING_TOL)) and rings_same
    flushed, nring = p // att.RING * att.RING, p % att.RING
    keys = torch.cat([(kc[1, :, :, :flushed].float() * ks[1, :, :, :flushed, None]).to(torch.bfloat16),
                      rk[1, :, :, :nring], k_new[:, :, None]], dim=2)
    vals = torch.cat([(vc[1, :, :, :flushed].float() * vs[1, :, :, :flushed, None]).to(torch.bfloat16),
                      rv[1, :, :, :nring], v_new[:, :, None]], dim=2)
    lib_ms = timer(lambda: sdpa(q[:, :, None, :], keys, vals))
    ms = timer(lambda: att.decode_attention_ring(q, k_new, v_new, *cache_args, *mine, lengths, 1))
    plain_ms = timer(lambda: att.decode_attention_ring_plain(q, k_new, v_new, *cache_args, *theirs, lengths, 1))
    nbytes = (B * Hkv * (flushed * (2 * D + 8) + nring * 4 * D) + B * Hkv * D * 2 * 3  # rows, q, k/v_new
              + B * Hkv * D * 4 + 2 * B * Hkv * D * 2 + B * 4)  # out, the ring slot, lengths
    b_ms, b_by = bound(nbytes, 4.0 * B * Hkv * D * (p + 1))
    rows.append(dict(kernel="decode_attention_ring", case=f"B={B} H=Hkv={Hkv} D={D} S={S} pos={p} ({nring} ring rows)",
                     max_abs_err=err, tol=f"atol/rtol {RING_TOL}, rings bit-equal", rings_equal=rings_same, ok=ok,
                     ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if not ok:
        raise AssertionError(f"decode_attention_ring: max_abs_err {err}, rings equal {rings_same}")
    del kc, vc, ks, vs, keys, vals

    # K7 kv_ring_flush: all 32 layers' rings into rows [568, 576)
    L, B, Hkv, S, D, p = (FLUSH_SHAPE[k] for k in ("L", "B", "Hkv", "S", "D", "pos"))
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=dev, generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=dev, generator=gen)
    ks = torch.rand((L, B, Hkv, S), device=dev, generator=gen) * 0.015 + 0.005
    vs = torch.rand((L, B, Hkv, S), device=dev, generator=gen) * 0.015 + 0.005
    rk = torch.randn((L, B, Hkv, att.RING, D), device=dev, generator=gen).to(torch.bfloat16)
    rv = torch.randn((L, B, Hkv, att.RING, D), device=dev, generator=gen).to(torch.bfloat16)
    pos = torch.full((B,), p, dtype=torch.int32, device=dev)
    mine = [t.clone() for t in (kc, vc, ks, vs)]
    theirs = [t.clone() for t in (kc, vc, ks, vs)]
    att.kv_ring_flush(*mine, rk, rv, pos)
    torch.cuda.synchronize()
    att.kv_ring_flush_plain(*theirs, rk, rv, pos)
    err_q = max(float((a.float() - b.float()).abs().max()) for a, b in zip(mine[:2], theirs[:2]))
    err_s = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(mine[2:], theirs[2:]))
    ok = err_q == 0.0 and err_s <= 1e-6
    ms = timer(lambda: att.kv_ring_flush(*mine, rk, rv, pos))
    plain_ms = timer(lambda: att.kv_ring_flush_plain(*theirs, rk, rv, pos))
    n = L * B * Hkv * att.RING
    b_ms, b_by = bound(2 * n * D * 2 + 2 * n * D + 2 * n * 4 + B * 4)
    rows.append(dict(kernel="kv_ring_flush", case=f"L={L} B={B} Hkv={Hkv} D={D} S={S} rows [{p - att.RING}, {p})",
                     max_abs_err=err_q, tol="int8 exact, scales rtol 1e-6", scale_rel_err=err_s, ok=bool(ok),
                     ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if not ok:
        raise AssertionError(f"kv_ring_flush: int8 err {err_q}, scale rel err {err_s}")
    del kc, vc, ks, vs, mine, theirs

    # K5 flash_prefill: batch 1, 32 heads, from position 0
    for T, S, form in FLASH_CASES:
        B, H, D = 1, SEVEN_B["num_attention_heads"], 128
        q = torch.randn((B, T, H, D), device=dev, generator=gen).to(torch.bfloat16)
        pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        if form == "int8":
            k = torch.randint(-127, 128, (B, H, S, D), dtype=torch.int8, device=dev, generator=gen)
            v = torch.randint(-127, 128, (B, H, S, D), dtype=torch.int8, device=dev, generator=gen)
            ksc = torch.rand((B, H, S), device=dev, generator=gen) * 0.015 + 0.005
            vsc = torch.rand((B, H, S), device=dev, generator=gen) * 0.015 + 0.005
            kd = (k.float() * ksc[..., None]).to(torch.bfloat16)
            vd = (v.float() * vsc[..., None]).to(torch.bfloat16)
        else:  # the cacheless layout [B, S, H, D], seen as [B, H, S, D]
            k = torch.randn((B, S, H, D), device=dev, generator=gen).to(torch.bfloat16).transpose(1, 2)
            v = torch.randn((B, S, H, D), device=dev, generator=gen).to(torch.bfloat16).transpose(1, 2)
            ksc = vsc = None
            kd, vd = k, v
        args = (q, k, v, ksc, vsc, pos, torch.bfloat16)
        out = fp.flash_prefill(*args)
        torch.cuda.synchronize()
        ref = fp.flash_prefill_plain(*args)
        err = float((out.float() - ref.float()).abs().max())
        ok = torch.allclose(out.float(), ref.float(), atol=FLASH_TOL, rtol=FLASH_TOL)
        del ref
        qt, kt, vt = q.transpose(1, 2), kd[:, :, :T].contiguous(), vd[:, :, :T].contiguous()
        lib_ms = timer(lambda: sdpa(qt, kt, vt, is_causal=True))
        del qt, kt, vt
        ms = timer(lambda: fp.flash_prefill(*args))
        plain_ms = timer(lambda: fp.flash_prefill_plain(*args), reps=5, warmup=1)
        keys = min(S, T)  # pos 0: keys [0, T) are visible to some query
        pairs = sum(min(S, t + 1) for t in range(T))  # (query, key) pairs the mask keeps
        elt = 1 if form == "int8" else 2
        nbytes = 2 * B * T * H * D * 2 + 2 * B * H * keys * D * elt + (2 * B * H * keys * 4 if form == "int8" else 0)
        b_ms, b_by = bound(nbytes, 4.0 * B * H * D * pairs)
        rows.append(dict(kernel="flash_prefill", case=f"T={T} S={S} B={B} H=Hkv={H} D={D} {form} K/V, pos 0",
                         max_abs_err=err, tol=f"atol/rtol {FLASH_TOL}", ok=bool(ok), ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"flash_prefill T={T} S={S} {form}: max_abs_err {err}")
        del q, k, v, kd, vd, out
    torch.cuda.empty_cache()

    # K8 w4_grouped_gemv: the sparse MoE paths' selections, one launch each
    for cname, Kf, Np, E, n, mode in K8_CASES:
        qw, sc, zs = stack(Kf, Np, L=E)
        shared = mode == "shared"
        if shared:  # one token's k distinct experts, reading one row
            ids = torch.randperm(E, generator=gen, device=dev)[:n]
        else:  # n // k tokens' top-k, sorted: experts repeat
            k = n // 8
            ids = torch.cat([torch.randperm(E, generator=gen, device=dev)[:k] for _ in range(n // k)]).sort().values
        ids = ids.to(torch.int32)
        x = torch.randn((1 if shared else n, Kf), device=dev, generator=gen).to(torch.bfloat16)
        host_ids = ids.tolist()
        pair = None
        if not shared:  # an equal (row, id) pair must give equal bits
            pair = next(j for j in range(1, n) if host_ids[j] == host_ids[j - 1])
            x[pair] = x[pair - 1]
        args = (x, qw, sc, zs, ids, shared)
        y = qmm.w4_grouped_gemv(*args)
        torch.cuda.synchronize()
        y_ref = qmm.w4_grouped_gemv_plain(*args)
        scale = float(y_ref.float().abs().max())
        err = float((y.float() - y_ref.float()).abs().max())
        same = pair is None or bool(torch.equal(y[pair], y[pair - 1]))
        ok = err <= K8_TOL[0] * scale + K8_TOL[1] and same
        w_sel = torch.stack([dequant(qw, sc, zs, e, Kf) for e in host_ids])  # [n, K, Np], outside the timing
        xs = x.expand(n, Kf) if shared else x
        lib_ms = timer(lambda: torch.bmm(xs[:, None, :], w_sel))
        del w_sel
        ms = timer(lambda: qmm.w4_grouped_gemv(*args))
        plain_ms = timer(lambda: qmm.w4_grouped_gemv_plain(*args), reps=5, warmup=1)
        uniq = len(set(host_ids))  # the experts this run's ids touch, each read once
        nbytes = uniq * (qw[0].numel() * 4 + 2 * sc[0].numel() * 2) + x.numel() * 2 + n * Np * 2 + n * 4
        b_ms, b_by = bound(nbytes, 2.0 * n * Kf * Np)
        rows.append(dict(kernel="w4_grouped_gemv", case=f"{cname} K={Kf} N={Np} E={E} n={n} {mode} ({uniq} experts)",
                         max_abs_err=err, tol=f"{K8_TOL[0]}*{scale:.4g} + {K8_TOL[1]}, equal pairs bit-equal",
                         ok=bool(ok), ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"w4_grouped_gemv {cname}: max_abs_err {err}, equal pair {same}")
        del qw, sc, zs, x, y, y_ref
    torch.cuda.empty_cache()

    # K3b past the JAX package's one-shot limit (its key-chunked kernel, #15)
    L, B, Hkv, S, D, n_rep = (LONG_ATTN_SHAPE[k] for k in ("L", "B", "Hkv", "S", "D", "n_rep"))
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=dev, generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=dev, generator=gen)
    ks = torch.rand((L, B, Hkv, S), device=dev, generator=gen) * 0.015 + 0.005
    vs = torch.rand((L, B, Hkv, S), device=dev, generator=gen) * 0.015 + 0.005
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hkv * n_rep, D), device=dev, generator=gen).to(torch.bfloat16)
    args = (q, kc, vc, ks, vs, lengths, 0)
    fields, ok = k3b_long_check(att, args, 5)
    kd =(kc[0].float() * ks[0][..., None]).to(torch.bfloat16).repeat_interleave(n_rep, dim=1)
    vd = (vc[0].float() * vs[0][..., None]).to(torch.bfloat16).repeat_interleave(n_rep, dim=1)
    lib_ms = timer(lambda: sdpa(q[:, :, None, :], kd, vd))
    del kd, vd
    ms = timer(lambda: att.decode_attention(*args))
    plain_ms = timer(lambda: att.decode_attn_int8_plain(*args), reps=5, warmup=1)
    n_rows = int(lengths.sum()) * Hkv
    b_ms, b_by = bound(n_rows * (2 * D + 8) + q.numel() * 2 + q.numel() * 4 + B * 4, 4.0 * n_rows * D * n_rep)
    rows.append(dict(kernel="decode_attn_int8", case=f"S={S} B={B} Hkv={Hkv} n_rep={n_rep} D={D} lengths {S}",
                     chunked=True, **fields, ok=ok, ms=ms,
                     plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if not ok:
        raise AssertionError(f"decode_attn_int8 at S={S}: {fields}")
    del kc, vc, ks, vs, q
    torch.cuda.empty_cache()

    # K4: the gateup stack at load time, [32, 4096/8, 22016]
    words = torch.randint(-(2**31), 2**31, K4_SHAPE, dtype=torch.int32, device=dev, generator=gen)
    k4 = K4_SHAPE[1] * 8
    out = repack.planarize_w4(words, k4)
    torch.cuda.synchronize()
    ref = repack.planarize_w4_plain(words, k4)
    mism = int((out != ref).sum())
    del ref
    ms = timer(lambda: repack.planarize_w4(words, k4))
    plain_ms = timer(lambda: repack.planarize_w4_plain(words, k4), reps=5, warmup=1)
    b_ms, b_by = bound(2 * words.numel() * 4)
    rows.append(dict(kernel="planarize_w4", case=f"{list(K4_SHAPE)} int32 (gateup stack)",
                     max_abs_err=float(mism), tol="bit-exact", ok=mism == 0, ms=ms, plain_ms=plain_ms,
                     library_ms=None, bound_ms=b_ms, bound_by=b_by))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if mism:
        raise AssertionError(f"planarize_w4: {mism} words differ")
    del words, out
    torch.cuda.empty_cache()
    return rows


def k3b_long_check(att, args, lengths_at: int):
    """K3b against its plain version past 8192 rows within LONG_ATTN_TOL,
    and a control: K3b with every length cut by one 128-row tile must
    miss the same limit. Returns the fields to log and whether both held."""
    out = att.decode_attention(*args)
    ref = att.decode_attn_int8_plain(*args)
    err = float((out - ref).abs().max())
    limit = LONG_ATTN_TOL[0] * float(ref.abs().max()) + LONG_ATTN_TOL[1]
    cut = list(args)
    cut[lengths_at] = args[lengths_at] - 128
    control_err = float((att.decode_attention(*cut) - ref).abs().max())
    fields = dict(max_abs_err=err, tol=f"{LONG_ATTN_TOL[0]}*max|plain| + {LONG_ATTN_TOL[1]} = {limit:.4g}",
                  control_one_tile_short_err=control_err)
    return fields, err <= limit < control_err


def counts(K):
    return {name: fn.launches for name, fn in K.items()}


def phase_main(torch, K):
    """The full-depth 7B main path: load + stack, prefill 8x128, 64 steps."""
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import make_cache, prefill
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.models.stacked import prepare_lm_head, stack_layer_params
    from qllm_tpu_torch.utils.testing import random_quantized_params

    cfg = ModelConfig(num_hidden_layers=MAIN["LAYERS"], **SEVEN_B)
    B, T, STEPS, MAX_SEQ = (MAIN[k] for k in ("B", "T", "STEPS", "MAX_SEQ"))
    t0 = time.time()
    params = random_quantized_params(cfg, 0, bits=4, group_size=128, quantize_lm_head=True, device=DEV)
    torch.cuda.synchronize()
    log(f"[main] random W4 g128 params drawn on the card in {time.time() - t0:.2f} s")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32, device=DEV, generator=gen)

    for fn in K.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    phases = {}
    t0 = time.time()
    sp = stack_layer_params(params)
    sp["lm_head"] = prepare_lm_head(sp["lm_head"])
    del params
    torch.cuda.synchronize()
    load_s = time.time() - t0
    phases["load"] = counts(K)
    cache = make_cache(cfg, B, MAX_SEQ, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(sp, cfg, prompts, cache, device=DEV)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    phases["prefill"] = counts(K)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    t0 = time.perf_counter()
    toks, cache = decode_loop(sp, cfg, first, cache, T, STEPS, device=DEV)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    total = counts(K)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_phase = {
        "load": phases["load"],
        "prefill": delta(phases["load"], phases["prefill"]),
        "decode": delta(phases["prefill"], total),
    }
    per_step = {k: v / STEPS for k, v in per_phase["decode"].items()}
    log(f"[main] launches per phase {json.dumps(per_phase)}")
    log(f"[main] launches per decode step {json.dumps(per_step)}")
    expected = {
        "load": {"planarize_w4": 5},
        "prefill": {"w4_planar_gemm": 4 * cfg.num_hidden_layers + 1, "flash_prefill": 0},
        "decode": {
            "w4_planar_gemv": (4 * cfg.num_hidden_layers + 1) * STEPS,
            "kv_write_int8": cfg.num_hidden_layers * STEPS,
            "decode_attn_int8": cfg.num_hidden_layers * STEPS,
            "decode_attention_ring": 0,
            "kv_ring_flush": 0,
        },
    }
    check_launches(per_phase, expected)
    lf = logits.float()
    if tuple(lf.shape) != (B, cfg.vocab_size) or not bool(torch.isfinite(lf).all()):
        raise AssertionError("prefill logits are not finite [B, V]")
    if tuple(toks.shape) != (B, STEPS) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("decoded ids out of range")

    # a second, warm run on a fresh cache (allocator and clocks warm)
    cache = make_cache(cfg, B, MAX_SEQ, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits2, cache = prefill(sp, cfg, prompts, cache, device=DEV)
    torch.cuda.synchronize()
    prefill_warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    toks2, cache = decode_loop(
        sp, cfg, torch.argmax(logits2, -1).to(torch.int32)[:, None], cache, T, STEPS, device=DEV
    )
    torch.cuda.synchronize()
    decode_warm_s = time.perf_counter() - t0
    same = bool(torch.equal(toks, toks2))
    busy = profile_decode(torch, sp, cfg, toks2[:, -1:].contiguous(), cache, T + STEPS)
    result = {
        "config": f"Llama-2-7B shape, {cfg.num_hidden_layers} layers, W4 g128, quantized lm_head, "
        f"int8 KV, B={B}, T={T}, max_seq {MAX_SEQ}",
        "load_s": load_s,
        "prefill_ms": prefill_ms,
        "prefill_warm_ms": prefill_warm_ms,
        "prefill_tok_s_warm": B * T / (prefill_warm_ms / 1e3),
        "decode_steps": STEPS,
        "decode_tok_s": B * STEPS / decode_s,
        "decode_tok_s_warm": B * STEPS / decode_warm_s,
        "decode_ms_per_step_warm": decode_warm_s / STEPS * 1e3,
        "peak_mem_gib": peak_gib,
        **busy,
        "repeat_run_same_ids": same,
    }
    log(f"[main] {json.dumps(result)}")
    if not same:
        raise AssertionError("a second run on the same prompts decoded other ids")
    del cache, logits, logits2
    torch.cuda.empty_cache()
    return total, (cfg, sp)


def check_launches(per_phase, expected):
    for ph, want in expected.items():
        for k, n in want.items():
            if per_phase[ph][k] != n:
                raise AssertionError(f"{ph}: {k} launched {per_phase[ph][k]} times, expected {n}")


def phase_main1(torch, K, model):
    """The batch-1 main path on the same 7B model: a 512-token flash
    prefill into a ring cache, 64 ring-fused steps, a 2048-token prefill."""
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import make_cache, prefill

    if model is None:
        from qllm_tpu_torch.models.llama import ModelConfig
        from qllm_tpu_torch.models.stacked import prepare_lm_head, stack_layer_params
        from qllm_tpu_torch.utils.testing import random_quantized_params

        cfg = ModelConfig(num_hidden_layers=MAIN["LAYERS"], **SEVEN_B)
        sp = stack_layer_params(random_quantized_params(cfg, 0, quantize_lm_head=True, device=DEV))
        sp["lm_head"] = prepare_lm_head(sp["lm_head"])
    else:
        cfg, sp = model
    T, STEPS, MAX_SEQ, T_LONG = (MAIN1[k] for k in ("T", "STEPS", "MAX_SEQ", "T_LONG"))
    L = cfg.num_hidden_layers
    gen = torch.Generator(device=DEV)
    gen.manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (1, T), dtype=torch.int32, device=DEV, generator=gen)
    prompt_long = torch.randint(0, cfg.vocab_size, (1, T_LONG), dtype=torch.int32, device=DEV, generator=gen)

    def run():
        """prefill T into a ring cache, STEPS ring steps, prefill T_LONG;
        the counts and times after each part"""
        marks, times = [], []
        cache = make_cache(cfg, 1, MAX_SEQ, ring=True, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(sp, cfg, prompt, cache, device=DEV)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        marks.append(counts(K))
        first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        toks, cache = decode_loop(sp, cfg, first, cache, T, STEPS, device=DEV)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        marks.append(counts(K))
        long_cache = make_cache(cfg, 1, T_LONG, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_long, long_cache = prefill(sp, cfg, prompt_long, long_cache, device=DEV)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        marks.append(counts(K))
        return logits, toks, cache, logits_long, marks, times

    for fn in K.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    zero = counts(K)
    logits, toks, cache, logits_long, marks, cold = run()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    total = marks[-1]
    per_phase = {
        f"prefill_{T}": delta(zero, marks[0]),
        "decode": delta(marks[0], marks[1]),
        f"prefill_{T_LONG}": delta(marks[1], marks[2]),
    }
    log(f"[main1] launches per phase {json.dumps(per_phase)}")
    prefill_want = {"w4_planar_gemm": 4 * L + 1, "flash_prefill": L, "w4_planar_gemv": 0}
    check_launches(per_phase, {
        f"prefill_{T}": prefill_want,
        "decode": {
            "w4_planar_gemv": (4 * L + 1) * STEPS,
            "decode_attention_ring": L * STEPS,
            "kv_ring_flush": STEPS // 8,
            "kv_write_int8": 0,
            "decode_attn_int8": 0,
            "flash_prefill": 0,
        },
        f"prefill_{T_LONG}": prefill_want,
    })
    for lg, n in ((logits, (1, cfg.vocab_size)), (logits_long, (1, cfg.vocab_size))):
        if tuple(lg.shape) != n or not bool(torch.isfinite(lg.float()).all()):
            raise AssertionError("prefill logits are not finite [1, V]")
    if tuple(toks.shape) != (1, STEPS) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("decoded ids out of range")

    # a second, warm run: the same ids
    _, toks2, cache, _, _, warm = run()
    same = bool(torch.equal(toks, toks2))
    busy = profile_decode(torch, sp, cfg, toks2[:, -1:].contiguous(), cache, T + STEPS, steps=8)
    result = {
        "config": f"Llama-2-7B shape, {L} layers, W4 g128, quantized lm_head, B=1: T={T} prefill into a ring "
        f"cache of max_seq {MAX_SEQ}, {STEPS} ring-fused greedy steps, T={T_LONG} prefill into an int8 "
        f"cache of max_seq {T_LONG}",
        f"prefill_{T}_ms": cold[0] * 1e3,
        f"prefill_{T}_warm_ms": warm[0] * 1e3,
        f"prefill_{T}_tok_s_warm": T / warm[0],
        f"prefill_{T_LONG}_ms": cold[2] * 1e3,
        f"prefill_{T_LONG}_warm_ms": warm[2] * 1e3,
        f"prefill_{T_LONG}_tok_s_warm": T_LONG / warm[2],
        "decode_steps": STEPS,
        "decode_tok_s": STEPS / cold[1],
        "decode_ms_per_step": cold[1] / STEPS * 1e3,
        "decode_tok_s_warm": STEPS / warm[1],
        "decode_ms_per_step_warm": warm[1] / STEPS * 1e3,
        "peak_mem_gib": peak_gib,
        **busy,
        "repeat_run_same_ids": same,
    }
    log(f"[main1] {json.dumps(result)}")
    if not same:
        raise AssertionError("a second run on the same prompt decoded other ids")
    del sp, cache
    torch.cuda.empty_cache()
    return total


def profile_decode(torch, sp, cfg, token, cache, pos0, steps: int = 4):
    """Device busy share of a few warm decode steps (torch.profiler, CUDA
    kernel time over host wall time) and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qllm_tpu_torch.models.decode_loop import decode_loop

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_loop(sp, cfg, token, cache, pos0, steps, device=DEV)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        return {"device_busy_share": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"[profile] {e.self_device_time_total / 1e3 / steps:9.3f} ms/step  x{e.count // steps:4d}  {e.key[:90]}")
    return {
        "profiled_steps": steps,
        "profiled_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms,
    }


def delta(a, b):
    return {k: b[k] - a.get(k, 0) for k in b}


def load_moe(torch, K, name, shape):
    """Random W4 g128 MoE params drawn on the card (raw [E]-stacked
    experts, one draw per leaf), hybrid-stacked for serving with the
    sources consumed as the stacks land."""
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.models.stacked import prepare_lm_head, stack_layer_params_hybrid
    from qllm_tpu_torch.utils.testing import random_quantized_params

    cfg = ModelConfig(**shape)
    for fn in K.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = random_quantized_params(cfg, 0, quantize_lm_head=True, experts_prestacked=True, device=DEV)
    torch.cuda.synchronize()
    drawn_s = time.time() - t0
    t0 = time.time()
    sp = stack_layer_params_hybrid(params, consume=True)
    sp["lm_head"] = prepare_lm_head(sp["lm_head"])
    del params
    torch.cuda.synchronize()
    load_s = time.time() - t0
    L = cfg.num_hidden_layers
    # q|k|v, o and the lm_head, and each layer's gate|up and down stacks
    check_launches({"load": counts(K)}, {"load": {"planarize_w4": 3 + 2 * L}})
    est = sp["layers"]["experts_stacked"]
    if sp["layers"]["_moe_stride"] != cfg.num_local_experts or est["gateup_proj"].qweight.shape[0] != L * cfg.num_local_experts:
        raise AssertionError("the experts did not stack to one [L*E] stack per name")
    gib = sum(t.numel() * t.element_size() for t in _tensors(sp)) / 2**30
    res = {"config": f"{name}, {L} layers, W4 g128, quantized lm_head", "params_drawn_s": drawn_s, "load_s": load_s,
           "weights_gib": gib, "load_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[{name}] {json.dumps(res)}")
    torch.cuda.empty_cache()
    return cfg, sp, counts(K)


def _tensors(node):
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    if isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, list):
        for v in node:
            yield from _tensors(v)
    elif isinstance(node, QuantizedTensor):
        yield from (node.qweight, node.scales, node.zeros)
    elif hasattr(node, "numel"):
        yield node


def drive(torch, K, tag, cfg, sp, B, T, steps, max_seq, ring, expected, profile_steps=0):
    """One model path: B prompts of T tokens prefilled into a fresh cache,
    then ``steps`` greedy steps, twice (cold, then warm). Launches are
    counted in the cold run, with every count set to 0 just before it."""
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import make_cache, prefill

    gen = torch.Generator(device=DEV)
    gen.manual_seed(9)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32, device=DEV, generator=gen)

    def run():
        cache = make_cache(cfg, B, max_seq, ring=ring, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(sp, cfg, prompts, cache, device=DEV)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        mark = counts(K)
        first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        toks, cache = decode_loop(sp, cfg, first, cache, T, steps, device=DEV)
        torch.cuda.synchronize()
        return logits, toks, cache, mark, (t_prefill, time.perf_counter() - t0)

    for fn in K.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    zero = counts(K)
    logits, toks, cache, mark, cold = run()
    total = counts(K)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_phase = {"prefill": delta(zero, mark), "decode": delta(mark, total)}
    log(f"[{tag}] launches per phase {json.dumps(per_phase)}")
    check_launches(per_phase, expected)
    lf = logits.float()
    if tuple(lf.shape) != (B, cfg.vocab_size) or not bool(torch.isfinite(lf).all()):
        raise AssertionError(f"{tag}: prefill logits are not finite [B, V]")
    if tuple(toks.shape) != (B, steps) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{tag}: decoded ids out of range")
    _, toks2, cache, _, warm = run()
    same = bool(torch.equal(toks, toks2))
    busy = {}
    if profile_steps:
        busy = profile_decode(torch, sp, cfg, toks2[:, -1:].contiguous(), cache, T + steps, steps=profile_steps)
    result = {
        "config": f"B={B}, T={T} prefill into a{' ring' if ring else 'n int8'} cache of max_seq {max_seq}, "
        f"{steps} greedy steps",
        "prefill_ms": cold[0] * 1e3,
        "prefill_warm_ms": warm[0] * 1e3,
        "prefill_tok_s_warm": B * T / warm[0],
        "decode_steps": steps,
        "decode_tok_s": B * steps / cold[1],
        "decode_tok_s_warm": B * steps / warm[1],
        "decode_ms_per_step_warm": warm[1] / steps * 1e3,
        "peak_mem_gib": peak_gib,
        **busy,
        "repeat_run_same_ids": same,
    }
    log(f"[{tag}] {json.dumps(result)}")
    if not same:
        raise AssertionError(f"{tag}: a second run on the same prompts decoded other ids")
    del cache
    torch.cuda.empty_cache()
    return total


def moe_expected(cfg, steps, B, ring):
    """Launches of one MoE path: the prefill runs the dense expert loop
    (K2 for q|k|v, o and every expert's gate|up and down, then the
    lm_head); decode runs K8 twice per layer when B*k < E, else the dense
    loop through K1."""
    L, E, k = cfg.num_hidden_layers, cfg.num_local_experts, cfg.num_experts_per_tok
    sparse = B * k < E
    per_layer_k1 = 2 if sparse else 2 + 2 * E
    attn = {"decode_attention_ring": L * steps, "kv_ring_flush": steps // 8, "kv_write_int8": 0,
            "decode_attn_int8": 0} if ring else {"decode_attention_ring": 0, "kv_ring_flush": 0,
                                                 "kv_write_int8": L * steps, "decode_attn_int8": L * steps}
    return {
        "prefill": {"w4_planar_gemm": L * (2 + 2 * E) + 1, "w4_planar_gemv": 0, "w4_grouped_gemv": 0,
                    "flash_prefill": L if ring else 0},
        "decode": {"w4_planar_gemv": (per_layer_k1 * L + 1) * steps, "w4_grouped_gemv": 2 * L * steps if sparse else 0,
                   "w4_planar_gemm": 0, "flash_prefill": 0, **attn},
    }


def check_no_sync(torch, tag, cfg, sp, B):
    """One sparse MoE block (router, sort, K8 twice, unsort, combine)
    under set_sync_debug_mode("error"): any wait on the host raises."""
    from qllm_tpu_torch.models.llama import _moe_sparse
    from qllm_tpu_torch.models.stacked import StackedLayerView

    gen = torch.Generator(device=DEV)
    gen.manual_seed(12)
    x = torch.randn((B, 1, cfg.hidden_size), device=DEV, generator=gen).to(torch.bfloat16)
    pv = StackedLayerView(sp["layers"], cfg.num_hidden_layers - 1, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = _moe_sparse(pv, cfg, x, cfg.num_experts_per_tok)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if tuple(y.shape) != tuple(x.shape) or not bool(torch.isfinite(y.float()).all()):
        raise AssertionError(f"{tag}: the sparse MoE block gave a bad result")
    log(f"[{tag}] the sparse MoE block at B={B} ran under set_sync_debug_mode('error'): no host sync")


def phase_moe(torch, K, model):
    """Mixtral-8x7B: batch 1 (flash prefill, ring steps, K8 shared row)
    and batch 8 (plain cache, the dense expert loop)."""
    cfg, sp = model
    runs = {}
    runs["moe_b1"] = drive(torch, K, "moe b1", cfg, sp, 1, MOE["T1"], MOE["STEPS1"], MOE["MAX1"], True,
                           moe_expected(cfg, MOE["STEPS1"], 1, True), profile_steps=8)
    check_no_sync(torch, "moe b1", cfg, sp, 1)
    runs["moe_b8"] = drive(torch, K, "moe b8", cfg, sp, MOE["B"], MOE["T"], MOE["STEPS"], MOE["MAX_SEQ"], False,
                           moe_expected(cfg, MOE["STEPS"], MOE["B"], False))
    return runs


def phase_long(torch, K, model):
    """Mixtral at batch 8 on a 16384-row int8 cache: rows [0, POS) filled
    on the card, then STEPS greedy steps (K3b at S > 8192, the JAX
    package's key-chunked path), and K3b against its plain version on
    the filled rows."""
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import make_cache
    from qllm_tpu_torch.ops import attention as att

    cfg, sp = model
    B, S, P, STEPS = (LONG[k] for k in ("B", "MAX_SEQ", "POS", "STEPS"))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    for fn in K.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    cache = make_cache(cfg, B, S, device=DEV)
    for t in (cache.k, cache.v):
        t[:, :, :, :P].random_(-127, 128, generator=gen)
    for t in (cache.k_scale, cache.v_scale):
        t[:, :, :, :P].uniform_(0.005, 0.02, generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32, device=DEV, generator=gen)
    torch.cuda.synchronize()
    zero = counts(K)
    t0 = time.perf_counter()
    toks, cache = decode_loop(sp, cfg, tok, cache, P, STEPS, device=DEV)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    total = counts(K)
    per_phase = {"decode": delta(zero, total)}
    log(f"[long] launches {json.dumps(per_phase)}")
    check_launches(per_phase, {"decode": moe_expected(cfg, STEPS, B, False)["decode"]})
    if tuple(toks.shape) != (B, STEPS) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("long: decoded ids out of range")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # K3b on the filled rows [0, P) (outside the counted run) against its
    # plain version. The rows the steps wrote hold the model's own K/V,
    # whose scores swamp the random rows' and whose values reach ~30, so a
    # limit scaled to an output that reads them misses a lost tile of fill.
    q = torch.randn((B, cfg.num_attention_heads, cfg.hd), device=DEV, generator=gen).to(torch.bfloat16)
    lengths = torch.full((B,), P, dtype=torch.int32, device=DEV)
    args = (q, cache.k, cache.v, cache.k_scale, cache.v_scale, lengths, cfg.num_hidden_layers - 1)
    fields, ok = k3b_long_check(att, args, 5)
    res = {
        "config": f"Mixtral-8x7B, B={B}, int8 cache of max_seq {S}, rows [0, {P}) filled on the card, "
        f"{STEPS} greedy steps from {P}",
        "decode_tok_s": B * STEPS / dec_s,
        "decode_ms_per_step": dec_s / STEPS * 1e3,
        **{f"k3b_{k}": v for k, v in fields.items()},
        "peak_mem_gib": peak_gib,
    }
    log(f"[long] {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"long: K3b at S={S}: {fields}")
    del cache
    torch.cuda.empty_cache()
    return total


def phase_moe_qwen3(torch, K):
    """Qwen3-30B-A3B: batch 1 (flash prefill at n_rep 8, ring steps, K8
    shared row, 8 selections) and batch 8 (64 sorted selections)."""
    cfg, sp, load = load_moe(torch, K, "Qwen3-30B-A3B", QWEN3)
    model = (cfg, sp)
    runs = {"qwen3_load": load}
    runs["qwen3_b1"] = drive(torch, K, "moe_qwen3 b1", cfg, sp, 1, MOE["T1"], MOE["STEPS1"], MOE["MAX1"], True,
                             moe_expected(cfg, MOE["STEPS1"], 1, True), profile_steps=8)
    check_no_sync(torch, "moe_qwen3 b1", cfg, sp, 1)
    runs["qwen3_b8"] = drive(torch, K, "moe_qwen3 b8", cfg, sp, MOE["B"], MOE["T"], MOE["STEPS"], MOE["MAX_SEQ"],
                             False, moe_expected(cfg, MOE["STEPS"], MOE["B"], False))
    check_no_sync(torch, "moe_qwen3 b8", cfg, sp, MOE["B"])
    del model, sp
    torch.cuda.empty_cache()
    return runs


def cross_moe(torch):
    """2 layers at Mixtral and at Qwen3 width on the card and on the CPU:
    a short prompt (the dense expert loop), then sparse greedy steps."""
    from qllm_tpu_torch.models.generate import decode_step, make_cache, prefill
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.models.stacked import prepare_lm_head, stack_layer_params_hybrid
    from qllm_tpu_torch.utils.testing import random_quantized_params

    out = {}
    for name, shape, B, T, steps in CROSS_MOE:
        cfg = ModelConfig(**dict(shape, num_hidden_layers=CROSS["LAYERS"]))
        if B * cfg.num_experts_per_tok >= cfg.num_local_experts:
            raise AssertionError(f"cross {name}: B={B} would not take the sparse path")
        gpu = random_quantized_params(cfg, 2, quantize_lm_head=True, experts_prestacked=True, device=DEV)
        cpu = _to_cpu(gpu)
        sides = {}
        for side, params, dev in (("cuda", gpu, DEV), ("cpu", cpu, "cpu")):
            sp = stack_layer_params_hybrid(params)
            sp["lm_head"] = prepare_lm_head(sp["lm_head"])
            sides[side] = (sp, dev)
        del gpu, cpu
        gen = torch.Generator()
        gen.manual_seed(14)
        prompts = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32, generator=gen)
        logits, caches = {}, {}
        for side, (sp, dev) in sides.items():
            lg, caches[side] = prefill(sp, cfg, prompts, make_cache(cfg, B, T + steps, device=dev), device=dev)
            logits[side] = [lg.float().cpu()]
        tok = torch.argmax(logits["cuda"][0], dim=-1).to(torch.int32)[:, None]
        agree = [bool(torch.equal(tok, torch.argmax(logits["cpu"][0], -1).to(torch.int32)[:, None]))]
        for i in range(steps):
            for side, (sp, dev) in sides.items():
                lg, caches[side] = decode_step(sp, cfg, tok, caches[side], T + i, device=dev)
                logits[side].append(lg.float().cpu())
            nxt = torch.argmax(logits["cuda"][-1], dim=-1).to(torch.int32)[:, None]
            agree.append(bool(torch.equal(nxt, torch.argmax(logits["cpu"][-1], -1).to(torch.int32)[:, None])))
            tok = nxt
        errs = [float((a - b).abs().max()) for a, b in zip(logits["cuda"], logits["cpu"])]
        oks = [bool(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)) for a, b in zip(logits["cuda"], logits["cpu"])]
        out[name] = {"B": B, "T": T, "steps": steps, "prefill_max_abs_err": errs[0],
                     "decode_max_abs_err": max(errs[1:]), "greedy_agreement": sum(agree) / len(agree),
                     "within_tol": all(oks)}
        if not all(oks) or not all(agree):
            raise AssertionError(f"cross {name}: card vs CPU logits {errs}, greedy agreement {agree}")
        del sides, caches
        torch.cuda.empty_cache()
    return out


def _to_cpu(node):
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_cpu(v) for v in node]
    if isinstance(node, QuantizedTensor):
        return node.map_arrays(lambda a: a.cpu())
    return node.cpu()


def phase_cross(torch):
    """2 layers at full width: the card's kernels against the CPU's plain versions."""
    from qllm_tpu_torch.models.generate import decode_step, make_cache, prefill
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.models.stacked import prepare_lm_head, stack_layer_params
    from qllm_tpu_torch.ops.attention import RING, kv_ring_flush
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor
    from qllm_tpu_torch.utils.testing import random_quantized_params

    cfg = ModelConfig(num_hidden_layers=CROSS["LAYERS"], **SEVEN_B)
    B, T, STEPS, MAX_SEQ = (CROSS[k] for k in ("B", "T", "STEPS", "MAX_SEQ"))
    gpu = random_quantized_params(cfg, 1, quantize_lm_head=True, device=DEV)
    cpu = _to_cpu(gpu)
    sides = {}
    for name, params, dev in (("cuda", gpu, DEV), ("cpu", cpu, "cpu")):
        sp = stack_layer_params(params)
        sp["lm_head"] = prepare_lm_head(sp["lm_head"])
        sides[name] = (sp, dev)
    # the card's K4 relayout against the CPU's plain relayout, leaf by leaf
    for k, v in sides["cuda"][0]["layers"].items():
        w = sides["cpu"][0]["layers"][k]
        if isinstance(v, QuantizedTensor):
            for f in ("qweight", "scales", "zeros"):
                if not torch.equal(getattr(v, f).cpu(), getattr(w, f)):
                    raise AssertionError(f"stacked {k}.{f} differs between card and CPU")
    gen = torch.Generator()
    gen.manual_seed(11)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32, generator=gen)
    logits, caches = {}, {}
    for name, (sp, dev) in sides.items():
        c = make_cache(cfg, B, MAX_SEQ, device=dev)
        lg, caches[name] = prefill(sp, cfg, prompts, c, device=dev)
        logits[name] = [lg.float().cpu()]
    tok = torch.argmax(logits["cuda"][0], dim=-1).to(torch.int32)[:, None]
    agree = [bool(torch.equal(tok, torch.argmax(logits["cpu"][0], -1).to(torch.int32)[:, None]))]
    for i in range(STEPS):
        for name, (sp, dev) in sides.items():
            lg, caches[name] = decode_step(sp, cfg, tok, caches[name], T + i, device=dev)
            logits[name].append(lg.float().cpu())
        nxt = torch.argmax(logits["cuda"][-1], dim=-1).to(torch.int32)[:, None]
        agree.append(bool(torch.equal(nxt, torch.argmax(logits["cpu"][-1], -1).to(torch.int32)[:, None])))
        tok = nxt
    errs = [float((a - b).abs().max()) for a, b in zip(logits["cuda"], logits["cpu"])]
    oks = [bool(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)) for a, b in zip(logits["cuda"], logits["cpu"])]

    # batch 1 on a ring cache: a T=256 flash prefill, then 16 ring-fused
    # steps with a flush after every 8th (decode_loop's schedule)
    T1, STEPS1, MAX1 = (CROSS1[k] for k in ("T", "STEPS", "MAX_SEQ"))
    prompt1 = torch.randint(0, cfg.vocab_size, (1, T1), dtype=torch.int32, generator=gen)
    logits1, caches1 = {}, {}
    for name, (sp, dev) in sides.items():
        c = make_cache(cfg, 1, MAX1, ring=True, device=dev)
        lg, caches1[name] = prefill(sp, cfg, prompt1, c, device=dev)
        logits1[name] = [lg.float().cpu()]

    def greedy(lg):
        return torch.argmax(lg, dim=-1).to(torch.int32)[:, None]

    tok = greedy(logits1["cuda"][0])
    agree1 = [bool(torch.equal(tok, greedy(logits1["cpu"][0])))]
    for i in range(STEPS1):
        for name, (sp, dev) in sides.items():
            lg, c = decode_step(sp, cfg, tok, caches1[name], T1 + i, device=dev)
            if (T1 + i + 1) % RING == 0:
                pos = torch.full((1,), T1 + i + 1, dtype=torch.int32, device=c.device)
                kv_ring_flush(c.k, c.v, c.k_scale, c.v_scale, c.ring_k, c.ring_v, pos)
            logits1[name].append(lg.float().cpu())
        tok = greedy(logits1["cuda"][-1])
        agree1.append(bool(torch.equal(tok, greedy(logits1["cpu"][-1]))))
    errs1 = [float((a - b).abs().max()) for a, b in zip(logits1["cuda"], logits1["cpu"])]
    oks1 = [bool(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)) for a, b in zip(logits1["cuda"], logits1["cpu"])]
    res = {
        "config": f"Llama-2-7B widths, {CROSS['LAYERS']} layers, card kernels vs CPU plain versions: "
        f"B={B}, T={T}, {STEPS} greedy steps on the plain int8 cache; B=1, T={T1} (flash), "
        f"{STEPS1} greedy steps on a ring cache",
        "prefill_max_abs_err": errs[0],
        "decode_max_abs_err": max(errs[1:]),
        "greedy_agreement": sum(agree) / len(agree),
        "ring_prefill_max_abs_err": errs1[0],
        "ring_decode_max_abs_err": max(errs1[1:]),
        "ring_greedy_agreement": sum(agree1) / len(agree1),
        "tol": f"atol/rtol {LOGIT_TOL}",
        "within_tol": all(oks) and all(oks1),
    }
    log(f"[cross] {json.dumps(res)}")
    if not all(oks) or not all(oks1):
        raise AssertionError(f"card vs CPU logits outside tolerance: {errs} {errs1}")


KERNEL_META = {
    "w4_planar_gemv": ("qllm_tpu_torch/csrc/qmm.cu", "qllm_tpu/ops/pallas_qmm.py:832"),
    "w4_planar_gemm": ("qllm_tpu_torch/csrc/qmm.cu", "qllm_tpu/ops/pallas_qmm.py:751"),
    "kv_write_int8": ("qllm_tpu_torch/csrc/attention.cu", "qllm_tpu/ops/pallas_attention.py:134"),
    "decode_attn_int8": ("qllm_tpu_torch/csrc/attention.cu", "qllm_tpu/ops/pallas_attention.py:97"),
    "planarize_w4": ("qllm_tpu_torch/csrc/repack.cu", "qllm_tpu/ops/pallas_repack.py:47"),
    # at S <= 2048 the TPU runs the single-key-block kernel :751, above it :791
    "flash_prefill": ("qllm_tpu_torch/csrc/flash_prefill.cu", "qllm_tpu/ops/pallas_attention.py:751"),
    "decode_attention_ring": ("qllm_tpu_torch/csrc/attention.cu", "qllm_tpu/ops/pallas_attention.py:1212"),
    "kv_ring_flush": ("qllm_tpu_torch/csrc/attention.cu", "qllm_tpu/ops/pallas_attention.py:1423"),
    "w4_grouped_gemv": ("qllm_tpu_torch/csrc/qmm.cu", "qllm_tpu/ops/pallas_qmm.py:1843"),
}
# the shape each kernel's summary entry reports (the largest of the path)
HEADLINE = {"w4_planar_gemv": "gateup", "w4_planar_gemm": "gateup", "flash_prefill": "T=2048 S=2048",
            "w4_grouped_gemv": "mixtral gateup"}
# K3b stands in the line twice: as the TPU's one-shot kernel (#13) and as
# its key-chunked kernel (#15), with its LONG_ATTN_SHAPE reading and its
# launches on the long path
CHUNKED = dict(replaces="qllm_tpu/ops/pallas_attention.py:284", path="long")


def summary_entry(name, replaces, launches, mine, headline=""):
    head = next((r for r in mine if headline in r["case"] and "+norm" not in r["case"]), None)
    head = head or (mine[0] if mine else {})
    entry = {
        "name": name,
        "route": "cuda",
        "source": KERNEL_META[name][0],
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max((r["max_abs_err"] for r in mine), default=None),
        "ms": head.get("ms"),
        "plain_ms": head.get("plain_ms"),
        "bound_ms": head.get("bound_ms"),
        "bound_by": head.get("bound_by"),
        "library_ms": head.get("library_ms"),
        "shape": head.get("case"),
    }
    if len(mine) > 1 and name == "w4_grouped_gemv":
        entry["readings"] = [{k: r[k] for k in ("case", "ms", "max_abs_err", "bound_ms", "library_ms", "plain_ms")}
                             for r in mine]
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,main,main1,moe,long,moe_qwen3,cross",
                    help="comma-separated subset")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "qllm_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the qllm_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_name_and_limit()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from qllm_tpu_torch.ops import _build, attention, flash_prefill, qmm, repack

    K = {
        "w4_planar_gemv": qmm.w4_planar_gemv,
        "w4_planar_gemm": qmm.w4_planar_gemm,
        "kv_write_int8": attention.kv_write_int8,
        "decode_attn_int8": attention.decode_attn_int8,
        "planarize_w4": repack.planarize_w4,
        "flash_prefill": flash_prefill.flash_prefill,
        "decode_attention_ring": attention.decode_attention_ring,
        "kv_ring_flush": attention.kv_ring_flush,
        "w4_grouped_gemv": qmm.w4_grouped_gemv,
    }
    t_start = time.time()
    t0 = time.time()
    _build.load_library()
    log(f"[build] kernels ready in {time.time() - t0:.1f} s ({_build.build_dir()})")
    blog = _build.build_dir() / "build.log"
    if blog.exists():
        for line in blog.read_text().splitlines():
            if "Used" in line or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line):
                log(f"[build] {line.strip()}")

    timer = Timer(torch)
    t0 = time.time()
    rows = phase_kernels(torch, timer) if "kernels" in phases else []
    log(f"[time] kernels {time.time() - t0:.1f} s")
    # launch counts come only from the main paths' runs, each with the
    # counts set to 0 just before it
    runs, model = {}, None
    t0 = time.time()
    if "main" in phases:
        runs["main"], model = phase_main(torch, K)
    if "main1" in phases:
        runs["main1"] = phase_main1(torch, K, model)
    model = None
    torch.cuda.empty_cache()
    log(f"[time] main, main1 {time.time() - t0:.1f} s")
    t0 = time.time()
    if "moe" in phases or "long" in phases:
        cfg, sp, runs["moe_load"] = load_moe(torch, K, "Mixtral-8x7B", MIXTRAL)
        model = (cfg, sp)
        del cfg, sp
        if "moe" in phases:
            runs.update(phase_moe(torch, K, model))
        if "long" in phases:
            runs["long"] = phase_long(torch, K, model)
        model = None
        torch.cuda.empty_cache()
    log(f"[time] moe, long {time.time() - t0:.1f} s")
    t0 = time.time()
    if "moe_qwen3" in phases:
        runs.update(phase_moe_qwen3(torch, K))
    log(f"[time] moe_qwen3 {time.time() - t0:.1f} s")
    t0 = time.time()
    if "cross" in phases:
        phase_cross(torch)
        log(f"[time] cross, 7B legs {time.time() - t0:.1f} s")
        log(f"[cross] MoE legs {json.dumps(cross_moe(torch))}")
    log(f"[time] cross {time.time() - t0:.1f} s")

    def launches(name, keep=lambda path: True):
        return sum(r[name] for p, r in runs.items() if keep(p)) if runs else None

    summary = []
    for name, (_, replaces) in KERNEL_META.items():
        mine = [r for r in rows if r["kernel"] == name]
        if name == "decode_attn_int8":
            mine = [r for r in mine if not r.get("chunked")]
            n = launches(name, lambda path: path != CHUNKED["path"])
        else:
            n = launches(name)
        summary.append(summary_entry(name, replaces, n, mine, HEADLINE.get(name, "")))
    mine = [r for r in rows if r["kernel"] == "decode_attn_int8" and r.get("chunked")]
    n = launches("decode_attn_int8", lambda path: path == CHUNKED["path"])
    summary.append(summary_entry("decode_attn_int8", CHUNKED["replaces"], n, mine))
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": summary}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
