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
     after warm-up, L2 flushed before each run); the decode attention
     body (K3b, K22, K21, K6) also at Falcon-7B's (71 heads on one kv
     head, head 64) and StarCoder's (48 on one, head 128) geometries, each
     row with the SM-microseconds a walked 128-key tile costs, a sequence's
     K3b and K6 outputs bit-equal between a batch-8 and a batch-1 launch,
     K1's (with and without the norm) and K17's M = 8 rows bit-equal to
     those of an M = 32 launch, and an A/B of the body's split length
     (128, 256, 512 rows); K1 also at M = 32 and 17, K17 at M = 32; K5 at
     Gemma-2-9B's head width 256 with its softcap and a window, and at
     head widths 384 and 512 (a synthetic head layout); K10 also at the
     engine's verify shape (M = 40) and K10 / K18 with a call's device time
     (torch.profiler) beside the event pair, as K2 and K5 have too; K1,
     K2, K17 and K18 on g = 8 stacks, whose groups close inside a 16-k
     tile, and on g = 6 stacks at Phi-3-mini's gate|up, whose groups end
     inside a planar word's k quadruple;
  3. main: a Llama-2-7B-shape W4 g128 model (32 layers, random weights
     drawn on the card, quantized lm_head) is stacked for serving,
     prefills 8 prompts of 128 tokens into an int8 KV cache (max_seq
     256) and decodes 64 greedy steps, with every kernel's launch count
     set to 0 before and read after;
  4. main1: the same model at batch 1: a 512-token prompt flash-prefilled
     into a ring-fused cache (max_seq 640), 64 ring-fused greedy steps,
     then a 2048-token prompt flash-prefilled into a 2048-row int8
     cache, counts again set to 0 before and read after; then one more
     warm 2048-token prefill under torch.profiler (device ms by kernel);
 4b. pnp (after main1, on its model): qmatmul_pnp_stacked, the JAX
     package's ops-level entry point for o_proj -> residual + RMSNorm ->
     gate|up (K20), at batch 8 for each of the 32 layers, against K1, the
     residual and K1 with the norm;
  5. serve: the continuous-batching engine (max_batch 8, max_seq 2048,
     prefill_chunk 256) on the 7B shape with per-layer (not stacked) W4
     g128 params, so every matmul runs K9 (M <= 32) or K10: 24 requests
     (prompts of 16-1536 tokens, 4 extending a registered 200-token
     prefix, 4 sampled), then the greedy ones again with n-gram
     speculation; each dispatch's launches asserted, bucket-length
     requests equal to greedy_generate, both legs' greedy streams held to
     teacher-forced prefills, sampled tokens inside their top-k /
     nucleus;
  6. moe: Mixtral-8x7B (32 layers, 8 experts, top-2, W4 g128, random
     weights drawn on the card), hybrid-stacked: (a) batch 1, a 512-token
     flash prefill into a ring cache (max_seq 640) and 64 ring-fused steps,
     the experts through the grouped kernel K8 with a shared row; (b)
     batch 8, 128-token prompts and 64 steps on the plain cache, where
     B*k >= E sends every expert through K1 (the dense loop); (c) the
     engine at max_batch 2 over 8 requests (K8 and K1);
  7. long: the same Mixtral at batch 8 on a 16384-row cache whose rows
     [0, 12288) are filled on the card, 16 steps from position 12288 (K3b
     past S = 8192, the JAX package's key-chunked path), then 4 steps
     under the profiler;
  8. moe_qwen3: Qwen3-30B-A3B (48 layers, 128 experts, top-8, q/k RMS
     norm), batch 1 as (a); then from one prefilled batch-1 cache state
     32 steps through K8 and 32 with moe_fused=True, each token's whole
     expert MLP in one K19 launch a layer (first-step logits within JAX's
     fused-vs-two-launch bound); batch 8 with 64 sorted selections per
     step through K8;
  9. cross: the 7B widths at 2 layers on the card and on the CPU (plain
     versions), B=2, T=32, 4 steps on the plain cache, then B=1, T=256
     (flash), 8 steps on a ring cache, then the plain-cache steps again
     with W4A8 (K11); the engine over 2 per-layer layers of 4 and 8 bits,
     with bf16 and with int8 activations (K12 on the 4-bit layer, K9 on
     the 8-bit one); then 2 layers at Mixtral and at Qwen3 width, a short
     prompt and sparse steps: bf16 expert stacks through K8, Qwen3 at
     batch 1 with moe_fused (K19), f32-scale stacks (the JAX package's
     default) at batch 1 and 2 and a 2-bit Qwen3 served per selection (no
     K8): logits within tolerance, the same greedy ids;
 11. widths (after serve): the 7B geometry stacked at other widths
     through the JAX package's routing: 2-bit g128 with f32 scales, 32
     layers, batch-8 prefill of 128 tokens (the fallback's K10) and 32
     greedy steps through K14 (v3); the same with bf16 scales (K14 v4)
     and under W4A8 at batch 32 (K15), 4 layers; 3-bit g128, 32 layers,
     f32 and bf16 scales, a batch-1 prompt of 32 tokens and 32 steps
     through K16; 8-bit and 4-bit act-order stacks through the fallback
     (K9 / K10) and a 4-bit planar=False stack through K14, 4 layers.
     Each leg: launches asserted, tok/s, device busy share, peak GiB, the
     streams against teacher-forced prefills (zero-mean weights at the
     serve model's spread) and the first steps on the card against the
     CPU's plain versions on the first 2 layers;
 10. w4a8 (run after main1, on its model): (a) bench.py's batch-32 decode
     leg: 32 prompts of 128 tokens prefilled once, then 64 greedy steps
     with bf16 activations (K1) and 64 from the same cache state with
     int8 activations (K11), the int8 stream held to teacher-forced
     prefills; (b) the engine with ServeConfig(w4a8=True) over the serve
     model's 20 greedy requests (K12 in every decode step), bucket-length
     requests equal to greedy_generate(w4a8=True) at batch 1; (c) the
     streaming ceiling (K13, ops.stream_bench.measure_stream_gbps) and
     each decode leg's device-time bandwidth as a share of it;
 12. f32s (after widths): the 7B geometry at 32 layers, W4 g128 with the
     serve model's weights, stacked with the defaults (f32 scales and
     zs, as the JAX package stacks): planar matmuls through K17 (M <= 32)
     and K18 (M > 32), the decode down_proj (K = 11008, no k-block) through
     the fallback's K9 (K12 under W4A8) as on the JAX package's chip:
     batch 8, 128-token prompts and 32 steps on the plain cache; batch 1,
     a 512-token flash prefill into a ring cache and 32 ring-fused steps;
     batch 8 with W4A8, 16 steps; then the same params stacked with bf16
     scales (K1 / K2), 16 steps at batch 8. Each leg: launches asserted,
     tok/s, device busy share, prefill ms, peak GiB; the plain-cache legs'
     streams against teacher-forced prefills and their first steps on the
     card against the CPU's plain versions on the first 2 layers.
 13. sp: the last two entry points of the JAX package's attention, at
     full width: sequence-parallel decode attention
     (``parallel.sp_decode_attention``, K21) over every layer of a
     Mixtral-geometry int8 cache of 32768 rows (17.2 GB, batch 8) through
     a one-rank NCCL group, against K3b over the whole cache; one layer
     split into 4 shards on the card and merged as the group merges, the
     empty shards exactly m = -1e30, acc = 0, den = 0; the per-layer 4-D
     cache (K22) at the Llama-2-7B, Gemma-2-9B (softcap 50, window 4096)
     and Bloom-7b1 (ALiBi) geometries; K3b with softcap and window at
     S = 16384 and with ALiBi at S = 4096.

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
import contextlib
import dataclasses
import functools
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
PEAK_INT8 = 1979e12  # int8 tensor-core op/s (K11 and K12 multiply int8)

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
# (steps cut to keep the script's clock: the CPU side is the slow part)
CROSS = dict(B=2, T=32, STEPS=4, MAX_SEQ=64, LAYERS=2)
CROSS1 = dict(T=256, STEPS=8, MAX_SEQ=280)
# the K3a / K3b phase: layers, batch, kv heads, cache length, head width
ATTN_SHAPE = dict(L=2, B=8, Hkv=32, S=256, D=128)
# K3a beside ATTN_SHAPE's bf16 row: the other head widths the port serves
# (Llama-3.2-1B's 64, Gemma-2-9B's 256) and an f32 k / v, at its B, Hkv, S
KV_WRITE_CASES = ((64, "bfloat16"), (256, "bfloat16"), (128, "float32"), (64, "float32"), (256, "float32"))
K4_SHAPE = (32, 512, 22016)  # the gateup stack, [L, 4096/8, N]
# K1 / K2 rows per case: (kernel, M, projection or None for all)
QMM_CASES = (
    ("w4_planar_gemv", 8, None),
    ("w4_planar_gemv", 1, None),
    ("w4_planar_gemv", 32, "gateup"),  # the w4a8 phase's a16 leg
    ("w4_planar_gemv", 17, "gateup"),  # the 4-tile kernel with its last two tiles nearly empty
    ("w4_planar_gemm", 1024, None),
    ("w4_planar_gemm", 512, "gateup"),
    ("w4_planar_gemm", 2048, "gateup"),
)
# K9 / K10 rows on per-layer GPTQ-order weights (the serve path's
# shapes): (kernel, M, projection, K, N, bits, act-order)
GPTQ_CASES = tuple(
    [("gptq_gemv", M, n, K, N, 4, False) for M in (1, 8)
     for n, K, N in (("q/k/v/o", 4096, 4096), ("gate/up", 4096, 11008), ("down", 11008, 4096),
                     ("lm_head", 4096, 32000))]
    + [("gptq_gemv", 8, "gate/up", 4096, 11008, b, False) for b in (2, 8)]
    + [("gptq_gemv", 8, "q/k/v/o", 4096, 4096, 4, True)]
    + [("gptq_gemm", 40, n, K, N, 4, False)  # the engine's verify step: 8 slots x (gamma 4 + 1)
       for n, K, N in (("q/k/v/o", 4096, 4096), ("gate/up", 4096, 11008), ("down", 11008, 4096))]
    + [("gptq_gemm", M, n, K, N, 4, False) for M in (256, 1024)
       for n, K, N in (("gate/up", 4096, 11008), ("down", 11008, 4096))]
    + [("gptq_gemm", 256, "gate/up", 4096, 11008, 8, False)]
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
# the MoE cross-check legs: (name, config, batches, prompt, sparse steps,
# scale storage, expert bits, moe_fused), each batch on the same stacks;
# bf16 4-bit stacks run K8 (K19 with moe_fused), the others are served per
# selection (no K8)
CROSS_MOE = (
    ("Mixtral", MIXTRAL, (2,), 16, 2, "bf16", 4, False),
    ("Qwen3", QWEN3, (4,), 16, 4, "bf16", 4, False),
    ("Qwen3 fused", QWEN3, (1,), 16, 4, "bf16", 4, True),
    ("Mixtral f32", MIXTRAL, (1, 2), 16, 2, "f32", 4, False),
    ("Qwen3 f32", QWEN3, (1, 2), 16, 4, "f32", 4, False),
    ("Qwen3 2-bit", QWEN3, (1,), 16, 4, "f32", 2, False),
)
# K8 cases: (name, K, padded N, experts in the stack, selections, mode):
# "shared", one token's k distinct experts reading one row; "sorted", n // 8
# tokens' top-8, sorted (runs of up to 8); "runs", sorted ids of K8_RUNS'
# run lengths (runs longer than the 8 rows a block takes)
K8_CASES = (
    ("mixtral gateup", 4096, 28672, 8, 2, "shared"),
    ("qwen3 gateup", 2048, 1536, 128, 8, "shared"),
    ("qwen3 down", 768, 2048, 128, 64, "sorted"),
    ("qwen3 down long runs", 768, 2048, 128, 64, "runs"),
)
K8_RUNS = (12, 12, 10, 10, 10, 10)
# the kernels a wrapper's launch makes, each with the fewest and the most
# of it a launch makes: K8 on the sparse MoE decode paths (its body, and its
# split sum when K is split), K12 on the W4A8 per-layer paths (its
# quantizer, K15's int8 body, its epilogue), K9 on the engine's plain step
# (the tensor-core body and its split sum); profile_run holds the profiled
# kernels under these names to the wrapper's own count
K8_KERNELS = {"planar_grouped_kernel": (1, 1), "split_sum_out_kernel": (0, 1)}
K12_KERNELS = {"quantize_rows_kernel": (1, 1), "stacked_s8_kernel": (1, 1), "a8_epilogue_kernel": (1, 1)}
K9_KERNELS = {"stacked_mma_kernel": (1, 1), "split_sum_out_kernel": (0, 1)}
# K1 and K17 (never in one profiled run): the planar body and its second
# kernel (the split sum, with K1's norm factor), summed by profile_run's
# ``sums``: the profiler lost a K1 body's record now and then (1 of 2308 in
# `long`, 1 of 516 in the f32s bf16 control), so no launch count holds them
K1_KERNELS = K17_KERNELS = ("planar_mma_kernel", "planar_out_kernel")
# K11's kernels in the a8 leg's profile (no K1 runs there): the quantizer,
# the int8 body on the planar consumer and its split sum
K11_KERNELS = ("quantize_rows_kernel", "planar_s8_kernel", "planar_out_kernel")
# K3a's kernel in the main path's profile (its share of the 7B b8 step)
K3A_KERNELS = ("kv_write_kernel",)
# K19's kernel in the fused leg's profile: one cooperative launch a call
K19_KERNELS = {"fused_mlp_kernel": (1, 1)}
# K19 (the fused expert MLP) at Qwen3-30B-A3B's batch-1 decode: experts in
# the stack, hidden (K1), expert width (K2), padded down width, selections
K19_CASE = dict(E=128, K1=2048, K2=768, Np2=2048, n=8)
# K20 (o_proj -> residual + RMSNorm -> gate|up) at the 7B's shapes: rows
K20_ROWS = (1, 8)
# K19 / K20 against their plain versions: one bf16 ulp of max|plain| on the
# bf16 outputs, 1e-5 * max|plain| on K20's f32 residual (f32 sums of the
# same products in another order)
HN_TOL = 1e-5
# the fused leg of moe_qwen3: steps from the batch-1 prefill's cache state,
# and JAX's own fused-vs-two-launch bound on the first step's logits
# (tests/test_moe_sparse.py:431: max|fused - two launches| / max|two launches|)
FUSED = dict(STEPS=32, REL=0.02)
# the pnp path: o_proj -> residual + RMSNorm -> gate|up through
# qmatmul_pnp_stacked for each layer of the 7B at batch 8, against K1, the
# residual and K1 with the norm (tests/test_pnp_kernel.py: 2e-2 on hn and
# 3e-2 on y2, relative to the largest value)
PNP = dict(M=8, HN_REL=2e-2, Y2_REL=3e-2)
# K3b past the one-shot limit: layers, batch, kv heads, rows, head width, n_rep
LONG_ATTN_SHAPE = dict(L=1, B=8, Hkv=8, S=16384, D=128, n_rep=4)
# the sp phase. K21: sequence-parallel decode attention at
# Mixtral-8x7B's attention geometry (32 layers, 8 kv heads, n_rep 4, head
# 128) over its max_position_embeddings of 32768 rows at batch 8, lengths
# that stop mid-shard, on a shard boundary, in the last shard and at the
# full cache; WORLD shards for the one-card merge check, LAYER the layer
# held against the plain version
SP = dict(L=32, B=8, Hkv=8, n_rep=4, D=128, S=32768, WORLD=4, LAYER=17,
          LENGTHS=(100, 8192, 16421, 24576, 30000, 32767, 32768, 5000))
# K21 against its plain version: acc and den within 1e-2 * max|plain|, m
# within 1e-5 relative (one max of f32 dot products summed in another order)
PARTIAL_TOL = (1e-2, 1e-5)
# multi-query attention at published geometries (config.json): (model, B,
# H, Hkv, D, S = the context); K3b, K22, K21 and K6 serve any n_rep
MQA = (("Falcon-7B", 8, 71, 1, 64, 2048), ("StarCoder", 8, 48, 1, 128, 8192))
# the decode body's split length, A/B'd at the kernel phase's long shapes
SPLIT_AB = (128, 256, 512)
# K5 at Gemma-2-9B's attention (16 heads, 8 kv heads, head 256, softcap 50,
# local-layer window 4096) over a 2048-token prompt, and with a window that
# masks (512): (T, S, window)
GEMMA_FLASH = dict(H=16, Hkv=8, D=256, softcap=50.0, CASES=((2048, 2048, 4096), (2048, 2048, 512)))
# K5 at head widths 384 and 512: no architecture of either package has them
# yet, so a synthetic layout (16 query heads on 8 kv heads, batch 1, T = S =
# 2048 from position 0): (D, softcap); the softcap row has its control
WIDE_FLASH = dict(H=16, Hkv=8, T=2048, CASES=((384, 0.0), (512, 0.0), (512, 50.0)))
# K1, K2, K17 and K18 on g = 8 planar stacks at the 7B gate|up shape
# (groups close inside a 16-k tile): (kernel, M); K18 at M = 128, where its
# plain version's [M, G, N] f32 group dots (G = 512) still fit the card
G8_CASES = (("w4_planar_gemv", 8), ("w4_planar_gemm", 1024), ("w4_planar_f32s_gemv", 8),
            ("w4_planar_f32s_gemm", 128))
# the same kernels on g = 6 stacks, whose groups end inside a planar word's k
# quadruple; the 7B's K (4096, 11008) has no g = 6 split at K/2, so Phi-3-mini's
# gate|up (config.json: hidden 3072, intermediate 8192): (g, name, K, N)
G6 = (6, "Phi-3-mini gateup", 3072, 16384)
SP_TOL = 2e-2  # the merged attention against K3b's: atol / rtol (tests/test_parallel.py:190)
# K22: one layer's 4-D cache at each model's published attention geometry
# and context (config.json): (model, B, H, Hkv, D, S, least length,
# options); Gemma-2's softcap and local-layer window, Bloom's ALiBi
ATTN_4D = (
    ("Llama-2-7B", 8, 32, 32, 128, 4096, 2048, {}),
    ("Gemma-2-9B", 8, 16, 8, 256, 8192, 4097, dict(softcap=50.0, window=4096)),
    ("Bloom-7b1", 8, 32, 32, 128, 2048, 1024, dict(alibi="bloom")),
)
# K3b with the options on a one-layer stack at Mixtral's geometry: (case,
# S, least length, options); S = 16384 is the JAX package's key-chunked
# path (#15), which takes the softcap and the window but no ALiBi
OPT_5D = (
    ("softcap+window", 16384, 8193, dict(softcap=50.0, window=4096)),
    ("alibi", 4096, 2048, dict(alibi="bloom")),
)
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
# card against CPU with int8 activations on both sides: ||a - b|| / ||b|| of
# the logits, the JAX package's own model-level W4A8 bound
# (tests/test_serve.py:287-296). x8 = round(x / sx) turns the last-bit
# differences that bf16-activation legs carry (within LOGIT_TOL) into whole
# int8 steps, and sx into a per-row factor: the stacked W4A8 leg is also
# held to LOGIT_TOL and equal greedy ids, the engine's W4A8 leg (per-layer
# serve-model weights, the first token's logits 0.125 apart already with
# bf16 activations) to this bound alone, LOGIT_TOL and its ids read.
A8_MODEL_REL = 0.15
# W4A8 kernels against their plain versions: x8 and sx bit-equal, outputs
# within one bf16 ulp of the plain version plus A8_TOL * max|plain| (both
# quantize x alike and sum exact integer dots; only the f32 order differs)
A8_TOL = 1e-3
# K11 rows: (M, projection); K12 rows: (M, projection, K, N, bits,
# act-order, scale storage): the serve path's fp16 scales, and the f32
# stacks' down_proj fallback (f32 scales at K = 11008)
A8_CASES = tuple((M, p) for M in (8, 32) for p in ("gateup", "down"))
A8_GPTQ_CASES = (
    (1, "gate/up", 4096, 11008, 4, False, "fp16"),
    (8, "gate/up", 4096, 11008, 4, False, "fp16"),
    (8, "gate/up", 4096, 11008, 2, False, "fp16"),
    (1, "q/k/v/o", 4096, 4096, 4, False, "fp16"),
    (8, "q/k/v/o", 4096, 4096, 4, False, "fp16"),
    (32, "q/k/v/o", 4096, 4096, 4, False, "fp16"),
    (8, "q/k/v/o", 4096, 4096, 4, True, "fp16"),
    (8, "down", 11008, 4096, 2, False, "f32"),
)
# the W4A8 decode leg (bench.py:653-691): batch, prompt, steps per leg,
# cache length; the streaming ceiling's geometry (the JAX package's
# default: the 7B gate|up stack) and passes per reading
W4A8 = dict(B=32, T=128, STEPS=64, MAX_SEQ=256)
W4A8_ALONE = (0, 17)  # rows of the batch-32 int8 leg decoded again alone
STREAM = dict(K=4096, N=22016, L=4, ITERS=512)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(bytes_moved: float, flops: float = 0.0, peak_ops: float = PEAK_BF16):
    """The least time (ms) for the work and what sets it."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak_ops * 1e3
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
                # a launch's device time (torch.profiler, L2 warm); K1's beside the library call's
                extra = {"device_ms": launch_us(torch, lambda: fn(*args), key="w4_gemm_kernel" if kname == "w4_planar_gemm"
                                                else "") / 1e3}
                if kname == "w4_planar_gemv":
                    extra["library_device_ms"] = launch_us(torch, lambda: torch.matmul(xin, w), key="") / 1e3
                del w
                ms = timer(lambda: fn(*args))
                plain_ms = timer(lambda: plain(*args), reps=5, warmup=1)
                nbytes = qw[1].numel() * 4 + 2 * sc[1].numel() * 2 + M * Kf * 2 + M * Np * 2
                nbytes += Kf * 2 if norm else 0
                b_ms, b_by = bound(nbytes, 2.0 * M * Kf * Np)
                rows.append(
                    dict(kernel=kname, case=f"{pname} K={Kf} N={Np} M={M}" + (" +norm" if norm else ""),
                         max_abs_err=err, tol=f"atol {QMM_TOL}*{scale:.4g} rtol {QMM_TOL}", ok=bool(ok),
                         ms=ms, **extra, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
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
    # the event pair holds the wrapper's host time: a call's device time beside it
    device_ms = launch_us(torch, lambda: att.kv_write_int8(k_new, v_new, *caches, 1, pos), key="") / 1e3
    rows.append(dict(kernel="kv_write_int8", case=f"B={B} Hkv={Hkv} D={D} S={S}", max_abs_err=err_q,
                     tol="int8 exact, scales rtol 1e-6", scale_rel_err=err_s, ok=bool(ok), ms=ms,
                     plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by, device_ms=device_ms))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if not ok:
        raise AssertionError(f"kv_write_int8: int8 err {err_q}, scale rel err {err_s}")
    for Dx, dname in KV_WRITE_CASES:
        dt = getattr(torch, dname)
        base = (torch.randint(-127, 128, (L, B, Hkv, S, Dx), dtype=torch.int8, device=dev, generator=gen),
                torch.randint(-127, 128, (L, B, Hkv, S, Dx), dtype=torch.int8, device=dev, generator=gen),
                torch.rand((L, B, Hkv, S), device=dev, generator=gen), torch.rand((L, B, Hkv, S), device=dev, generator=gen))
        kx = torch.randn((B, Hkv, Dx), device=dev, generator=gen).to(dt)
        vx = torch.randn((B, Hkv, Dx), device=dev, generator=gen).to(dt)
        mine, want = [t.clone() for t in base], [t.clone() for t in base]
        att.kv_write_int8(kx, vx, *mine, 1, pos)
        torch.cuda.synchronize()
        att.kv_write_int8_plain(kx, vx, *want, 1, pos)
        same = all(torch.equal(a, b) for a, b in zip(mine, want))
        err_x = max(float((a.float() - b.float()).abs().max()) for a, b in zip(mine, want))
        b_ms, b_by = bound(2 * B * Hkv * Dx * kx.element_size() + 2 * B * Hkv * Dx + 2 * B * Hkv * 4 + B * 4)
        rows.append(dict(kernel="kv_write_int8", case=f"B={B} Hkv={Hkv} D={Dx} S={S} {dname}", max_abs_err=err_x,
                         tol="bit-equal (int8 and scales)", ok=same,
                         ms=timer(lambda: att.kv_write_int8(kx, vx, *mine, 1, pos)),
                         plain_ms=timer(lambda: att.kv_write_int8_plain(kx, vx, *want, 1, pos)), library_ms=None,
                         bound_ms=b_ms, bound_by=b_by,
                         device_ms=launch_us(torch, lambda: att.kv_write_int8(kx, vx, *mine, 1, pos), key="") / 1e3))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not same:
            raise AssertionError(f"kv_write_int8 D={Dx} {dname}: not bit-equal to its plain version (err {err_x})")
        del base, mine, want

    lengths = pos + 1
    q = torch.randn((B, Hkv, D), device=dev, generator=gen).to(torch.bfloat16)
    args = (q, kc, vc, ks, vs, lengths, 1)
    out = att.decode_attn_int8(*args)
    torch.cuda.synchronize()
    ref = att.decode_attn_int8_plain(*args)
    err, ulp = float((out - ref).abs().max()), bf16_ulp(ref)
    ok = torch.allclose(out, ref, atol=ATTN_TOL, rtol=ATTN_TOL) and err <= ulp
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
                     max_abs_err=err, tol=f"atol/rtol {ATTN_TOL} and one bf16 ulp of max|plain| ({ulp:.4g})",
                     ok=bool(ok), ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                     **tile_cost(ms, lengths, 1, Hkv, fn=lambda: att.decode_attn_int8(*args))))
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
    err, ulp = float((out - ref).abs().max()), bf16_ulp(ref)
    rings_same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
    ok = bool(torch.allclose(out, ref, atol=RING_TOL, rtol=RING_TOL)) and rings_same and err <= ulp
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
                     max_abs_err=err, tol=f"atol/rtol {RING_TOL} and one bf16 ulp of max|plain| ({ulp:.4g}), rings "
                     "bit-equal", rings_equal=rings_same, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by,
                     **tile_cost(ms, lengths, 1, Hkv, ring=True, fn=lambda: att.decode_attention_ring(
                         q, k_new, v_new, *cache_args, *mine, lengths, 1))))
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
    device_ms = launch_us(torch, lambda: att.kv_ring_flush(*mine, rk, rv, pos), key="") / 1e3
    rows.append(dict(kernel="kv_ring_flush", case=f"L={L} B={B} Hkv={Hkv} D={D} S={S} rows [{p - att.RING}, {p})",
                     max_abs_err=err_q, tol="int8 exact, scales rtol 1e-6", scale_rel_err=err_s, ok=bool(ok),
                     ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by, device_ms=device_ms))
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
        dev_ms = launch_us(torch, lambda: fp.flash_prefill(*args), key="flash_prefill_kernel") / 1e3
        plain_ms = timer(lambda: fp.flash_prefill_plain(*args), reps=5, warmup=1)
        keys = min(S, T)  # pos 0: keys [0, T) are visible to some query
        pairs = sum(min(S, t + 1) for t in range(T))  # (query, key) pairs the mask keeps
        elt = 1 if form == "int8" else 2
        nbytes = 2 * B * T * H * D * 2 + 2 * B * H * keys * D * elt + (2 * B * H * keys * 4 if form == "int8" else 0)
        b_ms, b_by = bound(nbytes, 4.0 * B * H * D * pairs)
        rows.append(dict(kernel="flash_prefill", case=f"T={T} S={S} B={B} H=Hkv={H} D={D} {form} K/V, pos 0",
                         max_abs_err=err, tol=f"atol/rtol {FLASH_TOL}", ok=bool(ok), ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"flash_prefill T={T} S={S} {form}: max_abs_err {err}")
        del q, k, v, kd, vd, out
    torch.cuda.empty_cache()
    rows.extend(gemma_flash_rows(torch, timer, gen))

    rows.extend(k8_rows(torch, timer, gen, stack, dequant))

    rows.extend(fused_rows(torch, timer, gen, stack))
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
                     chunked=True, **fields, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                     bound_by=b_by, **tile_cost(ms, lengths, n_rep, Hkv, fn=lambda: att.decode_attention(*args))))
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
    rows.extend(gptq_rows(torch, timer, gen))
    rows.extend(a8_rows(torch, timer, gen, stack, dequant))
    rows.append(stream_row(torch, timer, gen))
    rows.extend(stacked_rows(torch, timer, gen))
    rows.extend(f32s_rows(torch, timer, gen))
    rows.extend(g8_rows(torch, timer, gen))
    rows.extend(g8_rows(torch, timer, gen, G6))
    rows.extend(wide_flash_rows(torch, timer, gen))
    rows.extend(sp_rows(torch, timer, gen))
    rows.extend(body_rows(torch, timer, gen))
    return rows


def k8_rows(torch, timer, gen, stack, dequant):
    """K8 w4_grouped_gemv at the sparse MoE paths' selections (K8_CASES),
    one launch each, against its plain version: K8_TOL, equal (row, id)
    pairs bit-equal (in one run, and across two heads of a run past 8
    selections), the first selections alone bit-equal to the whole launch's
    rows; the library call is torch.bmm on the selected experts'
    dequantized bf16 weights."""
    from qllm_tpu_torch.ops import qmm

    dev = DEV
    rows = []
    for cname, Kf, Np, E, n, mode in K8_CASES:
        qw, sc, zs = stack(Kf, Np, L=E)
        shared = mode == "shared"
        if shared:  # one token's k distinct experts, reading one row
            ids = torch.randperm(E, generator=gen, device=dev)[:n]
        elif mode == "sorted":  # n // 8 tokens' top-8, sorted: experts repeat
            ids = torch.cat([torch.randperm(E, generator=gen, device=dev)[:8] for _ in range(n // 8)]).sort().values
        else:  # runs longer than a block's 8 rows
            chosen = torch.randperm(E, generator=gen, device=dev)[: len(K8_RUNS)].tolist()
            ids = torch.tensor(sorted(e for e, r in zip(chosen, K8_RUNS) for _ in range(r)), device=dev)
        ids = ids.to(torch.int32)
        x = torch.randn((1 if shared else n, Kf), device=dev, generator=gen).to(torch.bfloat16)
        host_ids = ids.tolist()
        # equal (row, id) pairs must give equal bits: two selections of one
        # run, and (runs past 8) the heads of a run's first two blocks
        near, heads = [], []
        if not shared:
            near = [next(j for j in range(1, n) if host_ids[j] == host_ids[j - 1])]
            heads = [j for j in range(8, n) if host_ids[j] == host_ids[j - 8] and (j == 8 or host_ids[j - 9] != host_ids[j])]
        for j in near:
            x[j] = x[j - 1]
        for j in heads:
            x[j] = x[j - 8]
        args = (x, qw, sc, zs, ids, shared)
        y = qmm.w4_grouped_gemv(*args)
        torch.cuda.synchronize()
        y_ref = qmm.w4_grouped_gemv_plain(*args)
        scale = float(y_ref.float().abs().max())
        err = float((y.float() - y_ref.float()).abs().max())
        same = all(bool(torch.equal(y[j], y[j - 1])) for j in near) and all(
            bool(torch.equal(y[j], y[j - 8])) for j in heads)
        if mode == "runs" and not heads:
            raise AssertionError("w4_grouped_gemv long runs: no run passes 8 selections")
        # the last id outside the stack: a row of NaN, and the other rows'
        # bits unchanged (its run, if any, is one shorter)
        bad = ids.clone()
        bad[-1] = E
        yb = qmm.w4_grouped_gemv(x, qw, sc, zs, bad, shared)
        nan_row = bool(torch.isnan(yb[-1].float()).all()) and bool(torch.equal(yb[:-1], y[:-1]))
        # the first selections alone (a batch-1 token's, or the first 8 of
        # the sorted ones): the same bits as in the whole launch
        m = 1 if shared else 8
        alone = bool(torch.equal(qmm.w4_grouped_gemv(x[:m], qw, sc, zs, ids[:m], shared), y[:m]))
        ok = err <= K8_TOL[0] * scale + K8_TOL[1] and same and nan_row and alone
        w_sel = torch.stack([dequant(qw, sc, zs, e, Kf) for e in host_ids])  # [n, K, Np], outside the timing
        xs = x.expand(n, Kf) if shared else x
        lib_ms = timer(lambda: torch.bmm(xs[:, None, :], w_sel))
        lib_device_ms = launch_us(torch, lambda: torch.bmm(xs[:, None, :], w_sel), key="") / 1e3
        del w_sel
        ms = timer(lambda: qmm.w4_grouped_gemv(*args))
        device_ms = launch_us(torch, lambda: qmm.w4_grouped_gemv(*args), key="") / 1e3
        plain_ms = timer(lambda: qmm.w4_grouped_gemv_plain(*args), reps=5, warmup=1)
        uniq = len(set(host_ids))  # the experts this run's ids touch, each read once
        nbytes = uniq * (qw[0].numel() * 4 + 2 * sc[0].numel() * 2) + x.numel() * 2 + n * Np * 2 + n * 4
        b_ms, b_by = bound(nbytes, 2.0 * n * Kf * Np)
        rows.append(dict(kernel="w4_grouped_gemv", case=f"{cname} K={Kf} N={Np} E={E} n={n} {mode} ({uniq} experts)",
                         max_abs_err=err, tol=f"{K8_TOL[0]}*{scale:.4g} + {K8_TOL[1]}, equal pairs bit-equal",
                         run_heads=int((qmm.grouped_run_rows(ids.cpu()) > 0).sum()), nan_id_row=nan_row,
                         rows_alone_bit_equal=alone,
                         ok=bool(ok), ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library_device_ms=lib_device_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"w4_grouped_gemv {cname}: max_abs_err {err}, equal pairs {same}, NaN id row {nan_row}, "
                                 f"rows alone {alone}")
        del qw, sc, zs, x, y, y_ref
    torch.cuda.empty_cache()
    return rows


def gemma_flash_rows(torch, timer, gen):
    """K5 at Gemma-2-9B's attention with its logit softcap and a window,
    int8 K/V in the cache's layout, batch 1 from position 0, against its
    plain version within FLASH_TOL. The key scales draw scores of RMS
    0.5-1.5 x the cap, and the plain version without the softcap must miss
    ten times that limit. No single PyTorch call applies a logit softcap
    (library_ms null)."""
    from qllm_tpu_torch.ops import flash_prefill as fp

    H, Hkv, D, cap = (GEMMA_FLASH[k] for k in ("H", "Hkv", "D", "softcap"))
    rows = []
    for T, S, window in GEMMA_FLASH["CASES"]:
        B = 1
        q = torch.randn((B, T, H, D), device=DEV, generator=gen).to(torch.bfloat16)
        pos = torch.zeros((B,), dtype=torch.int32, device=DEV)
        k = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
        v = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
        ksc = key_scales(torch, (B, Hkv, S), gen, {"softcap": cap})
        vsc = torch.rand((B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
        win = torch.full((1,), window, dtype=torch.int32, device=DEV)
        args = (q, k, v, ksc, vsc, pos, torch.bfloat16, cap, win)
        out = fp.flash_prefill(*args)
        torch.cuda.synchronize()
        ref = fp.flash_prefill_plain(*args).float()
        err = float((out.float() - ref).abs().max())
        ok = bool(torch.allclose(out.float(), ref, atol=FLASH_TOL, rtol=FLASH_TOL))
        bare = fp.flash_prefill_plain(q, k, v, ksc, vsc, pos, torch.bfloat16, 0.0, win).float()
        miss = float((bare - ref).abs().max())
        control = not torch.allclose(bare, ref, atol=10 * FLASH_TOL, rtol=10 * FLASH_TOL)
        del ref, bare
        ms = timer(lambda: fp.flash_prefill(*args))
        dev_ms = launch_us(torch, lambda: fp.flash_prefill(*args), key="flash_prefill_kernel") / 1e3
        plain_ms = timer(lambda: fp.flash_prefill_plain(*args), reps=5, warmup=1)
        keys = min(S, T)  # pos 0: keys [0, T) are visible to some query
        pairs = sum(min(t + 1, window) for t in range(T))  # (query, key) pairs the masks keep
        nbytes = 2 * B * T * H * D * 2 + 2 * B * Hkv * keys * D + 2 * B * Hkv * keys * 4
        b_ms, b_by = bound(nbytes, 4.0 * B * H * D * pairs)
        rows.append(dict(kernel="flash_prefill", case=f"Gemma-2-9B T={T} S={S} B={B} H={H} Hkv={Hkv} D={D} int8 "
                         f"K/V, pos 0, softcap {cap}, window {window}", max_abs_err=err, tol=f"atol/rtol {FLASH_TOL}",
                         without_softcap_max_abs_err=miss, ok=ok and control, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not (ok and control):
            raise AssertionError(f"flash_prefill Gemma-2 window {window}: max_abs_err {err}, without the softcap "
                                 f"{miss} (must miss {10 * FLASH_TOL} atol/rtol)")
        del q, k, v, out
    torch.cuda.empty_cache()
    return rows


def wide_flash_rows(torch, timer, gen):
    """K5 at head widths 384 and 512 (WIDE_FLASH: a synthetic layout, no
    architecture of either package has these widths), int8 K/V in the
    cache's layout, batch 1 from position 0, against its plain version
    within FLASH_TOL; the softcap row draws scores of RMS 0.5-1.5 x the cap
    and its plain version without the cap must miss ten times the limit.
    Library: SDPA on the dequantized K/V (enable_gqa), where no softcap."""
    from qllm_tpu_torch.ops import flash_prefill as fp

    H, Hkv, T = (WIDE_FLASH[k] for k in ("H", "Hkv", "T"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for D, cap in WIDE_FLASH["CASES"]:
        B, S = 1, T
        q = torch.randn((B, T, H, D), device=DEV, generator=gen).to(torch.bfloat16)
        pos = torch.zeros((B,), dtype=torch.int32, device=DEV)
        k = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
        v = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
        ksc = key_scales(torch, (B, Hkv, S), gen, {"softcap": cap} if cap else {})
        vsc = torch.rand((B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
        args = (q, k, v, ksc, vsc, pos, torch.bfloat16, cap)
        out = fp.flash_prefill(*args)
        torch.cuda.synchronize()
        ref = fp.flash_prefill_plain(*args).float()
        err = float((out.float() - ref).abs().max())
        ok = bool(torch.allclose(out.float(), ref, atol=FLASH_TOL, rtol=FLASH_TOL))
        extra, lib_ms = {}, None
        if cap:
            bare = fp.flash_prefill_plain(q, k, v, ksc, vsc, pos, torch.bfloat16, 0.0).float()
            extra["without_softcap_max_abs_err"] = float((bare - ref).abs().max())
            ok = ok and not torch.allclose(bare, ref, atol=10 * FLASH_TOL, rtol=10 * FLASH_TOL)
            del bare
        else:
            kd = (k.float() * ksc[..., None]).to(torch.bfloat16)
            vd = (v.float() * vsc[..., None]).to(torch.bfloat16)
            qt = q.transpose(1, 2)
            lib_ms = timer(lambda: sdpa(qt, kd, vd, is_causal=True, enable_gqa=True))
            del kd, vd, qt
        del ref
        ms = timer(lambda: fp.flash_prefill(*args))
        dev_ms = launch_us(torch, lambda: fp.flash_prefill(*args), key="flash_prefill_kernel") / 1e3
        plain_ms = timer(lambda: fp.flash_prefill_plain(*args), reps=5, warmup=1)
        pairs = T * (T + 1) // 2  # (query, key) pairs the causal mask keeps
        nbytes = 2 * B * T * H * D * 2 + 2 * B * Hkv * S * D + 2 * B * Hkv * S * 4
        b_ms, b_by = bound(nbytes, 4.0 * B * H * D * pairs)
        rows.append(dict(kernel="flash_prefill", case=f"synthetic T={T} S={S} B={B} H={H} Hkv={Hkv} D={D} int8 K/V, "
                         f"pos 0" + (f", softcap {cap}" if cap else ""), max_abs_err=err, tol=f"atol/rtol {FLASH_TOL}",
                         **extra, ok=ok, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"flash_prefill D={D} softcap {cap}: {rows[-1]}")
        del q, k, v, out
        torch.cuda.empty_cache()
    return rows


def g8_rows(torch, timer, gen, geom=(8, "gateup", 4096, 22016)):
    """K1, K2, K17 and K18 on g = 8 planar stacks at the 7B gate|up shape
    (K = 4096, Np = 22016; a group closes inside every 16-k tile), or on
    ``geom`` = (g, name, K, Np) (G6: groups that end inside a k quadruple),
    against their plain versions: K1 / K2 within QMM_TOL, K17 / K18 within
    F32S_TIGHT * max|plain| with the next layer's plain version missing
    STACKED_TOL; K2 also with a launch's device time. Library: torch.matmul
    on the dequantized bf16 weight."""
    from qllm_tpu_torch.ops import qmm, qmm_planar

    g, pname, Kf, Np = geom
    G = Kf // g
    rows = []
    qw = torch.randint(-(2**31), 2**31, (3, Kf // 8, Np), dtype=torch.int32, device=DEV, generator=gen)
    v = qmm._planar_values(qw[1], Kf).reshape(G, g, Np)
    for kname, M in G8_CASES:
        f32 = "f32s" in kname
        mod = qmm_planar if f32 else qmm
        fn, plain = getattr(mod, kname), getattr(mod, kname + "_plain")
        x = torch.randn((M, Kf), device=DEV, generator=gen).to(torch.bfloat16)
        if f32:
            sc = (torch.rand((3, G, Np), device=DEV, generator=gen) + 0.5) * widths_scale(4)
            args, nxt = (x, qw, sc, 1), (x, qw, sc, 2)
            w = (v * sc[1][:, None]).reshape(Kf, Np).to(torch.bfloat16)
        else:
            sc = ((torch.rand((3, G, Np), device=DEV, generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
            zs = (sc.float() * 8.0).to(torch.bfloat16)
            args, nxt = (x, qw, sc, zs, 1), None
            w = (v * sc[1].float()[:, None] - zs[1].float()[:, None]).reshape(Kf, Np).to(torch.bfloat16)
        y = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args).float()
        scale = float(ref.abs().max())
        err = float((y.float() - ref).abs().max())
        if f32:
            control = float((y - plain(*nxt)).abs().max())
            ok = err <= F32S_TIGHT * scale and control > STACKED_TOL * scale
            extra = dict(tol=f"{F32S_TIGHT}*{scale:.4g}", control_next_layer_err=control)
        else:
            ok = bool(torch.allclose(y.float(), ref, atol=QMM_TOL * scale, rtol=QMM_TOL))
            extra = dict(tol=f"atol {QMM_TOL}*{scale:.4g} rtol {QMM_TOL}")
        del ref
        lib_ms = timer(lambda: torch.matmul(x, w))
        ms = timer(lambda: fn(*args))
        if kname == "w4_planar_gemm":
            extra["device_ms"] = launch_us(torch, lambda: fn(*args), key="w4_gemm_kernel") / 1e3
        plain_ms = timer(lambda: plain(*args), reps=5, warmup=1)
        s_bytes = sc[1].numel() * sc.element_size() * (1 if f32 else 2)
        nbytes = qw[1].numel() * 4 + s_bytes + M * Kf * 2 + M * Np * (4 if f32 else 2)
        b_ms, b_by = bound(nbytes, 2.0 * M * Kf * Np)
        rows.append(dict(kernel=kname, case=f"{pname} K={Kf} N={Np} M={M} g={g}" + (" f32 scales" if f32 else ""),
                         max_abs_err=err, **extra, ok=bool(ok), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"{kname} g={g} M={M}: {rows[-1]}")
        del x, sc, w, y
        torch.cuda.empty_cache()
    return rows


def int8_cache(torch, gen, shape):
    """An int8 K/V cache of ``shape`` with U(0.005, 0.02) f32 scales, on the card."""
    kc = torch.randint(-127, 128, shape, dtype=torch.int8, device=DEV, generator=gen)
    vc = torch.randint(-127, 128, shape, dtype=torch.int8, device=DEV, generator=gen)
    ks = torch.rand(shape[:-1], device=DEV, generator=gen) * 0.015 + 0.005
    vs = torch.rand(shape[:-1], device=DEV, generator=gen) * 0.015 + 0.005
    return kc, vc, ks, vs


def body_rows(torch, timer, gen):
    """The decode attention body (K3b, K22, K21, K6) at multi-query
    geometries, the batch-invariance check and the split-length A/B."""
    rows = []
    for shape in MQA:
        rows.extend(mqa_rows(torch, timer, gen, shape))
        torch.cuda.empty_cache()
    batch_invariance_check(torch, gen)
    split_ab(torch, timer, gen)
    torch.cuda.empty_cache()
    return rows


def mqa_rows(torch, timer, gen, shape):
    """K3b, K22, K21 and K6 at one MQA shape (one kv head, lengths drawn in
    [S / 2, S]), each against its plain version within one bf16 ulp of
    max|plain| (K21 as partial_check). The library call is SDPA with
    enable_gqa on the dequantized cache (K6: with the ring rows and the
    current token appended, masked per sequence); none for K21."""
    from qllm_tpu_torch.ops import attention as att

    name, B, H, Hkv, D, S = shape
    n_rep = H // Hkv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kc, vc, ks, vs = int8_cache(torch, gen, (1, B, Hkv, S, D))
    q = torch.randn((B, H, D), device=DEV, generator=gen).to(torch.bfloat16)
    lengths = torch.randint(S // 2, S + 1, (B,), dtype=torch.int32, device=DEV, generator=gen)
    pos = lengths - 1  # the ring step's past tokens
    rk = torch.randn((1, B, Hkv, att.RING, D), device=DEV, generator=gen).to(torch.bfloat16)
    rv = torch.randn((1, B, Hkv, att.RING, D), device=DEV, generator=gen).to(torch.bfloat16)
    k_new = torch.randn((B, Hkv, D), device=DEV, generator=gen).to(torch.bfloat16)
    v_new = torch.randn((B, Hkv, D), device=DEV, generator=gen).to(torch.bfloat16)
    kd = (kc[0].float() * ks[0][..., None]).to(torch.bfloat16)
    vd = (vc[0].float() * vs[0][..., None]).to(torch.bfloat16)
    col = torch.arange(S, device=DEV)[None, :]
    mask = (col < lengths[:, None])[:, None, None, :]
    flushed = pos // att.RING * att.RING
    ring_mask = torch.cat([col < flushed[:, None], torch.arange(att.RING, device=DEV)[None, :] < (pos - flushed)[:, None],
                           torch.ones((B, 1), dtype=torch.bool, device=DEV)], dim=1)[:, None, None, :]
    ring_keys = torch.cat([kd, rk[0], k_new[:, :, None]], dim=2)
    ring_vals = torch.cat([vd, rv[0], v_new[:, :, None]], dim=2)
    qs = q[:, :, None, :]
    mine, theirs = [rk.clone(), rv.clone()], [rk.clone(), rv.clone()]
    kernels = {
        "decode_attn_int8": (att.decode_attn_int8, att.decode_attn_int8_plain, (q, kc, vc, ks, vs, lengths, 0),
                             lambda: sdpa(qs, kd, vd, attn_mask=mask, enable_gqa=True)),
        "decode_attn_int8_4d": (att.decode_attn_int8_4d, att.decode_attn_int8_4d_plain,
                                (q, kc[0], vc[0], ks[0], vs[0], lengths),
                                lambda: sdpa(qs, kd, vd, attn_mask=mask, enable_gqa=True)),
        "decode_attn_int8_partial": (att.decode_attn_int8_partial, att.decode_attn_int8_partial_plain,
                                     (q, kc, vc, ks, vs, lengths, 0), None),
        "decode_attention_ring": (lambda *a: att.decode_attention_ring(*a[:7], *mine, *a[7:]),
                                  lambda *a: att.decode_attention_ring_plain(*a[:7], *theirs, *a[7:]),
                                  (q, k_new, v_new, kc, vc, ks, vs, pos, 0),
                                  lambda: sdpa(qs, ring_keys, ring_vals, attn_mask=ring_mask, enable_gqa=True)),
    }
    rows = []
    for kernel, (fn, plain, args, lib) in kernels.items():
        ring = kernel == "decode_attention_ring"
        got = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        if kernel == "decode_attn_int8_partial":
            fields, ok = partial_check(got, ref)
        else:
            err, tol = float((got - ref).abs().max()), bf16_ulp(ref)
            ok = err <= tol and (not ring or all(torch.equal(a, b) for a, b in zip(mine, theirs)))
            fields = dict(max_abs_err=err, tol=f"one bf16 ulp of max|plain| ({tol:.4g})" + (", rings bit-equal" if ring else ""))
        del got, ref
        ms = timer(lambda: fn(*args))
        plain_ms = timer(lambda: plain(*args), reps=5, warmup=1)
        lib_ms = timer(lib) if lib is not None else None
        n_rows = int((flushed if ring else lengths).sum()) * Hkv
        nbytes = n_rows * (2 * D + 8) + q.numel() * 2 + q.numel() * 4 + B * 4
        if kernel == "decode_attn_int8_partial":
            nbytes += 2 * B * H * 4
        if ring:  # the ring rows, this step's k / v and the slot written
            nbytes += int((pos - flushed).sum()) * Hkv * 4 * D + 2 * B * Hkv * D * 2 * 2
        b_ms, b_by = bound(nbytes, 4.0 * (n_rows + (B * Hkv * att.RING if ring else 0)) * D * n_rep)
        rows.append(dict(kernel=kernel, case=f"{name} B={B} H={H} Hkv={Hkv} D={D} S={S} lengths "
                         f"{int(lengths.min())}-{int(lengths.max())}" + (" (pos = lengths - 1)" if ring else ""),
                         **fields, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, **tile_cost(ms, pos if ring else lengths, n_rep, Hkv, ring=ring,
                                                   fn=lambda: fn(*args))))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"{kernel} at {name}: {fields}")
    return rows


def batch_invariance_check(torch, gen):
    """A sequence's K3b and K6 outputs are bit-equal whether it is decoded
    in a batch of 8 or alone: lengths around and past split edges at
    Mixtral's attention geometry (8 kv heads, n_rep 4, head 128); and the
    planar GEMVs' (K1, K17, K11) M = 8 rows equal those rows of an M = 32
    launch."""
    from qllm_tpu_torch.ops import attention as att

    C, S, B, Hkv, n_rep, D = att.SPLIT_KEYS, 4096, 8, 8, 4, 128
    cache = int8_cache(torch, gen, (1, B, Hkv, S, D))
    q = torch.randn((B, Hkv * n_rep, D), device=DEV, generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([min(n, S) for n in (1, C - 1, C, C + 1, 3 * C + 17, 5 * C, 16 * C, S)],
                           dtype=torch.int32, device=DEV)
    rk, rv = (torch.randn((1, B, Hkv, att.RING, D), device=DEV, generator=gen).to(torch.bfloat16) for _ in range(2))
    k_new, v_new = (torch.randn((B, Hkv, D), device=DEV, generator=gen).to(torch.bfloat16) for _ in range(2))
    pos = lengths - 1
    full = att.decode_attn_int8(q, *cache, lengths, 0)
    full_ring = att.decode_attention_ring(q, k_new, v_new, *cache, rk.clone(), rv.clone(), pos, 0)
    same = same_ring = True
    for b in range(B):
        one = [t[:, b : b + 1].contiguous() for t in cache]
        alone = att.decode_attn_int8(q[b : b + 1], *one, lengths[b : b + 1], 0)
        same = same and bool(torch.equal(alone, full[b : b + 1]))
        rings = [rk[:, b : b + 1].clone(), rv[:, b : b + 1].clone()]
        alone = att.decode_attention_ring(q[b : b + 1], k_new[b : b + 1], v_new[b : b + 1], *one, *rings,
                                          pos[b : b + 1], 0)
        same_ring = same_ring and bool(torch.equal(alone, full_ring[b : b + 1]))
    log(f"[kernel] " + json.dumps(dict(check="batch-8 against batch-1 launches, bit for bit", split_keys=C,
                                        lengths=lengths.tolist(), decode_attn_int8=same,
                                        decode_attention_ring=same_ring)))
    if not (same and same_ring):
        raise AssertionError(f"batch invariance: K3b {same}, K6 {same_ring}")
    # K1 (with and without the norm), K17 and K11 (with and without the
    # norm) at the 7B gate|up: the rows of an M = 8 launch against the same
    # rows of an M = 32 launch
    from qllm_tpu_torch.ops import qmm, qmm_planar

    Kf, Np = next((Kf, -(-N // 512) * 512) for name, Kf, N in PROJECTIONS if name == "gateup")
    qw = torch.randint(-(2**31), 2**31, (2, Kf // 8, Np), dtype=torch.int32, device=DEV, generator=gen)
    sc = (torch.rand((2, Kf // 128, Np), device=DEV, generator=gen) + 0.5) * 0.01
    sb, zs = sc.to(torch.bfloat16), (sc * 8.0).to(torch.bfloat16)
    nw = (torch.rand((2, Kf), device=DEV, generator=gen) + 0.5).to(torch.bfloat16)
    x = torch.randn((32, Kf), device=DEV, generator=gen).to(torch.bfloat16)
    gemv = {"w4_planar_gemv": lambda xs: qmm.w4_planar_gemv(xs, qw, sb, zs, 1),
            "w4_planar_gemv +norm": lambda xs: qmm.w4_planar_gemv(xs, qw, sb, zs, 1, nw, 1e-5),
            "w4_planar_f32s_gemv": lambda xs: qmm_planar.w4_planar_f32s_gemv(xs, qw, sc, 1),
            "w4a8_planar_gemv": lambda xs: qmm.w4a8_planar_gemv(xs, qw, sb, zs, 1),
            "w4a8_planar_gemv +norm": lambda xs: qmm.w4a8_planar_gemv(xs, qw, sb, zs, 1, nw, 1e-5)}
    rows = {name: bool(torch.equal(fn(x[:8]), fn(x)[:8])) for name, fn in gemv.items()}
    log(f"[kernel] " + json.dumps(dict(check="M=8 rows against the rows of an M=32 launch, bit for bit",
                                        shape=f"gateup K={Kf} N={Np}", **rows)))
    if not all(rows.values()):
        raise AssertionError(f"batch invariance of the planar GEMVs: {rows}")


def split_ab(torch, timer, gen):
    """The split length C of the decode body, A/B'd in turns (each C, then
    each again in reverse order) at K3b's S = 16384, K22's Llama-2-7B, K21's
    32768-row and K6's pos-571 shapes, by event pairs and by the device
    time of a launch; each C's output first held against the plain version
    within one bf16 ulp (K21: partial_check)."""
    from qllm_tpu_torch.ops import attention as att

    shapes = []
    L, B, Hkv, S, D, n_rep = (LONG_ATTN_SHAPE[k] for k in ("L", "B", "Hkv", "S", "D", "n_rep"))
    cache = int8_cache(torch, gen, (L, B, Hkv, S, D))
    q = torch.randn((B, Hkv * n_rep, D), device=DEV, generator=gen).to(torch.bfloat16)
    full = torch.full((B,), S, dtype=torch.int32, device=DEV)
    shapes.append(("decode_attn_int8", f"S={S} B={B} Hkv={Hkv} n_rep={n_rep}", att.decode_attn_int8,
                   att.decode_attn_int8_plain, (q, *cache, full, 0), (full, n_rep, Hkv, False)))
    _, B, H, Hkv, D, S, _, _ = ATTN_4D[0]
    cache4 = int8_cache(torch, gen, (B, Hkv, S, D))
    q4 = torch.randn((B, H, D), device=DEV, generator=gen).to(torch.bfloat16)
    full4 = torch.full((B,), S, dtype=torch.int32, device=DEV)
    shapes.append(("decode_attn_int8_4d", f"Llama-2-7B S={S} B={B} Hkv={Hkv}", att.decode_attn_int8_4d,
                   att.decode_attn_int8_4d_plain, (q4, *cache4, full4), (full4, H // Hkv, Hkv, False)))
    B, Hkv, n_rep, D, S = (SP[k] for k in ("B", "Hkv", "n_rep", "D", "S"))
    cache21 = int8_cache(torch, gen, (1, B, Hkv, S, D))
    q21 = torch.randn((B, Hkv * n_rep, D), device=DEV, generator=gen).to(torch.bfloat16)
    full21 = torch.full((B,), S, dtype=torch.int32, device=DEV)
    shapes.append(("decode_attn_int8_partial", f"S={S} B={B} Hkv={Hkv} n_rep={n_rep}", att.decode_attn_int8_partial,
                   att.decode_attn_int8_partial_plain, (q21, *cache21, full21, 0), (full21, n_rep, Hkv, False)))
    L, B, Hkv, S, D, p = (RING_SHAPE[k] for k in ("L", "B", "Hkv", "S", "D", "pos"))
    cache6 = int8_cache(torch, gen, (L, B, Hkv, S, D))
    q6 = torch.randn((B, Hkv, D), device=DEV, generator=gen).to(torch.bfloat16)
    kn, vn = (torch.randn((B, Hkv, D), device=DEV, generator=gen).to(torch.bfloat16) for _ in range(2))
    rings = [torch.randn((L, B, Hkv, att.RING, D), device=DEV, generator=gen).to(torch.bfloat16) for _ in range(2)]
    pos6 = torch.full((B,), p, dtype=torch.int32, device=DEV)
    ring_fn = lambda *a: att.decode_attention_ring(*a[:7], *[r.clone() for r in rings], *a[7:])  # noqa: E731
    ring_plain = lambda *a: att.decode_attention_ring_plain(*a[:7], *[r.clone() for r in rings], *a[7:])  # noqa: E731
    shapes.append(("decode_attention_ring", f"B={B} Hkv={Hkv} S={S} pos={p}", ring_fn, ring_plain,
                   (q6, kn, vn, *cache6, pos6, 1), (pos6, 1, Hkv, True)))
    keep = att.SPLIT_KEYS
    res = {}
    try:
        for C in SPLIT_AB + SPLIT_AB[::-1]:
            att.SPLIT_KEYS = C
            for kernel, case, fn, plain, args, (lens, n_rep, Hkv, ring) in shapes:
                entry = res.setdefault(f"{kernel} {case}", {}).setdefault(C, dict(ms=[]))
                if "ok" not in entry:
                    got, ref = fn(*args), plain(*args)
                    if kernel == "decode_attn_int8_partial":
                        _, entry["ok"] = partial_check(got, ref)
                    else:
                        entry["ok"] = float((got - ref).abs().max()) <= bf16_ulp(ref)
                    entry["tiles"] = walked_tiles(lens, n_rep, Hkv, ring=ring, split=C)
                    del got, ref
                entry["ms"].append(timer(lambda: fn(*args)))
                entry.setdefault("device_us", []).append(launch_us(torch, lambda: fn(*args)))
    finally:
        att.SPLIT_KEYS = keep
    log(f"[split-ab] " + json.dumps(res))
    bad = [(k, C) for k, per in res.items() for C, e in per.items() if not e["ok"]]
    if bad:
        raise AssertionError(f"split A/B: outputs outside one bf16 ulp at {bad}")


def gptq_rows(torch, timer, gen):
    """K9 / K10 on random GPTQ-order weights (fp16 scales, mid-range
    zeros, as the loaders give them) against their plain versions; the
    library time is torch.matmul on the pre-dequantized bf16 weight (after
    the same gather of x for the act-order row). Each
    row also gives a call's device time and the library call's
    (torch.profiler), since an event pair holds the wrapper's host time."""
    from qllm_tpu_torch.ops import qmm2d
    from qllm_tpu_torch.ops.ref_matmul import dequant_ref
    from qllm_tpu_torch.utils.testing import random_quantized_tensor

    rows = []
    fns = {"gptq_gemv": (qmm2d.gptq_gemv, qmm2d.gptq_gemv_plain), "gptq_gemm": (qmm2d.gptq_gemm, qmm2d.gptq_gemm_plain)}
    for kname, M, pname, Kf, N, bits, act_order in GPTQ_CASES:
        fn, plain = fns[kname]
        qt = random_quantized_tensor(gen, Kf, N, bits, 128)
        x = torch.randn((M, Kf), device=DEV, generator=gen).to(torch.bfloat16)
        w_args = (qt.qweight, qt.scales, qt.zeros, bits, 128)
        if act_order:  # the perm gathers x's columns first, inside qmatmul_2d
            perm = torch.randperm(Kf, generator=gen, device=DEV).to(torch.int32)
            qt = dataclasses.replace(qt, perm=perm)
            run = lambda: qmm2d.qmatmul_2d(x, qt)  # noqa: E731
            xp = x.index_select(1, perm.long())
            # the library call gathers x by the perm too (like for like)
            xl = lambda: torch.index_select(x, 1, perm.long())  # noqa: E731
        else:
            run = lambda: fn(x, *w_args)  # noqa: E731
            xp = x
            xl = lambda: x  # noqa: E731
        y = run()
        torch.cuda.synchronize()
        y_ref = plain(xp, *w_args)
        scale = float(y_ref.float().abs().max())
        err = float((y.float() - y_ref.float()).abs().max())
        ok = torch.allclose(y.float(), y_ref.float(), atol=QMM_TOL * scale, rtol=QMM_TOL)
        w = dequant_ref(qt, torch.bfloat16)
        lib_ms = timer(lambda: torch.matmul(xl(), w))
        lib_device_ms = launch_us(torch, lambda: torch.matmul(xl(), w), key="") / 1e3
        del w
        ms = timer(run)
        plain_ms = timer(lambda: plain(xp, *w_args), reps=5, warmup=1)
        nbytes = qt.qweight.numel() * 4 + 2 * qt.scales.numel() * qt.scales.element_size() + M * Kf * 2 + M * N * 2
        nbytes += Kf * 4 if act_order else 0
        b_ms, b_by = bound(nbytes, 2.0 * M * Kf * N)
        # a call's device time (K10: the group sums, the product and, for a
        # split launch, the segments' sum), beside the event pair
        dev = {"device_ms": launch_us(torch, run, key="") / 1e3, "library_device_ms": lib_device_ms}
        rows.append(dict(kernel=kname, case=f"{pname} K={Kf} N={N} M={M} {bits}-bit" + (" act-order" if act_order else ""),
                         max_abs_err=err, max_err_ulps_of_max=err / bf16_ulp(y_ref),
                         tol=f"atol {QMM_TOL}*{scale:.4g} rtol {QMM_TOL}", ok=bool(ok), ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **dev))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"{kname} {rows[-1]['case']}: max_abs_err {err} outside tolerance")
        del qt, x, y, y_ref
    torch.cuda.empty_cache()
    return rows


def a8_close(y, y_ref):
    """(max abs error, within one bf16 ulp of the plain version plus
    A8_TOL * max|plain|)."""
    import torch

    y, y_ref = y.float(), y_ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(y_ref.abs().clamp_min(2.0**-126))) - 7)
    err = (y - y_ref).abs()
    return float(err.max()), bool((err <= ulp + A8_TOL * y_ref.abs().max()).all())


def a8_rows(torch, timer, gen, stack, dequant):
    """K11 on planar stacks at the 7B gate|up and down shapes, K12 on
    GPTQ-order weights at the serve path's shapes, each against its plain
    version; the quantizer's x8 and sx against the plain quantizer's, bit
    for bit; K12's rows at M = 1 against the same rows inside M = 8. The
    library time is torch.matmul on the pre-dequantized bf16 weight; each
    row also gives both calls' device times (torch.profiler)."""
    from qllm_tpu_torch.ops import qmm, qmm2d
    from qllm_tpu_torch.ops.ref_matmul import dequant_ref
    from qllm_tpu_torch.utils.testing import random_quantized_tensor

    rows = []
    shapes = {name: (Kf, N) for name, Kf, N in PROJECTIONS}

    def record(kname, case, y, y_ref, quant_equal, run, plain, lib, nbytes, ops, extra=None):
        err, ok = a8_close(y, y_ref)
        ok = ok and quant_equal
        b_ms, b_by = bound(nbytes, ops, PEAK_INT8)
        # the prologue alone, without a norm (launched from K11's and K12's own entry points)
        extra = {**(extra or {}), "quantizer_ms": timer(lambda: qmm.quantize_rows_int8(x, 128))}
        # a call's device time (the quantizer prologue included) and the library's
        extra.update(device_ms=launch_us(torch, run, key="") / 1e3, library_device_ms=launch_us(torch, lib, key="") / 1e3)
        rows.append(dict(kernel=kname, case=case, max_abs_err=err, tol=f"1 bf16 ulp + {A8_TOL}*max|plain|",
                         x8_sx_bit_equal=quant_equal, ok=ok, ms=timer(run),
                         plain_ms=timer(plain, reps=5, warmup=1), library_ms=timer(lib), bound_ms=b_ms,
                         bound_by=b_by, **extra))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"{kname} {case}: max_abs_err {err}, x8/sx bit-equal {quant_equal}")

    def quant_equal(x, g):
        return all(bool(torch.equal(a, b)) for a, b in zip(qmm.quantize_rows_int8(x, g), qmm.quantize_rows_int8_plain(x, g)))

    for M, pname in A8_CASES:
        Kf, N = shapes[pname]
        Np = -(-N // 512) * 512
        qw, sc, zs = stack(Kf, Np)
        x = torch.randn((M, Kf), device=DEV, generator=gen).to(torch.bfloat16)
        w = dequant(qw, sc, zs, 1, Kf)
        # gate|up's input is RMS-normalised in K11's prologue on the main path
        for norm in (False, True) if pname == "gateup" else (False,):
            nw = (torch.rand((2, Kf), device=DEV, generator=gen) + 0.5).to(torch.bfloat16) if norm else None
            args = (x, qw, sc, zs, 1, nw, 1e-5)
            xin = qmm._rms_norm_rows(x, nw[1], 1e-5) if norm else x
            y = qmm.w4a8_planar_gemv(*args)
            torch.cuda.synchronize()
            nbytes = qw[1].numel() * 4 + 2 * sc[1].numel() * 2 + M * Kf * 2 + M * Np * 2 + (Kf * 2 if norm else 0)
            record("w4a8_planar_gemv", f"{pname} K={Kf} N={Np} M={M}" + (" +norm" if norm else ""), y,
                   qmm.w4a8_planar_gemv_plain(*args), quant_equal(xin, 128), lambda: qmm.w4a8_planar_gemv(*args),
                   lambda: qmm.w4a8_planar_gemv_plain(*args), lambda: torch.matmul(xin, w), nbytes,
                   2.0 * M * Kf * Np)
        del qw, sc, zs, w

    for M, pname, Kf, N, bits, act_order, sd in A8_GPTQ_CASES:
        qt = random_quantized_tensor(gen, Kf, N, bits, 128)
        if sd == "f32":
            qt = dataclasses.replace(qt, scales=qt.scales.float(), zeros=qt.zeros.float())
        x = torch.randn((M, Kf), device=DEV, generator=gen).to(torch.bfloat16)
        w_args = (qt.qweight, qt.scales, qt.zeros, bits, 128)
        extra = {}
        if act_order:  # the perm gathers x's columns first, inside qmatmul_2d
            perm = torch.randperm(Kf, generator=gen, device=DEV).to(torch.int32)
            qt = dataclasses.replace(qt, perm=perm)
            run = lambda: qmm2d.qmatmul_2d(x, qt, w4a8=True)  # noqa: E731
            xp = x.index_select(1, perm.long())
            # the library call gathers x by the perm too (like for like)
            lib = lambda: torch.matmul(torch.index_select(x, 1, perm.long()), w)  # noqa: E731
        else:
            run = lambda: qmm2d.gptq_w4a8_gemv(x, *w_args)  # noqa: E731
            xp = x
            lib = lambda: torch.matmul(x, w)  # noqa: E731
        y = run()
        torch.cuda.synchronize()
        if M >= 8 and not act_order:  # batch invariance: rows 0 and 5 alone
            extra["rows_alone_bit_equal"] = all(
                bool(torch.equal(qmm2d.gptq_w4a8_gemv(x[m : m + 1], *w_args)[0], y[m])) for m in (0, 5))
            if not extra["rows_alone_bit_equal"]:
                raise AssertionError(f"gptq_w4a8_gemv: a row alone differs from the same row at M={M} ({bits}-bit)")
        w = dequant_ref(qt, torch.bfloat16)
        nbytes = qt.qweight.numel() * 4 + 2 * qt.scales.numel() * qt.scales.element_size() + M * Kf * 2 + M * N * 2
        nbytes += Kf * 4 if act_order else 0
        record("gptq_w4a8_gemv", f"{pname} K={Kf} N={N} M={M} {bits}-bit" + (" act-order" if act_order else "")
               + (" f32 scales" if sd == "f32" else ""),
               y, qmm2d.gptq_w4a8_gemv_plain(xp, *w_args), quant_equal(xp, 128), run,
               lambda: qmm2d.gptq_w4a8_gemv_plain(xp, *w_args), lib, nbytes,
               2.0 * M * Kf * N, extra)
        del qt, w
    torch.cuda.empty_cache()
    return rows


def bf16_ulp(ref) -> float:
    """One bf16 ulp at the largest magnitude of ``ref``."""
    import math

    return 2.0 ** (math.floor(math.log2(float(ref.float().abs().max()))) - 7)


def walked_tiles(lengths, n_rep, Hkv, window=0, ring=False, split=None) -> int:
    """The 128-key tiles the decode attention body walks for these lengths:
    each split of SPLIT_KEYS rows from the tile holding its first valid row
    (in ring mode the flushed rows, lengths // 8 * 8), for every kv head and
    group of 8 query heads."""
    from qllm_tpu_torch.ops import attention as att

    C = split or att.SPLIT_KEYS
    tiles = 0
    for n in lengths.tolist():
        end = n // att.RING * att.RING if ring else n
        lo = max(n - window, 0) if window else 0
        for j in range(lo // C, (end - 1) // C + 1) if lo < end else ():
            tiles += -(-(min((j + 1) * C, end) - max(j * C, lo) // 128 * 128) // 128)
    return tiles * Hkv * -(-n_rep // 8)


def launch_us(torch, fn, reps: int = 20, key: str = "decode_attn_kernel") -> float:
    """The mean device time (us) of one call of fn over ``reps``
    back-to-back calls (torch.profiler, L2 warm), summed over the CUDA
    kernels whose name holds ``key`` (all of them for ""): an event pair
    around one call also holds the wrapper's host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    body = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and key in e.key]
    return sum(e.self_device_time_total for e in body) / reps


def tile_cost(ms, lengths, n_rep, Hkv, window=0, ring=False, split=None, fn=None):
    """A decode attention row's walked tiles and the SM-microseconds one
    costs: ms x the card's SMs / tiles (the body's first version walked
    each (b, kv head) in one block, at 34-40 us a tile); with ``fn``, also
    a launch's device time and the tile cost from it."""
    import torch

    tiles = walked_tiles(lengths, n_rep, Hkv, window, ring, split)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = dict(tiles=tiles, sm_us_per_tile=ms * 1e3 * sms / max(tiles, 1))
    if fn is not None:
        us = launch_us(torch, fn)
        out.update(device_us=us, device_sm_us_per_tile=us * sms / max(tiles, 1))
    return out


def fused_rows(torch, timer, gen, stack):
    """K19 at Qwen3-30B-A3B's batch-1 decode (8 experts of a 128-expert
    stack, one shared row) and K20 at the 7B's o_proj and gate|up (M = 1
    and 8), each against its plain version. No single PyTorch call computes
    either function (library_ms null); the yardstick is what the port runs
    without them: K8's two launches with the activation between them for
    K19, K1 on o_proj, the residual and K1 with the norm on gate|up for K20."""
    from qllm_tpu_torch.ops import qmm

    rows = []
    E, K1, K2, Np2, n = (K19_CASE[k] for k in ("E", "K1", "K2", "Np2", "n"))
    gq, gs, gz = stack(K1, 2 * K2, L=E)
    dq, ds, dz = stack(K2, Np2, L=E)
    ids = torch.randperm(E, generator=gen, device=DEV)[:n].to(torch.int32)
    x = torch.randn((1, K1), device=DEV, generator=gen).to(torch.bfloat16)
    args = (x, gq, gs, gz, dq, ds, dz, ids, K2, "silu", True)
    y = qmm.w4_grouped_fused_mlp(*args)
    torch.cuda.synchronize()
    y_ref = qmm.w4_grouped_fused_mlp_plain(*args)
    err = float((y.float() - y_ref.float()).abs().max())
    tol = bf16_ulp(y_ref)

    def two_launch():
        gu = qmm.w4_grouped_gemv(x, gq, gs, gz, ids, True).float()
        a = gu[:, :K2] * torch.sigmoid(gu[:, :K2]) * gu[:, K2 : 2 * K2]
        return qmm.w4_grouped_gemv(a.to(torch.bfloat16), dq, ds, dz, ids, False)

    yard_ms = timer(two_launch)
    ms = timer(lambda: qmm.w4_grouped_fused_mlp(*args))
    plain_ms = timer(lambda: qmm.w4_grouped_fused_mlp_plain(*args), reps=5, warmup=1)
    # a call's device time (all its kernels), K19's and the yardstick's
    device = dict(device_ms=launch_us(torch, lambda: qmm.w4_grouped_fused_mlp(*args), key="") / 1e3,
                  yardstick_device_ms=launch_us(torch, two_launch, key="") / 1e3)
    per_expert = gq[0].numel() * 4 + 2 * gs[0].numel() * 2 + dq[0].numel() * 4 + 2 * ds[0].numel() * 2
    nbytes = n * per_expert + x.numel() * 2 + n * Np2 * 2 + n * 4
    b_ms, b_by = bound(nbytes, 2.0 * n * (K1 * 2 * K2 + K2 * Np2))
    rows.append(dict(kernel="w4_grouped_fused_mlp", case=f"qwen3 K1={K1} K2={K2} N2={Np2} E={E} n={n} shared",
                     max_abs_err=err, tol=f"one bf16 ulp of max|plain| ({tol:.4g})", ok=err <= tol, ms=ms,
                     plain_ms=plain_ms, library_ms=None, yardstick="K8 gate|up, silu * up, K8 down",
                     yardstick_ms=yard_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, **device))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if err > tol:
        raise AssertionError(f"w4_grouped_fused_mlp: max_abs_err {err} > {tol}")
    del gq, gs, gz, dq, ds, dz, y, y_ref

    D, Kg = SEVEN_B["hidden_size"], SEVEN_B["intermediate_size"]
    Np = -(-2 * Kg // 512) * 512
    q1, s1, z1 = stack(D, D)
    q2, s2, z2 = stack(D, Np)
    nw = (torch.rand((2, D), device=DEV, generator=gen) + 0.5).to(torch.bfloat16)
    for M in K20_ROWS:
        x1 = torch.randn((M, D), device=DEV, generator=gen).to(torch.bfloat16)
        h = torch.randn((M, D), device=DEV, generator=gen) * 4.0
        args = (x1, h, q1, s1, z1, q2, s2, z2, nw, 1, 1e-5)
        hn, y2 = qmm.w4_pnp_gemv(*args)
        torch.cuda.synchronize()
        hn_ref, y2_ref = qmm.w4_pnp_gemv_plain(*args)
        err_hn = float((hn - hn_ref).abs().max())
        err_y2 = float((y2.float() - y2_ref.float()).abs().max())
        tol_hn, tol_y2 = HN_TOL * float(hn_ref.abs().max()), bf16_ulp(y2_ref)
        ok = err_hn <= tol_hn and err_y2 <= tol_y2

        def k1_pair():
            hn1 = h + qmm.w4_planar_gemv(x1, q1, s1, z1, 1).float()
            return qmm.w4_planar_gemv(hn1.to(torch.bfloat16), q2, s2, z2, 1, nw, 1e-5)

        yard_ms = timer(k1_pair)
        # a call's device time (all its kernels), K20's and the K1 pair's
        device = dict(device_ms=launch_us(torch, lambda: qmm.w4_pnp_gemv(*args), key="") / 1e3,
                      yardstick_device_ms=launch_us(torch, k1_pair, key="") / 1e3)
        ms = timer(lambda: qmm.w4_pnp_gemv(*args))
        plain_ms = timer(lambda: qmm.w4_pnp_gemv_plain(*args), reps=5, warmup=1)
        nbytes = (q1[1].numel() * 4 + 2 * s1[1].numel() * 2 + q2[1].numel() * 4 + 2 * s2[1].numel() * 2
                  + M * D * 2 + M * D * 4 + D * 2 + M * D * 4 + M * Np * 2)
        b_ms, b_by = bound(nbytes, 2.0 * M * (D * D + D * Np))
        rows.append(dict(kernel="w4_pnp_gemv", case=f"o_proj K={D} N={D} -> gate|up N={Np} M={M}",
                         max_abs_err=max(err_hn, err_y2), hn_max_abs_err=err_hn, y2_max_abs_err=err_y2,
                         tol=f"hn {HN_TOL} * max|plain| ({tol_hn:.4g}), y2 one bf16 ulp ({tol_y2:.4g})", ok=ok,
                         ms=ms, plain_ms=plain_ms, library_ms=None,
                         yardstick="K1 o_proj, + h, K1 gate|up with the norm", yardstick_ms=yard_ms, bound_ms=b_ms,
                         bound_by=b_by, bytes=nbytes, **device))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"w4_pnp_gemv M={M}: hn err {err_hn} (tol {tol_hn}), y2 err {err_y2} (tol {tol_y2})")
    return rows


def stream_row(torch, timer, gen):
    """K13 at the streaming ceiling's geometry: one pass over a layer of
    the [4, 512, 22016] stack (45.1 MB) against its plain version, bit for
    bit. Its time is stream_pass_seconds' (64 passes in one call, layers
    cycling): a single launch's event pair would also time the host's
    launch; the library time is torch.sum over the layer's words."""
    from qllm_tpu_torch.ops import stream_bench

    K, N, L = STREAM["K"], STREAM["N"], STREAM["L"]
    words = torch.randint(0, 255, (L, K // 8, N), dtype=torch.int32, device=DEV, generator=gen)
    out = stream_bench.stream_pass(words, 1)
    torch.cuda.synchronize()
    ref = stream_bench.stream_pass_plain(words, 1)
    mism = int((out != ref).sum())
    b_ms, b_by = bound(K * N // 2 + N * 4)
    row = dict(kernel="stream_pass", case=f"one pass over layer 1 of [{L}, {K // 8}, {N}] int32 words 0..254",
               max_abs_err=float(mism), tol="bit-exact column sums", ok=mism == 0,
               ms=stream_bench.stream_pass_seconds(words, iters=64) * 1e3,
               plain_ms=timer(lambda: stream_bench.stream_pass_plain(words, 1), reps=5, warmup=1),
               library_ms=timer(lambda: torch.sum(words[1], dim=0)), bound_ms=b_ms, bound_by=b_by)
    log(f"[kernel] {json.dumps(row)}")
    if mism:
        raise AssertionError(f"stream_pass: {mism} column sums differ")
    del words
    torch.cuda.empty_cache()
    return row


def k3b_long_check(att, args, lengths_at: int):
    """K3b against its plain version past 8192 rows within LONG_ATTN_TOL,
    and a control: K3b with every length cut by one 128-row tile must
    miss the same limit. Returns the fields to log and whether both held."""
    out = att.decode_attention(*args)
    ref = att.decode_attn_int8_plain(*args)
    err = float((out - ref).abs().max())
    limit = min(LONG_ATTN_TOL[0] * float(ref.abs().max()) + LONG_ATTN_TOL[1], bf16_ulp(ref))
    cut = list(args)
    cut[lengths_at] = args[lengths_at] - 128
    control_err = float((att.decode_attention(*cut) - ref).abs().max())
    fields = dict(max_abs_err=err, tol=f"min({LONG_ATTN_TOL[0]}*max|plain| + {LONG_ATTN_TOL[1]}, one bf16 ulp of "
                  f"max|plain|) = {limit:.4g}", control_one_tile_short_err=control_err)
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
    sp = stack_layer_params(params, scale_store_dtype=torch.bfloat16)
    sp["lm_head"] = prepare_lm_head(sp["lm_head"], scale_store_dtype=torch.bfloat16)
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
    busy = profile_decode(torch, sp, cfg, toks2[:, -1:].contiguous(), cache, T + STEPS,
                          sums={"k1": K1_KERNELS, "k3a": K3A_KERNELS})
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
        params = random_quantized_params(cfg, 0, quantize_lm_head=True, device=DEV)
        sp = stack_layer_params(params, scale_store_dtype=torch.bfloat16)
        sp["lm_head"] = prepare_lm_head(sp["lm_head"], scale_store_dtype=torch.bfloat16)
        del params
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
    busy = profile_decode(torch, sp, cfg, toks2[:, -1:].contiguous(), cache, T + STEPS, steps=8,
                          sums={"k1": K1_KERNELS})
    # one more warm T_LONG prefill under the profiler: device ms by kernel
    log(f"[main1] profile of one warm T={T_LONG} prefill (ms, launches, kernel):")
    long_cache = make_cache(cfg, 1, T_LONG, device=DEV)
    prefill_profile = profile_run(torch, lambda: prefill(sp, cfg, prompt_long, long_cache, device=DEV), 1)
    del long_cache
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
        f"prefill_{T_LONG}_profile": prefill_profile,
        "repeat_run_same_ids": same,
    }
    log(f"[main1] {json.dumps(result)}")
    if not same:
        raise AssertionError("a second run on the same prompt decoded other ids")
    del sp, cache
    torch.cuda.empty_cache()
    return total


def phase_pnp(torch, K, model):
    """qmatmul_pnp_stacked (K20), the JAX package's ops-level entry point
    for o_proj -> residual + RMSNorm -> gate|up (no model path calls it,
    there or here), on the 7B's stacked o_proj, gate|up and
    post-attention norm weights for each of the 32 layers at batch 8,
    counts set to 0 before and read after; against K1 on o_proj, the
    residual and K1 with the norm on gate|up, and the time of both."""
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.ops import qmm
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    gen = torch.Generator(device=DEV)
    gen.manual_seed(15)
    if model is None:  # the main model's planar bf16 stacks, drawn at random
        cfg = ModelConfig(num_hidden_layers=MAIN["LAYERS"], **SEVEN_B)
        L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size

        def qt(K, N, Np):
            qw = torch.randint(-(2**31), 2**31, (L, K // 8, Np), dtype=torch.int32, device=DEV, generator=gen)
            sc = ((torch.rand((L, K // 128, Np), device=DEV, generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
            return QuantizedTensor(qweight=qw, scales=sc, zeros=(sc.float() * 8).to(torch.bfloat16), perm=None,
                                   bits=4, group_size=128, in_features=K, out_features=N, sym=False, planar=True,
                                   zeros_prefolded=True)

        layers = {"o_proj": qt(D, D, D), "gateup_proj": qt(D, 2 * I, -(-2 * I // 512) * 512),
                  "post_attention_layernorm": torch.ones((L, D), dtype=torch.bfloat16, device=DEV)}
    else:
        cfg, sp = model
        layers = sp["layers"]
    o, gu, nw = layers["o_proj"], layers["gateup_proj"], layers["post_attention_layernorm"]
    L, M, eps = cfg.num_hidden_layers, PNP["M"], cfg.rms_norm_eps
    if not qmm.pnp_stacked_ok(o, gu):
        raise AssertionError("pnp: the 7B's o_proj / gate|up stacks are not K20's")
    x1 = torch.randn((M, o.in_features), device=DEV, generator=gen).to(torch.bfloat16)
    h = torch.randn((M, o.out_features), device=DEV, generator=gen) * 4.0

    def fused():
        return [qmm.qmatmul_pnp_stacked(x1, h, o, gu, nw, l, eps) for l in range(L)]

    def two_launch():
        out = []
        for l in range(L):
            hn = h + qmm.qmatmul_stacked(x1, o, l).float()
            out.append((hn, qmm.qmatmul_stacked(hn.to(torch.bfloat16), gu, l, norm_w=nw, norm_eps=eps)))
        return out

    torch.cuda.synchronize()
    for fn in K.values():
        fn.launches = 0
    zero = counts(K)
    res = fused()
    torch.cuda.synchronize()
    total = counts(K)
    check_launches({"pnp": delta(zero, total)}, {"pnp": {"w4_pnp_gemv": L, "w4_planar_gemv": 0}})
    ref = two_launch()
    e_hn = max(float((a[0] - b[0]).abs().max() / b[0].abs().max()) for a, b in zip(res, ref))
    e_y2 = max(float((a[1].float() - b[1].float()).abs().max() / b[1].float().abs().max()) for a, b in zip(res, ref))
    finite = all(bool(torch.isfinite(a[1].float()).all()) for a in res)
    times = {}
    for name, fn in (("pnp", fused), ("two_launch", two_launch), ("pnp_again", fused)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / L
    out = {"config": f"Llama-2-7B shape, {L} layers, o_proj {o.in_features}->{o.out_features}, gate|up "
           f"{gu.in_features}->{gu.out_features}, M={M}", "hn_rel_err": e_hn, "y2_rel_err": e_y2,
           "pnp_ms_per_layer": times["pnp"], "pnp_ms_per_layer_again": times["pnp_again"],
           "two_launch_ms_per_layer": times["two_launch"], "launches": delta(zero, total)}
    log(f"[pnp] {json.dumps(out)}")
    if not finite or e_hn > PNP["HN_REL"] or e_y2 > PNP["Y2_REL"]:
        raise AssertionError(f"pnp: hn rel err {e_hn}, y2 rel err {e_y2}, finite {finite}")
    del res, ref
    torch.cuda.empty_cache()
    return total


def profile_decode(torch, sp, cfg, token, cache, pos0, steps: int = 4, w4a8: bool = False, moe_fused: bool = False,
                   watch=None, sums=None):
    """Device busy share of a few warm decode steps (torch.profiler, CUDA
    kernel time over host wall time) and the kernels that take it;
    ``watch`` and ``sums`` as profile_run's."""
    from qllm_tpu_torch.models.decode_loop import decode_loop

    return profile_run(
        torch, lambda: decode_loop(sp, cfg, token, cache, pos0, steps, device=DEV, w4a8=w4a8, moe_fused=moe_fused),
        steps, watch, sums,
    )


def watched(name):
    """profile_run's watch entry of a wrapper by its name: (the wrapper,
    its kernels by K8_KERNELS, K12_KERNELS or K9_KERNELS)."""
    from qllm_tpu_torch.ops import qmm, qmm2d

    return {"k8": (qmm.w4_grouped_gemv, K8_KERNELS), "gptq_w4a8_gemv": (qmm2d.gptq_w4a8_gemv, K12_KERNELS),
            "gptq_gemv": (qmm2d.gptq_gemv, K9_KERNELS)}[name]


def profile_run(torch, run, steps: int, watch=None, sums=None, tries: int = 3):
    """profile_decode's reading of ``run``, which takes ``steps`` steps;
    ``watch``: {name: (wrapper, {kernel name: (fewest, most) a launch})}
    whose kernels' device ms and count per step to report as well. The
    profiled kernels under each name must number between the fewest and the
    most times the wrapper's launches in the run (at least one), so that no
    other kernel of the same name is counted as the wrapper's. ``sums``:
    {name: kernel names} whose device ms per step to report without that
    count (K1_KERNELS). The profiler now and then loses a kernel's record
    (one in 516 to 2308 watched records, on the H100): a reading with
    fewer records than launches is logged and ``run`` profiled again, up
    to ``tries`` readings; one with more fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    watch = watch or {}
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        before = {name: fn.launches for name, (fn, _) in watch.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {name: fn.launches - before[name] for name, (fn, _) in watch.items()}
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        if busy_ms <= 0:
            return {"device_busy_share": "not measured"}
        short = []
        for name, (_, per_launch) in watch.items():
            n = launched[name]
            for key, (lo, hi) in per_launch.items():
                seen = sum(e.count for e in kernels if key in e.key)
                if n >= 1 and seen < lo * n and attempt < tries:
                    short.append(f"{seen} kernels named {key} for {n} launches of {name}")
                elif n < 1 or not lo * n <= seen <= hi * n:
                    raise AssertionError(f"profile: {seen} kernels named {key} for {n} launches of {name} "
                                         f"(between {lo} and {hi} a launch)")
        if not short:
            break
        log(f"[profile] reading {attempt} of {tries} lost records ({'; '.join(short)}): profiling again")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"[profile] {e.self_device_time_total / 1e3 / steps:9.3f} ms/step  x{e.count // steps:4d}  {e.key[:90]}")
    res = {
        "profiled_steps": steps,
        "profiled_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms,
        "profile_readings": attempt,
    }
    for name, (_, per_launch) in watch.items():
        mine = [e for e in kernels if any(k in e.key for k in per_launch)]
        res[f"{name}_device_ms_per_step"] = sum(e.self_device_time_total for e in mine) / 1e3 / steps
        res[f"{name}_kernels_per_step"] = sum(e.count for e in mine) / steps
        res[f"{name}_launches_per_step"] = launched[name] / steps
    for name, keys in (sums or {}).items():
        mine = [e for e in kernels if any(k in e.key for k in keys)]
        res[f"{name}_device_ms_per_step"] = sum(e.self_device_time_total for e in mine) / 1e3 / steps
    return res


def delta(a, b):
    return {k: b[k] - a.get(k, 0) for k in b}


def load_moe(torch, K, name, shape):
    """Random W4 g128 MoE params drawn on the card (raw [E]-stacked
    experts, one draw per leaf), hybrid-stacked for serving with bf16
    scales (the layout K8 and K19 take, as the JAX engine stacks), the
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
    sp = stack_layer_params_hybrid(params, scale_store_dtype=torch.bfloat16, consume=True)
    sp["lm_head"] = prepare_lm_head(sp["lm_head"], scale_store_dtype=torch.bfloat16)
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


@contextlib.contextmanager
def k8_ids_seen(seen, on=True):
    """Inside, the ids of every grouped matmul of the MoE blocks (each one
    K8 launch) go into ``seen``: the tensors themselves, no copy, so the
    device does no more work; K8's own wrapper and counter stay as they are."""
    from qllm_tpu_torch.models import moe

    fn = moe.qmatmul_grouped_experts
    if not on:
        yield seen
        return

    def recording(x_rows, w, ids, *args, **kwargs):
        seen.append(ids)
        return fn(x_rows, w, ids, *args, **kwargs)

    moe.qmatmul_grouped_experts = recording
    try:
        yield seen
    finally:
        moe.qmatmul_grouped_experts = fn


def k8_run_share(seen, steps):
    """Of K8's selections (the ids of its launches), those that rode another
    selection's block as a later row of a run (qmm.grouped_run_rows, the
    plan each block makes in the launch): the share whose expert was not
    streamed again."""
    from qllm_tpu_torch.ops import qmm

    n = sum(int(ids.numel()) for ids in seen)
    heads = sum(int((qmm.grouped_run_rows(ids.cpu()) > 0).sum()) for ids in seen)
    return {"k8_selections_per_step": n / steps, "k8_heads_per_step": heads / steps, "k8_non_head_share": 1 - heads / n}


def drive(torch, K, tag, cfg, sp, B, T, steps, max_seq, ring, expected, profile_steps=0, watch=None):
    """One model path: B prompts of T tokens prefilled into a fresh cache,
    then ``steps`` greedy steps, twice (cold, then warm). Launches are
    counted in the cold run, with every count set to 0 just before it;
    ``profile_steps`` warm steps profiled after (``watch``: profile_run's)."""
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
        seen = []
        with k8_ids_seen(seen, "k8" in (watch or {})):
            busy = profile_decode(torch, sp, cfg, toks2[:, -1:].contiguous(), cache, T + steps, steps=profile_steps,
                                  watch=watch)
        if seen:
            busy.update(k8_run_share(seen, profile_steps))
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


def check_no_sync(torch, tag, cfg, sp, B, moe_fused=False):
    """One sparse MoE block (router, sort, K8 twice, unsort, combine; K19
    once with ``moe_fused`` at batch 1; the per-selection matmuls on stacks
    K8 does not take) under set_sync_debug_mode("error"): any wait on the
    host raises."""
    from qllm_tpu_torch.models.llama import _moe_sparse
    from qllm_tpu_torch.models.stacked import StackedLayerView

    gen = torch.Generator(device=DEV)
    gen.manual_seed(12)
    x = torch.randn((B, 1, cfg.hidden_size), device=DEV, generator=gen).to(torch.bfloat16)
    pv = StackedLayerView(sp["layers"], cfg.num_hidden_layers - 1, cfg, moe_fused=moe_fused)
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
                           moe_expected(cfg, MOE["STEPS1"], 1, True), profile_steps=8, watch={"k8": watched("k8")})
    check_no_sync(torch, "moe b1", cfg, sp, 1)
    runs["moe_b8"] = drive(torch, K, "moe b8", cfg, sp, MOE["B"], MOE["T"], MOE["STEPS"], MOE["MAX_SEQ"], False,
                           moe_expected(cfg, MOE["STEPS"], MOE["B"], False))
    runs["moe_engine"] = moe_engine_leg(torch, K, cfg, sp)
    return runs


def moe_engine_leg(torch, K, cfg, sp):
    """The engine over the stacked Mixtral: 8 requests of 16-token prompts
    and 16 new tokens at max_batch 2, so decode takes the sparse branch
    (B * k < E: K8) beside K1 for the attention projections."""
    import numpy as np

    from qllm_tpu_torch.serve import ContinuousBatchingEngine, ServeConfig

    B, n_req, T, new = 2, 8, 16, 16
    rng = np.random.default_rng(18)
    for fn in K.values():
        fn.launches = 0
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(sp, cfg, ServeConfig(max_batch=B, max_seq=64), device=DEV)
    reqs = [engine.submit(rng.integers(0, cfg.vocab_size, T).astype(np.int32), new) for _ in range(n_req)]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = counts(K)
    if any(len(r.output) != new or not r.finished for r in reqs):
        raise AssertionError("moe engine: a request did not finish with its length")
    if total["w4_grouped_gemv"] == 0 or total["w4_planar_gemv"] == 0 or total["gptq_gemv"] or total["gptq_gemm"]:
        raise AssertionError(f"moe engine: launches {total}")
    log(f"[moe engine] {json.dumps({'requests': n_req, 'max_batch': B, 'prompt': T, 'new_tokens': new, 'wall_s': wall, 'generated_tok_s': n_req * new / wall, 'launches': total})}")
    return total


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
    # four more steps under the profiler (after the counted run)
    prof = profile_decode(torch, sp, cfg, toks[:, -1:].to(torch.int32).contiguous(), cache, P + STEPS,
                          sums={"k1": K1_KERNELS})
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
        **prof,
    }
    log(f"[long] {json.dumps(res)}")
    if not ok:
        raise AssertionError(f"long: K3b at S={S}: {fields}")
    del cache
    torch.cuda.empty_cache()
    return total


def _clone_cache(cache):
    return dataclasses.replace(
        cache, **{f: getattr(cache, f).clone() for f in ("k", "v", "k_scale", "v_scale", "ring_k", "ring_v")
                  if getattr(cache, f) is not None}
    )


def qwen3_fused_leg(torch, K, cfg, sp):
    """Batch 1 with the fused expert MLP (moe_fused=True, K19) against the
    two-launch leg (K8 twice a layer), both decoding FUSED["STEPS"] ring
    steps from one prefilled cache state (each from its own copy): the
    first step's logits within JAX's fused-vs-two-launch bound, launches
    counted, step and device time, greedy agreement (reported: the two
    round differently)."""
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import decode_step, make_cache, prefill
    from qllm_tpu_torch.ops import qmm

    T, MAX, STEPS, L = MOE["T1"], MOE["MAX1"], FUSED["STEPS"], cfg.num_hidden_layers
    gen = torch.Generator(device=DEV)
    gen.manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (1, T), dtype=torch.int32, device=DEV, generator=gen)
    logits, cache = prefill(sp, cfg, prompt, make_cache(cfg, 1, MAX, ring=True, device=DEV), device=DEV)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    la, _ = decode_step(sp, cfg, first, _clone_cache(cache), T, device=DEV)
    lb, _ = decode_step(sp, cfg, first, _clone_cache(cache), T, device=DEV, moe_fused=True)
    rel = float((lb - la).abs().max() / la.abs().max())
    legs = {}
    for name, fused in (("two_launch", False), ("fused", True), ("fused_warm", True)):
        c = _clone_cache(cache)
        torch.cuda.synchronize()
        for fn in K.values():
            fn.launches = 0
        t0 = time.perf_counter()
        toks, c = decode_loop(sp, cfg, first, c, T, STEPS, device=DEV, moe_fused=fused)
        torch.cuda.synchronize()
        legs[name] = (toks, (time.perf_counter() - t0) / STEPS * 1e3, counts(K), c)
    want = {"fused": {"w4_grouped_fused_mlp": L * STEPS, "w4_grouped_gemv": 0},
            "two_launch": {"w4_grouped_fused_mlp": 0, "w4_grouped_gemv": 2 * L * STEPS}}
    check_launches({k: legs[k][2] for k in want}, want)
    toks_f, c = legs["fused_warm"][0], legs["fused_warm"][3]
    busy = profile_decode(torch, sp, cfg, toks_f[:, -1:].contiguous(), c, T + STEPS, steps=8, moe_fused=True,
                          watch={"k19": (qmm.w4_grouped_fused_mlp, K19_KERNELS)})
    # the two-launch leg profiled on from its own state: K8's share of its step beside K19's of the fused one
    toks_t, ct = legs["two_launch"][0], legs["two_launch"][3]
    busy_t = profile_decode(torch, sp, cfg, toks_t[:, -1:].contiguous(), ct, T + STEPS, steps=8,
                            watch={"k8": watched("k8")})
    agree = float((legs["fused"][0] == legs["two_launch"][0]).float().mean())
    out = {"config": f"Qwen3-30B-A3B, {L} layers, B=1, T={T} ring prefill, {STEPS} steps each way from its cache",
           "first_step_logits_rel_err": rel, "rel_bound": FUSED["REL"],
           "two_launch_ms_per_step": legs["two_launch"][1], "fused_ms_per_step": legs["fused"][1],
           "fused_ms_per_step_warm": legs["fused_warm"][1], "greedy_agreement": agree,
           "fused_repeat_same_ids": bool(torch.equal(legs["fused"][0], toks_f)),
           "fused_launches_per_step": {k: v / STEPS for k, v in legs["fused"][2].items() if v}, **busy,
           **{f"two_launch_{k}": v for k, v in busy_t.items()}}
    log(f"[moe_qwen3 fused] {json.dumps(out)}")
    if not rel <= FUSED["REL"] or not out["fused_repeat_same_ids"]:
        raise AssertionError(f"moe_qwen3 fused: first-step logits rel err {rel}, "
                             f"repeat ids {out['fused_repeat_same_ids']}")
    total = {k: sum(leg[2][k] for leg in legs.values()) for k in K}
    del legs, cache, c, ct
    torch.cuda.empty_cache()
    check_no_sync(torch, "moe_qwen3 fused b1", cfg, sp, 1, moe_fused=True)
    return total


def phase_moe_qwen3(torch, K):
    """Qwen3-30B-A3B: batch 1 (flash prefill at n_rep 8, ring steps, K8
    shared row, 8 selections), the same with the fused expert MLP (K19),
    and batch 8 (64 sorted selections)."""
    cfg, sp, load = load_moe(torch, K, "Qwen3-30B-A3B", QWEN3)
    model = (cfg, sp)
    runs = {"qwen3_load": load}
    runs["qwen3_b1"] = drive(torch, K, "moe_qwen3 b1", cfg, sp, 1, MOE["T1"], MOE["STEPS1"], MOE["MAX1"], True,
                             moe_expected(cfg, MOE["STEPS1"], 1, True), profile_steps=8, watch={"k8": watched("k8")})
    check_no_sync(torch, "moe_qwen3 b1", cfg, sp, 1)
    runs["qwen3_fused"] = qwen3_fused_leg(torch, K, cfg, sp)
    runs["qwen3_b8"] = drive(torch, K, "moe_qwen3 b8", cfg, sp, MOE["B"], MOE["T"], MOE["STEPS"], MOE["MAX_SEQ"],
                             False, moe_expected(cfg, MOE["STEPS"], MOE["B"], False), profile_steps=4,
                             watch={"k8": watched("k8")})
    check_no_sync(torch, "moe_qwen3 b8", cfg, sp, MOE["B"])
    del model, sp
    torch.cuda.empty_cache()
    return runs


def cross_moe(torch, K):
    """2 layers at Mixtral and at Qwen3 width on the card and on the CPU:
    a short prompt (the dense expert loop), then sparse greedy steps, for
    each leg of CROSS_MOE: bf16 4-bit stacks through K8 (K19 with
    moe_fused), f32-scale and 2-bit stacks per selection (K8 never
    launches). Launches are counted on the card's steps."""
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.models.stacked import prepare_lm_head, stack_layer_params_hybrid
    from qllm_tpu_torch.utils.testing import random_quantized_params

    out = {}
    for name, shape, batches, T, steps, sd, bits, fused in CROSS_MOE:
        cfg = ModelConfig(**dict(shape, num_hidden_layers=CROSS["LAYERS"]))
        if max(batches) * cfg.num_experts_per_tok >= cfg.num_local_experts:
            raise AssertionError(f"cross {name}: B={max(batches)} would not take the sparse path")
        dtype = torch.bfloat16 if sd == "bf16" else torch.float32
        gpu = random_quantized_params(cfg, 2, bits=bits, quantize_lm_head=True, experts_prestacked=True, device=DEV)
        cpu = _to_cpu(gpu)
        sides = {}
        for side, params, dev in (("cuda", gpu, DEV), ("cpu", cpu, "cpu")):
            sp = stack_layer_params_hybrid(params, scale_store_dtype=dtype)
            sp["lm_head"] = prepare_lm_head(sp["lm_head"], scale_store_dtype=torch.bfloat16)
            sides[side] = (sp, dev)
        del gpu, cpu
        for B in batches:
            tag = f"{name} B={B}"
            out[tag] = cross_moe_leg(torch, K, tag, cfg, sides, B, T, steps, fused, sd == "bf16" and bits == 4)
        del sides
        torch.cuda.empty_cache()
    return out


def cross_moe_leg(torch, K, tag, cfg, sides, B, T, steps, fused, k8):
    """One batch of a cross_moe leg: the prompt and the steps on both
    sides, launches counted on the card's steps (K8 twice a layer a step
    where it takes the stacks, K19 once with ``fused``)."""
    from qllm_tpu_torch.models.generate import decode_step, make_cache, prefill

    gen = torch.Generator()
    gen.manual_seed(14)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32, generator=gen)
    logits, caches = {}, {}
    for side, (sp, dev) in sides.items():
        lg, caches[side] = prefill(sp, cfg, prompts, make_cache(cfg, B, T + steps, device=dev), device=dev)
        logits[side] = [lg.float().cpu()]
    tok = torch.argmax(logits["cuda"][0], dim=-1).to(torch.int32)[:, None]
    agree = [bool(torch.equal(tok, torch.argmax(logits["cpu"][0], -1).to(torch.int32)[:, None]))]
    torch.cuda.synchronize()
    for fn in K.values():
        fn.launches = 0
    for i in range(steps):
        for side, (sp, dev) in sides.items():
            lg, caches[side] = decode_step(sp, cfg, tok, caches[side], T + i, device=dev, moe_fused=fused)
            logits[side].append(lg.float().cpu())
        nxt = torch.argmax(logits["cuda"][-1], dim=-1).to(torch.int32)[:, None]
        agree.append(bool(torch.equal(nxt, torch.argmax(logits["cpu"][-1], -1).to(torch.int32)[:, None])))
        tok = nxt
    n = counts(K)
    L = cfg.num_hidden_layers
    launched = {"w4_grouped_gemv": n["w4_grouped_gemv"], "w4_grouped_fused_mlp": n["w4_grouped_fused_mlp"]}
    want = {"w4_grouped_gemv": 2 * L * steps if k8 and not fused else 0,
            "w4_grouped_fused_mlp": L * steps if fused else 0}
    if launched != want:
        raise AssertionError(f"cross {tag}: launches {launched}, expected {want}")
    if not k8:
        check_no_sync(torch, f"cross {tag}", cfg, sides["cuda"][0], B)
    errs = [float((a - b).abs().max()) for a, b in zip(logits["cuda"], logits["cpu"])]
    oks = [bool(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)) for a, b in zip(logits["cuda"], logits["cpu"])]
    res = {"B": B, "T": T, "steps": steps, "moe_fused": fused, "prefill_max_abs_err": errs[0],
           "decode_max_abs_err": max(errs[1:]), "greedy_agreement": sum(agree) / len(agree), "within_tol": all(oks),
           "launches": launched}
    if not all(oks) or not all(agree):
        raise AssertionError(f"cross {tag}: card vs CPU logits {errs}, greedy agreement {agree}")
    return res


def _to_cpu(node):
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_cpu(v) for v in node]
    if isinstance(node, QuantizedTensor):
        return node.map_arrays(lambda a: a.cpu())
    return node.cpu()


def cross_engine(torch, w4a8=False):
    """The engine on the card and on the CPU over 2 per-layer layers at
    7B width, layer 0 at 4 bits and layer 1 at 8 (mixed widths, which only
    the unstacked path holds): the same greedy tokens, and the first
    token's logits within LOGIT_TOL. With ``w4a8`` the 4-bit layer's
    decode-size matmuls take int8 activations (K12 on the card, its plain
    version on the CPU) and the 8-bit layer stays on K9. On the CPU a 2-D weight takes
    qmatmul_2d here, K9's and K10's plain versions, as on the card (by
    default the CPU runs qmatmul_ref, JAX's CPU route, which rounds the
    weights to bf16 where K9 keeps f32: 2 layers put their logits 0.375
    apart on the card). The weights are the serve model's
    (zero-mean, scale 0.004; the 8-bit layer's scale 16x smaller, for the
    same spread) and the lm_head columns of 8 tokens are scaled up 8x (as
    the CPU tests do) so that no greedy decision is close."""
    import numpy as np

    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.ops import _build, qmm2d
    from qllm_tpu_torch.serve import engine as mod
    from qllm_tpu_torch.utils.testing import random_quantized_params

    cfg = ModelConfig(num_hidden_layers=CROSS["LAYERS"], **SEVEN_B)
    scale = SERVE_MODEL["WEIGHT_SCALE"]
    gpu = random_quantized_params(cfg, 3, bits=4, quantize_lm_head=True, device=DEV, scale=scale, centered=True)
    gpu["layers"][1] = random_quantized_params(cfg, 4, bits=8, device=DEV, scale=scale / 16, centered=True)["layers"][1]
    rng = np.random.default_rng(19)
    cols = torch.from_numpy(rng.choice(cfg.vocab_size, 8, replace=False)).to(DEV)
    gpu["lm_head"].scales[:, cols] *= 8.0
    sides = {"cuda": gpu, "cpu": _to_cpu(gpu)}
    prompts = [rng.integers(0, cfg.vocab_size, CROSS["T"]).astype(np.int32) for _ in range(CROSS["B"])]
    outs, first = {}, {}
    use_kernel = _build.use_kernel
    card_launches = {}
    for side, params in sides.items():
        dev = DEV if side == "cuda" else "cpu"
        if side == "cpu":
            _build.use_kernel = lambda t, name: name == "qmatmul" or use_kernel(t, name)
        before = {k: getattr(qmm2d, k).launches for k in ("gptq_gemv", "gptq_w4a8_gemv")}
        try:
            engine = mod.ContinuousBatchingEngine(
                params, cfg, mod.ServeConfig(max_batch=2, max_seq=CROSS["MAX_SEQ"], w4a8=w4a8), device=dev)
            reqs = [engine.submit(p, CROSS["STEPS"]) for p in prompts]
            engine.run()
            outs[side] = [r.output for r in reqs]
            mini = engine._make_mini_cache(CROSS["T"])
            last, _ = mod._prefill_one(params, cfg, torch.from_numpy(prompts[0])[None].to(dev), mini, CROSS["T"],
                                       w4a8=w4a8)
            first[side] = last.float().cpu()
        finally:
            _build.use_kernel = use_kernel
        if side == "cuda":
            card_launches = {k: getattr(qmm2d, k).launches - n for k, n in before.items()}
    # every dispatch runs the 8-bit layer's K9; under w4a8 the 4-bit layer's K12 and nothing else small
    if card_launches["gptq_gemv"] == 0 or (card_launches["gptq_w4a8_gemv"] > 0) != w4a8:
        raise AssertionError(f"cross engine (w4a8={w4a8}): card launches {card_launches}")
    err = float((first["cuda"] - first["cpu"]).abs().max())
    ok = bool(torch.allclose(first["cuda"], first["cpu"], atol=LOGIT_TOL, rtol=LOGIT_TOL))
    rel = float((first["cuda"] - first["cpu"]).norm() / first["cpu"].norm())
    same = outs["cuda"] == outs["cpu"]
    res = {"layers": "4-bit, 8-bit", "w4a8": w4a8, "requests": CROSS["B"], "T": CROSS["T"],
           "new_tokens": CROSS["STEPS"], "card_launches": card_launches, "first_token_max_abs_err": err,
           "first_token_rel_err": rel, "within_tol": ok, "same_greedy_tokens": same}
    if (rel >= A8_MODEL_REL) if w4a8 else (not ok or not same):
        raise AssertionError(f"cross engine: card vs CPU {res}")
    return res


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
        sp = stack_layer_params(params, scale_store_dtype=torch.bfloat16)
        sp["lm_head"] = prepare_lm_head(sp["lm_head"], scale_store_dtype=torch.bfloat16)
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

    # batch 1 on a ring cache: a T=256 flash prefill, then ring-fused
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

    # W4A8: the plain-cache prefill again (a16, M = B * T > 32), then the
    # same steps with int8 activations: K11 on the card, its plain version
    # on the CPU; the greedy ids must agree at every step
    from qllm_tpu_torch.ops import qmm

    logits8, caches8 = {}, {}
    for name, (sp, dev) in sides.items():
        c = make_cache(cfg, B, MAX_SEQ, device=dev)
        lg, caches8[name] = prefill(sp, cfg, prompts, c, device=dev)
        logits8[name] = [lg.float().cpu()]
    a8_launches = 0
    tok = greedy(logits8["cuda"][0])
    agree8 = [bool(torch.equal(tok, greedy(logits8["cpu"][0])))]
    for i in range(STEPS):
        for name, (sp, dev) in sides.items():
            before = qmm.w4a8_planar_gemv.launches
            lg, caches8[name] = decode_step(sp, cfg, tok, caches8[name], T + i, device=dev, w4a8=True)
            logits8[name].append(lg.float().cpu())
            if name == "cuda":
                a8_launches += qmm.w4a8_planar_gemv.launches - before
        tok = greedy(logits8["cuda"][-1])
        agree8.append(bool(torch.equal(tok, greedy(logits8["cpu"][-1]))))
    if a8_launches != (4 * cfg.num_hidden_layers + 1) * STEPS:
        raise AssertionError(f"cross w4a8: K11 launched {a8_launches} times on the card")
    errs8 = [float((a - b).abs().max()) for a, b in zip(logits8["cuda"], logits8["cpu"])]
    oks8 = [bool(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)) for a, b in zip(logits8["cuda"], logits8["cpu"])]
    rels8 = [float((a - b).norm() / b.norm()) for a, b in zip(logits8["cuda"], logits8["cpu"])]
    res_engine = cross_engine(torch)
    res_engine8 = cross_engine(torch, w4a8=True)
    res = {
        "engine": res_engine,
        "engine_w4a8": res_engine8,
        "config": f"Llama-2-7B widths, {CROSS['LAYERS']} layers, card kernels vs CPU plain versions: "
        f"B={B}, T={T}, {STEPS} greedy steps on the plain int8 cache; B=1, T={T1} (flash), "
        f"{STEPS1} greedy steps on a ring cache",
        "prefill_max_abs_err": errs[0],
        "decode_max_abs_err": max(errs[1:]),
        "greedy_agreement": sum(agree) / len(agree),
        "ring_prefill_max_abs_err": errs1[0],
        "ring_decode_max_abs_err": max(errs1[1:]),
        "ring_greedy_agreement": sum(agree1) / len(agree1),
        "w4a8_decode_max_abs_err": max(errs8[1:]),
        "w4a8_decode_max_rel_err": max(rels8[1:]),
        "w4a8_within_tol": all(oks8),
        "w4a8_greedy_agreement": sum(agree8) / len(agree8),
        "tol": f"atol/rtol {LOGIT_TOL}; w4a8 rel {A8_MODEL_REL}",
        "within_tol": all(oks) and all(oks1),
    }
    log(f"[cross] {json.dumps(res)}")
    if not all(oks) or not all(oks1):
        raise AssertionError(f"card vs CPU logits outside tolerance: {errs} {errs1}")
    if not all(oks8) or max(rels8) >= A8_MODEL_REL or not all(agree8):
        raise AssertionError(f"cross w4a8: card vs CPU logits {errs8} (rel {rels8}), ids agree {agree8}")


# the serve path: the engine's configuration (ServeConfig defaults but
# these), the requests' seed and prefix length, the speculative leg's gamma
SERVE = dict(MAX_BATCH=8, MAX_SEQ=2048, PREFILL_CHUNK=256, LAYERS=32, SEED=20, PREFIX=200, GAMMA=4)
# the serve model's weight scale and its lm_head separation (SEPARATE
# tokens' columns scaled up by SEPARATE_BY, as tests/test_torch_serve.py
# does); see phase_serve
SERVE_MODEL = dict(WEIGHT_SCALE=0.004, CENTERED=True, SEPARATE=8, SEPARATE_BY=8.0)
# check_streams: the least share of greedy tokens that are a teacher-forced
# prefill's argmax, and the largest gap to its top as a share of |top| + 1
STREAM_EXACT = 0.85
STREAM_GAP = 0.4
SERVE_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
# prompt lengths of the 18 requests that are neither bucket-length nor
# prefix requests (4 of them sampled): one-shot admission below 256
# tokens (K9 at bucket 32, K10 above), chunked admission beyond
SERVE_LENGTHS = (16, 20, 31, 40, 77, 100, 150, 200, 256, 300, 420, 512, 640, 800, 1000, 1200, 1400, 1536)
SERVE_SUFFIXES = (24, 180, 300, 700)  # prefix requests: one suffix window, then chunked suffixes


def serve_requests(vocab):
    """The serve path's 24 requests from a fixed numpy seed, in submission
    order: (prompt, max_new_tokens, kind) with kind "bucket" (greedy, a
    prompt of exactly a bucket's length: no padding changes the prefill's
    M, so its tokens must equal greedy_generate's), "prefix" (greedy,
    extends the registered prefix), "sampled" or "greedy"; and the prefix."""
    import numpy as np

    rng = np.random.default_rng(SERVE["SEED"])
    prefix = rng.integers(0, vocab, SERVE["PREFIX"]).astype(np.int32)

    def toks(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    def new():
        return int(rng.integers(16, 97))

    reqs = [(toks(64), new(), "bucket"), (toks(128), new(), "bucket")]
    reqs += [(np.concatenate([prefix, toks(n)]), new(), "prefix") for n in SERVE_SUFFIXES]
    kinds = ["sampled"] * 4 + ["greedy"] * (len(SERVE_LENGTHS) - 4)
    for n, kind in zip(rng.permutation(np.array(SERVE_LENGTHS)), kinds):
        reqs.append((toks(int(n)), new(), kind))
    return [reqs[i] for i in rng.permutation(len(reqs))], prefix


class EngineProbe:
    """Counts, per engine dispatch, the kernel launches and the time (with
    a synchronize on each side) by wrapping the engine module's step
    functions, and holds every sampled token to its top-k / nucleus
    support by wrapping its sample_logits. ``restore`` undoes it."""

    STEPS = {"_batched_decode_step": "decode", "_batched_spec_step": "verify",
             "_prefill_one": "prefill", "_prefill_chunk": "prefill"}

    def __init__(self, torch, K, mod):
        self.torch, self.K, self.mod = torch, K, mod
        self.calls, self.sampled_rows, self.bad_rows = [], 0, 0
        self.orig = {n: getattr(mod, n) for n in (*self.STEPS, "sample_logits")}
        for name, kind in self.STEPS.items():
            setattr(mod, name, self._step(self.orig[name], kind))
        mod.sample_logits = self._sample

    def _step(self, fn, kind):
        torch = self.torch

        def wrapped(*a, **kw):
            tokens = a[2]
            M = tokens.shape[0] * (a[8] + 1) if kind == "verify" else tokens.numel()
            torch.cuda.synchronize()
            before, t0 = counts(self.K), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append(dict(kind=kind, M=M, ms=(time.perf_counter() - t0) * 1e3,
                                   launches=delta(before, counts(self.K))))
            return out

        return wrapped

    def _sample(self, logits, generator, t, k, p):
        torch = self.torch
        tok = self.orig["sample_logits"](logits, generator, t, k, p)
        lt = logits.float() / torch.clamp(t.float(), min=1e-6)[:, None]
        mine = torch.gather(lt, 1, tok.long()[:, None])
        above = lt > mine
        kk = torch.where(k > 0, k, torch.full_like(k, lt.shape[1]))
        mass_above = (torch.softmax(lt, dim=-1) * above).sum(dim=1)
        in_support = (above.sum(dim=1) < kk) & ((p >= 1.0) | (mass_above < p))
        ok = torch.where(t > 0, in_support, tok.long() == torch.argmax(logits.float(), dim=1))
        self.sampled_rows += int((t > 0).sum())
        self.bad_rows += int((~ok).sum())
        return tok

    def restore(self):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)

    def check_launches(self, layers, w4a8=False):
        """Every dispatch launched what its M says: a plain decode step 7L+1
        K9 (K12 under w4a8), L K3a and L K3b; a verify step 7L+1 K10; a
        prefill 7L+1 K9 / K12 (M <= 32) or K10, and L K5 from 256 rows on;
        nothing else."""
        n = 7 * layers + 1
        small = "gptq_w4a8_gemv" if w4a8 else "gptq_gemv"
        for c in self.calls:
            if c["kind"] == "decode":
                want = {small: n, "kv_write_int8": layers, "decode_attn_int8": layers}
            elif c["kind"] == "verify":
                want = {"gptq_gemm": n}
            else:
                want = {small if c["M"] <= 32 else "gptq_gemm": n, "flash_prefill": layers if c["M"] >= 256 else 0}
            bad = {k: v for k, v in c["launches"].items() if v != want.get(k, 0)}
            if bad:
                raise AssertionError(f"serve: a {c['kind']} dispatch at M={c['M']} launched {bad}, expected {want}")

    def summary(self, kind):
        ms = [c["ms"] for c in self.calls if c["kind"] == kind]
        return {"dispatches": len(ms), "median_ms": statistics.median(ms) if ms else None}


def serve_leg(torch, K, probe, mod, params, cfg, requests, prefix, speculative, w4a8=False):
    """One engine run over ``requests`` with the counts set to 0 just
    before it: (requests, totals, metrics)."""
    import numpy as np

    scfg = mod.ServeConfig(max_batch=SERVE["MAX_BATCH"], max_seq=SERVE["MAX_SEQ"], prefill_chunk=SERVE["PREFILL_CHUNK"],
                           speculative=speculative, spec_gamma=SERVE["GAMMA"], w4a8=w4a8)
    for fn in K.values():
        fn.launches = 0
    probe.calls = []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = mod.ContinuousBatchingEngine(params, cfg, scfg, device=DEV)
    pid = engine.register_prefix(prefix)
    sampled = mod.SamplingParams(**SERVE_SAMPLED)
    reqs = [engine.submit(p, n, sampling=sampled if kind == "sampled" else None,
                          prefix_id=pid if kind == "prefix" else None) for p, n, kind in requests]
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = counts(K)
    probe.check_launches(cfg.num_hidden_layers, w4a8)
    if len(done) != len(reqs) or any(len(r.output) != n for r, (_, n, _) in zip(reqs, requests)):
        raise AssertionError("serve: a request did not finish with its length")
    if any(t < 0 or t >= cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError("serve: a token id out of range")
    ttft = np.array([r.first_token_at - r.submitted_at for r in reqs]) * 1e3
    gen_tokens = sum(len(r.output) for r in reqs)
    res = {
        "requests": len(reqs),
        "generated_tokens": gen_tokens,
        "prompt_tokens": int(sum(len(p) for p, _, _ in requests)),
        "wall_s": wall,
        "generated_tok_s": gen_tokens / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p90": float(np.percentile(ttft, 90)),
        "decode_step": probe.summary("decode"),
        "verify_step": probe.summary("verify"),
        "prefill": probe.summary("prefill"),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if speculative:
        fw = sum(r.spec_forwards for r in reqs)
        res["spec_tokens_per_forward"] = sum(r.spec_emitted for r in reqs) / fw if fw else None
    return reqs, total, res


def stream_check(torch, params, cfg, prompt, out):
    """Teacher-forced reading of one greedy stream: one prefill over the
    prompt and the stream (K10 and flash prefill) gives the logits at
    every generated position; returns (positions where the stream's token
    is that prefill's argmax, positions, the largest gap to the top as a
    share of |top| + 1)."""
    from qllm_tpu_torch.models.generate import make_cache
    from qllm_tpu_torch.models.llama import forward

    ids = torch.tensor(list(prompt) + out[:-1], dtype=torch.int32, device=DEV)[None]
    with torch.no_grad():
        logits, _ = forward(params, cfg, ids, make_cache(cfg, 1, ids.shape[1], device=DEV), pos=0)
    lf = logits[0, len(prompt) - 1 :].float()
    top = lf.max(dim=-1).values
    mine = torch.gather(lf, 1, torch.tensor(out, device=DEV)[:, None].long())[:, 0]
    gap = top - mine
    return int((gap == 0).sum()), len(out), float((gap / (top.abs() + 1)).max())


def check_streams(torch, params, cfg, legs):
    """Both legs' greedy streams against teacher-forced prefills: at least
    STREAM_EXACT of the tokens are the prefill's argmax and none lies more
    than STREAM_GAP * (|top| + 1) below the top. Bit-exact agreement is
    not a property of this pair: a plain step runs K9 (f32 activations and
    weights) where verify and prefill run K10 (bf16, the TPU's M > 32
    rounding), and 32 random layers carry that difference to logits ~1 apart
    (measured on one H100: every stream of the speculative leg forked from
    the plain one, at gaps of 0-2.75 logits with tops of 5-24)."""
    stats = {}
    for name, pairs in legs.items():
        exact = total = 0
        worst = 0.0
        for prompt, out in pairs:
            e, n, w = stream_check(torch, params, cfg, prompt, out)
            exact, total, worst = exact + e, total + n, max(worst, w)
        stats[name] = {"argmax_share": exact / total, "tokens": total, "worst_gap_share": worst}
        if exact < STREAM_EXACT * total or worst > STREAM_GAP:
            raise AssertionError(f"serve: the {name} leg's streams disagree with teacher-forced prefills: {stats[name]}")
    return stats


def profile_engine(torch, mod, params, cfg, speculative, steps=4, w4a8=False):
    """profile_run over ``steps`` warm engine iterations with 8 greedy
    requests of 128 tokens in the slots: plain decode steps, or verify
    steps when ``speculative``; with the mean cache rows a step reads per
    slot (kv_rows_per_slot)."""
    import numpy as np

    engine = mod.ContinuousBatchingEngine(params, cfg, mod.ServeConfig(
        max_batch=SERVE["MAX_BATCH"], max_seq=SERVE["MAX_SEQ"], speculative=speculative, spec_gamma=SERVE["GAMMA"],
        w4a8=w4a8), device=DEV)
    rng = np.random.default_rng(SERVE["SEED"] + 1)
    for _ in range(SERVE["MAX_BATCH"]):
        engine.submit(rng.integers(0, cfg.vocab_size, 128).astype(np.int32), 96)
    for _ in range(3):  # admission and two warm iterations
        engine.step()
    log(f"[serve] profile of {'verify' if speculative else 'plain decode'} steps at batch {SERVE['MAX_BATCH']}"
        f"{' (w4a8)' if w4a8 else ''}:")
    rows0 = float(engine.positions.mean())

    def run():
        for _ in range(steps):
            engine.step()

    # a plain step of per-layer weights runs K9 (the tensor-core body and its
    # split sum) and nothing else there, under w4a8 K12: their device ms per step
    watch = {} if speculative else {"gptq_w4a8_gemv": watched("gptq_w4a8_gemv")} if w4a8 else {
        "gptq_gemv": watched("gptq_gemv")}
    res = profile_run(torch, run, steps, watch)
    # a step attends over rows [0, position]: the mean over the profiled steps
    res["kv_rows_per_slot"] = (rows0 + float(engine.positions.mean())) / 2 + 1
    return res


def serve_model(torch, cfg):
    """The serve path's per-layer W4 g128 params, drawn on the card with
    zero-mean weights (centered zeros) at scale 0.004, and the lm_head
    columns of 8 tokens scaled up 8x so that greedy picks among them with
    wide margins. With the helper's defaults (zeros at 2^(bits-1), scale
    0.01) every weight column has a mean of -0.5 * its scale, a common
    component grows down the residual stream, and every greedy stream is
    made of the two tokens whose lm_head columns sum highest and lowest,
    picked by the sign of a near-cancellation; each projection also
    triples the spread of its input, so attention is near-argmax (measured
    on one H100: a verify row came out 71.5 logits from a prefill of the same
    tokens, from layer 1's attention on)."""
    from qllm_tpu_torch.utils.testing import random_quantized_params

    m = SERVE_MODEL
    params = random_quantized_params(cfg, 5, bits=4, group_size=128, quantize_lm_head=True, device=DEV,
                                     scale=m["WEIGHT_SCALE"], centered=m["CENTERED"])
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SERVE["SEED"])
    cols = torch.randperm(cfg.vocab_size, device=DEV, generator=gen)[: m["SEPARATE"]]
    sc = params["lm_head"].scales
    sc[:, cols] = (sc[:, cols].float() * m["SEPARATE_BY"]).to(sc.dtype)
    return params


def phase_serve(torch, K, card):
    """The continuous-batching engine on a full-depth Llama-2-7B-shape
    per-layer W4 g128 model (not stacked: every matmul through K9 / K10):
    24 requests (bucket-length, prefix, sampled, greedy), then the greedy
    ones again with n-gram speculation; both legs' greedy streams are held
    to teacher-forced prefills (check_streams)."""
    from qllm_tpu_torch.models.generate import greedy_generate
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.serve import engine as mod

    cfg = ModelConfig(num_hidden_layers=SERVE["LAYERS"], **SEVEN_B)
    t0 = time.time()
    params = serve_model(torch, cfg)
    torch.cuda.synchronize()
    log(f"[serve] random per-layer W4 g128 params drawn on the card in {time.time() - t0:.2f} s")
    requests, prefix = serve_requests(cfg.vocab_size)
    probe = EngineProbe(torch, K, mod)
    runs = {}
    try:
        reqs, runs["serve"], res = serve_leg(torch, K, probe, mod, params, cfg, requests, prefix, False)
        log(f"[serve] plain leg, {card}: {json.dumps(res)}")
        if probe.bad_rows or probe.sampled_rows == 0:
            raise AssertionError(f"serve: {probe.bad_rows} of {probe.sampled_rows} sampled rows outside their support")
        # batch invariance: a bucket-length greedy request decoded at batch 8
        # gives greedy_generate's tokens at batch 1, bit for bit
        for (p, n, kind), r in zip(requests, reqs):
            if kind == "bucket":
                ref = greedy_generate(params, cfg, torch.from_numpy(p)[None], n, device=DEV)[0, len(p):].tolist()
                if r.output != ref:
                    first = next(i for i, (a, b) in enumerate(zip(r.output, ref)) if a != b)
                    raise AssertionError(f"serve: the {len(p)}-token request left greedy_generate at token {first}")
        greedy = [(q, r) for q, r in zip(requests, reqs) if q[2] != "sampled"]
        spec_reqs, runs["serve_spec"], res_spec = serve_leg(torch, K, probe, mod, params, cfg, [q for q, _ in greedy],
                                                            prefix, True)
        log(f"[serve] speculative leg (gamma {SERVE['GAMMA']}), {card}: {json.dumps(res_spec)}")
    finally:
        probe.restore()
    stats = check_streams(torch, params, cfg, {"plain": [(q[0], r.output) for q, r in greedy],
                                               "speculative": [(q[0], s.output) for (q, _), s in zip(greedy, spec_reqs)]})
    forks = [next((i for i, (a, b) in enumerate(zip(r.output, s.output)) if a != b), None)
             for (_, r), s in zip(greedy, spec_reqs)]
    log(f"[serve] greedy streams against teacher-forced prefills: {json.dumps(stats)}; speculative vs plain: "
        f"{forks.count(None)} of {len(forks)} identical, first differing token of the others {[f for f in forks if f is not None]}")
    log(f"[serve] sampled rows held to their support: {probe.sampled_rows}; bucket-length requests equal to "
        f"greedy_generate")
    # per-layer weights run K9 / K10 (the stream check's readings assume it)
    k2 = sum(r.get("w4_planar_gemm", 0) for r in runs.values())
    log(f"[serve] K2 (w4_planar_gemm) launches over both legs: {k2}")
    if k2:
        raise AssertionError(f"serve: {k2} K2 launches on per-layer weights")
    for speculative in (False, True):
        log(f"[serve] {'verify' if speculative else 'decode'} step profile: "
            f"{json.dumps(profile_engine(torch, mod, params, cfg, speculative))}")
    del params
    torch.cuda.empty_cache()
    return runs


def quantized_bytes(node) -> int:
    """Bytes of every packed word, scale and zero point in a params tree:
    what a decode step streams (dense leaves such as the embedding are not
    read whole)."""
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    if isinstance(node, dict):
        return sum(quantized_bytes(v) for v in node.values())
    if isinstance(node, list):
        return sum(quantized_bytes(v) for v in node)
    if isinstance(node, QuantizedTensor):
        return sum(t.numel() * t.element_size() for t in (node.qweight, node.scales, node.zeros))
    return 0


def kv_bytes(cfg, slots, rows) -> float:
    """Bytes a decode step reads from the int8 cache: k and v rows (head
    width int8 values and one f32 scale each) of every layer and kv head,
    ``rows`` per slot."""
    return 2.0 * cfg.num_hidden_layers * slots * cfg.num_key_value_heads * rows * (cfg.hd + 4)


def w4a8_decode(torch, K, cfg, sp, tag):
    """(a) bench.py's batch-32 decode leg (bench.py:653-691): one a16
    prefill of 32 x 128 tokens (K2), then 64 greedy steps with bf16
    activations (K1) and 64 from the same cache state with int8
    activations (K11). Held: the launches, and rows W4A8_ALONE decoded
    alone (batch 1, int8) from their cache rows giving the batch-32 int8
    stream token for token. Read, not held: each leg's stream against
    teacher-forced prefills as check_streams reads it (see phase_w4a8).
    Returns (counts, per-leg readings)."""
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import make_cache, prefill

    B, T, STEPS, MAX_SEQ = (W4A8[k] for k in ("B", "T", "STEPS", "MAX_SEQ"))
    L = cfg.num_hidden_layers
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32, device=DEV, generator=gen)
    for fn in K.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    cache = make_cache(cfg, B, MAX_SEQ, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(sp, cfg, prompts, cache, device=DEV)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check_launches({"prefill": counts(K)}, {"prefill": {"w4_planar_gemm": 4 * L + 1, "w4a8_planar_gemv": 0}})
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    fields = ("k", "v", "k_scale", "v_scale")
    snap = [getattr(cache, f).clone() for f in fields]
    wbytes = quantized_bytes(sp)
    legs, streams = {}, {}
    for a8 in (False, True):
        for f, t in zip(fields, snap):
            getattr(cache, f).copy_(t)
        before = counts(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, cache = decode_loop(sp, cfg, first, cache, T, STEPS, device=DEV, w4a8=a8)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per = delta(before, counts(K))
        n = (4 * L + 1) * STEPS
        check_launches({"decode": per}, {"decode": {
            "w4a8_planar_gemv": n if a8 else 0, "w4_planar_gemv": 0 if a8 else n,
            "kv_write_int8": L * STEPS, "decode_attn_int8": L * STEPS}})
        if tuple(toks.shape) != (B, STEPS) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError("w4a8: decoded ids out of range")
        name = "w4a8" if a8 else "w4a16"
        streams[name] = [(prompts[b].tolist(), [int(first[b, 0])] + toks[b].tolist()) for b in range(B)]
        busy = profile_decode(torch, sp, cfg, toks[:, -1:].contiguous(), cache, T + STEPS, w4a8=a8,
                              sums={"k11": K11_KERNELS} if a8 else {"k1": K1_KERNELS})
        legs[name] = {
            "decode_tok_s": B * STEPS / dt,
            "decode_ms_per_step": dt / STEPS * 1e3,
            "launches_per_step": {k: v / STEPS for k, v in per.items() if v},
            **busy,
            # the profiled steps attend over T + STEPS + 1 .. + 4 rows
            "bytes_per_step": wbytes + kv_bytes(cfg, B, T + STEPS + 2.5),
        }
    # batch invariance at full depth: rows decoded alone (batch 1) from the
    # same cache rows and first token give the batch-32 int8 stream's tokens
    alone = {}
    for b in W4A8_ALONE:
        c1 = make_cache(cfg, 1, MAX_SEQ, device=DEV)
        for f, t in zip(fields, snap):
            getattr(c1, f).copy_(t[:, b : b + 1])
        t1, _ = decode_loop(sp, cfg, first[b : b + 1], c1, T, STEPS, device=DEV, w4a8=True)
        ref = streams["w4a8"][b][1][1:]
        alone[b] = next((i for i, (x, y) in enumerate(zip(t1[0].tolist(), ref)) if x != y), None)
        del c1
    total = counts(K)
    reads = {}
    for name, pairs in streams.items():
        e, n, w = zip(*(stream_check(torch, sp, cfg, p, o) for p, o in pairs))
        reads[name] = {"argmax_share": sum(e) / sum(n), "tokens": sum(n), "worst_gap_share": max(w)}
    forks = [next((i for i, (a, b) in enumerate(zip(s16[1], s8[1])) if a != b), None)
             for s16, s8 in zip(streams["w4a16"], streams["w4a8"])]
    res = {
        "config": f"Llama-2-7B shape, {L} layers, W4 g128, {tag}, stacked; B={B}, T={T} prefill (a16), {STEPS} "
        f"greedy steps per leg from the same cache state",
        "prefill_ms": prefill_ms,
        "legs": legs,
        "streams_against_teacher_forced_prefills": reads,
        "int8_rows_alone_first_difference": alone,
        "rows_identical": forks.count(None),
        "first_fork_tokens": sorted(f for f in forks if f is not None),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"[w4a8] batch-{B} stacked decode, {tag}: {json.dumps(res)}")
    if any(v is not None for v in alone.values()):
        raise AssertionError(f"w4a8 ({tag}): a row decoded alone left the batch-{B} int8 stream: {alone}")
    del cache, snap
    torch.cuda.empty_cache()
    return total, legs


def w4a8_engine(torch, K, card, cfg, params):
    """(b) ServeConfig(w4a8=True) over the serve model's 20 greedy
    requests (the serve phase's, without the sampled ones): K12 in every
    decode step and bucket-32 prefill, K10 in longer prefills; the
    bucket-length requests equal greedy_generate(w4a8=True) at batch 1."""
    from qllm_tpu_torch.models.generate import greedy_generate
    from qllm_tpu_torch.serve import engine as mod

    requests, prefix = serve_requests(cfg.vocab_size)
    greedy = [q for q in requests if q[2] != "sampled"]
    probe = EngineProbe(torch, K, mod)
    try:
        reqs, total, res = serve_leg(torch, K, probe, mod, params, cfg, greedy, prefix, False, w4a8=True)
    finally:
        probe.restore()
    log(f"[w4a8] engine leg (ServeConfig(w4a8=True)), {card}: {json.dumps(res)}")
    for (p, n, kind), r in zip(greedy, reqs):
        if kind == "bucket":
            ref = greedy_generate(params, cfg, torch.from_numpy(p)[None], n, device=DEV, w4a8=True)[0, len(p):].tolist()
            if r.output != ref:
                first = next(i for i, (a, b) in enumerate(zip(r.output, ref)) if a != b)
                raise AssertionError(f"w4a8 engine: the {len(p)}-token request left greedy_generate at token {first}")
    log("[w4a8] bucket-length requests equal to greedy_generate(w4a8=True) at batch 1")
    wbytes = quantized_bytes(params)
    legs = {}
    for a8 in (False, True):
        busy = profile_engine(torch, mod, params, cfg, False, w4a8=a8)
        busy["bytes_per_step"] = wbytes + kv_bytes(cfg, SERVE["MAX_BATCH"], busy.pop("kv_rows_per_slot"))
        legs["engine_w4a8" if a8 else "engine_w4a16"] = busy
        log(f"[w4a8] engine decode step profile ({'w4a8' if a8 else 'w4a16'}): {json.dumps(busy)}")
    return total, legs


def phase_w4a8(torch, K, card, model):
    """W4A8: (c) the streaming ceiling; (a) the batch-32 stacked decode
    legs on the main model, and again on the serve model's weights,
    stacked; (b) the engine with int8 activations on the serve model;
    then each decode leg's device-time bandwidth (weight + KV bytes per
    step over device ms per step) as a share of the ceiling.

    The int8 streams are read against teacher-forced prefills, not held
    to check_streams' limits: those limits bound the rounding difference
    between bf16-activation paths, and int8 activations differ from bf16
    ones by far more than rounding (the JAX package states ~1% extra
    relative error a matmul), which 32 random layers carry to whole
    logits: on one H100 the serve model's bf16 stream holds the limits
    and its int8 stream does not, and on the main model's weights (every
    column's mean -0.5 * its scale, see serve_model) the bf16 stream
    already leaves them (readings in PERF.md). The int8 path is held
    instead by K11 / K12 against their plain versions, by the cross phase
    (card against CPU, int8 on both sides) and by batch invariance here
    and in the engine leg."""
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.models.stacked import prepare_lm_head, stack_layer_params
    from qllm_tpu_torch.ops.stream_bench import measure_stream_gbps

    if model is None:
        from qllm_tpu_torch.utils.testing import random_quantized_params

        cfg = ModelConfig(num_hidden_layers=MAIN["LAYERS"], **SEVEN_B)
        params = random_quantized_params(cfg, 0, quantize_lm_head=True, device=DEV)
        sp = stack_layer_params(params, scale_store_dtype=torch.bfloat16)
        sp["lm_head"] = prepare_lm_head(sp["lm_head"], scale_store_dtype=torch.bfloat16)
        del params
        model = (cfg, sp)
    runs = {}
    for fn in K.values():
        fn.launches = 0
    gbps = measure_stream_gbps(STREAM["K"], STREAM["N"], STREAM["L"], STREAM["ITERS"])
    runs["w4a8_stream"] = counts(K)
    check_launches({"stream": runs["w4a8_stream"]}, {"stream": {"stream_pass": STREAM["L"] + 3 * STREAM["ITERS"]}})
    ceiling = {"stream_gbps": gbps, "share_of_3.35_TB_s": gbps * 1e9 / PEAK_BYTES,
               "geometry": f"K={STREAM['K']} N={STREAM['N']} L={STREAM['L']}, {STREAM['K'] * STREAM['N'] // 2} bytes a pass"}
    log(f"[w4a8] streaming ceiling, {card}: {json.dumps(ceiling)}")
    runs["w4a8_decode"], legs = w4a8_decode(torch, K, *model, "main model")
    cfg = ModelConfig(num_hidden_layers=SERVE["LAYERS"], **SEVEN_B)
    params = serve_model(torch, cfg)  # per-layer, for the engine
    sp = stack_layer_params(params, scale_store_dtype=torch.bfloat16)
    sp["lm_head"] = prepare_lm_head(sp["lm_head"], scale_store_dtype=torch.bfloat16)
    runs["w4a8_decode_serve_model"], legs2 = w4a8_decode(torch, K, cfg, sp, "serve model's weights")
    del sp
    runs["serve_w4a8"], engine_legs = w4a8_engine(torch, K, card, cfg, params)
    del params
    torch.cuda.empty_cache()
    legs.update({f"{k}_serve_model": v for k, v in legs2.items()})
    legs.update(engine_legs)
    shares = {}
    for name, leg in legs.items():
        dev_ms = leg.get("device_busy_ms_per_step")
        if not isinstance(dev_ms, float):
            shares[name] = "not measured"
            continue
        bw = leg["bytes_per_step"] / (dev_ms / 1e3) / 1e9
        shares[name] = {"bytes_per_step": leg["bytes_per_step"], "device_ms_per_step": dev_ms,
                        "device_gbps": bw, "share_of_ceiling": bw / gbps,
                        "wall_ms_per_step": leg.get("decode_ms_per_step", leg.get("profiled_ms_per_step"))}
    log(f"[w4a8] decode legs' device-time bandwidth against the ceiling: {json.dumps(shares)}")
    return runs


# ---------------------------------------------------------------------------
# widths: stacked serving at 2, 3, 8 bits, act-order and non-planar 4-bit
# ---------------------------------------------------------------------------

# K14-K16 rows: (kernel, bits, scale storage, fused) at the 7B stacked
# projections, M = 1, 8, 32 at gate|up and down, M = 8 at qkv and lm_head,
# on a stack of STACK_L layers, layer 1 (its control: the plain version of
# layer 2)
STACKED_VARIANTS = (
    ("gptq_stacked_gemv", 2, "f32", False),  # v3
    ("gptq_stacked_gemv", 2, "bf16", True),  # v4
    ("gptq_stacked_w4a8_gemv", 2, "f32", False),
    ("bitplane_stacked_gemv", 3, "f32", False),
    ("bitplane_stacked_gemv", 3, "bf16", True),
    ("bitplane_stacked_gemv", 5, "bf16", True),
)
STACKED_PROJ = (("qkv", 4096, 12288), ("gateup", 4096, 22016), ("down", 11008, 4096), ("lm_head", 4096, 32000))
STACKED_TOL = 1e-2  # |y - plain| <= 1e-2 * max|plain| (tests/test_torch_qmm2d.py)
STACK_L = 4
# the widths legs: batch, prompt, steps, cache rows; batch-32 W4A8; the
# odd widths' batch-1 prompt (M = 32: K16 prefills, as JAX's chip can);
# depth of the short legs; depth of the card-vs-CPU cut and its prompt
WIDTHS = dict(B=8, T=128, STEPS=32, MAX_SEQ=192, LAYERS=32, SHORT_LAYERS=4, B_A8=32, T_ODD=32,
              CROSS_LAYERS=2, CROSS_B=2, CROSS_T=24)


# the widths legs' card-vs-CPU bound on ||card - cpu|| / ||cpu|| of the
# logits, with equal greedy ids. The plain versions round as the kernels
# do and only the f32 summation order differs, but across two layers of
# 7B width one-ulp bf16 flips of the activations put single logits of the
# 2-bit model 0.19-0.23 apart (rel 1.0-1.1%, one H100; LOGIT_TOL's
# elementwise 5e-2 is read, not held); a kernel that reads the wrong
# layer or group misses this by a factor of tens
WIDTHS_CROSS_REL = 3e-2


def widths_scale(bits: int) -> float:
    """The weight scale that gives a bits-wide model the serve model's
    weight spread: uniform words spread sqrt((4^bits - 1) / 12) steps."""
    std = lambda b: ((4.0**b - 1.0) / 12.0) ** 0.5  # noqa: E731
    return SERVE_MODEL["WEIGHT_SCALE"] * std(4) / std(bits)


def stacked_rows(torch, timer, gen):
    """K14, K15 and K16 at the 7B stacked shapes against their plain
    versions (1e-2 * max|plain|, the largest gap also in bf16 ulps of the
    plain output), with a control: the same kernel output against the
    plain version of the next layer must miss the limit. K14 and K16 also
    hold their tensor cores' rounding: fused (bf16) outputs within one bf16
    ulp of max|plain|; unfused (f32) outputs within F32S_TIGHT of
    max|plain|, which x @ the weight q * s rounded to bf16 first must miss.
    K15 also holds A8_TOL (a8_close: its s32 dots are exact).
    Library time: torch.matmul on the layer dequantized to bf16. Each
    reading also gives a call's device time (the split sum included) and
    the library call's, from torch.profiler."""
    from qllm_tpu_torch.ops import qmm, qmm_stacked as qs
    from qllm_tpu_torch.quant.qtensor import unpack_rows

    rows = []
    for kname, bits, sd, fused in STACKED_VARIANTS:
        dtype = torch.float32 if sd == "f32" else torch.bfloat16
        tight = kname != "gptq_stacked_w4a8_gemv"
        for pname, Kf, N in STACKED_PROJ:
            Np = -(-N // 512) * 512
            G = Kf // 128
            qw = torch.randint(-(2**31), 2**31, (STACK_L, Kf * bits // 32, Np), dtype=torch.int32, device=DEV,
                               generator=gen)
            sc = (torch.rand((STACK_L, G, Np), device=DEV, generator=gen) + 0.5) * widths_scale(bits)
            zs = (sc * ((1 << bits) / 2.0 - 0.5)).to(dtype)
            sc = sc.to(dtype)
            q = unpack_rows(qw[1], bits, Kf).float().reshape(G, 128, Np)
            w = (q * sc[1].float()[:, None] - zs[1].float()[:, None]).reshape(Kf, Np).to(torch.bfloat16)
            # the unfused control: the weight q * s rounded to bf16 first
            wq = (q * sc[1].float()[:, None]).reshape(Kf, Np).to(torch.bfloat16) if tight and not fused else None
            del q
            for M in ((1, 8, 32) if pname in ("gateup", "down") else (8,)):
                x = torch.randn((M, Kf), device=DEV, generator=gen).to(torch.bfloat16)
                if kname == "gptq_stacked_w4a8_gemv":
                    x8, _, _ = qmm.quantize_rows_int8(x, 128)
                    args = lambda layer: (x8, qw, sc, layer, bits, 128)  # noqa: E731
                else:
                    args = lambda layer: (x, qw, sc, zs, layer, bits, 128, fused)  # noqa: E731
                in_bytes = args(1)[0].numel() * args(1)[0].element_size()
                fn, plain = getattr(qs, kname), getattr(qs, kname + "_plain")
                y = fn(*args(1))
                torch.cuda.synchronize()
                ref = plain(*args(1)).float()
                yf = y.float()
                scale = float(ref.abs().max())
                err = float((yf - ref).abs().max())
                ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
                err_ulps = float(((yf - ref).abs() / ulp).max())
                control = float((yf - plain(*args(2)).float()).abs().max())
                limit = STACKED_TOL * scale
                ok = err <= limit < control
                extra = {}
                if not tight:  # K15: exact s32 dots, only the f32 order differs
                    _, a8_ok = a8_close(yf, ref)
                    extra = dict(a8_tol=f"1 bf16 ulp + {A8_TOL}*max|plain|", a8_ok=a8_ok)
                    ok = ok and a8_ok
                elif tight and fused:
                    extra = dict(tight_tol=f"one bf16 ulp: {bf16_ulp(ref):.4g}")
                    ok = ok and err <= bf16_ulp(ref)
                elif tight:
                    control_bf16 = float((torch.matmul(x.float(), wq.float()) - ref).abs().max())
                    extra = dict(tight_tol=f"{F32S_TIGHT}*{scale:.4g}", control_bf16_weight_err=control_bf16)
                    ok = ok and err <= F32S_TIGHT * scale < control_bf16
                ms = timer(lambda: fn(*args(1)))
                plain_ms = timer(lambda: plain(*args(1)), reps=5, warmup=1)
                lib_ms = timer(lambda: torch.matmul(x, w))
                device_ms = launch_us(torch, lambda: fn(*args(1)), key="") / 1e3
                lib_device_ms = launch_us(torch, lambda: torch.matmul(x, w), key="") / 1e3
                # the function's bytes: the layer's words and scales (and zs
                # when fused), x in, y out (bf16 fused, else f32)
                nbytes = (qw[1].numel() * 4 + sc[1].numel() * sc.element_size() * (2 if fused else 1)
                          + in_bytes + M * Np * (2 if fused else 4))
                b_ms, b_by = bound(nbytes, 2.0 * M * Kf * Np, PEAK_INT8 if "w4a8" in kname else PEAK_BF16)
                case = f"{pname} K={Kf} N={Np} M={M} {bits}-bit {sd} scales" + (" fused" if fused else "")
                rows.append(dict(kernel=kname, case=case, max_abs_err=err, max_err_bf16_ulps=err_ulps,
                                 tol=f"{STACKED_TOL}*{scale:.4g}", control_next_layer_err=control, **extra, ok=bool(ok),
                                 ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 library_device_ms=lib_device_ms, bound_ms=b_ms, bound_by=b_by))
                log(f"[kernel] {json.dumps(rows[-1])}")
                if not ok:
                    raise AssertionError(f"{kname} {case}: max_abs_err {err}, limit {limit}, control {control}, {extra}")
            del qw, sc, zs, w, wq
        torch.cuda.empty_cache()
    return rows


def widths_model(torch, bits, layers, scale_dtype, planar=True, act_order=False, seed=30):
    """A Llama-2-7B-shape model at ``bits`` g128 (quantized lm_head), drawn
    on the card with zero-mean weights at the serve model's spread and 8
    lm_head columns scaled up 8x (serve_model), stacked for serving with
    ``planar`` and ``scale_store_dtype`` (None: the stacking defaults)."""
    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.models.stacked import prepare_lm_head, stack_layer_params
    from qllm_tpu_torch.utils.testing import random_quantized_params

    cfg = ModelConfig(num_hidden_layers=layers, **SEVEN_B)
    params = random_quantized_params(cfg, seed, bits=bits, group_size=128, quantize_lm_head=True, device=DEV,
                                     scale=widths_scale(bits), centered=True, act_order=act_order)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    cols = torch.randperm(cfg.vocab_size, device=DEV, generator=gen)[: SERVE_MODEL["SEPARATE"]]
    sc = params["lm_head"].scales
    sc[:, cols] = (sc[:, cols].float() * SERVE_MODEL["SEPARATE_BY"]).to(sc.dtype)
    sd = {} if scale_dtype is None else {"scale_store_dtype": scale_dtype}
    sp = stack_layer_params(params, planar=planar, **sd)
    sp["lm_head"] = prepare_lm_head(sp["lm_head"], **sd)
    del params
    torch.cuda.synchronize()
    return cfg, sp


def stream_check_chunked(torch, params, cfg, prompt, out, chunk):
    """stream_check's teacher-forced reading in forwards of at most
    ``chunk`` rows on one cache (an odd-width stack serves M <= 32 on the
    card, as on JAX's chip)."""
    from qllm_tpu_torch.models.generate import make_cache
    from qllm_tpu_torch.models.llama import forward

    ids = torch.tensor(list(prompt) + out[:-1], dtype=torch.int32, device=DEV)[None]
    cache = make_cache(cfg, 1, ids.shape[1], device=DEV)
    parts = []
    with torch.no_grad():
        for p0 in range(0, ids.shape[1], chunk):
            lg, cache = forward(params, cfg, ids[:, p0 : p0 + chunk], cache, pos=p0)
            parts.append(lg[0])
    lf = torch.cat(parts)[len(prompt) - 1 :].float()
    top = lf.max(dim=-1).values
    mine = torch.gather(lf, 1, torch.tensor(out, device=DEV)[:, None].long())[:, 0]
    gap = top - mine
    return int((gap == 0).sum()), len(out), float((gap / (top.abs() + 1)).max())


def greedy_ids_agree(torch, card, cpu) -> bool:
    """Every row's greedy id on the card is a greedy id of the CPU's logits:
    the CPU's argmax, or an id whose CPU logit equals the CPU's row maximum
    (bf16 logits can tie exactly, and argmax then takes the lowest id, which
    no kernel's rounding can be held to)."""
    ids = card.argmax(-1)
    return bool((cpu.gather(-1, ids[..., None])[..., 0] == cpu.max(-1).values).all())


def widths_cross(torch, cfg, sp, B, T, w4a8):
    """The first steps card against CPU on the first CROSS_LAYERS layers of
    the same stacks: a prefill of B prompts of T tokens and one decode
    step, held to the CPU's greedy ids (greedy_ids_agree) and ||card -
    cpu|| / ||cpu|| below WIDTHS_CROSS_REL (W4A8's step: A8_MODEL_REL, as the cross phase's
    engine leg); LOGIT_TOL is read. The CPU runs every kernel's plain
    version, a 2-D fallback weight included (K9 / K10's, as cross_engine
    does)."""
    from qllm_tpu_torch.models.generate import decode_step, make_cache, prefill
    from qllm_tpu_torch.ops import _build
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    n = WIDTHS["CROSS_LAYERS"]
    cut = {k: (v.map_arrays(lambda a: a[:n]) if isinstance(v, QuantizedTensor) else v[:n])
           for k, v in sp["layers"].items()}
    cut = {**sp, "layers": cut}
    ccfg = dataclasses.replace(cfg, num_hidden_layers=n)
    gen = torch.Generator()
    gen.manual_seed(17)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32, generator=gen)
    use_kernel = _build.use_kernel
    logits = {}
    for side, params in (("cuda", cut), ("cpu", _to_cpu(cut))):
        dev = DEV if side == "cuda" else "cpu"
        if side == "cpu":
            _build.use_kernel = lambda t, name: name == "qmatmul" or use_kernel(t, name)
        try:
            cache = make_cache(ccfg, B, T + 8, device=dev)
            lg0, cache = prefill(params, ccfg, prompts, cache, device=dev)
            tok = torch.argmax(lg0.float().cpu(), dim=-1).to(torch.int32)[:, None] if side == "cuda" else tok
            lg1, _ = decode_step(params, ccfg, tok, cache, T, device=dev, w4a8=w4a8)
        finally:
            _build.use_kernel = use_kernel
        logits[side] = (lg0.float().cpu(), lg1.float().cpu())
    res = {}
    for i, name in enumerate(("prefill", "step")):
        a, b = logits["cuda"][i], logits["cpu"][i]
        res[f"{name}_max_abs_err"] = float((a - b).abs().max())
        res[f"{name}_rel_err"] = float((a - b).norm() / b.norm())
        res[f"{name}_within_tol"] = bool(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL))
        res[f"{name}_same_ids"] = greedy_ids_agree(torch, a, b)
    ok = (res["prefill_rel_err"] < WIDTHS_CROSS_REL and res["prefill_same_ids"]
          and (res["step_rel_err"] < A8_MODEL_REL if w4a8 else
               res["step_rel_err"] < WIDTHS_CROSS_REL and res["step_same_ids"]))
    return res, ok


def widths_leg(torch, K, tag, cfg, sp, B, T, steps, expected, w4a8=False, chunk=None, profile_prefill=False,
               watch=None, sums=None):
    """One widths leg: B prompts of T tokens prefilled (a16) into a fresh
    int8 cache and ``steps`` greedy steps (``w4a8`` as given), with every
    count set to 0 just before and the launches asserted; tok/s, the device
    busy share of 4 warm steps (with ``profile_prefill``, of a warm prefill
    too: its device ms by kernel), peak GiB; the streams against
    teacher-forced prefills (check_streams' limits; ``chunk``: in forwards
    of that many rows); and the first steps card against CPU on a cut of
    the stacks. ``watch``, ``sums``: kernels whose device ms a decode step
    the profile reports (profile_run's)."""
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import make_cache, prefill

    gen = torch.Generator(device=DEV)
    gen.manual_seed(21)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32, device=DEV, generator=gen)
    for fn in K.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    cache = make_cache(cfg, B, T + steps + 8, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(sp, cfg, prompts, cache, device=DEV)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    mark = counts(K)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    t0 = time.perf_counter()
    toks, cache = decode_loop(sp, cfg, first, cache, T, steps, device=DEV, w4a8=w4a8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = counts(K)
    per_phase = {"prefill": mark, "decode": delta(mark, total)}
    log(f"[widths] {tag}: launches per phase {json.dumps({p: {k: v for k, v in c.items() if v} for p, c in per_phase.items()})}")
    check_launches(per_phase, expected)
    lf = logits.float()
    if not bool(torch.isfinite(lf).all()) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"widths {tag}: logits not finite or ids out of range")
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = profile_decode(torch, sp, cfg, toks[:, -1:].contiguous(), cache, T + steps, steps=4, w4a8=w4a8, watch=watch,
                          sums=sums)
    del cache
    if profile_prefill:  # a warm prefill into a fresh cache, after the counts were read
        log(f"[widths] {tag}: warm prefill profile")
        busy["prefill"] = profile_run(
            torch, lambda: prefill(sp, cfg, prompts, make_cache(cfg, B, T + steps + 8, device=DEV), device=DEV), 1)
    streams = [(prompts[b].tolist(), [int(first[b, 0])] + toks[b].tolist()) for b in range(B)]
    if chunk is None:
        reads = [stream_check(torch, sp, cfg, p, o) for p, o in streams]
    else:
        reads = [stream_check_chunked(torch, sp, cfg, p, o, chunk) for p, o in streams]
    e, n, w = zip(*reads)
    stats = {"argmax_share": sum(e) / sum(n), "tokens": sum(n), "worst_gap_share": max(w)}
    cross, cross_ok = widths_cross(torch, cfg, sp, min(B, WIDTHS["CROSS_B"]), min(T, WIDTHS["CROSS_T"]), w4a8)
    res = {
        "config": f"Llama-2-7B shape, {cfg.num_hidden_layers} layers, {tag}; B={B}, T={T} prefill, {steps} "
        f"greedy steps" + (" (w4a8)" if w4a8 else ""),
        "prefill_ms": prefill_ms,
        "decode_tok_s": B * steps / dt,
        "decode_ms_per_step": dt / steps * 1e3,
        **busy,
        "peak_mem_gib": peak,
        "launches_per_step": {k: v / steps for k, v in per_phase["decode"].items() if v},
        "streams_against_teacher_forced_prefills": stats,
        f"card_vs_cpu_{WIDTHS['CROSS_LAYERS']}_layers": cross,
    }
    log(f"[widths] {tag}: {json.dumps(res)}")
    # int8 activations differ from bf16 by more than rounding: their streams
    # are read against the a16 prefills, not held (phase_w4a8)
    if not w4a8 and (stats["argmax_share"] < STREAM_EXACT or stats["worst_gap_share"] > STREAM_GAP):
        raise AssertionError(f"widths {tag}: streams outside the teacher-forced limits {stats}")
    if not cross_ok:
        raise AssertionError(f"widths {tag}: card vs CPU {cross}")
    torch.cuda.empty_cache()
    return total


def phase_widths(torch, K):
    """Stacked serving at every width on the 7B geometry (each leg through
    widths_leg): 2-bit g128 with f32 scales at full depth (prefill through
    the fallback's K10, decode through K14 v3), with bf16 scales (K14 v4)
    and under W4A8 at batch 32 (K15); 3-bit g128 at full depth with both
    scale storages (K16 unfused and fused; batch 1, a 32-token prompt);
    8-bit and 4-bit act-order stacks through the fallback (K9 / K10) and a
    4-bit planar=False stack through K14."""
    W = WIDTHS
    L, S = W["LAYERS"], W["STEPS"]
    Ls = W["SHORT_LAYERS"]
    runs = {}

    def leg(name, bits, layers, sd, B, T, expected, planar=True, act_order=False, w4a8=False, chunk=None):
        t0 = time.time()
        cfg, sp = widths_model(torch, bits, layers, sd, planar=planar, act_order=act_order)
        runs[f"widths_{name}"] = widths_leg(torch, K, name, cfg, sp, B, T, S, expected, w4a8=w4a8, chunk=chunk,
                                            profile_prefill=bits in (3, 5, 6, 7))
        del sp
        torch.cuda.empty_cache()
        log(f"[time] widths {name} {time.time() - t0:.1f} s")

    f32, bf16 = torch.float32, torch.bfloat16
    n, ns = 4 * L + 1, 4 * Ls + 1
    att = lambda layers: {"kv_write_int8": layers * S, "decode_attn_int8": layers * S}  # noqa: E731
    leg("w2_g128_f32", 2, L, f32, W["B"], W["T"], {
        "prefill": {"gptq_gemm": n, "gptq_stacked_gemv": 0},
        "decode": {"gptq_stacked_gemv": n * S, "gptq_gemv": 0, **att(L)}})
    leg("w2_g128_bf16", 2, Ls, bf16, W["B"], W["T"], {
        "prefill": {"gptq_gemm": ns}, "decode": {"gptq_stacked_gemv": ns * S, **att(Ls)}})
    leg("w2_g128_f32_w4a8_b32", 2, Ls, f32, W["B_A8"], W["T"], {
        "prefill": {"gptq_gemm": ns, "gptq_stacked_w4a8_gemv": 0},
        "decode": {"gptq_stacked_w4a8_gemv": ns * S, "gptq_stacked_gemv": 0, **att(Ls)}}, w4a8=True)
    for sd, tag in ((f32, "f32"), (bf16, "bf16")):
        leg(f"w3_g128_{tag}_b1", 3, L, sd, 1, W["T_ODD"], {
            "prefill": {"bitplane_stacked_gemv": n, "gptq_gemm": 0},
            "decode": {"bitplane_stacked_gemv": n * S, **att(L)}}, chunk=W["T_ODD"])
    leg("w8_g128_bf16", 8, Ls, bf16, W["B"], W["T"], {
        "prefill": {"gptq_gemm": ns}, "decode": {"gptq_gemv": ns * S, "gptq_stacked_gemv": 0}})
    # act-order: no q/k/v or gate/up fusion (7 projections a layer); the
    # lm_head (no perm) stays planar: K2 / K1
    leg("w4_g128_act_order", 4, Ls, bf16, W["B"], W["T"], {
        "prefill": {"gptq_gemm": 7 * Ls, "w4_planar_gemm": 1},
        "decode": {"gptq_gemv": 7 * Ls * S, "w4_planar_gemv": S}}, act_order=True)
    leg("w4_g128_nonplanar", 4, Ls, bf16, W["B"], W["T"], {
        "prefill": {"gptq_gemm": 4 * Ls, "w4_planar_gemm": 1},
        "decode": {"gptq_stacked_gemv": 4 * Ls * S, "w4_planar_gemv": S, "planarize_w4": 0}}, planar=False)
    return runs


# K17 / K18 rows: (kernel, projection of STACKED_PROJ, M)
F32S_CASES = (
    ("w4_planar_f32s_gemv", "gateup", 1),
    ("w4_planar_f32s_gemv", "gateup", 8),
    ("w4_planar_f32s_gemv", "gateup", 32),
    ("w4_planar_f32s_gemv", "qkv", 8),
    ("w4_planar_f32s_gemm", "gateup", 1024),
    ("w4_planar_f32s_gemm", "down", 1024),  # no planar_bk: the relaxed k-block 256
)
# the f32s legs: batch, prompt, steps and depth of the plain-cache legs; the
# ring leg's prompt, steps and cache rows; the W4A8 and bf16-control steps
F32S = dict(B=8, T=128, STEPS=32, LAYERS=32, T1=512, STEPS1=32, MAX1=640, STEPS_A8=16, STEPS_BF16=16)
# K17 / K18's second limit, on #3's rounding: the kernel's f32 output within
# F32S_TIGHT * max|plain|, which the same product with the weight q * s
# rounded to bf16 first (K2's dequantize-then-dot) must miss
F32S_TIGHT = 1e-4


def f32s_rows(torch, timer, gen):
    """K17 and K18 at the 7B shapes against their plain versions (f32 out;
    STACKED_TOL of max|plain|, the largest gap also in bf16 ulps of the
    plain output), each with a control that must miss: the kernel's output
    against the next layer's plain version. Then within F32S_TIGHT of
    max|plain|, with a second control that must miss it: x @ the layer's
    weight q * s dequantized to bf16, in f32. Library time: torch.matmul
    on that bf16 weight."""
    from qllm_tpu_torch.ops import qmm, qmm_planar

    rows = []
    proj = {p: (Kf, N) for p, Kf, N in STACKED_PROJ}
    for kname, pname, M in F32S_CASES:
        Kf, N = proj[pname]
        Np = -(-N // 512) * 512
        G = Kf // 128
        qw = torch.randint(-(2**31), 2**31, (STACK_L, Kf // 8, Np), dtype=torch.int32, device=DEV, generator=gen)
        sc = (torch.rand((STACK_L, G, Np), device=DEV, generator=gen) + 0.5) * widths_scale(4)
        w = (qmm._planar_values(qw[1], Kf).reshape(G, 128, Np) * sc[1][:, None]).reshape(Kf, Np).to(torch.bfloat16)
        x = torch.randn((M, Kf), device=DEV, generator=gen).to(torch.bfloat16)
        fn, plain = getattr(qmm_planar, kname), getattr(qmm_planar, kname + "_plain")
        y = fn(x, qw, sc, 1)
        torch.cuda.synchronize()
        ref = plain(x, qw, sc, 1)
        scale = float(ref.abs().max())
        err = float((y - ref).abs().max())
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
        err_ulps = float(((y - ref).abs() / ulp).max())
        control = float((y - plain(x, qw, sc, 2)).abs().max())
        limit = STACKED_TOL * scale
        tight = F32S_TIGHT * scale
        control_bf16 = float((torch.matmul(x.float(), w.float()) - ref).abs().max())
        ok = err <= limit < control and err <= tight < control_bf16
        ms = timer(lambda: fn(x, qw, sc, 1))
        plain_ms = timer(lambda: plain(x, qw, sc, 1), reps=5, warmup=1)
        lib_ms = timer(lambda: torch.matmul(x, w))
        # the function's bytes: the layer's words and f32 scales, x in, f32 y out
        b_ms, b_by = bound(qw[1].numel() * 4 + sc[1].numel() * 4 + M * Kf * 2 + M * Np * 4, 2.0 * M * Kf * Np)
        bk = qmm.planar_bk(Kf, 128) or qmm.planar_bk_relaxed(Kf, 128)
        case = f"{pname} K={Kf} N={Np} M={M} f32 scales" + (f" (TPU bk {bk})" if M > 32 else "")
        # a launch's device time (torch.profiler, L2 warm); at M <= 32 (K17) beside the library call's
        dev = {"device_ms": launch_us(torch, lambda: fn(x, qw, sc, 1), key="") / 1e3}
        if M <= 32:
            dev["library_device_ms"] = launch_us(torch, lambda: torch.matmul(x, w), key="") / 1e3
        rows.append(dict(kernel=kname, case=case, max_abs_err=err, max_err_bf16_ulps=err_ulps,
                         tol=f"{STACKED_TOL}*{scale:.4g}", control_next_layer_err=control,
                         tight_tol=f"{F32S_TIGHT}*{scale:.4g}", control_bf16_weight_err=control_bf16, ok=bool(ok), ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **dev))
        log(f"[kernel] {json.dumps(rows[-1])}")
        if not ok:
            raise AssertionError(f"{kname} {case}: max_abs_err {err}, limits {limit} / {tight}, controls {control} / "
                                 f"{control_bf16}")
        del qw, sc, w, x, y, ref
        torch.cuda.empty_cache()
    return rows


def f32s_ring_leg(torch, K, cfg, sp):
    """The f32s model at batch 1: a T1-token flash prefill into a ring
    cache and STEPS1 ring-fused greedy steps, every count set to 0 just
    before and the launches asserted, then the same again warm (the same
    ids); the device busy share of 8 warm steps, prefill ms, peak GiB."""
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import make_cache, prefill

    W = F32S
    L, T, S = cfg.num_hidden_layers, W["T1"], W["STEPS1"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(22)
    prompt = torch.randint(0, cfg.vocab_size, (1, T), dtype=torch.int32, device=DEV, generator=gen)

    def run():
        cache = make_cache(cfg, 1, W["MAX1"], ring=True, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(sp, cfg, prompt, cache, device=DEV)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mark = counts(K)
        first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks, cache = decode_loop(sp, cfg, first, cache, T, S, device=DEV)
        torch.cuda.synchronize()
        return logits, toks, cache, mark, (t1 - t0, time.perf_counter() - t1)

    for fn in K.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    logits, toks, cache, mark, cold = run()
    total = counts(K)
    per_phase = {"prefill": mark, "decode": delta(mark, total)}
    log(f"[f32s] b1_ring: launches per phase {json.dumps({p: {k: v for k, v in c.items() if v} for p, c in per_phase.items()})}")
    check_launches(per_phase, {
        "prefill": {"w4_planar_f32s_gemm": 4 * L + 1, "flash_prefill": L, "w4_planar_f32s_gemv": 0,
                    "w4_planar_gemm": 0, "gptq_gemm": 0},
        "decode": {"w4_planar_f32s_gemv": (3 * L + 1) * S, "gptq_gemv": L * S, "decode_attention_ring": L * S,
                   "kv_ring_flush": S // 8, "w4_planar_f32s_gemm": 0, "w4_planar_gemv": 0, "kv_write_int8": 0,
                   "decode_attn_int8": 0},
    })
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(logits.float()).all()) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError("f32s b1_ring: logits not finite or ids out of range")
    _, toks2, cache, _, warm = run()
    same = bool(torch.equal(toks, toks2))
    busy = profile_decode(torch, sp, cfg, toks2[:, -1:].contiguous(), cache, T + S, steps=8)
    res = {
        "config": f"Llama-2-7B shape, {L} layers, W4 g128 f32 scales (the stacking defaults); B=1, T={T} flash "
        f"prefill into a ring cache of max_seq {W['MAX1']}, {S} ring-fused greedy steps",
        "prefill_ms": cold[0] * 1e3,
        "prefill_warm_ms": warm[0] * 1e3,
        "decode_tok_s": S / cold[1],
        "decode_ms_per_step": cold[1] / S * 1e3,
        "decode_tok_s_warm": S / warm[1],
        "decode_ms_per_step_warm": warm[1] / S * 1e3,
        **busy,
        "peak_mem_gib": peak,
        "launches_per_step": {k: v / S for k, v in per_phase["decode"].items() if v},
        "repeat_run_same_ids": same,
    }
    log(f"[f32s] b1_ring: {json.dumps(res)}")
    if not same:
        raise AssertionError("f32s b1_ring: a second run on the same prompt decoded other ids")
    del cache
    torch.cuda.empty_cache()
    return total


def phase_f32s(torch, K):
    """The 7B geometry stacked as the JAX package stacks by default (f32
    scales and zs): batch 8 on the plain cache, batch 1 on the ring, batch
    8 under W4A8 (each through widths_leg or f32s_ring_leg), then the same
    params stacked with bf16 scales (K1 / K2) as the control."""
    from qllm_tpu_torch.quant.qtensor import QuantizedTensor

    W = F32S
    L, B, T = W["LAYERS"], W["B"], W["T"]
    n = 4 * L + 1
    att = lambda steps: {"kv_write_int8": L * steps, "decode_attn_int8": L * steps}  # noqa: E731
    runs = {}
    t0 = time.time()
    cfg, sp = widths_model(torch, 4, L, None)
    leaves = [v for v in [*sp["layers"].values(), sp["lm_head"]] if isinstance(v, QuantizedTensor)]
    if not all(v.planar and v.scales.dtype == v.zeros.dtype == torch.float32 for v in leaves):
        raise AssertionError("f32s: the default stacking is not planar with f32 scales and zs")
    log(f"[f32s] drawn and stacked with the defaults (f32 scales, {len(leaves)} planar stacks) in "
        f"{time.time() - t0:.1f} s")
    S = W["STEPS"]
    runs["f32s_b8"] = widths_leg(torch, K, "f32s_b8", cfg, sp, B, T, S, {
        "prefill": {"w4_planar_f32s_gemm": n, "w4_planar_f32s_gemv": 0, "w4_planar_gemm": 0, "gptq_gemm": 0},
        "decode": {"w4_planar_f32s_gemv": (3 * L + 1) * S, "gptq_gemv": L * S, "w4_planar_f32s_gemm": 0,
                   "w4_planar_gemv": 0, **att(S)}}, sums={"k17": K17_KERNELS})
    runs["f32s_b1_ring"] = f32s_ring_leg(torch, K, cfg, sp)
    S = W["STEPS_A8"]
    runs["f32s_b8_w4a8"] = widths_leg(torch, K, "f32s_b8_w4a8", cfg, sp, B, T, S, {
        "prefill": {"w4_planar_f32s_gemm": n, "gptq_w4a8_gemv": 0},
        "decode": {"w4_planar_f32s_gemv": (3 * L + 1) * S, "gptq_w4a8_gemv": L * S, "gptq_gemv": 0,
                   "w4a8_planar_gemv": 0, **att(S)}}, w4a8=True,
        watch={"gptq_w4a8_gemv": watched("gptq_w4a8_gemv")}, sums={"k17": K17_KERNELS})
    del sp
    torch.cuda.empty_cache()
    cfg, sp = widths_model(torch, 4, L, torch.bfloat16)
    S = W["STEPS_BF16"]
    runs["f32s_bf16_control"] = widths_leg(torch, K, "f32s_bf16_control", cfg, sp, B, T, S, {
        "prefill": {"w4_planar_gemm": n, "w4_planar_f32s_gemm": 0},
        "decode": {"w4_planar_gemv": n * S, "w4_planar_f32s_gemv": 0, "gptq_gemv": 0, **att(S)}},
        sums={"k1": K1_KERNELS})
    del sp
    torch.cuda.empty_cache()
    return runs


def attn_options(torch, opts, H):
    """decode_attention's keywords for an ATTN_4D / OPT_5D options dict:
    the ALiBi slopes and the window as tensors on the card."""
    from qllm_tpu_torch.models.llama import alibi_slopes

    kw = {}
    if "softcap" in opts:
        kw["softcap"] = opts["softcap"]
    if "alibi" in opts:
        kw["alibi_slopes"] = alibi_slopes(H, opts["alibi"], device=DEV)
    if "window" in opts:
        kw["window"] = torch.full((1,), opts["window"], dtype=torch.int32, device=DEV)
    return kw


def key_scales(torch, shape, gen, opts):
    """The key scales of an options case, f32 ``shape`` on the card. An int8
    draw has RMS 127 / sqrt(3) and q ~ N(0, 1) is pre-scaled by D**-0.5, so
    the scores' RMS is about 73.3 * ks: with a softcap the scales give RMS
    0.5-1.5 x the cap, where cap * tanh(s / cap) bends far from s (the
    control in softcap_control); else U(0.005, 0.02), as everywhere here."""
    u = torch.rand(shape, device=DEV, generator=gen)
    if "softcap" in opts:
        return (u + 0.5) * (opts["softcap"] * 3**0.5 / 127)
    return u * 0.015 + 0.005


def softcap_control(out, tol, plain, kw) -> float | None:
    """With a softcap, max|out - plain without it|, which must exceed ten
    times the one-ulp limit ``tol`` (a kernel that dropped the cap, or
    whose tanh is far off, would then fail); None without a softcap."""
    if "softcap" not in kw:
        return None
    miss = float((out - plain(**{k: v for k, v in kw.items() if k != "softcap"})).abs().max())
    if miss <= 10 * tol:
        raise AssertionError(f"the softcap moves the output by only {miss} (limit {tol}): the check cannot see it")
    return miss


def attn_rows_needed(lengths, window) -> int:
    """The cache rows a decode step reads: min(length, window) per sequence."""
    return int(lengths.clamp(max=window).sum()) if window else int(lengths.sum())


def sp_rows(torch, timer, gen):
    """K22 at the Llama-2-7B shape (one layer's 4-D cache, B=8, S=4096,
    every row valid) and K21 over one Mixtral layer's 32768 rows (B=8),
    each against its plain version. The library call for K22 is SDPA on
    the dequantized cache; no single PyTorch call computes K21's partial
    statistics, so its yardstick is K3b over the same rows."""
    from qllm_tpu_torch.ops import attention as att

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    name, B, H, Hkv, D, S, _, _ = ATTN_4D[0]
    kc = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
    vc = torch.randint(-127, 128, (B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
    ks = torch.rand((B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
    vs = torch.rand((B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
    q = torch.randn((B, H, D), device=DEV, generator=gen).to(torch.bfloat16)
    lengths = torch.full((B,), S, dtype=torch.int32, device=DEV)
    args = (q, kc, vc, ks, vs, lengths)
    out = att.decode_attn_int8_4d(*args)
    torch.cuda.synchronize()
    ref = att.decode_attn_int8_4d_plain(*args)
    err, tol = float((out - ref).abs().max()), bf16_ulp(ref)
    kd = (kc.float() * ks[..., None]).to(torch.bfloat16)
    vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
    lib_ms = timer(lambda: sdpa(q[:, :, None, :], kd, vd))
    del kd, vd
    ms = timer(lambda: att.decode_attn_int8_4d(*args))
    plain_ms = timer(lambda: att.decode_attn_int8_4d_plain(*args), reps=5, warmup=1)
    n_rows = B * Hkv * S
    nbytes = n_rows * (2 * D + 8) + q.numel() * 2 + q.numel() * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * n_rows * D * (H // Hkv))
    rows.append(dict(kernel="decode_attn_int8_4d", case=f"{name} B={B} H=Hkv={Hkv} D={D} S={S} lengths {S}",
                     max_abs_err=err, tol=f"one bf16 ulp of max|plain| ({tol:.4g})", ok=err <= tol, ms=ms,
                     plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                     **tile_cost(ms, lengths, H // Hkv, Hkv, fn=lambda: att.decode_attn_int8_4d(*args))))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if err > tol:
        raise AssertionError(f"decode_attn_int8_4d: max_abs_err {err} > {tol}")
    del kc, vc, ks, vs, args, out, ref
    rows.append(options_row(torch, timer, gen, "decode_attn_int8_4d", ATTN_4D[1]))
    rows.append(options_row(torch, timer, gen, "decode_attn_int8_4d", ATTN_4D[2]))
    case, S5, lo, opts = OPT_5D[0]
    B, Hkv, n_rep, D = (SP[k] for k in ("B", "Hkv", "n_rep", "D"))
    shape = (f"Mixtral layer {case}", B, Hkv * n_rep, Hkv, D, S5, lo, opts)
    rows.append(options_row(torch, timer, gen, "decode_attn_int8", shape))

    B, Hkv, n_rep, D, S = (SP[k] for k in ("B", "Hkv", "n_rep", "D", "S"))
    kc = torch.randint(-127, 128, (1, B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
    vc = torch.randint(-127, 128, (1, B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
    ks = torch.rand((1, B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
    vs = torch.rand((1, B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
    q = torch.randn((B, Hkv * n_rep, D), device=DEV, generator=gen).to(torch.bfloat16)
    lengths = torch.full((B,), S, dtype=torch.int32, device=DEV)
    args = (q, kc, vc, ks, vs, lengths, 0)
    got = att.decode_attn_int8_partial(*args)
    torch.cuda.synchronize()
    fields, ok = partial_check(got, att.decode_attn_int8_partial_plain(*args))
    yard_ms = timer(lambda: att.decode_attn_int8(*args))
    ms = timer(lambda: att.decode_attn_int8_partial(*args))
    plain_ms = timer(lambda: att.decode_attn_int8_partial_plain(*args), reps=5, warmup=1)
    n_rows = B * Hkv * S
    nbytes = n_rows * (2 * D + 8) + q.numel() * 2 + q.numel() * 4 + 2 * B * q.shape[1] * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * n_rows * D * n_rep)
    rows.append(dict(kernel="decode_attn_int8_partial", case=f"Mixtral layer B={B} Hkv={Hkv} n_rep={n_rep} D={D} "
                     f"S={S} lengths {S}", **fields, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=None,
                     yardstick="K3b decode_attn_int8 over the same rows", yardstick_ms=yard_ms, bound_ms=b_ms,
                     bound_by=b_by, bytes=nbytes,
                     **tile_cost(ms, lengths, n_rep, Hkv, fn=lambda: att.decode_attn_int8_partial(*args))))
    log(f"[kernel] {json.dumps(rows[-1])}")
    if not ok:
        raise AssertionError(f"decode_attn_int8_partial: {fields}")
    del kc, vc, ks, vs, got
    torch.cuda.empty_cache()
    return rows


def options_row(torch, timer, gen, kernel, shape):
    """One kernel-phase row of K22 (4-D cache) or K3b (one-layer stack)
    with the options of ``shape`` (an ATTN_4D-style tuple), lengths drawn
    in [least, S], against its plain version within one bf16 ulp, and K3b
    without the options on the same rows. No single PyTorch call applies a
    logit softcap (library_ms null)."""
    from qllm_tpu_torch.ops import attention as att

    name, B, H, Hkv, D, S, lo, opts = shape
    lead = () if kernel == "decode_attn_int8_4d" else (1,)
    kc = torch.randint(-127, 128, lead + (B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
    vc = torch.randint(-127, 128, lead + (B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
    ks = key_scales(torch, lead + (B, Hkv, S), gen, opts)
    vs = torch.rand(lead + (B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
    q = torch.randn((B, H, D), device=DEV, generator=gen).to(torch.bfloat16)
    lengths = torch.randint(lo, S + 1, (B,), dtype=torch.int32, device=DEV, generator=gen)
    kw = attn_options(torch, opts, H)
    if kernel == "decode_attn_int8_4d":
        fn, plain = att.decode_attn_int8_4d, att.decode_attn_int8_4d_plain
        args = (q, kc, vc, ks, vs, lengths)
        bare = (q, kc[None], vc[None], ks[None], vs[None], lengths, 0)
    else:
        fn, plain = att.decode_attn_int8, att.decode_attn_int8_plain
        args = bare = (q, kc, vc, ks, vs, lengths, 0)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    err, tol = float((out - ref).abs().max()), bf16_ulp(ref)
    if err > tol:
        raise AssertionError(f"{kernel} {name} {opts}: max_abs_err {err} > {tol}")
    miss = softcap_control(out, tol, functools.partial(plain, *args), kw)
    ms = timer(lambda: fn(*args, **kw))
    no_opt_ms = timer(lambda: att.decode_attn_int8(*bare))
    plain_ms = timer(lambda: plain(*args, **kw), reps=5, warmup=1)
    n_rows = attn_rows_needed(lengths, opts.get("window", 0)) * Hkv
    nbytes = n_rows * (2 * D + 8) + q.numel() * 2 + q.numel() * 4 + B * 4 + (H * 4 if "alibi" in opts else 0)
    b_ms, b_by = bound(nbytes, 4.0 * n_rows * D * (H // Hkv))
    row = dict(kernel=kernel, case=f"{name} B={B} H={H} Hkv={Hkv} D={D} S={S} lengths {int(lengths.min())}-"
               f"{int(lengths.max())} {opts}", options=True, chunked=S > 8192 and kernel == "decode_attn_int8",
               max_abs_err=err, tol=f"one bf16 ulp of max|plain| ({tol:.4g})", ok=err <= tol,
               without_softcap_max_abs_err=miss, ms=ms, plain_ms=plain_ms, library_ms=None,
               k3b_without_options_ms=no_opt_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               **tile_cost(ms, lengths, H // Hkv, Hkv, window=opts.get("window", 0), fn=lambda: fn(*args, **kw)))
    log(f"[kernel] {json.dumps(row)}")
    return row


def partial_check(got, ref):
    """K21's (acc, m, den) against its plain version: acc and den within
    PARTIAL_TOL[0] * max|plain| and one bf16 ulp of it, m within
    PARTIAL_TOL[1] relative; -> (fields to log, whether it held)."""
    (acc, m, den), (r_acc, r_m, r_den) = got, ref
    err_acc, err_den = float((acc - r_acc).abs().max()), float((den - r_den).abs().max())
    lim_acc = min(PARTIAL_TOL[0] * float(r_acc.abs().max()), bf16_ulp(r_acc))
    lim_den = min(PARTIAL_TOL[0] * float(r_den.abs().max()), bf16_ulp(r_den))
    rel_m = float(((m - r_m).abs() / r_m.abs()).max())
    tol = (f"acc {lim_acc:.4g}, den {lim_den:.4g} (min of {PARTIAL_TOL[0]} * max|plain| and one bf16 ulp), "
           f"m {PARTIAL_TOL[1]} relative")
    fields = dict(max_abs_err=err_acc, den_max_abs_err=err_den, m_max_rel_err=rel_m, tol=tol)
    return fields, err_acc <= lim_acc and err_den <= lim_den and rel_m <= PARTIAL_TOL[1]


def merge_check(torch, out, ref):
    """A merged output against K3b's: finite, within SP_TOL (atol / rtol,
    JAX's bound) and within the scaled LONG_ATTN_TOL, which a lost key tile
    would miss at these lengths. -> (max |out - ref|, whether both held)."""
    err = float((out - ref).abs().max())
    limit = LONG_ATTN_TOL[0] * float(ref.abs().max()) + LONG_ATTN_TOL[1]
    ok = bool(torch.isfinite(out).all()) and torch.allclose(out, ref, atol=SP_TOL, rtol=SP_TOL) and err <= limit
    return err, ok


def phase_sp(torch, K):
    """The last two attention entry points at full width, each with the launch counts
    set to 0 just before it and read just after:
    (a) ``parallel.sp_decode_attention`` over every layer of a Mixtral-
        geometry int8 cache of 32768 rows through a one-rank NCCL group
        (K21 on the rank's shard, the all-reduce MAX and SUMs), held
        against K3b over the whole cache; K21 against its plain version on
        one layer; the same layer split into WORLD shards (copied by
        ``sp_cache_shard``), K21 on each and the partials merged by
        ``lse_merge``, the group path's merge, against K3b; every empty
        (row, shard) pair exactly m = -1e30, acc = 0, den = 0;
    (b) ``decode_attention`` on one layer's 4-D cache (K22) at the
        Llama-2-7B, Gemma-2-9B (softcap, window) and Bloom-7b1 (ALiBi)
        geometries, each against its plain version;
    (c) ``decode_attention`` on a layer-stacked cache with the options
        (K3b): softcap and window at S = 16384, ALiBi at S = 4096."""
    import os

    import torch.distributed as dist

    from qllm_tpu_torch.ops import attention as att
    from qllm_tpu_torch.parallel import lse_merge, sp_cache_shard, sp_decode_attention

    runs = {}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(90)
    L, B, Hkv, n_rep, D, S, n, layer = (SP[k] for k in ("L", "B", "Hkv", "n_rep", "D", "S", "WORLD", "LAYER"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    kc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
    vc = torch.randint(-127, 128, (L, B, Hkv, S, D), dtype=torch.int8, device=DEV, generator=gen)
    ks = torch.rand((L, B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
    vs = torch.rand((L, B, Hkv, S), device=DEV, generator=gen) * 0.015 + 0.005
    q = torch.randn((B, Hkv * n_rep, D), device=DEV, generator=gen).to(torch.bfloat16)
    lengths = torch.tensor(SP["LENGTHS"], dtype=torch.int32, device=DEV)
    torch.cuda.synchronize()
    log(f"[sp] int8 K/V {2 * kc.numel() / 1e9:.2f} GB and scales {2 * ks.numel() * 4 / 1e9:.2f} GB "
        f"drawn on the card in {time.time() - t0:.2f} s")

    # (a) one rank: the whole cache is its shard
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one process on one host
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        shard = [sp_cache_shard(t, dist.get_rank(group), dist.get_world_size(group)) for t in (kc, vc, ks, vs)]
        for fn in K.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [sp_decode_attention(q, *shard, lengths, l, group) for l in range(L)]
        torch.cuda.synchronize()
        sp_ms = (time.perf_counter() - t0) * 1e3  # the first all-reduce makes the communicator
        runs["sp"] = counts(K)
        t0 = time.perf_counter()
        again = [sp_decode_attention(q, *shard, lengths, l, group) for l in range(L)]
        torch.cuda.synchronize()
        sp_warm_ms = (time.perf_counter() - t0) * 1e3
        same = all(torch.equal(a, b) for a, b in zip(outs, again))
        del again
    finally:
        dist.destroy_process_group()
    del shard
    check_launches({"sp": runs["sp"]}, {"sp": {"decode_attn_int8_partial": L, "decode_attn_int8": 0}})
    err_1, ok_1 = 0.0, True
    for l in range(L):
        e, ok = merge_check(torch, outs[l], att.decode_attn_int8(q, kc, vc, ks, vs, lengths, l))
        err_1, ok_1 = max(err_1, e), ok_1 and ok
    ref = att.decode_attn_int8(q, kc, vc, ks, vs, lengths, layer)
    args = (q, kc, vc, ks, vs, lengths, layer)
    p_fields, p_ok = partial_check(att.decode_attn_int8_partial(*args), att.decode_attn_int8_partial_plain(*args))

    # WORLD shards of one layer on this card, merged as the group merges
    one = [t[layer : layer + 1] for t in (kc, vc, ks, vs)]
    s_loc = S // n
    locs, parts = [], []
    for r in range(n):
        loc = (lengths - r * s_loc).clamp(0, s_loc).to(torch.int32)
        locs.append(loc)
        parts.append(att.decode_attn_int8_partial(q, *[sp_cache_shard(t, r, n) for t in one], loc, 0))
    acc, m, den = (torch.stack(t) for t in zip(*parts))
    err_n, ok_n = merge_check(torch, lse_merge(acc, m, den, lambda t: t.amax(0), lambda t: t.sum(0)), ref)
    empty = torch.stack(locs) == 0  # [WORLD, B]
    n_empty = int(empty.sum())
    e = empty[:, :, None, None]
    exact = bool(((m == -1e30) | ~e).all()) and bool(((acc == 0) | ~e).all()) and bool(((den == 0) | ~e).all())
    res = {
        "config": f"Mixtral-8x7B attention, {L} layers, B={B}, Hkv={Hkv}, n_rep={n_rep}, D={D}, S={S}, "
        f"lengths {list(SP['LENGTHS'])}",
        "one_rank_nccl_ms_all_layers": sp_ms,
        "one_rank_nccl_ms_all_layers_warm": sp_warm_ms,
        "warm_run_bit_equal": same,
        "launches": {k: v for k, v in runs["sp"].items() if v},
        "one_rank_vs_k3b_max_abs_err": err_1,
        f"{n}_shards_vs_k3b_max_abs_err": err_n,
        "tol": f"atol/rtol {SP_TOL} and {LONG_ATTN_TOL[0]} * max|K3b| + {LONG_ATTN_TOL[1]}",
        "partial_vs_plain": p_fields,
        "empty_row_shards": n_empty,
        "empty_exact": exact,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"[sp] {json.dumps(res)}")
    if not (ok_1 and p_ok and ok_n and exact and n_empty > 0 and same):
        raise AssertionError(f"sp: one rank {ok_1}, partial {p_ok}, {n} shards {ok_n}, empty shards exact {exact}, "
                             f"warm run equal {same}")
    del kc, vc, ks, vs, one, parts, acc, m, den, outs, ref
    torch.cuda.empty_cache()

    # (b) K22 and (c) K3b with the options: every call of a path, then the comparisons
    def drive_attention(tag, cases, expected):
        for fn in K.values():
            fn.launches = 0
        outs = [att.decode_attention(*a, **kw) for _, a, kw in cases]
        torch.cuda.synchronize()
        runs[tag] = counts(K)
        check_launches({tag: runs[tag]}, {tag: expected})
        for (case, a, kw), out in zip(cases, outs):
            if a[1].dim() == 4:
                plain = functools.partial(att.decode_attn_int8_4d_plain, *a[:6])
            else:
                plain = functools.partial(att.decode_attn_int8_plain, *a)
            ref = plain(**kw)
            err, tol = float((out - ref).abs().max()), bf16_ulp(ref)
            finite = bool(torch.isfinite(out).all())
            if not (err <= tol and finite):
                raise AssertionError(f"{tag} {case}: max_abs_err {err} > {tol}")
            miss = softcap_control(out, tol, plain, kw)
            window = int(kw["window"][0]) if "window" in kw else 0
            log(f"[sp] " + json.dumps(dict(path=tag, case=case, max_abs_err=err, tol=f"one bf16 ulp of max|plain| "
                                           f"({tol:.4g})", without_softcap_max_abs_err=miss,
                                           rows_read=attn_rows_needed(a[5], window), finite=finite)))

    cases = []
    for name, B4, H, Hkv4, D4, S4, lo, opts in ATTN_4D:
        kc4 = torch.randint(-127, 128, (B4, Hkv4, S4, D4), dtype=torch.int8, device=DEV, generator=gen)
        vc4 = torch.randint(-127, 128, (B4, Hkv4, S4, D4), dtype=torch.int8, device=DEV, generator=gen)
        ks4 = key_scales(torch, (B4, Hkv4, S4), gen, opts)
        vs4 = torch.rand((B4, Hkv4, S4), device=DEV, generator=gen) * 0.015 + 0.005
        q4 = torch.randn((B4, H, D4), device=DEV, generator=gen).to(torch.bfloat16)
        len4 = torch.randint(lo, S4 + 1, (B4,), dtype=torch.int32, device=DEV, generator=gen)
        case = f"{name} B={B4} H={H} Hkv={Hkv4} D={D4} S={S4} {opts or 'no option'}"
        cases.append((case, (q4, kc4, vc4, ks4, vs4, len4, None), attn_options(torch, opts, H)))
    drive_attention("attn_4d", cases, {"decode_attn_int8_4d": len(ATTN_4D), "decode_attn_int8": 0})
    del cases
    for case, S5, lo, opts in OPT_5D:
        kc5 = torch.randint(-127, 128, (1, B, Hkv, S5, D), dtype=torch.int8, device=DEV, generator=gen)
        vc5 = torch.randint(-127, 128, (1, B, Hkv, S5, D), dtype=torch.int8, device=DEV, generator=gen)
        ks5 = key_scales(torch, (1, B, Hkv, S5), gen, opts)
        vs5 = torch.rand((1, B, Hkv, S5), device=DEV, generator=gen) * 0.015 + 0.005
        q5 = torch.randn((B, Hkv * n_rep, D), device=DEV, generator=gen).to(torch.bfloat16)
        len5 = torch.randint(lo, S5 + 1, (B,), dtype=torch.int32, device=DEV, generator=gen)
        tag = "options_long" if S5 > 8192 else "options"
        label = f"Mixtral layer B={B} Hkv={Hkv} n_rep={n_rep} D={D} S={S5} {case} {opts}"
        drive_attention(tag, [(label, (q5, kc5, vc5, ks5, vs5, len5, 0), attn_options(torch, opts, Hkv * n_rep))],
                        {"decode_attn_int8": 1, "decode_attn_int8_4d": 0})
    torch.cuda.empty_cache()
    return runs


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
    "w4_grouped_gemv": ("qllm_tpu_torch/csrc/grouped_mma.cu", "qllm_tpu/ops/pallas_qmm.py:1843"),
    # at M <= 32 the TPU runs _qmm_kernel_v3 (:177) for 2/4 bits, _qmm_kernel (:119) for 8
    "gptq_gemv": ("qllm_tpu_torch/csrc/gptq_stacked.cu", "qllm_tpu/ops/pallas_qmm.py:177"),
    "gptq_gemm": ("qllm_tpu_torch/csrc/gptq_mm.cu", "qllm_tpu/ops/pallas_qmm.py:119"),
    # the a8 branch (:871-873, :932-942) of the full-K planar kernel
    "w4a8_planar_gemv": ("qllm_tpu_torch/csrc/w4a8.cu", "qllm_tpu/ops/pallas_qmm.py:832"),
    "gptq_w4a8_gemv": ("qllm_tpu_torch/csrc/gptq_stacked.cu", "qllm_tpu/ops/pallas_qmm.py:239"),
    "stream_pass": ("qllm_tpu_torch/csrc/stream.cu", "qllm_tpu/ops/stream_bench.py:26"),
    # v3 (:476); with bf16 scales the fused v4 (:514)
    "gptq_stacked_gemv": ("qllm_tpu_torch/csrc/gptq_stacked.cu", "qllm_tpu/ops/pallas_qmm.py:476"),
    "gptq_stacked_w4a8_gemv": ("qllm_tpu_torch/csrc/gptq_stacked.cu", "qllm_tpu/ops/pallas_qmm.py:584"),
    "bitplane_stacked_gemv": ("qllm_tpu_torch/csrc/bitplane.cu", "qllm_tpu/ops/pallas_qmm.py:676"),
    "w4_planar_f32s_gemv": ("qllm_tpu_torch/csrc/planar_f32.cu", "qllm_tpu/ops/pallas_qmm.py:999"),
    "w4_planar_f32s_gemm": ("qllm_tpu_torch/csrc/planar_f32.cu", "qllm_tpu/ops/pallas_qmm.py:999"),
    "w4_grouped_fused_mlp": ("qllm_tpu_torch/csrc/fused_mlp.cu", "qllm_tpu/ops/pallas_qmm.py:2239"),
    "w4_pnp_gemv": ("qllm_tpu_torch/csrc/fused_mlp.cu", "qllm_tpu/ops/pallas_qmm.py:1950"),
    "decode_attn_int8_4d": ("qllm_tpu_torch/csrc/attention.cu", "qllm_tpu/ops/pallas_attention.py:39"),
    "decode_attn_int8_partial": ("qllm_tpu_torch/csrc/attention.cu", "qllm_tpu/ops/pallas_attention.py:1053"),
}
# the shape each kernel's summary entry reports (the largest of the path)
HEADLINE = {"w4_planar_gemv": "gateup", "w4_planar_gemm": "gateup", "flash_prefill": "T=2048 S=2048",
            "w4_grouped_gemv": "mixtral gateup", "gptq_gemv": "gate/up K=4096 N=11008 M=8 4-bit",
            "gptq_gemm": "gate/up K=4096 N=11008 M=256 4-bit", "w4a8_planar_gemv": "gateup K=4096 N=22016 M=32",
            "gptq_w4a8_gemv": "gate/up K=4096 N=11008 M=8 4-bit",
            "gptq_stacked_gemv": "gateup K=4096 N=22016 M=8 2-bit f32",
            "gptq_stacked_w4a8_gemv": "gateup K=4096 N=22016 M=32 2-bit",
            "bitplane_stacked_gemv": "gateup K=4096 N=22016 M=1 3-bit f32",
            "w4_planar_f32s_gemv": "gateup K=4096 N=22016 M=8", "w4_planar_f32s_gemm": "gateup K=4096 N=22016 M=1024",
            "w4_pnp_gemv": "M=8"}
# K3b stands in the line twice: as the TPU's one-shot kernel (#13) and as
# its key-chunked kernel (#15), with its LONG_ATTN_SHAPE reading and its
# launches on the paths past 8192 rows (long, and the sp phase's options_long)
CHUNKED = dict(replaces="qllm_tpu/ops/pallas_attention.py:284", paths=("long", "options_long"))


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
    if len(mine) > 1 and name in ("w4_planar_gemv", "w4_planar_gemm", "flash_prefill", "w4_grouped_gemv", "gptq_gemv",
                                  "gptq_gemm", "w4a8_planar_gemv", "gptq_w4a8_gemv",
                                  "gptq_stacked_gemv", "gptq_stacked_w4a8_gemv", "bitplane_stacked_gemv",
                                  "w4_planar_f32s_gemv", "w4_planar_f32s_gemm", "w4_pnp_gemv",
                                  "decode_attn_int8_4d", "kv_write_int8"):
        entry["readings"] = [{k: r[k] for k in ("case", "ms", "device_ms", "max_abs_err", "bound_ms", "library_ms",
                                                "library_device_ms", "plain_ms") if k in r} for r in mine]
    if "yardstick_ms" in head:
        entry["yardstick"] = head["yardstick"]
        entry["yardstick_ms"] = head["yardstick_ms"]
    for k in ("device_ms", "yardstick_device_ms"):
        if k in head:
            entry[k] = head[k]
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,main,main1,pnp,w4a8,serve,widths,f32s,moe,long,moe_qwen3,cross,sp",
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
    from qllm_tpu_torch.ops import (_build, attention, flash_prefill, qmm, qmm2d, qmm_planar, qmm_stacked, repack,
                                    stream_bench)

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
        "gptq_gemv": qmm2d.gptq_gemv,
        "gptq_gemm": qmm2d.gptq_gemm,
        "w4a8_planar_gemv": qmm.w4a8_planar_gemv,
        "gptq_w4a8_gemv": qmm2d.gptq_w4a8_gemv,
        "stream_pass": stream_bench.stream_pass,
        "gptq_stacked_gemv": qmm_stacked.gptq_stacked_gemv,
        "gptq_stacked_w4a8_gemv": qmm_stacked.gptq_stacked_w4a8_gemv,
        "bitplane_stacked_gemv": qmm_stacked.bitplane_stacked_gemv,
        "w4_planar_f32s_gemv": qmm_planar.w4_planar_f32s_gemv,
        "w4_planar_f32s_gemm": qmm_planar.w4_planar_f32s_gemm,
        "w4_grouped_fused_mlp": qmm.w4_grouped_fused_mlp,
        "w4_pnp_gemv": qmm.w4_pnp_gemv,
        "decode_attn_int8_4d": attention.decode_attn_int8_4d,
        "decode_attn_int8_partial": attention.decode_attn_int8_partial,
    }
    t_start = time.time()
    t0 = time.time()
    _build.load_library()
    log(f"[build] kernels ready in {time.time() - t0:.1f} s ({_build.build_dir()})")
    blog = _build.build_dir() / "build.log"
    if blog.exists():
        for line in blog.read_text().splitlines():
            if ("Used" in line or "Compiling entry function" in line or line.startswith("[build seconds]")
                    or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line)):
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
    log(f"[time] main, main1 {time.time() - t0:.1f} s")
    t0 = time.time()
    if "pnp" in phases:
        runs["pnp"] = phase_pnp(torch, K, model)
    log(f"[time] pnp {time.time() - t0:.1f} s")
    t0 = time.time()
    if "w4a8" in phases:
        runs.update(phase_w4a8(torch, K, card, model))
    model = None
    torch.cuda.empty_cache()
    log(f"[time] w4a8 {time.time() - t0:.1f} s")
    t0 = time.time()
    if "serve" in phases:
        runs.update(phase_serve(torch, K, card))
    log(f"[time] serve {time.time() - t0:.1f} s")
    t0 = time.time()
    if "widths" in phases:
        runs.update(phase_widths(torch, K))
    log(f"[time] widths {time.time() - t0:.1f} s")
    t0 = time.time()
    if "f32s" in phases:
        runs.update(phase_f32s(torch, K))
    log(f"[time] f32s {time.time() - t0:.1f} s")
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
        log(f"[cross] MoE legs {json.dumps(cross_moe(torch, K))}")
    log(f"[time] cross {time.time() - t0:.1f} s")
    t0 = time.time()
    if "sp" in phases:
        runs.update(phase_sp(torch, K))
    log(f"[time] sp {time.time() - t0:.1f} s")

    def launches(name, keep=lambda path: True):
        return sum(r[name] for p, r in runs.items() if keep(p)) if runs else None

    summary = []
    for name, (_, replaces) in KERNEL_META.items():
        mine = [r for r in rows if r["kernel"] == name]
        if name == "decode_attn_int8":
            mine = [r for r in mine if not r.get("chunked")]
            n = launches(name, lambda path: path not in CHUNKED["paths"])
        else:
            n = launches(name)
        summary.append(summary_entry(name, replaces, n, mine, HEADLINE.get(name, "")))
    mine = [r for r in rows if r["kernel"] == "decode_attn_int8" and r.get("chunked")]
    n = launches("decode_attn_int8", lambda path: path in CHUNKED["paths"])
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
