"""Device time of the decode GEMVs on the tensor-core body per launch, for
the package of the working directory: run it from the root of each tree of
an A/B (an archived parent beside this one) in one call on the card, so
that both sides share the card and its power limit.

    python3 chip_stacked_ab.py [--tag NAME] [--reps N] [--parts stacked,k9,k15,engine,k9_targets,k12,k8,planar,k8_heads,k11,pnp,k19,k3a]

  * stacked: K14 gptq_stacked_gemv and K16 bitplane_stacked_gemv at the
    Llama-2-7B stacked projections;
  * k9: K9 gptq_gemv at the engine's per-layer shapes (q/k/v/o, gate/up,
    down, lm_head; M = 1 and 8), with the sum one 32-layer decode step's
    225 launches make, and 8-bit gate/up at M = 8;
  * k15: K15 gptq_stacked_w4a8_gemv at the stacked projections, 2 bits,
    M = 8 and 32;
  * engine: K9's device ms in a plain decode step of the serving engine on
    the 7B per-layer model at batch 8 (chip_smoke's serve model);
  * k9_targets (not in the default parts; trees whose K9 takes its split
    of K from ops.tc_plan): K9's C entry at the k9 part's shapes with the
    split plan of each of K9_TARGETS, the blocks a launch may hold;
  * k12 (not in the default parts): K12 gptq_w4a8_gemv at the k9 part's
    shapes (M = 1, 8, 32) with the sum one W4A8 decode step's 225 launches
    make, act-order q/k/v/o at M = 8 through qmatmul_2d (its gather
    included), 2-bit f32-scale down at M = 8, and K12's device ms in the
    engine's W4A8 decode step;
  * k8_heads (not in the default parts; trees whose K8 plans a fixed
    count of heads): K8's C entry at the k8 part's shapes with the split
    plan for each of K8_HEADS head blocks, and with the tree's own plan
    and every selection served on its own (runs off);
  * k11 (not in the default parts): K11 w4a8_planar_gemv at the 7B
    projections (q/k/v, o, gate|up with and without the norm, down,
    lm_head) at M = 1, 8 and 32, each beside its bound and the library's
    torch.matmul on the dequantized bf16 weight;
  * pnp (not in the default parts): K20 w4_pnp_gemv at the 7B (o_proj
    4096->4096, the residual, RMSNorm, gate|up 4096->22016) at M = 1 and
    8, beside its bound and the K1 pair it fuses (K1 o_proj, + h, K1
    gate|up with the norm), the yardstick, there being no one library call;
  * k19 (not in the default parts): K19 w4_grouped_fused_mlp at
    chip_smoke's K19_CASE (Qwen3-30B-A3B's experts, silu, one shared x
    row) at n = 1, 8 and 16 selections, beside its bound and its yardstick,
    what the port runs without it (K8 gate|up, silu * up, K8 down, as
    chip_smoke's fused_rows builds it): no one PyTorch call computes it;
  * k3a (not in the default parts): K3a kv_write_int8 at B = 8, Hkv = 32,
    S = 256 and D = 64, 128 and 256, in bf16 and f32, beside its bound;
  * k8 (not in the default parts): K8 w4_grouped_gemv at the sparse MoE
    decode paths' shapes, with the sums a Mixtral b1, Qwen3 b1 and Qwen3
    b8 decode step make, and the long-run case; the Mixtral gate|up read
    four ways (the profiler's back-to-back device time, an event pair
    around one call with L2 flushed and without, events around 20
    back-to-back calls).

Each kernel reading is torch.profiler's device time of back-to-back calls
(the split sum included; L2 warm, so a layer of 11-34 MB is read from L2
after the first call), through the public wrappers only (k9_targets and
k8_heads aside),
so a parent tree without this script's names runs it unchanged. It prints one JSON line a
reading, the card's name and power limit first, and per variant the sum a
decode step makes. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import sys

# projection, K, N; a layer runs the first four, the step the lm_head once
PROJ = (("qkv", 4096, 12288), ("o", 4096, 4096), ("gateup", 4096, 22016), ("down", 11008, 4096),
        ("lm_head", 4096, 32000))
LAYERS = 32
# kernel, bits, scale storage, fused, M: the 2-bit b8 decode step (v3 and
# v4), the 3-bit b1 decode step and its T=32 prefill, and M=1 / 32 for 2 bits
VARIANTS = (
    ("gptq_stacked_gemv", 2, "f32", False, 1), ("gptq_stacked_gemv", 2, "f32", False, 8),
    ("gptq_stacked_gemv", 2, "f32", False, 32), ("gptq_stacked_gemv", 2, "bf16", True, 8),
    ("bitplane_stacked_gemv", 3, "f32", False, 1), ("bitplane_stacked_gemv", 3, "f32", False, 8),
    ("bitplane_stacked_gemv", 3, "f32", False, 32), ("bitplane_stacked_gemv", 3, "bf16", True, 1),
    ("bitplane_stacked_gemv", 3, "bf16", True, 32),
)
# K9 at the engine's per-layer 4-bit g128 shapes: projection, K, N, launches
# a layer (the lm_head once a step); fp16 scales and zeros, as the loaders give
GEMV_PROJ = (("q/k/v/o", 4096, 4096, 4), ("gate/up", 4096, 11008, 2), ("down", 11008, 4096, 1),
             ("lm_head", 4096, 32000, 0))
GEMV_M = (1, 8)
GEMV_8BIT = ("gate/up", 4096, 11008, 8)  # and the 8-bit gate/up at M = 8 (chip_smoke's GPTQ_CASES row)
K15_M = (8, 32)
K9_TARGETS = (264, 396, 528, 660, 792, 1056)
# the kernels of a plain per-layer decode step that are K9: the tensor-core
# body, or the first version's GEMV and its split sum
K9_KERNELS = ("stacked_mma_kernel", "gptq_gemv_kernel", "split_sum_out_kernel")
# K12's kernels in either tree: the quantizer, then the int8 tensor-core
# body and its epilogue, or the first version's GEMV and its split sum
K12_KERNELS = ("quantize_rows_kernel", "stacked_s8_kernel", "a8_epilogue_kernel", "gptq_w4a8_gemv_kernel",
               "split_sum_scaled_kernel")
K12_M = (1, 8, 32)
ENGINE_STEPS = 4
# K8 at the sparse MoE decode paths (config.json widths): case, K, padded N,
# experts, selections, mode ("shared": one token's distinct experts on one
# row; "rows": one row a selection; "sorted": n // 8 tokens' top-8 sorted;
# "runs": sorted ids in runs of K8_RUNS), and the paths' launches a step
K8_SHAPES = (("mixtral gateup", 4096, 28672, 8, 2, "shared"), ("mixtral down", 14336, 4096, 8, 2, "rows"),
             ("qwen3 gateup", 2048, 1536, 128, 8, "shared"), ("qwen3 down", 768, 2048, 128, 8, "rows"),
             ("qwen3 gateup b8", 2048, 1536, 128, 64, "sorted"), ("qwen3 down b8", 768, 2048, 128, 64, "sorted"),
             ("qwen3 down long runs", 768, 2048, 128, 64, "runs"))
K8_RUNS = (12, 12, 10, 10, 10, 10)
# the head blocks K8's split plan may count on (k8_heads), each read with
# heads of up to 8 rows, and the tree's own count with runs off as well
K8_HEADS = (1, 2, 4, 8, 16)
K11_M = (1, 8, 32)
PNP_M = (1, 8)
K8_STEPS = {"mixtral_b1": (32, ("mixtral gateup", "mixtral down")), "qwen3_b1": (48, ("qwen3 gateup", "qwen3 down")),
            "qwen3_b8": (48, ("qwen3 gateup b8", "qwen3 down b8"))}


def stacked(torch, cs, qs, gen, args):
    for kname, bits, sd, fused, M in VARIANTS:
        fn = getattr(qs, kname)
        dtype = torch.float32 if sd == "f32" else torch.bfloat16
        per = {}
        for pname, K, N in PROJ:
            Np = -(-N // 512) * 512
            qw = torch.randint(-(2**31), 2**31, (2, K * bits // 32, Np), dtype=torch.int32, device="cuda",
                               generator=gen)
            sc = (torch.rand((2, K // 128, Np), device="cuda", generator=gen) + 0.5) * cs.widths_scale(bits)
            zs = (sc * ((1 << bits) / 2.0 - 0.5)).to(dtype)
            sc = sc.to(dtype)
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            per[pname] = cs.launch_us(torch, lambda: fn(x, qw, sc, zs, 1, bits, 128, fused), reps=args.reps,
                                      key="") / 1e3
            del qw, sc, zs
        total = LAYERS * sum(per[p] for p in ("qkv", "o", "gateup", "down")) + per["lm_head"]
        print(json.dumps(dict(tag=args.tag, kernel=kname, bits=bits, scales=sd, fused=fused, M=M,
                              device_ms=per, launches=4 * LAYERS + 1, device_ms_129_launches=total)), flush=True)


def k9(torch, cs, gen, args):
    from qllm_tpu_torch.ops import qmm2d
    from qllm_tpu_torch.utils.testing import random_quantized_tensor

    for M in GEMV_M:
        per = {}
        for pname, K, N, _ in GEMV_PROJ:
            qt = random_quantized_tensor(gen, K, N, 4, 128)
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            w = (qt.qweight, qt.scales, qt.zeros, 4, 128)
            per[pname] = cs.launch_us(torch, lambda: qmm2d.gptq_gemv(x, *w), reps=args.reps, key="") / 1e3
            del qt
        total = LAYERS * sum(per[p] * n for p, _, _, n in GEMV_PROJ) + per["lm_head"]
        launches = LAYERS * sum(n for *_, n in GEMV_PROJ) + 1
        print(json.dumps(dict(tag=args.tag, kernel="gptq_gemv", bits=4, scales="fp16", M=M, device_ms=per,
                              launches=launches, device_ms_decode_step=total)), flush=True)
    pname, K, N, M = GEMV_8BIT
    qt = random_quantized_tensor(gen, K, N, 8, 128)
    x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
    w = (qt.qweight, qt.scales, qt.zeros, 8, 128)
    ms = cs.launch_us(torch, lambda: qmm2d.gptq_gemv(x, *w), reps=args.reps, key="") / 1e3
    print(json.dumps(dict(tag=args.tag, kernel="gptq_gemv", bits=8, scales="fp16", M=M, device_ms={pname: ms})),
          flush=True)


def k9_targets(torch, cs, gen, args):
    try:
        from qllm_tpu_torch.ops import tc_plan
    except ImportError:
        print(f"chip_stacked_ab: K9 of the tree {args.tag} takes no target", flush=True)
        return
    from qllm_tpu_torch.ops import _build
    from qllm_tpu_torch.utils.testing import random_quantized_tensor

    lib = _build.load_library()
    for pname, K, N, _ in GEMV_PROJ:
        qt = random_quantized_tensor(gen, K, N, 4, 128)
        for M in GEMV_M:
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            per = {}
            for target in K9_TARGETS:
                splits, units = tc_plan.tc_splits(K // 8, N, target)
                part = torch.empty((splits, M, N), dtype=torch.float32, device="cuda")

                def run():
                    _build.check("gptq_gemv", lib.qllm_gptq_gemv(
                        x.data_ptr(), 0, qt.qweight.data_ptr(), qt.scales.data_ptr(), qt.zeros.data_ptr(),
                        tc_plan.PARAM_TYPES[qt.scales.dtype], _build.ptr(part if splits > 1 else None),
                        out.data_ptr(), 4, M, K, N, 128, splits, units, _build.stream(x)))

                per[f"{target} ({splits} splits)"] = cs.launch_us(torch, run, reps=args.reps, key="") / 1e3
            print(json.dumps(dict(tag=args.tag, kernel="gptq_gemv", targets=True, projection=pname, M=M,
                                  device_ms_by_target=per)), flush=True)
        del qt


def k15(torch, cs, qs, gen, args):
    from qllm_tpu_torch.ops import qmm

    bits = 2
    for M in K15_M:
        per = {}
        for pname, K, N in PROJ:
            Np = -(-N // 512) * 512
            qw = torch.randint(-(2**31), 2**31, (2, K * bits // 32, Np), dtype=torch.int32, device="cuda",
                               generator=gen)
            sc = (torch.rand((2, K // 128, Np), device="cuda", generator=gen) + 0.5) * cs.widths_scale(bits)
            x8, _, _ = qmm.quantize_rows_int8(torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16),
                                              128)
            per[pname] = cs.launch_us(torch, lambda: qs.gptq_stacked_w4a8_gemv(x8, qw, sc, 1, bits, 128),
                                      reps=args.reps, key="") / 1e3
            del qw, sc
        total = LAYERS * sum(per[p] for p in ("qkv", "o", "gateup", "down")) + per["lm_head"]
        print(json.dumps(dict(tag=args.tag, kernel="gptq_stacked_w4a8_gemv", bits=bits, scales="f32", M=M,
                              device_ms=per, launches=4 * LAYERS + 1, device_ms_129_launches=total)), flush=True)


def engine(torch, cs, args, w4a8=False):
    """K9's (K12's with ``w4a8``) device ms per plain decode step of the
    engine at batch 8 (8 greedy requests of 128 tokens, after admission and
    two warm steps)."""
    import time

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.serve import engine as mod

    cfg = ModelConfig(num_hidden_layers=cs.SERVE["LAYERS"], **cs.SEVEN_B)
    params = cs.serve_model(torch, cfg)
    eng = mod.ContinuousBatchingEngine(params, cfg, mod.ServeConfig(max_batch=cs.SERVE["MAX_BATCH"],
                                                                    max_seq=cs.SERVE["MAX_SEQ"], w4a8=w4a8),
                                       device="cuda")
    rng = np.random.default_rng(cs.SERVE["SEED"] + 1)
    for _ in range(cs.SERVE["MAX_BATCH"]):
        eng.submit(rng.integers(0, cfg.vocab_size, 128).astype(np.int32), 96)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ENGINE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    mine = [e for e in kernels if any(k in e.key for k in (K12_KERNELS if w4a8 else K9_KERNELS))]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / ENGINE_STEPS
    ms = sum(e.self_device_time_total for e in mine) / 1e3 / ENGINE_STEPS
    k = "k12" if w4a8 else "k9"
    print(json.dumps({"tag": args.tag, "kernel": "gptq_w4a8_gemv" if w4a8 else "gptq_gemv", "engine_decode_step": True,
                      "w4a8": w4a8, "batch": cs.SERVE["MAX_BATCH"], f"{k}_device_ms_per_step": ms,
                      f"{k}_kernel_launches_per_step": sum(e.count for e in mine) / ENGINE_STEPS,
                      "device_busy_ms_per_step": busy, "wall_ms_per_step": wall_ms / ENGINE_STEPS}), flush=True)
    del eng, params
    torch.cuda.empty_cache()


def k12(torch, cs, gen, args):
    import dataclasses

    from qllm_tpu_torch.ops import qmm2d
    from qllm_tpu_torch.utils.testing import random_quantized_tensor

    def us(fn):
        return cs.launch_us(torch, fn, reps=args.reps, key="") / 1e3

    one = torch.zeros(1, device="cuda")  # the profiler's reading of a one-element fill: a launch's floor
    print(json.dumps(dict(tag=args.tag, device_ms_one_element_fill=us(one.zero_))), flush=True)
    for M in K12_M:
        per = {}
        for pname, K, N, _ in GEMV_PROJ:
            qt = random_quantized_tensor(gen, K, N, 4, 128)
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            w = (qt.qweight, qt.scales, qt.zeros, 4, 128)
            per[pname] = us(lambda: qmm2d.gptq_w4a8_gemv(x, *w))
            if M == 8 and pname in ("q/k/v/o", "gate/up"):  # each of the call's kernels
                parts = {k: cs.launch_us(torch, lambda: qmm2d.gptq_w4a8_gemv(x, *w), reps=args.reps, key=k) / 1e3
                         for k in K12_KERNELS}
                print(json.dumps(dict(tag=args.tag, kernel="gptq_w4a8_gemv", M=M, projection=pname,
                                      device_ms_by_kernel={k: v for k, v in parts.items() if v})), flush=True)
            del qt
        total = LAYERS * sum(per[p] * n for p, _, _, n in GEMV_PROJ) + per["lm_head"]
        launches = LAYERS * sum(n for *_, n in GEMV_PROJ) + 1
        print(json.dumps(dict(tag=args.tag, kernel="gptq_w4a8_gemv", bits=4, scales="fp16", M=M, device_ms=per,
                              launches=launches, device_ms_decode_step=total)), flush=True)
    qt = random_quantized_tensor(gen, 4096, 4096, 4, 128, act_order=True)
    x = torch.randn((8, 4096), device="cuda", generator=gen).to(torch.bfloat16)
    ms = us(lambda: qmm2d.qmatmul_2d(x, qt, w4a8=True))
    print(json.dumps(dict(tag=args.tag, kernel="gptq_w4a8_gemv", bits=4, scales="fp16", M=8,
                          device_ms={"q/k/v/o act-order": ms})), flush=True)
    qt = random_quantized_tensor(gen, 11008, 4096, 2, 128)
    qt = dataclasses.replace(qt, scales=qt.scales.float(), zeros=qt.zeros.float())
    x = torch.randn((8, 11008), device="cuda", generator=gen).to(torch.bfloat16)
    ms = us(lambda: qmm2d.gptq_w4a8_gemv(x, qt.qweight, qt.scales, qt.zeros, 2, 128))
    print(json.dumps(dict(tag=args.tag, kernel="gptq_w4a8_gemv", bits=2, scales="f32", M=8, device_ms={"down": ms})),
          flush=True)
    del qt
    engine(torch, cs, args, w4a8=True)


def planar(torch, cs, gen, args):
    from qllm_tpu_torch.ops import qmm, qmm_planar

    for M in (1, 8):
        k1, k1n, k17 = {}, {}, {}
        for pname, K, N in PROJ:
            Np = -(-N // 512) * 512
            qw = torch.randint(-(2**31), 2**31, (2, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
            sc = (torch.rand((2, K // 128, Np), device="cuda", generator=gen) + 0.5) * 0.01
            zs = (sc * 8).to(torch.bfloat16)
            sb = sc.to(torch.bfloat16)
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            k1[pname] = cs.launch_us(torch, lambda: qmm.w4_planar_gemv(x, qw, sb, zs, 1), reps=args.reps,
                                     key="") / 1e3
            if pname in ("qkv", "gateup"):  # the inputs the main path normalises in K1
                nw = (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
                k1n[pname] = cs.launch_us(torch, lambda: qmm.w4_planar_gemv(x, qw, sb, zs, 1, nw, 1e-5),
                                          reps=args.reps, key="") / 1e3
            k17[pname] = cs.launch_us(torch, lambda: qmm_planar.w4_planar_f32s_gemv(x, qw, sc, 1), reps=args.reps,
                                      key="") / 1e3
            del qw, sc, zs, sb
        for kname, per in (("w4_planar_gemv", k1), ("w4_planar_gemv +norm", k1n), ("w4_planar_f32s_gemv", k17)):
            print(json.dumps(dict(tag=args.tag, kernel=kname, M=M, device_ms=per)), flush=True)


def k8_ids(torch, gen, E, n, mode):
    if mode in ("shared", "rows"):  # distinct experts
        return torch.randperm(E, generator=gen, device="cuda")[:n].sort().values.to(torch.int32)
    if mode == "sorted":
        return torch.cat([torch.randperm(E, generator=gen, device="cuda")[:8] for _ in range(n // 8)]).sort().values.to(
            torch.int32)
    chosen = torch.randperm(E, generator=gen, device="cuda")[: len(K8_RUNS)].tolist()
    return torch.tensor(sorted(e for e, r in zip(chosen, K8_RUNS) for _ in range(r)), dtype=torch.int32, device="cuda")


def k8(torch, cs, gen, args):
    from qllm_tpu_torch.ops import qmm

    per = {}
    for cname, K, Np, E, n, mode in K8_SHAPES:
        qw = torch.randint(-(2**31), 2**31, (E, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
        sc = ((torch.rand((E, K // 128, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
        zs = (sc.float() * 8).to(torch.bfloat16)
        ids = k8_ids(torch, gen, E, n, mode)
        shared = mode == "shared"
        x = torch.randn((1 if shared else n, K), device="cuda", generator=gen).to(torch.bfloat16)

        def run():
            return qmm.w4_grouped_gemv(x, qw, sc, zs, ids, shared)

        per[cname] = cs.launch_us(torch, run, reps=args.reps, key="") / 1e3
        row = dict(tag=args.tag, kernel="w4_grouped_gemv", case=cname, K=K, Np=Np, E=E, n=n, mode=mode,
                   experts=len(set(ids.tolist())), device_ms=per[cname])
        if cname == "mixtral gateup":  # the same call read four ways
            flushed = cs.Timer(torch)
            row["event_ms_l2_flushed"] = flushed(run, reps=args.reps)
            del flushed
            times = []
            for _ in range(args.reps):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            row["event_ms_warm"] = sorted(times)[len(times) // 2]
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            run()
            a.record()
            for _ in range(args.reps):
                run()
            b.record()
            b.synchronize()
            row["event_ms_back_to_back"] = a.elapsed_time(b) / args.reps
        print(json.dumps(row), flush=True)
        del qw, sc, zs
        torch.cuda.empty_cache()
    for path, (layers, names) in K8_STEPS.items():
        print(json.dumps(dict(tag=args.tag, kernel="w4_grouped_gemv", path=path, launches=2 * layers,
                              device_ms_per_step=layers * sum(per[c] for c in names))), flush=True)


def k8_heads(torch, cs, gen, args):
    try:
        from qllm_tpu_torch.ops.qmm import GROUPED_RUN_ROWS, grouped_plan_heads
    except ImportError:
        print(f"chip_stacked_ab: K8 of the tree {args.tag} plans no fixed heads", flush=True)
        return
    from qllm_tpu_torch.ops import _build, tc_plan

    lib = _build.load_library()
    per = {}
    for cname, K, Np, E, n, mode in K8_SHAPES:
        qw = torch.randint(-(2**31), 2**31, (E, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
        sc = ((torch.rand((E, K // 128, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
        zs = (sc.float() * 8).to(torch.bfloat16)
        ids = k8_ids(torch, gen, E, n, mode)
        shared = mode == "shared"
        x = torch.randn((1 if shared else n, K), device="cuda", generator=gen).to(torch.bfloat16)
        out = torch.empty((n, Np), dtype=torch.bfloat16, device="cuda")
        ms, splits_of = {}, {}
        plans = [(h, GROUPED_RUN_ROWS) for h in K8_HEADS] + [(grouped_plan_heads(K, Np), 1)]
        for heads, rows in plans:
            splits, units = tc_plan.tc_splits(K // 8, Np, tc_plan.TC_TARGET_BLOCKS["planar"], row_blocks=heads)
            part = torch.empty((splits, n, Np), dtype=torch.float32, device="cuda")

            def run():
                _build.check("w4_grouped_gemv", lib.qllm_w4_grouped_gemv(
                    x.data_ptr(), qw.data_ptr(), sc.data_ptr(), zs.data_ptr(), ids.data_ptr(),
                    _build.ptr(part if splits > 1 else None), out.data_ptr(), n, E, int(shared), K, Np, 128, splits,
                    units, rows, _build.stream(x)))

            label = f"{heads} heads" if rows > 1 else "own plan, runs off"
            ms[label] = cs.launch_us(torch, run, reps=args.reps, key="") / 1e3
            splits_of[label] = splits
        per[cname] = ms
        print(json.dumps(dict(tag=args.tag, kernel="w4_grouped_gemv", case=cname, K=K, Np=Np, E=E, n=n, mode=mode,
                              experts=len(set(ids.tolist())), device_ms_by_plan=ms, splits_by_plan=splits_of)),
              flush=True)
        del qw, sc, zs
        torch.cuda.empty_cache()
    for path, (layers, names) in K8_STEPS.items():
        by_plan = {label: layers * sum(per[c][label] for c in names) for label in per[names[0]]}
        print(json.dumps(dict(tag=args.tag, kernel="w4_grouped_gemv", path=path, launches=2 * layers,
                              device_ms_per_step_by_plan=by_plan)), flush=True)


def planar_stack(torch, gen, K, Np, L=2):
    """A random [L]-stacked planar W4 g128 serving stack (bf16 scales,
    prefolded zs) and its layer-1 weight dequantized to bf16."""
    from qllm_tpu_torch.ops import qmm

    qw = torch.randint(-(2**31), 2**31, (L, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
    sc = ((torch.rand((L, K // 128, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
    zs = (sc.float() * 8).to(torch.bfloat16)
    v = qmm._planar_values(qw[1], K).reshape(K // 128, 128, Np)
    w = (v * sc[1].float()[:, None] - zs[1].float()[:, None]).reshape(K, Np).to(torch.bfloat16)
    return qw, sc, zs, w


def k11(torch, cs, gen, args):
    """K11 per call (device ms of all its kernels: the quantizer, the body,
    the split sum), its bound (bytes over 3.35 TB/s against the int8 MMAs
    over 1979 TOP/s) and the library's torch.matmul on the dequantized
    bf16 weight (the normalised x for the row with the norm)."""
    from qllm_tpu_torch.ops import qmm

    def us(fn):
        return cs.launch_us(torch, fn, reps=args.reps, key="") / 1e3

    for pname, K, N in PROJ:
        Np = -(-N // 512) * 512
        qw, sc, zs, w = planar_stack(torch, gen, K, Np)
        nw = (torch.rand((2, K), device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
        for M in K11_M:
            x = torch.randn((M, K), device="cuda", generator=gen).to(torch.bfloat16)
            for norm in (False, True) if pname == "gateup" else (False,):
                a = (x, qw, sc, zs, 1, nw if norm else None, 1e-5)
                xin = qmm._rms_norm_rows(x, nw[1], 1e-5) if norm else x
                nbytes = qw[1].numel() * 4 + 2 * sc[1].numel() * 2 + M * K * 2 + M * Np * 2 + (K * 2 if norm else 0)
                b_ms, b_by = cs.bound(nbytes, 2.0 * M * K * Np, cs.PEAK_INT8)
                print(json.dumps(dict(tag=args.tag, kernel="w4a8_planar_gemv", projection=pname + (" +norm" if norm else ""),
                                      K=K, Np=Np, M=M, device_ms=us(lambda: qmm.w4a8_planar_gemv(*a)),
                                      library_device_ms=us(lambda: torch.matmul(xin, w)), bound_ms=b_ms,
                                      bound_by=b_by)), flush=True)
        del qw, sc, zs, w
        torch.cuda.empty_cache()


def pnp(torch, cs, gen, args):
    """K20 per call (device ms of all its kernels) at the 7B's o_proj and
    gate|up, its bound, and the K1 pair it fuses (K1 o_proj, + h in f32,
    K1 gate|up with the norm on bf16(hn)): no one PyTorch call computes it."""
    from qllm_tpu_torch.ops import qmm

    def us(fn):
        return cs.launch_us(torch, fn, reps=args.reps, key="") / 1e3

    D, inter = 4096, 11008
    Np = -(-2 * inter // 512) * 512
    q1, s1, z1, _ = planar_stack(torch, gen, D, D)
    q2, s2, z2, _ = planar_stack(torch, gen, D, Np)
    nw = (torch.rand((2, D), device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    for M in PNP_M:
        x1 = torch.randn((M, D), device="cuda", generator=gen).to(torch.bfloat16)
        h = torch.randn((M, D), device="cuda", generator=gen) * 4.0
        a = (x1, h, q1, s1, z1, q2, s2, z2, nw, 1, 1e-5)

        def k1_pair():
            hn1 = h + qmm.w4_planar_gemv(x1, q1, s1, z1, 1).float()
            return qmm.w4_planar_gemv(hn1.to(torch.bfloat16), q2, s2, z2, 1, nw, 1e-5)

        nbytes = (q1[1].numel() * 4 + 2 * s1[1].numel() * 2 + q2[1].numel() * 4 + 2 * s2[1].numel() * 2
                  + M * D * 2 + M * D * 4 + D * 2 + M * D * 4 + M * Np * 2)
        b_ms, b_by = cs.bound(nbytes, 2.0 * M * (D * D + D * Np))
        print(json.dumps(dict(tag=args.tag, kernel="w4_pnp_gemv", M=M, device_ms=us(lambda: qmm.w4_pnp_gemv(*a)),
                              k1_pair_device_ms=us(k1_pair), bound_ms=b_ms, bound_by=b_by)), flush=True)
    del q1, s1, z1, q2, s2, z2
    torch.cuda.empty_cache()


K19_N = (1, 8, 16)
K3A_D = (64, 128, 256)


def k19(torch, cs, gen, args):
    """K19 per call (device ms of all its kernels) at K19_CASE for each of
    K19_N, its bound (the selected experts' bytes over 3.35 TB/s) and the
    yardstick's device ms (K8's two launches and the activation between
    them, all their kernels)."""
    from qllm_tpu_torch.ops import qmm

    def us(fn):
        return cs.launch_us(torch, fn, reps=args.reps, key="") / 1e3

    E, K1, K2, Np2 = (cs.K19_CASE[k] for k in ("E", "K1", "K2", "Np2"))
    gq, gs, gz, _ = planar_stack(torch, gen, K1, 2 * K2, L=E)
    dq, ds, dz, _ = planar_stack(torch, gen, K2, Np2, L=E)
    x = torch.randn((1, K1), device="cuda", generator=gen).to(torch.bfloat16)
    for n in K19_N:
        ids = torch.randperm(E, generator=gen, device="cuda")[:n].to(torch.int32)
        a = (x, gq, gs, gz, dq, ds, dz, ids, K2, "silu", True)

        def two_launch():
            gu = qmm.w4_grouped_gemv(x, gq, gs, gz, ids, True).float()
            act = gu[:, :K2] * torch.sigmoid(gu[:, :K2]) * gu[:, K2 : 2 * K2]
            return qmm.w4_grouped_gemv(act.to(torch.bfloat16), dq, ds, dz, ids, False)

        per_expert = gq[0].numel() * 4 + 2 * gs[0].numel() * 2 + dq[0].numel() * 4 + 2 * ds[0].numel() * 2
        nbytes = n * per_expert + x.numel() * 2 + n * Np2 * 2 + n * 4
        b_ms, b_by = cs.bound(nbytes, 2.0 * n * (K1 * 2 * K2 + K2 * Np2))
        print(json.dumps(dict(tag=args.tag, kernel="w4_grouped_fused_mlp", n=n, K1=K1, K2=K2, Np2=Np2, E=E,
                              device_ms=us(lambda: qmm.w4_grouped_fused_mlp(*a)),
                              yardstick_device_ms=us(two_launch), bound_ms=b_ms, bound_by=b_by)), flush=True)
    del gq, gs, gz, dq, ds, dz
    torch.cuda.empty_cache()


def k3a(torch, cs, gen, args):
    """K3a per call (device ms) at B = 8, Hkv = 32, S = 256 (layer 1 of 2)
    for each head width of K3A_D and each input dtype, beside its bound
    (k and v in, their int8 rows and scales out)."""
    from qllm_tpu_torch.ops import attention as att

    L, B, H, S = 2, 8, 32, 256
    for D in K3A_D:
        caches = (torch.zeros((L, B, H, S, D), dtype=torch.int8, device="cuda"),
                  torch.zeros((L, B, H, S, D), dtype=torch.int8, device="cuda"),
                  torch.zeros((L, B, H, S), device="cuda"), torch.zeros((L, B, H, S), device="cuda"))
        pos = torch.randint(0, S, (B,), dtype=torch.int32, device="cuda", generator=gen)
        for dt in (torch.bfloat16, torch.float32):
            kn = torch.randn((B, H, D), device="cuda", generator=gen).to(dt)
            vn = torch.randn((B, H, D), device="cuda", generator=gen).to(dt)
            es = kn.element_size()
            b_ms, b_by = cs.bound(2 * B * H * D * es + 2 * B * H * D + 2 * B * H * 4 + B * 4)
            dev_ms = cs.launch_us(torch, lambda: att.kv_write_int8(kn, vn, *caches, 1, pos), reps=args.reps,
                                  key="") / 1e3
            print(json.dumps(dict(tag=args.tag, kernel="kv_write_int8", B=B, Hkv=H, S=S, D=D, dtype=str(dt),
                                  device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by)), flush=True)
        del caches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="stacked,k9,k15,engine")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    import torch

    if not torch.cuda.is_available():
        print("chip_stacked_ab: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from qllm_tpu_torch.ops import _build
    from qllm_tpu_torch.ops import qmm_stacked as qs

    print(cs.gpu_name_and_limit(), flush=True)
    _build.load_library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if "stacked" in parts:
        stacked(torch, cs, qs, gen, args)
    if "k9" in parts:
        k9(torch, cs, gen, args)
    if "k15" in parts:
        k15(torch, cs, qs, gen, args)
    if "engine" in parts:
        engine(torch, cs, args)
    if "k9_targets" in parts:
        k9_targets(torch, cs, gen, args)
    if "k12" in parts:
        k12(torch, cs, gen, args)
    if "k8" in parts:
        k8(torch, cs, gen, args)
    if "planar" in parts:
        planar(torch, cs, gen, args)
    if "k8_heads" in parts:
        k8_heads(torch, cs, gen, args)
    if "k11" in parts:
        k11(torch, cs, gen, args)
    if "pnp" in parts:
        pnp(torch, cs, gen, args)
    if "k19" in parts:
        k19(torch, cs, gen, args)
    if "k3a" in parts:
        k3a(torch, cs, gen, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
