"""Device time of the decode GEMVs on the tensor-core body per launch, for
the package of the working directory: run it from the root of each tree of
an A/B (an archived parent beside this one) in one call on the card, so
that both sides share the card and its power limit.

    python3 chip_stacked_ab.py [--tag NAME] [--reps N] [--parts stacked,k9,k15,engine,k9_targets]

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
    split plan of each of K9_TARGETS, the blocks a launch may hold.

Each kernel reading is torch.profiler's device time of back-to-back calls
(the split sum included; L2 warm, so a layer of 11-34 MB is read from L2
after the first call), through the public wrappers only (k9_targets aside),
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
ENGINE_STEPS = 4


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


def engine(torch, cs, args):
    """K9's device ms per plain decode step of the engine at batch 8 (8
    greedy requests of 128 tokens, after admission and two warm steps)."""
    import time

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qllm_tpu_torch.models.llama import ModelConfig
    from qllm_tpu_torch.serve import engine as mod

    cfg = ModelConfig(num_hidden_layers=cs.SERVE["LAYERS"], **cs.SEVEN_B)
    params = cs.serve_model(torch, cfg)
    eng = mod.ContinuousBatchingEngine(params, cfg, mod.ServeConfig(max_batch=cs.SERVE["MAX_BATCH"],
                                                                    max_seq=cs.SERVE["MAX_SEQ"]), device="cuda")
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
    mine = [e for e in kernels if any(k in e.key for k in K9_KERNELS)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / ENGINE_STEPS
    k9_ms = sum(e.self_device_time_total for e in mine) / 1e3 / ENGINE_STEPS
    print(json.dumps(dict(tag=args.tag, kernel="gptq_gemv", engine_decode_step=True, batch=cs.SERVE["MAX_BATCH"],
                          k9_device_ms_per_step=k9_ms, k9_kernel_launches_per_step=sum(e.count for e in mine)
                          / ENGINE_STEPS, device_busy_ms_per_step=busy, wall_ms_per_step=wall_ms / ENGINE_STEPS)),
          flush=True)
    del eng, params
    torch.cuda.empty_cache()


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
