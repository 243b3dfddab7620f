"""Device time of K14 gptq_stacked_gemv and K16 bitplane_stacked_gemv per
launch at the Llama-2-7B stacked projections, for the package of the
working directory: run it from the root of each tree of an A/B (an
archived parent beside this one) in one call on the card, so that both
sides share the card and its power limit.

    python3 chip_stacked_ab.py [--tag NAME] [--reps N]

Each reading is torch.profiler's device time of back-to-back calls (the
split sum included; L2 warm, so a layer of a 2/3-bit 7B stack, 11-34 MB,
is read from L2 after the first call), through the public wrappers only,
so a parent tree without this script's names runs it unchanged. It
prints one JSON line a reading, the card's name and power limit first,
and per variant the sum a decode step or a prefill of 32 layers makes
(4 projections a layer and the lm_head). Needs a CUDA device."""

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
