"""K19's phase timeline on one H100: a tool for finding where its time goes.

Copies this tree's ``qllm_tpu_torch`` into ``build/k19_timeline/`` with
``%globaltimer`` stamps at the phase edges of ``csrc/fused_mlp.cu``'s
``fused_mlp_kernel`` (for each edge the earliest and the latest block, by
``atomicMin`` / ``atomicMax``), builds the copy, and prints one JSON line a
selection count at ``chip_smoke.K19_CASE`` (silu, one shared x row): each
edge's earliest and latest block in µs from the launch's first block, the
mean over 29 launches after a first, and the launch's error against the
plain version. The stamps cost a global atomic a block and edge, so
compare a timeline only with another timeline, not with a time of
``chip_stacked_ab.py``.

    python3 chip_k19_timeline.py [--n 1,8,16]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COPY = ROOT / "build" / "k19_timeline"
# the edges in stamp order: the consumers' thread 0 (0-7), the producer's lane 0 (8, 9)
EDGES = ("start", "p1_end", "bar1_out", "merge_end", "bar2_out", "p2_end", "bar3_out", "end", "prod_p1_end", "prod_end")

STAMP = """
__device__ unsigned long long g_tmin[16], g_tmax[16];
__device__ __forceinline__ void stamp(int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  atomicMin(g_tmin + i, t);
  atomicMax(g_tmax + i, t);
}
"""

READ = """
// the stamps (16 minima, then 16 maxima) into out, then reset
QLLM_API int qllm_k19_stamps(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_tmin, sizeof(g_tmin));
  cudaMemcpyFromSymbol(out + 16, g_tmax, sizeof(g_tmax));
  unsigned long long lo[16], hi[16];
  for (int i = 0; i < 16; ++i) lo[i] = ~0ull, hi[i] = 0ull;
  cudaMemcpyToSymbol(g_tmin, lo, sizeof(lo));
  cudaMemcpyToSymbol(g_tmax, hi, sizeof(hi));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def stamped(src: str) -> str:
    """fused_mlp.cu with the stamps in fused_mlp_kernel and their reader."""
    src = src.replace("namespace sm = stacked_mma;\n", "namespace sm = stacked_mma;\n" + STAMP, 1)
    k, e = src.index("fused_mlp_kernel("), src.index("// K20: one layer's pointers")
    body = src[k:e]

    def put(old, new):
        nonlocal body
        if body.count(old) != 1:
            raise SystemExit(f"chip_k19_timeline: fused_mlp_kernel has no single {old!r}")
        body = body.replace(old, new)

    put("  sm::init_ring<S>(full, empty, false);", "  if (threadIdx.x == 0) stamp(0);\n  sm::init_ring<S>(full, empty, false);")
    put("W1, sm::kCopyLanes, t);\n    }", "W1, sm::kCopyLanes, t);\n    }\n    if (lane == 0) stamp(8);")
    put("W2, sm::kCopyLanes, t);\n    }\n    return;", "W2, sm::kCopyLanes, t);\n    }\n    if (lane == 0) stamp(9);\n    return;")
    bars = re.findall(r"  grid_barrier\(bar[^;]*;\n", body)
    if len(bars) != 3:
        raise SystemExit(f"chip_k19_timeline: {len(bars)} grid barriers in fused_mlp_kernel, not 3")
    for j, b in enumerate(bars):
        put(b, f"  if (tid == 0) stamp({2 * j + 1});\n{b}  if (tid == 0) stamp({2 * j + 2});\n")
    end = body.rstrip().rfind("}")
    body = body[:end] + "  if (tid == 0) stamp(7);\n" + body[end:]
    return src[:k] + body + src[e:] + READ


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", default="1,8,16", help="selection counts")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_k19_timeline: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "qllm_tpu_torch", COPY / "qllm_tpu_torch", ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "qllm_tpu_torch" / "csrc" / "fused_mlp.cu"
    cu.write_text(stamped(cu.read_text()))
    sys.path.insert(0, str(COPY))  # the stamped copy's package, chip_smoke's constants from this tree
    import chip_smoke as cs
    from qllm_tpu_torch.ops import _build, qmm

    lib = _build.load_library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    E, K1, K2, Np2 = (cs.K19_CASE[k] for k in ("E", "K1", "K2", "Np2"))

    def stack(K, Np):
        qw = torch.randint(-(2**31), 2**31, (E, K // 8, Np), dtype=torch.int32, device="cuda", generator=gen)
        sc = ((torch.rand((E, K // 128, Np), device="cuda", generator=gen) + 0.5) * 0.01).to(torch.bfloat16)
        return qw, sc, (sc.float() * 8).to(torch.bfloat16)

    gq, gs, gz = stack(K1, 2 * K2)
    dq, ds, dz = stack(K2, Np2)
    x = torch.randn((1, K1), device="cuda", generator=gen).to(torch.bfloat16)
    buf = (ctypes.c_ulonglong * 32)()
    for n in (int(v) for v in args.n.split(",")):
        ids = torch.randperm(E, generator=gen, device="cuda")[:n].to(torch.int32)
        a = (x, gq, gs, gz, dq, ds, dz, ids, K2, "silu", True)
        edges = {}
        for it in range(30):
            y = qmm.w4_grouped_fused_mlp(*a)
            torch.cuda.synchronize()
            _build.check("qllm_k19_stamps", lib.qllm_k19_stamps(buf))
            if it == 0:  # the stamps start at zero: the first launch only resets them
                continue
            for i, name in enumerate(EDGES):
                if buf[16 + i]:
                    edges.setdefault(f"{name}_min", []).append((buf[i] - buf[0]) / 1e3)
                    edges.setdefault(f"{name}_max", []).append((buf[16 + i] - buf[0]) / 1e3)
        ref = qmm.w4_grouped_fused_mlp_plain(*a).float()
        err = float((y.float() - ref).abs().max())
        print(json.dumps({"n": n, "max_abs_err": err, "tol": cs.bf16_ulp(ref),
                          **{k: round(statistics.fmean(v), 2) for k, v in edges.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
