"""Read-only streaming microbench over packed-weight stacks (the
counterpart of ``qllm_tpu/ops/stream_bench.py``).

A pass reads every int32 word of one layer of an ``[L, K/8, N]`` stack
and reduces it to per-column sums, doing no dequantization or product:
the practical bandwidth ceiling for the serving kernels' weight stream,
against which decode is judged (``bench.py``'s ``vs_practical``). CUDA
kernel K13 ``stream_pass`` (csrc/stream.cu) replaces ``_stream_kernel``.

``stream_pass_seconds`` times passes with CUDA events, the layer cycling
from pass to pass so that L2 (50 MB on the H100) does not serve a pass
from the last one; one C call launches them all, so the host's launch
cost stays out of the reading (the JAX package slope-times chained
passes inside one jit for the same reason). The TPU's ``bk`` / ``bn``
block arguments do not carry over. ``measure_stream_gbps`` keeps the JAX
package's byte count (K * N / 2 a pass) and its default geometry, the 7B
gate|up stack (K = 4096, N = 22016, L = 4: 45.1 MB a pass). Both measure
the card: they raise on the CPU.
"""

from __future__ import annotations

import statistics
from typing import Union

import torch

from . import _build
from ..utils.device import resolve_device

__all__ = ["stream_pass", "stream_pass_plain", "stream_pass_seconds", "stream_gbps", "measure_stream_gbps"]


def stream_pass_plain(qweight: torch.Tensor, layer: int, passes: int = 1) -> torch.Tensor:
    """The plain version of K13: int32 [N] column sums of the words of
    layers layer, layer + 1, ... (cycling, ``passes`` of them), modulo
    2^32. For words in 0..254 (``measure_stream_gbps``'s) they are exact
    and equal the JAX kernel's [8, N] output summed over its rows."""
    L = qweight.shape[0]
    tot = torch.zeros(qweight.shape[-1], dtype=torch.int64, device=qweight.device)
    for i in range(passes):
        tot += qweight[(layer + i) % L].to(torch.int64).sum(dim=0)
    return (tot & 0xFFFFFFFF).to(torch.int32)


def stream_pass(qweight: torch.Tensor, layer: int, passes: int = 1) -> torch.Tensor:
    """K13: ``passes`` read-only passes over layers layer, layer + 1, ...
    of an int32 [L, rows, N] stack (N % 4 == 0) -> int32 [N] column sums
    (see the plain version). Bound: bytes (rows * N * 4 a pass) over
    3.35 TB/s. Counts one launch per pass."""
    if not _build.use_kernel(qweight, "stream_pass"):
        return stream_pass_plain(qweight, layer, passes)
    if qweight.dtype != torch.int32 or qweight.dim() != 3 or not qweight.is_contiguous():
        raise ValueError("stream_pass: qweight must be a contiguous int32 [L, rows, N] stack")
    L, rows, N = qweight.shape
    if N % 4 or qweight.data_ptr() % 16 or not 0 <= layer < L or passes < 1:
        raise ValueError(f"stream_pass: needs N % 4 == 0, a 16-byte aligned stack, 0 <= layer < {L}, passes >= 1")
    out = torch.empty((N,), dtype=torch.int32, device=qweight.device)
    code = _build.load_library().qllm_stream_pass(
        qweight.data_ptr(), out.data_ptr(), L, rows, N, layer, passes, _build.stream(qweight)
    )
    _build.check("stream_pass", code)
    stream_pass.launches += passes
    return out


stream_pass.launches = 0


def stream_pass_seconds(qweight: torch.Tensor, iters: int = 512) -> float:
    """Seconds for one read-only pass over one layer of the packed
    [L, K/8, N] stack on the card: ``iters`` passes per reading, layers
    cycling, timed with CUDA events after a warm-up; the median of three
    readings."""
    if not qweight.is_cuda:
        raise ValueError("stream_pass_seconds measures the card: qweight must be a CUDA tensor")
    L = qweight.shape[0]
    stream_pass(qweight, 0, min(L, iters))  # warm-up (and the kernels' build)
    per = []
    for r in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stream_pass(qweight, r % L, iters)
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(per)


def stream_gbps(K: int, N: int, seconds: float) -> float:
    """GB/s of one pass over a W4 [K, N] packed layer: K * N / 2 bytes
    (the JAX package's count, K * N * 4 / 8) in ``seconds``."""
    return K * N * 4 / 8 / seconds / 1e9


def measure_stream_gbps(
    K: int = 4096,
    N: int = 22016,
    L: int = 4,
    iters: int = 512,
    device: Union[str, torch.device] = "cuda",
) -> float:
    """Practical streaming GB/s on the card for a W4 [K, N] packed stack
    (default: the 7B gate|up geometry, the byte-dominant serving shape):
    K * N / 2 bytes a pass over ``stream_pass_seconds``. The words, 0..254
    as in the JAX package, are drawn on the card from seed 0."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure_stream_gbps measures the card; there is no CPU reading")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    qw = torch.randint(0, 255, (L, K // 8, N), dtype=torch.int32, device=dev, generator=gen)
    return stream_gbps(K, N, stream_pass_seconds(qw, iters=iters))
