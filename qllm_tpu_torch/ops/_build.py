"""Build and load the package's hand-written CUDA kernels.

Every ``qllm_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together) and linked
into one shared library with a plain C interface, loaded with
``ctypes``:

    build/qllm_tpu_torch/libqllm_tpu_torch_kernels.so

beside the package's parent directory. A stamp file holds the SHA-256
of the sources, so the library is rebuilt only when a source changes.
The build runs at the first launch of a kernel, never at import, and
raises (with the command it tried) when ``nvcc`` is missing or fails.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch

__all__ = ["load_library", "check", "ptr", "stream", "build_dir"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_LIB_NAME = "libqllm_tpu_torch_kernels.so"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p
_SIGNATURES = {
    "qllm_w4_planar_gemv": [_P] * 7 + [_I] * 8 + [_F, _P],
    "qllm_w4_planar_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "qllm_w4_grouped_gemv": [_P] * 7 + [_I] * 9 + [_P],
    "qllm_kv_write_int8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "qllm_decode_attn_int8": [_P] * 7 + [_I] * 6 + [_F, _F, _F, _P, _P, _P, _P, _I, _P],
    "qllm_decode_attn_int8_4d": [_P] * 7 + [_I] * 5 + [_F, _F, _F, _P, _P, _P, _P, _I, _P],
    "qllm_decode_attn_int8_partial": [_P] * 9 + [_I] * 6 + [_F, _P, _P, _I, _P],
    "qllm_planarize_w4": [_P, _P, _I, _I, _I, _P],
    "qllm_decode_attn_ring": [_P] * 11 + [_I] * 6 + [_F, _P, _P, _I, _P],
    "qllm_kv_ring_flush": [_P] * 7 + [_I] * 5 + [_P],
    "qllm_flash_prefill": [_P] * 7 + [_I] * 6 + [_L] * 3 + [_I, _I, _F, _F, _F, _P, _P],
    "qllm_gptq_gemv": [_P, _I, _P, _P, _P, _I, _P, _P] + [_I] * 7 + [_P],
    "qllm_gptq_gemm": [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P] + [_I] * 9 + [_P],
    "qllm_quantize_rows_int8": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
    "qllm_w4a8_planar_gemv": [_P, _I] + [_P] * 6 + [_I, _F, _P, _P] + [_I] * 7 + [_P],
    "qllm_gptq_w4a8_gemv": [_P, _I] + [_P] * 7 + [_I, _P, _P] + [_I] * 7 + [_P],
    "qllm_stream_pass": [_P, _P] + [_I] * 5 + [_P],
    "qllm_gptq_stacked_gemv": [_P, _I, _P, _P, _P, _I, _P, _P] + [_I] * 9 + [_P],
    "qllm_gptq_stacked_w4a8_gemv": [_P, _P, _P, _I, _P, _P] + [_I] * 8 + [_P],
    "qllm_bitplane_stacked_gemv": [_P, _I, _P, _P, _P, _I, _P, _P] + [_I] * 9 + [_P],
    "qllm_w4_planar_f32s_gemv": [_P] * 5 + [_I] * 7 + [_P],
    "qllm_w4_planar_f32s_gemm": [_P] * 4 + [_I] * 5 + [_P],
    "qllm_w4_grouped_fused_mlp": [_P] * 13 + [_I] * 13 + [_P],
    "qllm_w4_pnp_gemv": [_P] * 3 + [_I] + [_P] * 13 + [_I] * 11 + [_F, _P],
}

_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    return _PKG.parent / "build" / "qllm_tpu_torch"


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_ARCH + _FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _run_all(cmds: List[List[str]], log: Path) -> None:
    """Run the commands concurrently; log each one's output and the
    seconds from the start until it ended; raise naming the first that
    fails."""
    t0 = time.perf_counter()
    procs = []
    for cmd in cmds:
        out = tempfile.TemporaryFile()
        try:
            procs.append((cmd, out, subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)))
        except FileNotFoundError as e:
            out.close()
            for _, o, p in procs:
                p.kill()
                p.wait()
                o.close()
            raise RuntimeError(f"nvcc not found; tried: {' '.join(cmd)}") from e
    ended = {}
    while len(ended) < len(procs):
        for i, (_, _, p) in enumerate(procs):
            if i not in ended and p.poll() is not None:
                ended[i] = time.perf_counter() - t0
        time.sleep(0.05)
    failed = None
    with open(log, "ab") as f:
        for i, (cmd, out, p) in enumerate(procs):
            out.seek(0)
            text = out.read()
            out.close()
            what = Path(cmd[cmd.index("-c") + 1]).name if "-c" in cmd else "link"
            f.write(f"$ {' '.join(cmd)}\n".encode() + text + f"[build seconds] {what} {ended[i]:.1f}\n".encode())
            if p.returncode != 0 and failed is None:
                failed = (cmd, text.decode(errors="replace"))
    if failed is not None:
        cmd, out = failed
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n{out[-4000:]}")


def _build(out: Path, digest: str) -> None:
    bdir = out.parent
    bdir.mkdir(parents=True, exist_ok=True)
    log = bdir / "build.log"
    log.write_bytes(b"")
    nvcc = _nvcc()
    objs, cmds = [], []
    for src in _sources():
        obj = bdir / f"{src.stem}.o"
        objs.append(obj)
        cmds.append([nvcc, *_ARCH, *_FLAGS, "-I", str(_CSRC), "-c", str(src), "-o", str(obj)])
    _run_all(cmds, log)
    tmp = bdir / f"{_LIB_NAME}.tmp{os.getpid()}"
    _run_all([[nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]], log)
    os.replace(tmp, out)
    (bdir / f"{_LIB_NAME}.sha256").write_text(digest)


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    out = build_dir() / _LIB_NAME
    stamp = build_dir() / f"{_LIB_NAME}.sha256"
    digest = _digest()
    if not (out.exists() and stamp.exists() and stamp.read_text() == digest):
        _build(out, digest)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def use_kernel(t: torch.Tensor, name: str) -> bool:
    """The dispatch rule of every op: a CUDA tensor launches the kernel,
    a CPU tensor takes the plain version, anything else is refused."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: tensors on {t.device} are not served")


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
