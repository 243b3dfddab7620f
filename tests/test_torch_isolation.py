"""The port stands alone: importing every qllm_tpu_torch module (and
chip_smoke.py) loads neither jax nor qllm_tpu, and the entry points run
on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import qllm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(qllm_tpu_torch.__path__, "qllm_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "qllm_tpu" or m.startswith("qllm_tpu."))
print(len(names), bad)
assert len(names) >= 16 and "qllm_tpu_torch.models.moe" in names, names
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    from qllm_tpu_torch.models.llama import ModelConfig

    return ModelConfig(
        vocab_size=64, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1,
    )


def _tiny_moe():
    import dataclasses

    return dataclasses.replace(
        _tiny(), hidden_size=256, arch="qwen3_moe", num_local_experts=4, num_experts_per_tok=1,
        moe_router="deepseek", norm_topk_prob=True, qk_norm="rms",
    )


def _entry_points():
    from qllm_tpu_torch.interop import params_from_numpy
    from qllm_tpu_torch.models.decode_loop import decode_loop
    from qllm_tpu_torch.models.generate import decode_step, greedy_generate, make_cache, prefill
    from qllm_tpu_torch.models.stacked import stack_layer_params_hybrid
    from qllm_tpu_torch.utils.testing import random_quantized_params

    cfg = _tiny()
    params = random_quantized_params(cfg, 0, device="cpu")
    cache = make_cache(cfg, 1, 16, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    mcfg = _tiny_moe()
    moe = stack_layer_params_hybrid(random_quantized_params(mcfg, 0, device="cpu", experts_prestacked=True))
    moe_cache = make_cache(mcfg, 1, 16, device="cpu")
    return {
        "random_quantized_params_moe": lambda **kw: random_quantized_params(mcfg, 0, experts_prestacked=True, **kw),
        "make_cache_moe": lambda **kw: make_cache(mcfg, 1, 16, **kw),
        "decode_loop_moe": lambda **kw: decode_loop(moe, mcfg, tok, moe_cache, 0, 2, **kw),
        "make_cache": lambda **kw: make_cache(cfg, 1, 16, **kw),
        "random_quantized_params": lambda **kw: random_quantized_params(cfg, 0, **kw),
        "params_from_numpy": lambda **kw: params_from_numpy({"norm": [1.0, 2.0]}, **kw),
        "prefill": lambda **kw: prefill(params, cfg, tok, cache, **kw),
        "decode_step": lambda **kw: decode_step(params, cfg, tok, cache, 0, **kw),
        "greedy_generate": lambda **kw: greedy_generate(params, cfg, tok, 2, **kw),
        "decode_loop": lambda **kw: decode_loop(params, cfg, tok, cache, 0, 2, **kw),
    }


@pytest.mark.parametrize(
    "name",
    ["make_cache", "random_quantized_params", "params_from_numpy", "prefill",
     "decode_step", "greedy_generate", "decode_loop", "random_quantized_params_moe",
     "make_cache_moe", "decode_loop_moe"],
)
def test_entry_points_default_to_the_card(no_cuda, name):
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    call(device="cpu")  # the CPU runs only when asked for
