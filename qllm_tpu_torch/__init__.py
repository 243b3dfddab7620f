"""PyTorch / CUDA port of qllm_tpu for one NVIDIA H100 (sm_90a).

Mirrors the JAX package's layout (quant/, ops/, models/, utils/); every
Pallas kernel on the ported path has a hand-written CUDA kernel under
csrc/, built at first use by ops/_build.py. Imports neither jax nor
qllm_tpu.
"""

__version__ = "0.1.0"
