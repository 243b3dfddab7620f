"""Continuous-batching request serving (the counterpart of
``qllm_tpu/serve``; its tensor-parallel engine is not ported)."""

from .engine import ContinuousBatchingEngine, Request, SamplingParams, ServeConfig

__all__ = ["ContinuousBatchingEngine", "Request", "SamplingParams", "ServeConfig"]
