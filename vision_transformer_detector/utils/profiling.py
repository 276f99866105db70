"""Profiling and timing utilities.

The reference's only timing is wall-clock bookends in the notebook
(SURVEY.md §5 tracing); here:
  * ``trace`` — context manager around ``jax.profiler`` writing a
    TensorBoard-loadable trace,
  * ``time_jitted`` — compile-then-time loop ending in
    ``block_until_ready``,
  * ``flops_estimate`` — analytic FLOPs of a detector config, for
    achieved-FLOP/s reporting in the benchmark suite.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

from ..config import DetectorConfig


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: ``with trace('/tmp/trace'): step()``."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_jitted(fn: Callable, *args, iterations: int = 10,
                warmup: int = 1) -> Tuple[float, float]:
    """(seconds_per_call, calls_per_second) for a jitted fn: ``warmup``
    calls compile it, then ``iterations`` calls are timed up to
    ``block_until_ready`` on the last result (the device runs one
    stream's programs in order, so that waits for every call)."""
    import jax

    result = None
    for _ in range(max(1, warmup)):
        result = fn(*args)
    jax.block_until_ready(result)
    tic = time.perf_counter()
    for _ in range(iterations):
        result = fn(*args)
    jax.block_until_ready(result)
    per_call = (time.perf_counter() - tic) / iterations
    return per_call, 1.0 / per_call


def flops_estimate(config: DetectorConfig, batch_size: int = 1) -> float:
    """Analytic forward FLOPs (matmuls only; 2*M*N*K convention)."""
    tokens = config.num_patches
    d = config.embedding_dim
    h, k = config.num_heads, config.key_dim

    flops = 2.0 * tokens * config.patch_dim * d  # patch projection

    per_block = 0.0
    per_block += 3 * 2.0 * tokens * d * h * k       # qkv projections
    if config.attention_window:
        window_tokens = config.attention_window ** 2
        per_block += 2 * 2.0 * tokens * window_tokens * h * k
    else:
        per_block += 2 * 2.0 * tokens * tokens * h * k  # scores + p@v
    per_block += 2.0 * tokens * h * k * d           # output projection
    in_dim = d
    for units in config.encoder_mlp_units:
        per_block += 2.0 * tokens * in_dim * units
        in_dim = units
    flops += config.encoder_blocks * per_block

    if config.head_scales == (1,):
        flops += 2.0 * tokens * d * config.max_objects  # token dense
        in_dim = config.num_patches
    else:
        # Multi-scale head (models/vit_detector.py): one token-dense per
        # pooled grid; the per-slot feature concatenates over scales.
        gh, gw = config.grid_size
        in_dim = 0
        for s in config.head_scales:
            pooled = (gh // s) * (gw // s)
            flops += 2.0 * pooled * d * config.max_objects
            in_dim += pooled
    for units in config.head_units:
        for _ in range(config.head_block_repeats):
            flops += 2.0 * config.max_objects * in_dim * units
            in_dim = units
    flops += 2.0 * config.max_objects * in_dim * 6

    return flops * batch_size
