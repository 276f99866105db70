"""Attention implementations timed at each preset's shape on one GPU.

For the four attention shapes of chip_smoke.py (vit_b16_384, vit_l16_640,
highres_1024's windows, reference_608) this times, forward and
forward+backward:

  * ``einsum``  — the model's plain path: score einsum, fp32 softmax,
    probabilities cast to the compute dtype, output einsum (the
    ``use_flash_attention=False`` route of models/vit_detector.py),
  * ``cudnn``   — ``jax.nn.dot_product_attention(implementation="cudnn")``
    with cuDNN's own backward (half precision only),
  * ``chunked`` — kernels/flash_attention.py's custom VJP,
  * ``triton``  — the Pallas-through-Triton ``mha`` kernel that ships with
    JAX (``jax.experimental.pallas.ops.gpu.attention``): a library
    kernel, called as it is, not one this repository wrote.

reference_608 trains with probability dropout 0.1, which only ``einsum``
and ``chunked`` can apply; it is timed with and without it. Each line
printed is one JSON object; the card's name and power limit lead. Run on
the GPU:  python tools/bench_attention.py [--iterations 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (preset, batch, N, H, K, dtype, dropout) — the preset's inference or
# training batch; highres_1024's is 8 images x 16 windows of 256 tokens.
SHAPES = [
    ("vit_b16_384", 64, 576, 12, 64, "bfloat16", None),
    ("vit_l16_640", 8, 1600, 16, 64, "bfloat16", None),
    ("highres_1024", 128, 256, 16, 64, "bfloat16", None),
    ("reference_608", 8, 1296, 8, 40, "float32", None),
    ("reference_608", 8, 1296, 8, 40, "float32", 0.1),
]


def _einsum(q, k, v, rate, rng):
    import jax
    import jax.numpy as jnp

    scores = jnp.einsum("bnhk,bmhk->bhnm", q, k,
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(scores, axis=-1)
    if rate is not None:
        keep = jax.random.bernoulli(rng, 1.0 - rate, probs.shape)
        probs = jnp.where(keep, probs / (1.0 - rate), 0.0)
    return jnp.einsum("bhnm,bmhk->bnhk", probs.astype(q.dtype), v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


def _triton_blocks(n: int):
    from jax.experimental.pallas.ops.gpu.attention import BlockSizes

    block = 128
    while n % block:
        block //= 2
    small = min(block, 32)
    return BlockSizes(block_q=block, block_k=block, block_q_dkv=small,
                      block_kv_dkv=small, block_q_dq=small,
                      block_kv_dq=small)


def candidates(n: int, dtype: str, rate):
    """name -> attention fn(q, k, v, rng) on (B, N, H, K) inputs."""
    import jax

    from vision_transformer_detector.kernels.flash_attention import (
        flash_attention)

    out = {"einsum": lambda q, k, v, rng: _einsum(q, k, v, rate, rng)}
    seed = 1234 if rate is not None else None
    out["chunked"] = lambda q, k, v, rng: flash_attention(
        q, k, v, dropout_rate=rate, dropout_seed=seed,
        implementation="chunked")
    if rate is None:
        if dtype == "bfloat16":
            out["cudnn"] = lambda q, k, v, rng: jax.nn.dot_product_attention(
                q, k, v, scale=1.0, implementation="cudnn")
        from jax.experimental.pallas.ops.gpu.attention import mha

        blocks = _triton_blocks(n)
        out["triton"] = lambda q, k, v, rng: mha(
            q, k, v, segment_ids=None, sm_scale=1.0, block_sizes=blocks)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", type=int, default=20)
    parser.add_argument("--output", default=None,
                        help="also append the JSON lines to this file")
    args = parser.parse_args()

    from vision_transformer_detector.utils.runtime import (
        enable_compilation_cache, gpu_name_and_power_limit, require_gpu)

    devices = require_gpu()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vision_transformer_detector.kernels.flash_attention import (
        reference_attention)
    from vision_transformer_detector.utils.profiling import time_jitted

    enable_compilation_cache()
    sink = open(args.output, "a") if args.output else None

    def emit(**fields):
        line = json.dumps(fields)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    emit(card=gpu_name_and_power_limit(), kind=devices[0].device_kind,
         jax=jax.__version__)
    for preset, b, n, h, kd, dtype, rate in SHAPES:
        keys = jax.random.split(jax.random.PRNGKey(n), 5)
        q, k, v = (jax.random.normal(r, (b, n, h, kd), jnp.float32)
                   for r in keys[:3])
        q = q / np.sqrt(kd)
        q, k, v = (t.astype(dtype) for t in (q, k, v))
        g = jax.random.normal(keys[3], (b, n, h, kd), jnp.float32).astype(
            dtype)
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jax.jit(reference_attention)(
                *(t.astype(jnp.float32) for t in (q, k, v))))
        for name, fn in candidates(n, dtype, rate).items():
            fwd = jax.jit(lambda q, k, v, fn=fn: fn(q, k, v, keys[4]))
            # g is an argument, not a closed-over constant that XLA
            # would spend its compile time folding.
            both = jax.jit(jax.value_and_grad(
                lambda q, k, v, g, fn=fn: jnp.sum(
                    fn(q, k, v, keys[4]).astype(jnp.float32) * g),
                argnums=(0, 1, 2)))
            record = {"preset": preset, "shape": [b, n, h, kd],
                      "dtype": dtype, "dropout": rate, "impl": name}
            try:
                if rate is None:
                    got = np.asarray(fwd(q, k, v), np.float64)
                    record["max_rel_err"] = float(
                        np.max(np.abs(got - want)) / np.max(np.abs(want)))
                record["fwd_ms"] = 1e3 * time_jitted(
                    fwd, q, k, v, iterations=args.iterations, warmup=2)[0]
                record["fwd_bwd_ms"] = 1e3 * time_jitted(
                    both, q, k, v, g, iterations=args.iterations, warmup=2)[0]
            except Exception as exc:  # a candidate that fails is a result
                record["error"] = f"{type(exc).__name__}: {exc}"[:2000]
                traceback.print_exc()
            emit(**record)
    if sink is not None:
        sink.close()


if __name__ == "__main__":
    main()
