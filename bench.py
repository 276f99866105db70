"""Benchmark: images/sec at 640px batch inference on one GPU.

Prints ONE JSON line, last:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Baseline: the TF reference's graph-mode inference measured ~2 s per 8-image
batch at 608px on its GPU (ipynb cell 15; BASELINE.md), i.e. ~4 img/s.

The benchmarked model is the reference architecture (patch 17, embed 28,
8 blocks — ipynb cell 7) at 640px input in bf16, jit-compiled end to end
including the on-device decode. Without a GPU the run stops with a nonzero
exit code and prints no metric.
"""

from __future__ import annotations

import json
import time

BASELINE_IMG_PER_S = 4.0  # TF reference, ipynb cell 15 (~2 s / 8 images)
BATCH_SIZE = 128
ITERATIONS = 20


def main() -> None:
    from vision_transformer_detector.utils.runtime import (
        enable_compilation_cache, gpu_name_and_power_limit, require_gpu)

    devices = require_gpu()
    import jax

    enable_compilation_cache()
    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.models.vit_detector import (
        forward, init_params)
    from vision_transformer_detector.ops.decode import (
        transform_predictions)

    config = DetectorConfig(image_size=(640, 640), compute_dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(0), config)
    h, w = config.image_size
    images = jax.random.uniform(
        jax.random.PRNGKey(1), (BATCH_SIZE, h, w, 3),
        minval=-1.0, maxval=1.0)

    @jax.jit
    def infer(params, images):
        return transform_predictions(forward(params, images, config), config)

    tic = time.perf_counter()
    jax.block_until_ready(infer(params, images))   # compile + warm-up
    setup_s = time.perf_counter() - tic
    tic = time.perf_counter()
    for _ in range(ITERATIONS):
        out = infer(params, images)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - tic

    img_per_s = BATCH_SIZE * ITERATIONS / elapsed
    print(json.dumps({
        "metric": f"{h}px batch inference throughput "
                  f"(batch {BATCH_SIZE}, {config.compute_dtype})",
        "value": img_per_s,
        "unit": "images/sec",
        "vs_baseline": img_per_s / BASELINE_IMG_PER_S,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices),
                   "card": gpu_name_and_power_limit()},
        "peak_bytes_in_use": devices[0].memory_stats()["peak_bytes_in_use"],
        "compile_and_warmup_s": setup_s,
    }))


if __name__ == "__main__":
    main()
