"""Concurrent HTTP serving load test: micro-batching on vs off.

Measures end-to-end wall-clock throughput of the stdlib HTTP server
under N concurrent client threads posting JPEGs. HTTP responses are
host-visible data, so plain wall-clock timing is right here — every
response has synced through the device. Direct dispatch is the server's
default and batching is opt-in; which wins on the GPU is not measured.

Run on the GPU:  python tools/bench_serving.py [--preset reference_608]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_payloads(image_size, count: int):
    from PIL import Image

    rng = np.random.default_rng(0)
    payloads = []
    for _ in range(count):
        h = int(rng.integers(240, 640))
        w = int(rng.integers(240, 640))
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            buf, format="JPEG")
        payloads.append(buf.getvalue())
    return payloads


def run_load(base: str, payloads, threads: int, requests_per_thread: int):
    errors = []
    latencies = []
    lock = threading.Lock()

    def worker(tid: int):
        for i in range(requests_per_thread):
            data = payloads[(tid * requests_per_thread + i) % len(payloads)]
            req = urllib.request.Request(
                f"{base}/predict", data=data,
                headers={"Content-Type": "image/jpeg"})
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    json.loads(r.read())
            except Exception as exc:   # noqa: BLE001 - recorded, not raised
                with lock:
                    errors.append(str(exc))
                continue
            with lock:
                latencies.append(time.monotonic() - t0)

    ts = [threading.Thread(target=worker, args=(t,))
          for t in range(threads)]
    start = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    elapsed = time.monotonic() - start
    total = threads * requests_per_thread
    return {
        "requests": total,
        "errors": len(errors),
        "wall_s": round(elapsed, 3),
        "req_per_s": round((total - len(errors)) / elapsed, 2),
        "p50_ms": round(1e3 * float(np.percentile(latencies, 50)), 1)
        if latencies else None,
        "p99_ms": round(1e3 * float(np.percentile(latencies, 99)), 1)
        if latencies else None,
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="reference_608")
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--requests-per-thread", type=int, default=8)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--window-ms", type=float, default=5.0)
    parser.add_argument("--bucket-mode", default="pow2",
                        choices=("pow2", "exact"))
    args = parser.parse_args()

    import jax

    from vision_transformer_detector.config import get_config
    from vision_transformer_detector.models.vit_detector import (
        init_params)
    from vision_transformer_detector.serving import (
        DetectionServer, DetectionService)
    from vision_transformer_detector.utils.runtime import (
        enable_compilation_cache)

    enable_compilation_cache()
    config = get_config(args.preset)
    if jax.devices()[0].platform == "cpu":
        config = config.replace(use_flash_attention=False)
    params = init_params(jax.random.PRNGKey(0), config)
    service = DetectionService(config, params)
    payloads = make_payloads(config.image_size, 16)

    for batching in (False, True):
        server = DetectionServer(service, port=0, batching=batching,
                                 max_batch=args.max_batch,
                                 max_wait_ms=args.window_ms,
                                 bucket_mode=args.bucket_mode)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            # Warm-up: compile every power-of-two bucket up front.
            run_load(base, payloads, args.max_batch, 2)
            stats = run_load(base, payloads, args.threads,
                             args.requests_per_thread)
        finally:
            server.stop()
        stats["mode"] = "batching" if batching else "direct"
        if batching and server.batcher is not None:
            sizes = server.batcher.batch_sizes
            stats["mean_batch"] = round(float(np.mean(sizes)), 2) \
                if sizes else None
        print(json.dumps(stats), flush=True)


if __name__ == "__main__":
    main()
