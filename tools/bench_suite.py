"""Multi-config benchmark suite: inference + train-step throughput per
preset on one GPU, with analytic forward FLOPs and the FLOP/s achieved.

Writes one JSON object per line (or a markdown table with --markdown).
Each preset runs in its own child process, one after another; the parent
stays off the card. Run on the GPU: python tools/bench_suite.py
[--presets a,b,c]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_config(name: str, batch_size: int, train: bool) -> dict:
    import jax
    import jax.numpy as jnp

    from vision_transformer_detector.config import (
        LossConfig, TrainConfig, get_config)
    from vision_transformer_detector.models.vit_detector import (
        count_params, forward, init_params)
    from vision_transformer_detector.ops.decode import (
        transform_predictions)
    from vision_transformer_detector.train.optimizer import make_optimizer
    from vision_transformer_detector.train.trainer import (
        create_train_state, make_train_step)
    from vision_transformer_detector.utils.profiling import (
        flops_estimate, time_jitted)
    from vision_transformer_detector.utils.runtime import require_gpu

    device = require_gpu()[0]
    config = get_config(name)

    h, w = config.image_size
    params = init_params(jax.random.PRNGKey(0), config)
    images = jax.random.uniform(jax.random.PRNGKey(1), (batch_size, h, w, 3),
                                minval=-1.0, maxval=1.0)

    @jax.jit
    def infer(params, images):
        return transform_predictions(forward(params, images, config), config)

    per_call, _ = time_jitted(infer, params, images, iterations=10)
    img_per_s = batch_size / per_call
    flops = flops_estimate(config, batch_size)

    row = {
        "preset": name,
        "image_size": h,
        "params_m": round(count_params(params) / 1e6, 2),
        "batch": batch_size,
        "infer_ms": round(per_call * 1000, 2),
        "infer_img_s": round(img_per_s, 1),
        "fwd_gflops_img": round(flops / batch_size / 1e9, 1),
        "fwd_tflop_s": round(flops / per_call / 1e12, 1),
        "device_kind": device.device_kind,
    }

    if train:
        labels = jnp.zeros((batch_size, config.max_objects, 6))
        labels = labels.at[..., 0].set(0.0).at[:, 0].set(
            jnp.asarray([1.0, 3.0, w / 2, h / 2, h / 4, w / 4]))
        optimizer = make_optimizer(TrainConfig())
        state = create_train_state(jax.random.PRNGKey(0), config, optimizer)
        step = make_train_step(config, LossConfig(), optimizer, donate=False)
        rng = jax.random.PRNGKey(2)
        per_step, _ = time_jitted(
            lambda s, i, l: step(s, i, l, rng)[1], state, images, labels,
            iterations=5)
        row["train_ms"] = round(per_step * 1000, 2)
        row["train_img_s"] = round(batch_size / per_step, 1)
    return row


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--presets",
                        default="reference_608,vit_s16_224,vit_b16_384")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--markdown", action="store_true")
    parser.add_argument("--single", action="store_true",
                        help="run in-process (child mode)")
    args = parser.parse_args()

    if args.single:
        from vision_transformer_detector.utils.runtime import (
            enable_compilation_cache)

        enable_compilation_cache()
        for name in args.presets.split(","):
            print(json.dumps(
                bench_config(name.strip(), args.batch_size, args.train)),
                flush=True)
        return

    rows = []
    for name in args.presets.split(","):
        # Each preset runs in its own process: isolates compilation state
        # (cross-config jit caches have produced spurious linearization
        # errors) and any OOM from the big configs.
        import subprocess
        cmd = [sys.executable, os.path.abspath(__file__),
               "--presets", name.strip(),
               "--batch-size", str(args.batch_size), "--single"]
        if args.train:
            cmd.append("--train")
        result = subprocess.run(cmd, capture_output=True, text=True)
        line = [l for l in result.stdout.splitlines() if l.startswith("{")]
        if not line:
            print(json.dumps({"preset": name.strip(), "error":
                              result.stderr.strip()[-300:]}), flush=True)
            continue
        row = json.loads(line[-1])
        rows.append(row)
        if not args.markdown:
            print(json.dumps(row), flush=True)

    if args.markdown and rows:
        keys = list(rows[0])
        print("| " + " | ".join(keys) + " |")
        print("|" + "---|" * len(keys))
        for row in rows:
            print("| " + " | ".join(str(row.get(k, "")) for k in keys) + " |")


if __name__ == "__main__":
    main()
