"""Micro-benchmark: the evaluation path (forward + decode + jitted mAP).

The training loop's per-epoch evaluate (SaveModelHighestAP.evaluate,
reference vision_transformer_detector.py:2162-2172) is forward + decode +
metric update per batch, plus one compute() at the end. This tool breaks
that path into its device-side pieces so the expensive one is visible:

  * infer        — forward + transform_predictions only
  * infer+update — the full per-batch eval step with fast_map.update
  * update       — fast_map.update alone on a fixed decoded batch
  * compute      — one fast_map.compute() call (per-epoch, not per-batch)

Each variant runs `iterations` steps CHAINED by a data dependency inside
ONE jit (lax.scan threading the metric state / feeding a scalar of the
output back into the images), timed after a compiling call up to
block_until_ready on the result.

Usage: python tools/bench_eval.py [--preset reference_608] [--b 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="reference_608")
    parser.add_argument("--b", type=int, default=8)
    parser.add_argument("--iterations", type=int, default=10)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from vision_transformer_detector.config import get_config
    from vision_transformer_detector.metrics import fast_map
    from vision_transformer_detector.models.vit_detector import (
        forward, init_params)
    from vision_transformer_detector.ops.decode import (
        transform_predictions)

    config = get_config(args.preset)
    h, w = config.image_size
    params = init_params(jax.random.PRNGKey(0), config)
    images = jax.random.uniform(jax.random.PRNGKey(1), (args.b, h, w, 3),
                                minval=-1.0, maxval=1.0)
    # Synthetic labels: a few valid boxes per image, rest EMPTY_SLOT fill.
    rng = jax.random.PRNGKey(2)
    n_valid = 5
    cxy = jax.random.uniform(rng, (args.b, n_valid, 4), minval=0.2,
                             maxval=0.8)
    cats = jax.random.randint(jax.random.PRNGKey(3),
                              (args.b, n_valid, 1), 0, config.num_classes)
    obj = jnp.ones((args.b, n_valid, 1))
    valid = jnp.concatenate([cxy, cats.astype(jnp.float32), obj], axis=-1)
    fill = jnp.full((args.b, config.max_objects - n_valid, 6), -8.0)
    labels = jnp.concatenate([valid, fill], axis=1)

    print(json.dumps({"preset": args.preset, "batch": args.b,
                      "device_kind": jax.devices()[0].device_kind}),
          flush=True)

    def timed(fn, *fn_args):
        jax.block_until_ready(fn(*fn_args))  # compile + run
        tic = time.perf_counter()
        jax.block_until_ready(fn(*fn_args))
        return (time.perf_counter() - tic) * 1e3

    def report(name, total_ms):
        per = total_ms / args.iterations
        print(json.dumps({"variant": name, "ms": round(per, 2),
                          "img_per_s": round(args.b / (per / 1e3), 1)}),
              flush=True)
        return per

    # --- infer only: forward + decode, chained through the images.
    # params/labels are ARGUMENTS, not closures: closed-over arrays embed
    # as HLO constants in the compiled program.
    @jax.jit
    def infer_chain(params, images):
        def body(carry, _):
            img, acc = carry
            decoded = transform_predictions(
                forward(params, img, config, train=False), config)
            feedback = decoded.astype(jnp.float32).mean() * 1e-6
            return (img + feedback, acc + feedback), None
        (_, acc), _ = jax.lax.scan(body, (images, jnp.zeros(())), None,
                                   length=args.iterations)
        return acc

    infer_ms = report("infer", timed(infer_chain, params, images))

    # --- infer + metric update: the real per-batch eval step. The metric
    # state threading is itself the data dependency.
    state0 = fast_map.init_state(config)

    @jax.jit
    def eval_chain(params, labels, images, state):
        def body(carry, _):
            img, st = carry
            decoded = transform_predictions(
                forward(params, img, config, train=False), config)
            st = fast_map.update(st, labels, decoded, config,
                                 use_transform_predictions=False)
            feedback = decoded.astype(jnp.float32).mean() * 1e-6
            return (img + feedback, st), None
        (_, st), _ = jax.lax.scan(body, (images, state), None,
                                  length=args.iterations)
        return st.labels_quantity_per_image.sum()

    full_ms = report("infer+update",
                     timed(eval_chain, params, labels, images, state0))

    # --- update alone on a fixed decoded batch.
    decoded_fixed = jax.jit(
        lambda p, im: transform_predictions(
            forward(p, im, config, train=False), config))(params, images)

    @jax.jit
    def update_chain(labels, decoded_fixed, state):
        def body(st, _):
            st = fast_map.update(st, labels, decoded_fixed, config,
                                 use_transform_predictions=False)
            return st, None
        st, _ = jax.lax.scan(body, state, None, length=args.iterations)
        return st.labels_quantity_per_image.sum()

    update_ms = report("update",
                       timed(update_chain, labels, decoded_fixed, state0))

    # --- compute(): once per epoch, so time a single call (chained x
    # iterations would distort it — it is read-only on the state, so chain
    # through a scalar accumulator instead).
    state_n = jax.jit(
        lambda st: fast_map.update(st, labels, decoded_fixed, config,
                                   use_transform_predictions=False))(state0)

    @jax.jit
    def compute_chain(state):  # state is an argument; nothing big closed over
        def body(acc, _):
            ap = fast_map.compute(
                state._replace(
                    labels_quantity_per_image=state.labels_quantity_per_image
                    + acc * 1e-9), config)
            return acc + ap.astype(jnp.float32), None
        acc, _ = jax.lax.scan(body, jnp.zeros(()), None,
                              length=args.iterations)
        return acc

    report("compute", timed(compute_chain, state_n))

    overhead = full_ms - infer_ms
    print(json.dumps({
        "metric_overhead_ms": round(overhead, 2),
        "overhead_vs_infer_pct": round(100 * overhead / max(infer_ms, 1e-9),
                                       1),
        "update_alone_ms": round(update_ms, 2)}), flush=True)


if __name__ == "__main__":
    main()
