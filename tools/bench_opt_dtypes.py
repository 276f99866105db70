"""A/B: Adam moment-state dtype vs train-step time (VERDICT r2 #3).

The ViT-L/16 640px step trace attributes ~45 ms to optimizer-state/grad
convert+update fusions (ROADMAP 'Performance'). Candidate lever: store
Adam moments in bf16 (arithmetic stays fp32; master params fp32), halving
the optimizer-state HBM reads+writes. Variants:
  * fp32       — optax.adam (round-2 baseline)
  * mu_bf16    — optax.adam(mu_dtype=bf16)
  * munu_bf16  — scale_by_adam_compact (both moments bf16)

Same time_jitted methodology as tools/bench_suite.py. Run on the GPU:
  python tools/bench_opt_dtypes.py [--preset vit_l16_640] [--batch 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from vision_transformer_detector.config import (
        LossConfig, TrainConfig, get_config)
    from vision_transformer_detector.models.vit_detector import (
        init_params)
    from vision_transformer_detector.train.optimizer import (
        make_optimizer)
    from vision_transformer_detector.train.trainer import (
        make_train_step)
    from vision_transformer_detector.utils.profiling import time_jitted
    from vision_transformer_detector.utils.runtime import (
        enable_compilation_cache)

    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="vit_l16_640")
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args()

    enable_compilation_cache()
    config = get_config(args.preset)
    if jax.devices()[0].platform == "cpu":
        config = config.replace(use_flash_attention=False)
    h, w = config.image_size
    b = args.batch
    params = init_params(jax.random.PRNGKey(0), config)
    images = jax.random.uniform(jax.random.PRNGKey(1), (b, h, w, 3),
                                minval=-1.0, maxval=1.0)
    labels = jnp.zeros((b, config.max_objects, 6)).at[:, 0].set(
        jnp.asarray([1.0, 3.0, w / 2, h / 2, h / 4, w / 4]))
    rng = jax.random.PRNGKey(2)

    variants = (
        ("fp32", TrainConfig()),
        ("mu_bf16", TrainConfig(adam_mu_dtype="bfloat16")),
        ("munu_bf16", TrainConfig(adam_mu_dtype="bfloat16",
                                  adam_nu_dtype="bfloat16")),
    )
    for name, tc in variants:
        optimizer = make_optimizer(tc)
        state = {"params": params, "opt_state": optimizer.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        step = make_train_step(config, LossConfig(), optimizer,
                               donate=False)
        per_step, _ = time_jitted(
            lambda s, i, l: step(s, i, l, rng)[1], state, images, labels,
            iterations=10)
        opt_bytes = sum(
            leaf.size * leaf.dtype.itemsize
            for leaf in jax.tree_util.tree_leaves(state["opt_state"])
            if hasattr(leaf, "dtype"))
        print(json.dumps({
            "bench": f"train_{args.preset}_b{b}_{name}",
            "ms": round(per_step * 1e3, 1),
            "img_s": round(b / per_step, 1),
            "opt_state_mb": round(opt_bytes / 1e6, 1)}), flush=True)


if __name__ == "__main__":
    main()
