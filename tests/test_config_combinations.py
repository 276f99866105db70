"""Config-combination stress: adversarial knob combinations through the
full train-step path (init -> forward -> loss -> grad -> update).

Pairwise interactions are covered by the focused tests (test_model.py,
test_train.py, test_kernels.py); this file drives triples/quadruples that
no focused test combines — e.g. multi-scale head + windowed attention +
bf16 + remat + dropout in ONE program — because config-combination bugs
(a remat policy capturing a dropout mask, a head-scale reshape assuming
the einsum path's layout) only surface when the knobs meet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector.train.trainer import (
    Trainer, make_train_step)
from vision_transformer_detector.train.optimizer import make_optimizer

# Every config: 64px/p16 (4x4 grid, 16 tokens), tiny dims -> seconds-scale
# CPU compiles. Knobs chosen to collide: multi-scale heads need the grid
# layout, windows re-order tokens, remat wraps the blocks that hold both,
# bf16 changes which path accumulates in fp32, dropout adds RNG plumbing
# through whichever attention kernel is routed.
BASE = dict(image_size=(64, 64), patch_size=16, embedding_dim=16,
            num_heads=2, key_dim=8, encoder_blocks=2, encoder_mlp_layers=2,
            head_last_units=16, head_layers=2)

COMBOS = {
    "multiscale_windowed_bf16": dict(
        head_scales=(1, 2, 4), attention_window=2,
        compute_dtype="bfloat16"),
    "multiscale_flash_dropout_remat": dict(
        head_scales=(1, 2), use_flash_attention=True, dropout=0.25,
        remat_encoder=True),
    "windowed_dropout_remat_alternate": dict(
        attention_window=2, dropout=0.25, remat_encoder=True,
        remat_policy="alternate"),
    "flash_bf16_headsmajor_nonsquare": dict(
        use_flash_attention=True, compute_dtype="bfloat16",
        attention_heads_major=True, image_size=(64, 80)),
    "train_flash_eval_einsum_dropout": dict(
        train_use_flash_attention=True, use_flash_attention=False,
        dropout=0.25),
    # 75px/p16 -> a 5x5 grid via SAME padding; scale 5 pools it to one
    # cell (scales must divide the grid — enforced since the
    # grid-geometry validation landed).
    "multiscale_nondivisible_remat_dots": dict(
        head_scales=(1, 5), image_size=(75, 75), remat_encoder=True,
        remat_policy="dots"),
}


@pytest.mark.parametrize("name", sorted(COMBOS))
def test_combo_trains_one_step(name):
    cfg = DetectorConfig(**{**BASE, **COMBOS[name]})
    optimizer = make_optimizer(TrainConfig(), steps_per_epoch=1)
    from vision_transformer_detector.train.trainer import (
        create_train_state)
    state = create_train_state(jax.random.PRNGKey(0), cfg, optimizer)
    step = make_train_step(cfg, LossConfig(), optimizer, donate=False)

    rng = np.random.default_rng(3)
    h, w = cfg.image_size
    images = jnp.asarray(rng.uniform(-1, 1, (2, h, w, 3)), jnp.float32)
    labels = np.full((2, cfg.max_objects, 6), -8.0, np.float32)
    labels[:, :, 0] = 0.0
    labels[0, 0] = (1, 5, h / 2, w / 2, 16.0, 16.0)
    labels[1, 0] = (1, 9, h / 4, w / 4, 12.0, 20.0)

    new_state, loss = step(state, images, jnp.asarray(labels),
                           jax.random.PRNGKey(7))
    assert np.isfinite(float(loss)), (name, float(loss))
    # The update must actually move the params (a silently-zero gradient
    # through an exotic path combination would still "pass" a loss check).
    leaves_before = jax.tree_util.tree_leaves(state["params"])
    leaves_after = jax.tree_util.tree_leaves(new_state["params"])
    moved = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(leaves_before, leaves_after))
    assert moved, name
    for leaf in leaves_after:
        assert np.isfinite(np.asarray(leaf)).all(), name


def test_combo_eval_matches_between_attention_routings():
    """train_use_flash_attention must not leak into eval: the eval step of
    a train-flash config and a pure-einsum config produce identical
    predictions for identical params."""
    from vision_transformer_detector.train.trainer import make_eval_step

    cfg_split = DetectorConfig(**{**BASE,
                                  "train_use_flash_attention": True,
                                  "use_flash_attention": False})
    cfg_plain = DetectorConfig(**{**BASE, "use_flash_attention": False})
    from vision_transformer_detector.models.vit_detector import (
        init_params)
    params = init_params(jax.random.PRNGKey(1), cfg_plain)
    images = jnp.asarray(
        np.random.default_rng(5).uniform(-1, 1, (2, 64, 64, 3)), jnp.float32)
    out_split = make_eval_step(cfg_split)(params, images)
    out_plain = make_eval_step(cfg_plain)(params, images)
    np.testing.assert_array_equal(np.asarray(out_split),
                                  np.asarray(out_plain))
