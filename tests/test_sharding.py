"""SPMD tests on the virtual 8-device CPU mesh: DP gradient equivalence,
TP parameter sharding, full sharded train step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from vision_transformer_detector.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector.parallel.mesh import (
    MODEL_AXIS, batch_sharding, create_mesh, param_shardings, replicated)
from vision_transformer_detector.train.optimizer import make_optimizer
from vision_transformer_detector.train.trainer import (
    Trainer, create_train_state, make_train_step)

TINY = DetectorConfig(
    image_size=(32, 32), patch_size=16, embedding_dim=8, num_heads=2,
    key_dim=4, encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8,
    head_layers=1)


def _batch(batch_size):
    rng = np.random.default_rng(0)
    h, w = TINY.image_size
    images = rng.uniform(-1, 1, (batch_size, h, w, 3)).astype(np.float32)
    labels = np.full((batch_size, TINY.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    for i in range(batch_size):
        labels[i, 0] = (1, i % 80, 16.0, 16.0, 10.0, 10.0)
    return jnp.asarray(images), jnp.asarray(labels)


def test_eight_devices_available():
    assert jax.device_count() == 8


def test_pure_dp_training_matches_single_device():
    """One sharded DP train step must equal the unsharded step bitwise-ish:
    same loss, same updated params (the psum reduction is exact here)."""
    mesh = create_mesh(data=8, model=1)
    optimizer = make_optimizer(TrainConfig(learning_rate=1e-3))
    state = create_train_state(jax.random.PRNGKey(0), TINY, optimizer)
    train_step = make_train_step(TINY, LossConfig(), optimizer, donate=False)
    images, labels = _batch(8)
    rng = jax.random.PRNGKey(1)

    _, loss_single = train_step(state, images, labels, rng)

    sharded_state = jax.device_put(
        state, jax.tree_util.tree_map(
            lambda _: replicated(mesh), state,
            is_leaf=lambda x: isinstance(x, jnp.ndarray)))
    images_s = jax.device_put(images, batch_sharding(mesh))
    labels_s = jax.device_put(labels, batch_sharding(mesh))
    _, loss_sharded = train_step(sharded_state, images_s, labels_s, rng)

    np.testing.assert_allclose(
        float(loss_single), float(loss_sharded), rtol=1e-5)


def test_tp_param_shardings():
    mesh = create_mesh(data=4, model=2)
    cfg = TINY.replace(embedding_dim=8, num_heads=2)
    optimizer = make_optimizer(TrainConfig())
    state = create_train_state(jax.random.PRNGKey(0), cfg, optimizer)
    shardings = param_shardings(state["params"], mesh)
    # attention qkv kernels shard heads over the model axis
    qkv = shardings["encoder"][0]["mha"]["query"]["kernel"]
    assert qkv.spec == P(None, MODEL_AXIS, None)
    out = shardings["encoder"][0]["mha"]["out"]["kernel"]
    assert out.spec == P(MODEL_AXIS, None, None)
    # biases replicated
    assert shardings["encoder"][0]["mha"]["query"]["bias"].spec == P()
    # non-divisible dims fall back to replication: position embedding (P,1)
    assert shardings["position_embedding"].spec == P()


def test_dp_tp_train_step_compiles_and_runs():
    """Full train step over a (4 data x 2 model) mesh: the multi-axis
    sharding story dryrun_multichip exercises."""
    mesh = create_mesh(data=4, model=2)
    trainer = Trainer(TINY, LossConfig(), TrainConfig(learning_rate=1e-3),
                      mesh=mesh)
    state = trainer.init_state()
    images, labels = _batch(8)
    images, labels = trainer._put_batch(images, labels)
    new_state, loss = trainer.train_step(
        state, images, labels, jax.random.PRNGKey(0))
    assert np.isfinite(float(loss))
    # params keep their shardings after the update (GSPMD may strip
    # trailing Nones from the spec, so compare shardings, not raw specs)
    q = new_state["params"]["encoder"][0]["mha"]["query"]["kernel"]
    from jax.sharding import NamedSharding
    expected = NamedSharding(mesh, P(None, MODEL_AXIS, None))
    assert q.sharding.is_equivalent_to(expected, q.ndim)


def test_mesh_validation():
    # Real raise (asserts vanish under python -O), round-4 review.
    with pytest.raises(ValueError, match="available devices"):
        create_mesh(data=3, model=2)  # 6 != 8


def test_sequence_sharding_compiles_and_matches():
    """SP: token axis sharded over 'model'; output must equal unsharded."""
    import jax.numpy as jnp

    cfg = TINY.replace(attention_window=1, sequence_sharding=True)
    base = TINY.replace(attention_window=1)
    mesh = create_mesh(data=4, model=2)

    from vision_transformer_detector.models.vit_detector import (
        forward, init_params)

    params = init_params(jax.random.PRNGKey(0), base)
    images = jnp.asarray(np.random.default_rng(0).uniform(
        -1, 1, (8, 32, 32, 3)).astype(np.float32))

    out_base = forward(params, images, base)

    with mesh:
        params_s = jax.device_put(params, replicated(mesh))
        images_s = jax.device_put(images, batch_sharding(mesh))
        out_sp = jax.jit(lambda p, x: forward(p, x, cfg))(params_s, images_s)

    np.testing.assert_allclose(np.asarray(out_base), np.asarray(out_sp),
                               atol=1e-4)


def test_sequence_sharding_train_step():
    """Full SP train step through the Trainer's mesh context."""
    cfg = TINY.replace(attention_window=1, sequence_sharding=True)
    mesh = create_mesh(data=4, model=2)
    trainer = Trainer(cfg, LossConfig(), TrainConfig(learning_rate=1e-3),
                      mesh=mesh)
    state = trainer.init_state()
    images, labels = _batch(8)
    images, labels = trainer._put_batch(images, labels)
    with mesh:
        _, loss = trainer.train_step(state, images, labels,
                                     jax.random.PRNGKey(0))
    assert np.isfinite(float(loss))


def test_dp_eval_matches_single_device():
    """Eval batches shard over the data axis (Trainer._put_images) and
    produce the same decoded predictions as a single-device eval; a
    ragged final batch (not divisible by the axis) still evaluates,
    unsharded."""
    from vision_transformer_detector.train.trainer import make_eval_step

    mesh = create_mesh(data=8, model=1)
    trainer = Trainer(TINY, LossConfig(), TrainConfig(), mesh=mesh)
    params = trainer.init_state()["params"]
    images, _ = _batch(8)

    placed = trainer._put_images(np.asarray(images))
    assert placed.sharding.is_equivalent_to(batch_sharding(mesh), 4)
    with mesh:
        decoded_mesh = trainer.eval_step(params, placed)

    single = Trainer(TINY, LossConfig(), TrainConfig())
    decoded_single = single.eval_step(
        jax.device_put(params, jax.devices()[0]), images)
    np.testing.assert_allclose(np.asarray(decoded_mesh),
                               np.asarray(decoded_single),
                               rtol=1e-5, atol=1e-5)

    ragged = trainer._put_images(np.asarray(images[:6]))
    assert not ragged.sharding.is_equivalent_to(batch_sharding(mesh), 4)
    with mesh:
        decoded_ragged = trainer.eval_step(params, ragged)
    np.testing.assert_allclose(np.asarray(decoded_ragged),
                               np.asarray(decoded_single[:6]),
                               rtol=1e-5, atol=1e-5)
