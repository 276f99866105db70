"""Ring attention (context parallelism) vs full-attention oracle on the
virtual 8-device mesh."""

import jax
import numpy as np
import pytest

from vision_transformer_detector.kernels.flash_attention import (
    reference_attention)
from vision_transformer_detector.kernels.ring_attention import (
    ring_attention)
from vision_transformer_detector.parallel.mesh import create_mesh


def _qkv(b, n, h, k, seed=0):
    rngs = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(rngs[0], (b, n, h, k)),
            jax.random.normal(rngs[1], (b, n, h, k)),
            jax.random.normal(rngs[2], (b, n, h, k)))


@pytest.mark.parametrize("ring", [2, 4, 8])
def test_ring_matches_full_attention(ring):
    mesh = create_mesh(data=8 // ring, model=ring)
    q, k, v = _qkv(2, 64, 2, 16)
    out = ring_attention(q, k, v, mesh)
    expected = reference_attention(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected),
                               atol=2e-5, rtol=2e-5)


def test_ring_single_device_axis():
    """Degenerate ring of 1: no rotation."""
    mesh = create_mesh(data=8, model=1)
    q, k, v = _qkv(1, 32, 2, 8, seed=1)
    out = ring_attention(q, k, v, mesh)
    expected = reference_attention(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected),
                               atol=2e-5, rtol=2e-5)


def test_ring_rejects_indivisible_tokens():
    mesh = create_mesh(data=2, model=4)
    q, k, v = _qkv(1, 30, 2, 8)
    with pytest.raises(AssertionError):
        ring_attention(q, k, v, mesh)


def test_model_with_ring_attention_matches_plain():
    """forward() with config.ring_attention over the mesh == plain forward."""
    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.models.vit_detector import (
        forward, init_params)
    from vision_transformer_detector.parallel.mesh import (
        batch_sharding, replicated)

    base = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1)
    ring_cfg = base.replace(ring_attention=True)
    mesh = create_mesh(data=2, model=4)  # grid 4x4=16 tokens / ring of 4

    params = init_params(jax.random.PRNGKey(0), base)
    images = jax.random.uniform(jax.random.PRNGKey(1), (4, 64, 64, 3),
                                minval=-1, maxval=1)
    out_plain = forward(params, images, base)

    params_s = jax.device_put(params, replicated(mesh))
    images_s = jax.device_put(images, batch_sharding(mesh))
    out_ring = jax.jit(
        lambda p, x: forward(p, x, ring_cfg, mesh=mesh))(params_s, images_s)

    np.testing.assert_allclose(np.asarray(out_plain), np.asarray(out_ring),
                               atol=3e-5, rtol=3e-5)


def test_trainer_with_ring_attention():
    """Full train step with CP attention through the Trainer."""
    from vision_transformer_detector.config import (
        DetectorConfig, LossConfig, TrainConfig)
    from vision_transformer_detector.train.trainer import Trainer

    cfg = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1, ring_attention=True)
    mesh = create_mesh(data=2, model=4)
    trainer = Trainer(cfg, LossConfig(), TrainConfig(learning_rate=1e-3),
                      mesh=mesh)
    state = trainer.init_state()
    images = np.random.default_rng(0).uniform(
        -1, 1, (4, 64, 64, 3)).astype(np.float32)
    labels = np.full((4, cfg.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[:, 0] = (1, 3, 32.0, 32.0, 20.0, 20.0)
    images_j, labels_j = trainer._put_batch(images, labels)
    with mesh:
        _, loss = trainer.train_step(state, images_j, labels_j,
                                     jax.random.PRNGKey(0))
    assert np.isfinite(float(loss))


def test_highres_ring_preset_trains_on_mesh():
    """A miniaturised highres_1024_ring trains one step over a 4x2 mesh:
    the ring preset's full config surface (ring_attention + remat +
    multi-scale head) compiles and runs under SPMD."""
    import numpy as np

    from vision_transformer_detector.config import (
        LossConfig, TrainConfig, get_config)
    from vision_transformer_detector.train.trainer import Trainer

    config = get_config("highres_1024_ring").replace(
        image_size=(64, 64), embedding_dim=8, num_heads=2, key_dim=4,
        encoder_blocks=2, head_last_units=8, head_layers=2,
        compute_dtype="float32", head_scales=(1, 2))
    mesh = create_mesh(data=4, model=2)
    trainer = Trainer(config, LossConfig(), TrainConfig(learning_rate=1e-3),
                      mesh=mesh)
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
    labels = np.full((8, config.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[:, 0] = (1, 3, 32.0, 32.0, 16.0, 16.0)
    images, labels = trainer._put_batch(images, labels)
    with mesh:
        state, loss = trainer.train_step(state, images, labels,
                                         jax.random.PRNGKey(0))
    assert np.isfinite(float(loss))


def test_ring_dropout_matches_flash_and_masked_oracle():
    """Ring attention's in-kernel dropout uses the SAME positional mask
    as the flash kernel, keyed on GLOBAL coordinates — so the output is
    identical to flash-with-dropout and to an explicit-mask einsum
    oracle, for every ring size (sharding-invariance of the mask)."""
    import jax.numpy as jnp

    from vision_transformer_detector.kernels.flash_attention import (
        _keep_threshold, dropout_keep_mask, flash_attention)
    from vision_transformer_detector.kernels.ring_attention import (
        ring_attention_in_jit)

    b, n, h, kd = 2, 64, 2, 16
    q, k, v = _qkv(b, n, h, kd, seed=5)
    rate, seed = 0.3, 4242

    # Explicit-mask oracle.
    pos = jnp.arange(n, dtype=jnp.uint32)
    bh = jnp.arange(b * h, dtype=jnp.uint32).reshape(b, h)
    keep = dropout_keep_mask(
        jnp.uint32(seed), bh[:, :, None, None],
        pos[None, None, :, None], pos[None, None, None, :],
        _keep_threshold(rate))
    scores = jnp.einsum("bnhk,bmhk->bhnm", q, k)
    probs = jax.nn.softmax(scores, axis=-1)
    probs = jnp.where(keep, probs / (1.0 - rate), 0.0)
    want = np.asarray(jnp.einsum("bhnm,bmhk->bnhk", probs, v))

    flash = np.asarray(flash_attention(
        q, k, v, dropout_rate=rate, dropout_seed=jnp.uint32(seed)))
    np.testing.assert_allclose(flash, want, atol=3e-5, rtol=3e-5)

    for ring in (2, 4):
        mesh = create_mesh(data=8 // ring, model=ring)
        with mesh:
            out = jax.jit(
                lambda q, k, v: ring_attention_in_jit(
                    q, k, v, mesh, dropout_rate=rate,
                    dropout_seed=jnp.uint32(seed)))(q, k, v)
        np.testing.assert_allclose(np.asarray(out), want,
                                   atol=3e-5, rtol=3e-5,
                                   err_msg=f"ring={ring}")


def test_ring_dropout_gradients_finite():
    """Autodiff through the rotated loop with dropout: finite grads."""
    import jax.numpy as jnp

    from vision_transformer_detector.kernels.ring_attention import (
        ring_attention_in_jit)

    mesh = create_mesh(data=4, model=2)
    q, k, v = _qkv(1, 32, 2, 8, seed=6)

    def loss(q, k, v):
        out = ring_attention_in_jit(q, k, v, mesh, dropout_rate=0.25,
                                    dropout_seed=jnp.uint32(7))
        return jnp.sum(out ** 2)

    with mesh:
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for g in grads:
        assert np.all(np.isfinite(np.asarray(g)))


def test_ring_batch_sharded_over_data_matches_oracle():
    """With batch % data == 0 the batch axis is sharded over 'data'
    (round-3 review: a replicated spec made GSPMD all-gather the global
    batch and recompute attention on every data shard). Outputs — and
    the dropout mask's GLOBAL batch coordinates — must match the
    unsharded oracle exactly."""
    import jax.numpy as jnp

    from vision_transformer_detector.kernels.flash_attention import (
        flash_attention)
    from vision_transformer_detector.kernels.ring_attention import (
        ring_attention_in_jit)

    mesh = create_mesh(data=4, model=2)
    q, k, v = _qkv(4, 64, 2, 16, seed=9)   # batch 4 over data=4

    with mesh:
        out = jax.jit(lambda q, k, v: ring_attention_in_jit(
            q, k, v, mesh))(q, k, v)
    want = reference_attention(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               atol=2e-5, rtol=2e-5)

    rate, seed = 0.3, 321
    with mesh:
        out_d = jax.jit(lambda q, k, v: ring_attention_in_jit(
            q, k, v, mesh, dropout_rate=rate,
            dropout_seed=jnp.uint32(seed)))(q, k, v)
    want_d = flash_attention(q, k, v, dropout_rate=rate,
                             dropout_seed=jnp.uint32(seed))
    np.testing.assert_allclose(np.asarray(out_d), np.asarray(want_d),
                               atol=3e-5, rtol=3e-5)


def test_ring_jitted_entry_accepts_dropout():
    """The standalone jitted ring_attention entry must accept
    dropout_rate (it traced the float and died in the `in (None, 0.0)`
    bool — round-4 review; only ring_attention_in_jit was covered)."""
    from vision_transformer_detector.kernels.ring_attention import (
        ring_attention, ring_attention_in_jit)

    q, k, v = _qkv(2, 16, 2, 8)
    mesh = create_mesh(data=2, model=4)
    out = ring_attention(q, k, v, mesh, dropout_rate=0.25, dropout_seed=7)
    assert np.isfinite(np.asarray(out)).all()
    # dropout_rate=0.0 is the documented no-op spelling.
    out0 = ring_attention(q, k, v, mesh, dropout_rate=0.0)
    ref = ring_attention(q, k, v, mesh)
    np.testing.assert_allclose(np.asarray(out0), np.asarray(ref))
