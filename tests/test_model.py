"""Model-level tests: patchify parity, forward shapes, dtype policy,
windowed attention, head reshape semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector.config import DetectorConfig
from vision_transformer_detector.models.vit_detector import (
    count_params,
    extract_patches,
    forward,
    init_params,
    mish,
)

TINY = DetectorConfig(
    image_size=(68, 68), embedding_dim=16, num_heads=2, key_dim=8,
    encoder_blocks=2, encoder_mlp_layers=3, head_last_units=16, head_layers=2)


def test_extract_patches_divisible():
    """Exact patch contents for a divisible size: row-major (row, col,
    channel) flattening like tf.image.extract_patches (vtd.py:189-199)."""
    h = w = 4
    p = 2
    img = np.arange(h * w * 3, dtype=np.float32).reshape(1, h, w, 3)
    patches = np.asarray(extract_patches(jnp.asarray(img), p))
    assert patches.shape == (1, 4, 12)
    # First patch = rows 0-1, cols 0-1, all channels, row-major.
    expected = img[0, 0:2, 0:2, :].reshape(-1)
    np.testing.assert_array_equal(patches[0, 0], expected)
    # Second patch = rows 0-1, cols 2-3.
    expected = img[0, 0:2, 2:4, :].reshape(-1)
    np.testing.assert_array_equal(patches[0, 1], expected)


def test_extract_patches_same_padding():
    """608 = 17*35 + 13: SAME padding adds ceil-grid patches with zeros
    (SURVEY.md §7 hard parts)."""
    img = jnp.ones((1, 75, 75, 3), jnp.float32)  # 75 = 17*4 + 7
    patches = extract_patches(img, 17)
    assert patches.shape == (1, 25, 17 * 17 * 3)
    # Edge patches contain zero padding -> their sum is less than a full
    # interior patch's sum.
    sums = np.asarray(patches.sum(axis=-1)).reshape(5, 5)
    assert sums[0, 0] < sums[2, 2]
    # TF SAME puts the smaller pad before: pad_total=10, top=5, bottom=5.
    assert sums[0, 2] == sums[4, 2]


def test_forward_shapes_and_param_count():
    params = init_params(jax.random.PRNGKey(0), TINY)
    images = jnp.zeros((3, 68, 68, 3), jnp.float32)
    logits = forward(params, images, TINY)
    assert logits.shape == (3, TINY.max_objects, 6)
    assert logits.dtype == jnp.float32
    assert count_params(params) > 0


def test_reference_config_structure():
    """The default config reproduces the reference's measured architecture
    (ipynb cell 7): 36x36=1296 patches of 867, encoder pyramid 3584..28,
    head pyramid 8704..136."""
    cfg = DetectorConfig()
    assert cfg.grid_size == (36, 36)
    assert cfg.num_patches == 1296
    assert cfg.patch_dim == 867
    assert cfg.encoder_mlp_units == (3584, 1792, 896, 448, 224, 112, 56, 28)
    assert cfg.head_units == (8704, 4352, 2176, 1088, 544, 272, 136)


def test_bfloat16_close_to_fp32():
    params = init_params(jax.random.PRNGKey(0), TINY)
    images = jax.random.uniform(
        jax.random.PRNGKey(1), (2, 68, 68, 3), minval=-1, maxval=1)
    out32 = forward(params, images, TINY)
    out16 = forward(params, images, TINY.replace(compute_dtype="bfloat16"))
    assert out16.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(out32), np.asarray(out16), atol=0.15)


def test_windowed_attention_runs():
    cfg = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1, attention_window=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    logits = forward(params, jnp.ones((1, 64, 64, 3)), cfg)
    assert bool(jnp.all(jnp.isfinite(logits)))


def test_windowed_equals_full_when_window_covers_grid():
    """A window spanning the whole grid must equal full attention."""
    base = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1)
    windowed = base.replace(attention_window=4)  # grid is 4x4
    params = init_params(jax.random.PRNGKey(0), base)
    images = jax.random.uniform(jax.random.PRNGKey(1), (1, 64, 64, 3))
    out_full = forward(params, images, base)
    out_win = forward(params, images, windowed)
    np.testing.assert_allclose(
        np.asarray(out_full), np.asarray(out_win), atol=1e-4)


def test_windowed_flash_equals_windowed_einsum():
    """use_flash_attention + attention_window routes the independent
    windows through the flash kernel (batch-folded); it must match the
    materialised per-window softmax path."""
    base = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1, attention_window=2)
    flash = base.replace(use_flash_attention=True)
    params = init_params(jax.random.PRNGKey(0), base)
    images = jax.random.uniform(jax.random.PRNGKey(1), (2, 64, 64, 3))
    out_einsum = forward(params, images, base)
    out_flash = forward(params, images, flash)
    np.testing.assert_allclose(np.asarray(out_einsum),
                               np.asarray(out_flash), atol=2e-3)

    # Gradients flow through the flash-windowed path (the point: no saved
    # window probabilities -> trains without remat).
    def loss(p):
        return jnp.sum(forward(p, images, flash) ** 2)
    grads = jax.grad(loss)(params)
    assert all(bool(jnp.all(jnp.isfinite(g)))
               for g in jax.tree_util.tree_leaves(grads))


def test_mish_matches_definition():
    x = jnp.linspace(-5, 5, 11)
    expected = x * jnp.tanh(jnp.log1p(jnp.exp(x)))
    np.testing.assert_allclose(np.asarray(mish(x)), np.asarray(expected),
                               rtol=1e-6)


def test_dropout_only_active_in_training():
    cfg = TINY.replace(dropout=0.5)
    params = init_params(jax.random.PRNGKey(0), cfg)
    images = jax.random.uniform(jax.random.PRNGKey(1), (1, 68, 68, 3))
    eval_1 = forward(params, images, cfg, train=False)
    eval_2 = forward(params, images, cfg, train=False)
    np.testing.assert_array_equal(np.asarray(eval_1), np.asarray(eval_2))
    train_1 = forward(params, images, cfg, train=True,
                      dropout_rng=jax.random.PRNGKey(2))
    train_2 = forward(params, images, cfg, train=True,
                      dropout_rng=jax.random.PRNGKey(3))
    assert not np.allclose(np.asarray(train_1), np.asarray(train_2))


@pytest.mark.slow
def test_attention_dropout_each_mode():
    """keras MHA dropout is honoured (not silently dropped) on every
    attention path (vtd.py:364-369): einsum, flash (falls back to the exact
    einsum path), windowed (per-window prob dropout); ring raises."""
    import pytest

    base = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1, dropout=0.5)
    params = init_params(jax.random.PRNGKey(0), base)
    images = jax.random.uniform(jax.random.PRNGKey(1), (1, 64, 64, 3))

    for cfg in (base,
                base.replace(use_flash_attention=True),
                base.replace(attention_window=2)):
        t1 = forward(params, images, cfg, train=True,
                     dropout_rng=jax.random.PRNGKey(2))
        t2 = forward(params, images, cfg, train=True,
                     dropout_rng=jax.random.PRNGKey(3))
        assert not np.allclose(np.asarray(t1), np.asarray(t2)), cfg
        assert bool(jnp.all(jnp.isfinite(t1)))
        # eval is deterministic and dropout-free
        e1 = forward(params, images, cfg, train=False)
        e2 = forward(params, images, cfg, train=False)
        np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))

    # flash runs dropout IN-KERNEL (counter-based mask) since round 3:
    # same rng draws a different mask than the einsum path, so outputs
    # differ — but both are real dropout (checked above) and their
    # statistics agree (test_flash_dropout_statistically_matches_...).
    flash = base.replace(use_flash_attention=True)
    out_e = forward(params, images, base, train=True,
                    dropout_rng=jax.random.PRNGKey(5))
    out_f = forward(params, images, flash, train=True,
                    dropout_rng=jax.random.PRNGKey(5))
    assert out_f.shape == out_e.shape
    assert bool(jnp.all(jnp.isfinite(out_f)))

    # Ring attention drops in-kernel too (round 3; same positional mask
    # as flash) — training forwards differ per rng and stay finite.
    ring = base.replace(ring_attention=True)
    from vision_transformer_detector.parallel.mesh import create_mesh
    mesh = create_mesh(data=1, model=2, devices=jax.devices()[:2])
    r1 = forward(params, images, ring, train=True,
                 dropout_rng=jax.random.PRNGKey(2), mesh=mesh)
    r2 = forward(params, images, ring, train=True,
                 dropout_rng=jax.random.PRNGKey(3), mesh=mesh)
    assert not np.allclose(np.asarray(r1), np.asarray(r2))
    assert bool(jnp.all(jnp.isfinite(r1)))


def test_train_step_with_dropout_each_mode():
    """One full training step with dropout configured under each attention
    mode (VERDICT round-1 item 5)."""
    from vision_transformer_detector.config import (
        LossConfig, TrainConfig)
    from vision_transformer_detector.train.trainer import Trainer

    base = DetectorConfig(
        image_size=(32, 32), patch_size=16, embedding_dim=8, num_heads=2,
        key_dim=4, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=8, head_layers=1, dropout=0.3)
    images = np.random.default_rng(0).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)
    labels = np.full((2, base.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[:, 0] = (1, 3, 16.0, 16.0, 10.0, 10.0)

    for cfg in (base,
                base.replace(use_flash_attention=True),
                base.replace(attention_window=2)):
        trainer = Trainer(cfg, LossConfig(), TrainConfig(learning_rate=1e-3))
        state = trainer.init_state()
        state, loss = trainer.train_step(
            state, jnp.asarray(images), jnp.asarray(labels),
            jax.random.PRNGKey(0))
        assert np.isfinite(float(loss)), cfg


def test_multi_scale_head():
    """Multi-scale head (BASELINE configs[4]): pooled-scale features
    concatenated per slot; forward shape unchanged."""
    cfg = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=2, head_scales=(1, 2))
    params = init_params(jax.random.PRNGKey(0), cfg)
    assert isinstance(params["head_token_dense"], list)
    assert len(params["head_token_dense"]) == 2
    # pyramid input dim: 4x4 grid -> 16 + 2x2 -> 4 = 20
    assert params["head_mlp"][0]["kernel"].shape[0] == 20
    logits = forward(params, jnp.ones((2, 64, 64, 3)), cfg)
    assert logits.shape == (2, cfg.max_objects, 6)
    assert bool(jnp.all(jnp.isfinite(logits)))


def test_multi_scale_head_gradients():
    cfg = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1, head_scales=(1, 2))
    params = init_params(jax.random.PRNGKey(0), cfg)
    grads = jax.grad(
        lambda p: jnp.sum(forward(p, jnp.ones((1, 64, 64, 3)), cfg) ** 2)
    )(params)
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in leaves)


def test_window_major_matches_transpose_path():
    """The one-time window-major token reorder (forward() encoder entry)
    plus reshape-only folding must produce exactly the same attention
    output as the per-layer transpose folding, on a grid with MULTIPLE
    windows (4x4 grid, 2x2 windows -> non-trivial permutation)."""
    from vision_transformer_detector.models.vit_detector import (
        _windowed_attention)

    cfg = DetectorConfig(image_size=(64, 64), patch_size=16,
                         embedding_dim=8, num_heads=2, key_dim=4,
                         encoder_blocks=1, encoder_mlp_layers=1,
                         head_last_units=8, head_layers=1,
                         attention_window=2)
    gh, gw = cfg.grid_size
    b, n, h, k = 2, gh * gw, cfg.num_heads, cfg.key_dim
    rng = jax.random.PRNGKey(0)
    q, key, v = (jax.random.normal(r, (b, n, h, k), jnp.float32)
                 for r in jax.random.split(rng, 3))

    ref = _windowed_attention(q, key, v, gh, gw, 2, cfg, jnp.float32,
                              window_major=False)

    w = 2
    nh, nw = gh // w, gw // w

    def perm(t):
        t = t.reshape(b, nh, w, nw, w, h, k)
        return t.transpose(0, 1, 3, 2, 4, 5, 6).reshape(b, n, h, k)

    def inv(t):
        t = t.reshape(b, nh, nw, w, w, h, k)
        return t.transpose(0, 1, 3, 2, 4, 5, 6).reshape(b, n, h, k)

    got = inv(_windowed_attention(perm(q), perm(key), perm(v), gh, gw, 2,
                                  cfg, jnp.float32, window_major=True))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


def test_window_major_forward_golden_vs_einsum_oracle():
    """End-to-end: the windowed forward (window-major fast path) equals a
    straightforward oracle that materialises each window's attention via
    the einsum path on the SAME params (flash off so both sides use
    einsum; the only difference is the token-reorder plumbing)."""
    cfg = DetectorConfig(image_size=(64, 64), patch_size=16,
                         embedding_dim=8, num_heads=2, key_dim=4,
                         encoder_blocks=2, encoder_mlp_layers=2,
                         head_last_units=8, head_layers=1,
                         attention_window=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    images = jax.random.uniform(jax.random.PRNGKey(1), (2, 64, 64, 3),
                                minval=-1, maxval=1)
    out = forward(params, images, cfg)
    assert np.isfinite(np.asarray(out)).all()
    # Oracle: window covering one quadrant == slicing tokens per window and
    # running full attention per window is exactly what window=grid gives
    # on each 2x2 sub-grid; instead validate against the flash-folded
    # route, which shares none of the einsum path's code.
    out_flash = forward(params, images, cfg.replace(
        use_flash_attention=True))
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_flash),
                               rtol=2e-2, atol=2e-2)


def test_alternate_remat_matches_no_remat():
    """remat_policy='alternate' (checkpoint every other block) is a pure
    memory/time tradeoff — forward values and gradients match the
    un-remat'd model exactly."""
    from vision_transformer_detector.config import LossConfig
    from vision_transformer_detector.ops.loss import detection_loss

    cfg = DetectorConfig(image_size=(34, 34), embedding_dim=8, num_heads=2,
                         key_dim=4, encoder_blocks=4, encoder_mlp_layers=2,
                         head_last_units=8, head_layers=1)
    cfg_alt = cfg.replace(remat_encoder=True, remat_policy="alternate")
    params = init_params(jax.random.PRNGKey(0), cfg)
    images = jax.random.uniform(jax.random.PRNGKey(1), (2, 34, 34, 3),
                                minval=-1, maxval=1)
    labels = np.full((2, cfg.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 17.0, 17.0, 10.0, 10.0)
    labels = jnp.asarray(labels)

    def loss_fn(cfg_):
        return lambda p: detection_loss(
            labels, forward(p, images, cfg_), cfg_, LossConfig())

    l0, g0 = jax.value_and_grad(loss_fn(cfg))(params)
    l1, g1 = jax.value_and_grad(loss_fn(cfg_alt))(params)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_attention_layout_flag_equivalence():
    """attention_heads_major True/False produce the same outputs on the
    same params (the flag only changes data plumbing); the narrow-head
    auto default picks tokens-major."""
    cfg = DetectorConfig(image_size=(34, 34), embedding_dim=8, num_heads=2,
                         key_dim=4, encoder_blocks=2, encoder_mlp_layers=2,
                         head_last_units=8, head_layers=1)
    assert cfg.key_dim % 64 != 0  # auto -> tokens-major
    params = init_params(jax.random.PRNGKey(0), cfg)
    images = jax.random.uniform(jax.random.PRNGKey(1), (2, 34, 34, 3),
                                minval=-1, maxval=1)
    out_auto = forward(params, images, cfg)
    out_hm = forward(params, images,
                     cfg.replace(attention_heads_major=True))
    out_tm = forward(params, images,
                     cfg.replace(attention_heads_major=False))
    np.testing.assert_allclose(np.asarray(out_hm), np.asarray(out_tm),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out_auto), np.asarray(out_tm))


def test_pad_attention_key_dim_exact_forward_and_grads():
    """Weight-level head-dim padding (40-style -> 64) is numerically
    exact: same forward output, same gradients on real weights, and
    identically-zero gradients on the padding (so it stays zero under
    training). VERDICT r2 next-step #4."""
    from vision_transformer_detector.models.vit_detector import (
        pad_attention_key_dim)

    cfg = TINY  # key_dim 8 -> padded 64 exercises the same code path
    params = init_params(jax.random.PRNGKey(0), cfg)
    padded = pad_attention_key_dim(params, to=64)
    assert padded["encoder"][0]["mha"]["query"]["kernel"].shape[-1] == 64
    # Idempotent / no-op when already wide enough.
    again = pad_attention_key_dim(padded, to=64)
    assert (again["encoder"][0]["mha"]["query"]["kernel"].shape
            == padded["encoder"][0]["mha"]["query"]["kernel"].shape)

    images = jax.random.uniform(jax.random.PRNGKey(1), (2, 68, 68, 3),
                                minval=-1, maxval=1)
    want = forward(params, images, cfg)
    got = forward(padded, images, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5, rtol=1e-5)

    # Heads-major einsum path too (the inference headline layout).
    cfg_hm = cfg.replace(attention_heads_major=True)
    got_hm = forward(padded, images, cfg_hm)
    np.testing.assert_allclose(np.asarray(got_hm), np.asarray(want),
                               atol=1e-5, rtol=1e-5)

    def loss(p):
        return jnp.sum(forward(p, images, cfg) ** 2)

    g_plain = jax.grad(loss)(params)
    g_padded = jax.grad(loss)(padded)
    for b_plain, b_padded in zip(g_plain["encoder"], g_padded["encoder"]):
        for name in ("query", "key", "value"):
            kp = np.asarray(b_plain["mha"][name]["kernel"])
            kq = np.asarray(b_padded["mha"][name]["kernel"])
            np.testing.assert_allclose(kq[..., :kp.shape[-1]], kp,
                                       atol=1e-4, rtol=1e-4)
            assert np.all(kq[..., kp.shape[-1]:] == 0.0)
        op = np.asarray(b_plain["mha"]["out"]["kernel"])
        oq = np.asarray(b_padded["mha"]["out"]["kernel"])
        np.testing.assert_allclose(oq[:, :op.shape[1]], op,
                                   atol=1e-4, rtol=1e-4)
        assert np.all(oq[:, op.shape[1]:] == 0.0)


def test_flash_dropout_statistically_matches_einsum_dropout():
    """keras-MHA probability dropout through the flash kernel vs the
    einsum path: same keep-rate semantics, so averaging over seeds must
    converge to the same (no-dropout) expectation for both (VERDICT r2
    next-step #5 'statistical equivalence')."""
    cfg_einsum = TINY.replace(dropout=0.4)
    cfg_flash = cfg_einsum.replace(use_flash_attention=True)
    params = init_params(jax.random.PRNGKey(0), cfg_einsum)
    images = jax.random.uniform(jax.random.PRNGKey(1), (1, 68, 68, 3),
                                minval=-1, maxval=1)
    base = np.asarray(forward(params, images, TINY))  # no dropout

    seeds = 24
    sums = {}
    for name, cfg in (("einsum", cfg_einsum), ("flash", cfg_flash)):
        fwd = jax.jit(lambda p, x, r, cfg=cfg: forward(
            p, x, cfg, train=True, dropout_rng=r))
        acc = np.zeros_like(base)
        for s in range(seeds):
            acc += np.asarray(fwd(params, images, jax.random.PRNGKey(s)))
        sums[name] = acc / seeds
    # Through the nonlinear head, E[f(dropout(x))] != f(x) — but that
    # bias is a property of the DROPOUT SEMANTICS, so the two paths must
    # exhibit the SAME bias (measured 0.5652 vs 0.5608 relative at 24
    # seeds) and their means must be close to each other.
    scale = np.abs(base).mean() + 1e-6
    rel = {name: np.abs(m - base).mean() / scale
           for name, m in sums.items()}
    assert abs(rel["flash"] - rel["einsum"]) < 0.05, rel
    assert (np.abs(sums["flash"] - sums["einsum"]).mean() / scale
            < 0.35)


def test_windowed_flash_dropout_trains():
    """Scaled stand-in for the 1024px windowed preset: flash + window +
    dropout compiles and yields finite loss/grads (the old path fell
    back to einsum under dropout; at 1024px that OOMed)."""
    from vision_transformer_detector.config import LossConfig
    from vision_transformer_detector.ops.loss import detection_loss

    cfg = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=16, head_layers=2, dropout=0.2,
        use_flash_attention=True, attention_window=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    images = jax.random.uniform(jax.random.PRNGKey(1), (2, 64, 64, 3),
                                minval=-1, maxval=1)
    labels = np.full((2, cfg.max_objects, 6), -8.0, np.float32)
    labels[:, :, 0] = 0.0
    labels[0, 0] = (1, 3, 32, 32, 16, 16)

    def loss_fn(p, rng):
        logits = forward(p, images, cfg, train=True, dropout_rng=rng)
        return detection_loss(jnp.asarray(labels), logits, cfg,
                              LossConfig())

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jax.random.PRNGKey(2))
    assert np.isfinite(float(loss))
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_grid_geometry_validation():
    """Non-divisible attention_window / head_scales fail at init with an
    actionable message instead of a reshape TypeError (window) or silent
    edge-cell truncation (head scales)."""
    import pytest

    bad_window = TINY.replace(image_size=(64, 64), patch_size=16,
                              attention_window=3)
    with pytest.raises(ValueError, match="attention_window=3"):
        init_params(jax.random.PRNGKey(0), bad_window)

    bad_scale = TINY.replace(image_size=(64, 64), patch_size=16,
                             head_scales=(1, 3))
    with pytest.raises(ValueError, match="head_scales entry 3"):
        init_params(jax.random.PRNGKey(0), bad_scale)

    zero_cells = TINY.replace(image_size=(64, 64), patch_size=16,
                              head_scales=(1, 8))
    with pytest.raises(ValueError, match="head_scales entry 8"):
        init_params(jax.random.PRNGKey(0), zero_cells)

    ok = TINY.replace(image_size=(64, 64), patch_size=16,
                      attention_window=2, head_scales=(1, 2, 4))
    params = init_params(jax.random.PRNGKey(0), ok)
    out = forward(params, jnp.zeros((1, 64, 64, 3)), ok)
    assert out.shape == (1, ok.max_objects, 6)


def test_ring_and_window_mutually_exclusive():
    """ring_attention + attention_window fails at init: with a mesh the
    ring path runs exact global attention (window silently ignored) while
    meshless calls would run windowed attention — same weights, two
    architectures. The validator now rejects the combination."""
    import pytest

    bad = TINY.replace(image_size=(64, 64), patch_size=16,
                       ring_attention=True, attention_window=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        init_params(jax.random.PRNGKey(0), bad)


@pytest.mark.slow
def test_init_rng_budget_deep_configs():
    """init_params sizes its rng key pool exactly; deep-head / deep-MLP
    configs that exhausted the old approximate budget (StopIteration
    inside jit) now initialise and run."""
    for cfg in (
        TINY.replace(head_block_repeats=6),
        TINY.replace(encoder_mlp_layers=12),
        TINY.replace(image_size=(64, 64), patch_size=16,
                     head_scales=(1, 2, 4), head_block_repeats=5),
    ):
        params = init_params(jax.random.PRNGKey(0), cfg)
        h, w = cfg.image_size
        out = forward(params, jnp.zeros((1, h, w, 3)), cfg)
        assert out.shape == (1, cfg.max_objects, 6)


def test_mha_init_matches_keras_fans():
    """Attention projection init uses keras compute_fans semantics for the
    rank-3 EinsumDense kernels: (D, H, K) -> fans (H*D, K*D) and
    (H, K, D) -> (K*H, D*H). The naive (prod-in, prod-out) fans start the
    projections ~2x wider than keras' — verified against installed keras'
    compute_fans((28, 8, 40)) == (224, 1120)."""
    import math

    from vision_transformer_detector.models.vit_detector import (
        _keras_fans)

    assert _keras_fans((28, 8, 40)) == (224, 1120)
    assert _keras_fans((8, 40, 28)) == (320, 224)
    assert _keras_fans((16, 32)) == (16, 32)  # rank-2 Dense unchanged

    cfg = TINY.replace(embedding_dim=64, num_heads=4, key_dim=16)
    params = init_params(jax.random.PRNGKey(0), cfg)
    mha = params["encoder"][0]["mha"]
    q = np.asarray(mha["query"]["kernel"], np.float32)
    fan_in, fan_out = _keras_fans(q.shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    assert np.max(np.abs(q)) <= limit + 1e-6
    assert np.max(np.abs(q)) > 0.9 * limit  # uniform fills its range
    o = np.asarray(mha["out"]["kernel"], np.float32)
    fan_in, fan_out = _keras_fans(o.shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    assert np.max(np.abs(o)) <= limit + 1e-6
    assert np.max(np.abs(o)) > 0.9 * limit


def test_split_prefix_stability_and_init_checksum():
    """init_params sizes its key pool exactly and the docstring asserts
    split(rng, n) is prefix-stable in n (vit_detector.py:108-114); pin
    both so a future JAX PRNG-default change (threefry -> rbg /
    partitionable) fails here loudly instead of silently changing
    fresh-init reproducibility for existing seeds (round-4 advisor)."""
    k = jax.random.PRNGKey(123)
    short = jax.random.key_data(jax.random.split(k, 5))
    long = jax.random.key_data(jax.random.split(k, 9))
    np.testing.assert_array_equal(np.asarray(short), np.asarray(long[:5]))

    cfg = DetectorConfig(image_size=(68, 68), patch_size=17,
                         embedding_dim=12, num_heads=2, key_dim=5,
                         encoder_blocks=2, encoder_mlp_layers=2,
                         head_last_units=8, head_layers=2)
    params = init_params(jax.random.PRNGKey(0), cfg)
    leaves = jax.tree_util.tree_leaves(params)
    checksum = float(sum(np.float64(np.asarray(l)).sum() for l in leaves))
    assert len(leaves) == 43
    np.testing.assert_allclose(checksum, 40.134562349549924, rtol=1e-6)
