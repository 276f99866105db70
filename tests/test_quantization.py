"""Int8 serving-path quantization: numerics, drop-in forward, AP retention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector.kernels.quantization import (
    int8_dense, quantize_params)
from vision_transformer_detector.models.vit_detector import (
    forward, init_params)

TINY = DetectorConfig(
    image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
    encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8, head_layers=1)


def test_int8_dense_close_to_fp32():
    rng = np.random.default_rng(0)
    layer = {"kernel": rng.normal(0, 0.3, (64, 32)).astype(np.float32),
             "bias": rng.normal(0, 0.1, (32,)).astype(np.float32)}
    x = jnp.asarray(rng.normal(0, 1.0, (5, 64)).astype(np.float32))
    want = np.asarray(x) @ layer["kernel"] + layer["bias"]

    from vision_transformer_detector.kernels.quantization import (
        _quantize_dense_layer)
    got = np.asarray(int8_dense(x, _quantize_dense_layer(layer)))
    # ~1% relative error budget for 8-bit weights x 8-bit activations.
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, atol=0.02 * scale)


def test_quantized_forward_is_dropin():
    """quantize_params output feeds forward() directly under jit; decoded
    detections agree with fp32 within the int8 error budget."""
    from vision_transformer_detector.ops.decode import (
        transform_predictions)

    params = init_params(jax.random.PRNGKey(0), TINY)
    qparams = quantize_params(params)
    images = jax.random.uniform(
        jax.random.PRNGKey(1), (2, 34, 34, 3), minval=-1, maxval=1)

    logits = jax.jit(lambda p, x: forward(p, x, TINY))(params, images)
    qlogits = jax.jit(lambda p, x: forward(p, x, TINY))(qparams, images)
    assert qlogits.shape == logits.shape and qlogits.dtype == logits.dtype

    dec = np.asarray(transform_predictions(logits, TINY))
    qdec = np.asarray(transform_predictions(qlogits, TINY))
    # Objectness/score space after sigmoid: small absolute budget.
    np.testing.assert_allclose(qdec[..., 0], dec[..., 0], atol=0.05)
    # Box centers within a couple of pixels at 34px.
    np.testing.assert_allclose(qdec[..., 2:4], dec[..., 2:4], atol=2.0)


def test_quantized_ap_retention():
    """Overfit a tiny detector, quantize, and the streaming mAP must hold
    (the end-to-end accuracy guard for the serving path)."""
    from vision_transformer_detector.train.optimizer import (
        make_optimizer)
    from vision_transformer_detector.train.trainer import (
        create_train_state, evaluate_map, make_train_step)

    rng_np = np.random.default_rng(0)
    h, w = TINY.image_size
    images = jnp.asarray(
        rng_np.uniform(-1, 1, (2, h, w, 3)).astype(np.float32))
    labels = np.full((2, TINY.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 17.0, 17.0, 10.0, 10.0)
    labels[1, 0] = (1, 40, 10.0, 20.0, 8.0, 12.0)
    labels = jnp.asarray(labels)

    optimizer = make_optimizer(TrainConfig(learning_rate=2e-4))
    state = create_train_state(jax.random.PRNGKey(0), TINY, optimizer)
    step = make_train_step(TINY, LossConfig(), optimizer, donate=False)
    rng = jax.random.PRNGKey(1)
    for _ in range(5000):  # reaches AP 0.5 on this fixed pair (measured)
        state, _ = step(state, images, labels, rng)

    data = [(images, labels)]
    ap_fp32 = evaluate_map(state["params"], data, TINY)
    ap_int8 = evaluate_map(quantize_params(state["params"]), data, TINY)
    assert ap_fp32 >= 0.4, "fp32 overfit did not learn; test is vacuous"
    assert ap_int8 >= ap_fp32 - 0.1


def test_quantized_multi_scale_head():
    cfg = DetectorConfig(
        image_size=(64, 64), patch_size=16, embedding_dim=16, num_heads=2,
        key_dim=8, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=16, head_layers=1, head_scales=(1, 2))
    params = init_params(jax.random.PRNGKey(0), cfg)
    qparams = quantize_params(params)
    out = forward(qparams, jnp.ones((1, 64, 64, 3)), cfg)
    assert out.shape == (1, cfg.max_objects, 6)
    assert bool(jnp.all(jnp.isfinite(out)))


@pytest.mark.parametrize("kernel_shape,bias_shape,mha_out", [
    ((200, 96), (96,), False),           # plain dense layer
    ((16, 2, 8), (2, 8), False),         # MHA q/k/v projection (D, H, K)
    ((2, 8, 16), (16,), True),           # MHA output projection (H, K, D)
])
def test_int8_dense_routing(kernel_shape, bias_shape, mha_out):
    """Every quantized layer the model's _dense meets goes through
    int8_dense (the plain XLA int8 path): same values, compute dtype."""
    from vision_transformer_detector.kernels.quantization import (
        _quantize_dense_layer)
    from vision_transformer_detector.models.vit_detector import _dense

    rng = np.random.default_rng(1)
    layer = _quantize_dense_layer(
        {"kernel": rng.normal(0, 0.3, kernel_shape).astype(np.float32),
         "bias": rng.normal(0, 0.1, bias_shape).astype(np.float32)},
        mha_out=mha_out)
    in_dim = layer["kernel_q"].shape[0]
    x = jnp.asarray(rng.normal(0, 1.0, (3, 7, in_dim)).astype(np.float32))
    for dtype in (jnp.float32, jnp.bfloat16):
        got = _dense(x, layer, dtype)
        assert got.dtype == dtype
        assert got.shape == (3, 7) + bias_shape
        np.testing.assert_array_equal(
            np.asarray(got, np.float32),
            np.asarray(int8_dense(x, layer).astype(dtype), np.float32))
