"""Attention and layer numerics vs plain-JAX and NumPy oracles.

The chunked custom-VJP attention, the implementation choice, the dense and
LayerNorm layers run here on the CPU; the cuDNN route runs only on a GPU
(tests marked ``gpu``, run by chip_smoke.py on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector.kernels.flash_attention import (
    _chunk_group, attention_implementation, flash_attention,
    reference_attention)
from vision_transformer_detector.models.vit_detector import mish


def _qkv(b, n, h, k, dtype=jnp.float32, seed=0):
    rngs = jax.random.split(jax.random.PRNGKey(seed), 3)
    shape = (b, n, h, k)
    q = jax.random.normal(rngs[0], shape, dtype)
    key = jax.random.normal(rngs[1], shape, dtype)
    v = jax.random.normal(rngs[2], shape, dtype)
    return q, key, v


@pytest.mark.parametrize("n,k", [(196, 64), (256, 64), (300, 40)])
def test_flash_attention_matches_reference(n, k):
    """Covers: short, power-of-two and odd sequence lengths, and the
    reference model's narrow head_dim 40."""
    q, key, v = _qkv(2, n, 2, k)
    out = flash_attention(q, key, v)
    expected = reference_attention(q, key, v)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(expected), atol=2e-5, rtol=2e-5)


def test_flash_attention_bf16():
    q, key, v = _qkv(1, 128, 2, 64, dtype=jnp.bfloat16)
    out = flash_attention(q, key, v)
    expected = reference_attention(
        q.astype(jnp.float32), key.astype(jnp.float32),
        v.astype(jnp.float32))
    assert out.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(expected),
        atol=3e-2, rtol=3e-2)


def test_flash_attention_unpadded_whole_row():
    """A sequence that is a multiple of 16 but not of 128: forward and
    gradients must match the einsum oracle."""
    n = 144
    q, key, v = _qkv(2, n, 2, 64)
    out = flash_attention(q, key, v)          # auto blocks
    expected = reference_attention(q, key, v)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(expected), atol=2e-5, rtol=2e-5)

    cot = jax.random.normal(jax.random.PRNGKey(7), q.shape)
    grads = jax.grad(
        lambda q, k, v: (flash_attention(q, k, v) * cot).sum(),
        argnums=(0, 1, 2))(q, key, v)
    expected_grads = jax.grad(
        lambda q, k, v: (reference_attention(q, k, v) * cot).sum(),
        argnums=(0, 1, 2))(q, key, v)
    for g, e in zip(grads, expected_grads):
        np.testing.assert_allclose(np.asarray(g), np.asarray(e),
                                   atol=1e-4, rtol=1e-4)


def test_flash_attention_single_query_block():
    """One batch element and one head: a single chunk."""
    q, key, v = _qkv(1, 64, 1, 64)
    out = flash_attention(q, key, v)
    expected = reference_attention(q, key, v)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(expected), atol=2e-5, rtol=2e-5)


def test_flash_attention_gradients_match_reference():
    """Custom VJP vs reference-attention autodiff (training path)."""
    rngs = jax.random.split(jax.random.PRNGKey(3), 4)
    shape = (2, 128, 2, 64)
    q, k, v, g = (jax.random.normal(r, shape) for r in rngs)

    def loss_flash(q, k, v):
        return jnp.sum(flash_attention(q, k, v) * g)

    def loss_ref(q, k, v):
        return jnp.sum(reference_attention(q, k, v) * g)

    grads_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    grads_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(grads_flash, grads_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("variant,tol", [("delta", 3e-5),
                                         ("bf16_delta", 2e-2)])
def test_chunked_bwd_variants_match_reference(variant, tol):
    """Bandwidth-shaped chunked backwards (flash-v2 delta trick, bf16
    score streaming) vs reference autodiff. The delta identity
    rowsum(p * dp) == rowsum(g * (p @ v)) is exact, so "delta" holds
    fp32 tolerance; bf16 streaming rounds every probability to 8 bits
    of mantissa, so its gradients carry ~1e-2 relative error (same
    class as the bf16 forward)."""
    rngs = jax.random.split(jax.random.PRNGKey(13), 4)
    shape = (2, 128, 2, 64)
    q, k, v, g = (jax.random.normal(r, shape) for r in rngs)

    def loss_variant(q, k, v):
        return jnp.sum(flash_attention(q, k, v, bwd_variant=variant) * g)

    def loss_ref(q, k, v):
        return jnp.sum(reference_attention(q, k, v) * g)

    grads_variant = jax.grad(loss_variant, argnums=(0, 1, 2))(q, k, v)
    grads_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(grads_variant, grads_ref):
        scale = np.max(np.abs(np.asarray(b)))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=tol * scale, rtol=tol)


def test_chunked_bwd_delta_matches_with_dropout():
    """The delta identity must also hold through the dropout-scaled
    chain (rowsum(p * dpm) == rowsum(pd * (g v^T)))."""
    rngs = jax.random.split(jax.random.PRNGKey(14), 4)
    shape = (2, 128, 2, 64)
    q, k, v, g = (jax.random.normal(r, shape) for r in rngs)

    def loss(variant):
        def fn(q, k, v):
            return jnp.sum(flash_attention(
                q, k, v, dropout_rate=0.25, dropout_seed=7,
                bwd_variant=variant) * g)
        return fn

    grads_delta = jax.grad(loss("delta"), argnums=(0, 1, 2))(q, k, v)
    grads_fp32 = jax.grad(loss("fp32"), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(grads_delta, grads_fp32):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=3e-5, rtol=3e-5)


def test_flash_attention_grad_unaligned_seq():
    """Gradient path at an unaligned length (N=200), head dim 40."""
    rngs = jax.random.split(jax.random.PRNGKey(4), 3)
    shape = (1, 200, 2, 40)
    q, k, v = (jax.random.normal(r, shape) for r in rngs)

    def loss_flash(q, k, v):
        return jnp.sum(flash_attention(q, k, v) ** 2)

    def loss_ref(q, k, v):
        return jnp.sum(reference_attention(q, k, v) ** 2)

    grads_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    grads_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(grads_flash, grads_ref):
        # squared loss amplifies fp accumulation-order noise slightly
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=3e-4, rtol=1e-3)


def test_remat_encoder_gradients():
    """jax.checkpoint path produces finite grads (vit_l16_640 uses it)."""
    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.models.vit_detector import (
        forward, init_params)

    cfg = DetectorConfig(
        image_size=(32, 32), patch_size=16, embedding_dim=8, num_heads=2,
        key_dim=4, encoder_blocks=2, encoder_mlp_layers=2,
        head_last_units=8, head_layers=1, remat_encoder=True)
    params = init_params(jax.random.PRNGKey(0), cfg)
    grads = jax.grad(
        lambda p: float(0) + jnp.sum(
            forward(p, jnp.ones((1, 32, 32, 3)), cfg) ** 2))(params)
    assert all(bool(jnp.all(jnp.isfinite(g)))
               for g in jax.tree_util.tree_leaves(grads))


def test_flash_layout_bhnk_matches_bnhk():
    """layout='bhnk' (heads-major) must match the historical bnhk layout
    exactly — forward and gradients — since it only changes data
    plumbing, not math."""
    import jax

    from vision_transformer_detector.kernels.flash_attention import (
        flash_attention)

    rng = jax.random.PRNGKey(0)
    b, n, h, k = 2, 80, 3, 16
    q, key, v = (jax.random.normal(r, (b, n, h, k), jnp.float32) * 0.3
                 for r in jax.random.split(rng, 3))
    cot = jax.random.normal(jax.random.PRNGKey(9), (b, n, h, k),
                            jnp.float32)

    def loss_bnhk(q, key, v):
        return (flash_attention(q, key, v) * cot).sum()

    def loss_bhnk(q, key, v):
        qt, kt, vt = (t.transpose(0, 2, 1, 3) for t in (q, key, v))
        out = flash_attention(qt, kt, vt, layout="bhnk")
        return (out.transpose(0, 2, 1, 3) * cot).sum()

    (l0, g0) = jax.value_and_grad(loss_bnhk, argnums=(0, 1, 2))(q, key, v)
    (l1, g1) = jax.value_and_grad(loss_bhnk, argnums=(0, 1, 2))(q, key, v)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, c in zip(g0, g1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# Probability dropout (counter-based mask)


def _masked_oracle(q, k, v, rate, seed):
    """Dropout-after-softmax oracle using the SAME positional mask the
    chunked route generates (dropout_keep_mask is a pure function, so this
    is an exact — not statistical — equivalence check)."""
    from vision_transformer_detector.kernels.flash_attention import (
        _keep_threshold, dropout_keep_mask)

    b, n, h, kd = q.shape
    threshold = _keep_threshold(rate)
    pos = jnp.arange(n, dtype=jnp.uint32)
    bh = jnp.arange(b * h, dtype=jnp.uint32).reshape(b, h)
    keep = dropout_keep_mask(
        jnp.uint32(seed), bh[:, :, None, None],
        pos[None, None, :, None], pos[None, None, None, :], threshold)
    scores = jnp.einsum("bnhk,bmhk->bhnm", q.astype(jnp.float32),
                        k.astype(jnp.float32))
    probs = jax.nn.softmax(scores, axis=-1)
    probs = jnp.where(keep, probs / (1.0 - rate), 0.0)
    return jnp.einsum("bhnm,bmhk->bnhk", probs.astype(v.dtype), v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


def test_flash_dropout_matches_masked_oracle_exactly():
    q, k, v = _qkv(2, 200, 2, 40, seed=7)
    rate, seed = 0.3, 1234
    out = flash_attention(q, k, v, dropout_rate=rate,
                          dropout_seed=jnp.uint32(seed))
    want = _masked_oracle(q, k, v, rate, seed)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               atol=3e-5, rtol=3e-5)


def test_flash_dropout_gradients_match_masked_oracle():
    """The chunked backward replays the forward's mask: grads must match
    autodiff through the explicit-mask oracle."""
    q, k, v = _qkv(1, 160, 2, 40, seed=8)
    g = jax.random.normal(jax.random.PRNGKey(9), q.shape)
    rate, seed = 0.25, 77

    def loss_flash(q, k, v):
        return jnp.sum(flash_attention(
            q, k, v, dropout_rate=rate,
            dropout_seed=jnp.uint32(seed)) * g)

    def loss_oracle(q, k, v):
        return jnp.sum(_masked_oracle(q, k, v, rate, seed) * g)

    got = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_oracle, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=3e-4, rtol=3e-4)


def test_dropout_mask_statistics():
    """Counter-hash mask: keep-rate within 1% of 1-rate, and masks from
    different seeds / batch-heads decorrelated."""
    from vision_transformer_detector.kernels.flash_attention import (
        _keep_threshold, dropout_keep_mask)

    n = 512
    pos = jnp.arange(n, dtype=jnp.uint32)
    for rate in (0.1, 0.5):
        threshold = _keep_threshold(rate)
        m0 = np.asarray(dropout_keep_mask(
            jnp.uint32(1), jnp.uint32(0), pos[:, None], pos[None, :],
            threshold))
        assert abs(m0.mean() - (1 - rate)) < 0.01
        m1 = np.asarray(dropout_keep_mask(
            jnp.uint32(2), jnp.uint32(0), pos[:, None], pos[None, :],
            threshold))
        m2 = np.asarray(dropout_keep_mask(
            jnp.uint32(1), jnp.uint32(1), pos[:, None], pos[None, :],
            threshold))
        for other in (m1, m2):
            agree = (m0 == other).mean()
            expected = (1 - rate) ** 2 + rate ** 2
            assert abs(agree - expected) < 0.01


@pytest.mark.slow
def test_flash_dropout_mean_approximates_no_dropout():
    """Inverted-scaling dropout is unbiased: averaging over many seeds
    approaches the deterministic output."""
    q, k, v = _qkv(1, 64, 1, 16, seed=10)
    rate = 0.5
    base = np.asarray(reference_attention(q, k, v))
    acc = np.zeros_like(base)
    seeds = 64
    for s in range(seeds):
        acc += np.asarray(flash_attention(
            q, k, v, dropout_rate=rate, dropout_seed=jnp.uint32(s)))
    mean = acc / seeds
    err = np.abs(mean - base).mean() / (np.abs(base).mean() + 1e-9)
    assert err < 0.2, err


def test_flash_dropout_zero_rate_is_identity():
    q, k, v = _qkv(1, 128, 2, 64, seed=11)
    out = flash_attention(q, k, v, dropout_rate=None)
    want = flash_attention(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want))


def test_int8_serving_with_padded_key_dim():
    """quantize_params(pad_attention_key_dim(params)) — both public
    APIs composed — must forward: the attention head dim is read off
    the quantized layer's (H, K) bias, not config.key_dim (round-4
    review: the reshape crashed on the physical 64 vs nominal 40)."""
    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.kernels.quantization import (
        quantize_params)
    from vision_transformer_detector.models.vit_detector import (
        forward, init_params, pad_attention_key_dim)

    cfg = DetectorConfig(
        image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
        encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8,
        head_layers=1)
    params = init_params(jax.random.PRNGKey(0), cfg)
    padded_q = quantize_params(pad_attention_key_dim(params, to=8))
    images = jax.random.uniform(jax.random.PRNGKey(1), (2, 34, 34, 3),
                                minval=-1, maxval=1)
    base = forward(params, images, cfg)
    quant = forward(padded_q, images, cfg)
    assert quant.shape == base.shape
    assert np.isfinite(np.asarray(quant)).all()
    # int8 is lossy but must stay in the same ballpark as fp32.
    assert float(jnp.mean(jnp.abs(quant - base))) < 1.0




# ---------------------------------------------------------------------------
# Chunked custom-VJP backward at multi-chunk, whole-sequence and
# heads-major shapes.


@pytest.mark.parametrize("layout,shape", [
    ("bnhk", (1, 200, 2, 40)),    # unaligned length, narrow head dim
    ("bnhk", (2, 300, 2, 64)),    # several (batch, head) chunks
    ("bnhk", (2, 200, 2, 32)),    # one whole sequence per chunk
    ("bhnk", (2, 3, 80, 16)),     # heads-major layout
])
def test_chunked_backward_matches_reference(layout, shape):
    rngs = jax.random.split(jax.random.PRNGKey(5), 4)
    q, k, v, g = (jax.random.normal(r, shape) for r in rngs)
    to_bnhk = ((lambda t: t.transpose(0, 2, 1, 3)) if layout == "bhnk"
               else (lambda t: t))

    def loss_flash(q, k, v):
        return jnp.sum(flash_attention(q, k, v, layout=layout,
                                       implementation="chunked") * g)

    def loss_ref(q, k, v):
        out = reference_attention(to_bnhk(q), to_bnhk(k), to_bnhk(v))
        return jnp.sum(to_bnhk(out) * g)

    grads_flash = jax.grad(loss_flash, argnums=(0, 1, 2))(q, k, v)
    grads_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(grads_flash, grads_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("bh,n,buffers,want", [
    (16, 576, 3, 1),        # few heads: one per iteration
    (2048, 256, 3, 16),     # windows fold into many heads: grouped
    (2048, 4096, 3, 1),     # score budget caps the group at 1
    (260, 256, 3, 2),       # rounded down to a divisor of bh (3 -> 2)
])
def test_chunk_group(bh, n, buffers, want):
    group = _chunk_group(bh, n, score_buffers=buffers)
    assert group == want
    assert bh % group == 0


@pytest.mark.parametrize("platform,dtype,dropout,head_dim,want", [
    ("gpu", jnp.bfloat16, False, 64, "cudnn"),
    ("gpu", jnp.float16, False, 40, "cudnn"),
    ("gpu", jnp.float32, False, 64, "chunked"),   # cuDNN takes half only
    ("gpu", jnp.bfloat16, True, 64, "chunked"),   # dropout needs the mask
    ("gpu", jnp.bfloat16, False, 4, "chunked"),   # head dim not 8-aligned
    ("cpu", jnp.bfloat16, False, 64, "chunked"),
])
def test_attention_implementation_choice(platform, dtype, dropout, head_dim,
                                         want):
    assert attention_implementation(platform, dtype, dropout,
                                    head_dim) == want


def test_flash_attention_rejects_unknown_implementation():
    q, key, v = _qkv(1, 16, 1, 8)
    with pytest.raises(ValueError, match="unknown implementation"):
        flash_attention(q, key, v, implementation="triton")
    with pytest.raises(ValueError, match="no probability dropout"):
        flash_attention(q, key, v, implementation="cudnn",
                        dropout_rate=0.1, dropout_seed=1)


# (N, H, K) of each preset's attention: reference_224, vit_s16_224,
# vit_b16_384, reference_608, vit_l16_640, highres_1024's 16x16 windows.
PRESET_ATTENTION_SHAPES = [(169, 8, 40), (196, 6, 64), (576, 12, 64),
                           (1296, 8, 40), (1600, 16, 64), (256, 16, 64)]


@pytest.mark.parametrize("n,h,k", PRESET_ATTENTION_SHAPES)
def test_dot_product_attention_xla_matches_reference(n, h, k):
    """jax.nn.dot_product_attention's XLA implementation — the portable
    form of the library call the cuDNN route makes — against the einsum
    oracle at each preset's attention shape (scale 1: inputs arrive
    pre-scaled)."""
    q, key, v = _qkv(1, n, h, k, seed=n)
    q = q / np.sqrt(k)
    got = jax.nn.dot_product_attention(q, key, v, scale=1.0,
                                       implementation="xla")
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(reference_attention(q, key, v)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bnhk", "bhnk"])
def test_cudnn_attention_matches_reference(layout):
    """On the GPU, bf16 attention takes the cuDNN route; forward and
    gradients stay within bf16 tolerance of the fp32 oracle."""
    q, key, v = _qkv(2, 576, 4, 64, dtype=jnp.bfloat16, seed=3)
    g = jax.random.normal(jax.random.PRNGKey(4), q.shape, jnp.float32)
    assert attention_implementation(jax.default_backend(), q.dtype, False,
                                    64) == "cudnn"
    flip = ((lambda t: t.transpose(0, 2, 1, 3)) if layout == "bhnk"
            else (lambda t: t))

    def loss(fn):
        def f(q, key, v):
            return jnp.sum(fn(q, key, v).astype(jnp.float32) * g)
        return f

    def cudnn(q, key, v):
        return flip(flash_attention(flip(q), flip(key), flip(v),
                                    layout=layout))

    def oracle(q, key, v):
        with jax.default_matmul_precision("highest"):
            return reference_attention(*(t.astype(jnp.float32)
                                         for t in (q, key, v)))

    np.testing.assert_allclose(
        np.asarray(jax.jit(cudnn)(q, key, v), np.float32),
        np.asarray(jax.jit(oracle)(q, key, v)), atol=2e-2, rtol=2e-2)
    got = jax.jit(jax.grad(loss(cudnn), argnums=(0, 1, 2)))(q, key, v)
    want = jax.jit(jax.grad(loss(oracle), argnums=(0, 1, 2)))(q, key, v)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(np.asarray(a, np.float32), b,
                                   atol=2e-2 * np.abs(b).max(), rtol=2e-2)


@pytest.mark.gpu
def test_cudnn_route_lowers_to_cudnn_custom_call():
    """The GPU program of a bf16 call holds cuDNN's fused attention (no
    silent fallback to another lowering)."""
    q, key, v = _qkv(1, 256, 2, 64, dtype=jnp.bfloat16)
    hlo = jax.jit(flash_attention).lower(q, key, v).compile().as_text()
    assert "cudnn" in hlo.lower()


# ---------------------------------------------------------------------------
# Dense + activation and LayerNorm: the XLA layers the model runs.


@pytest.mark.parametrize("lead,k,n", [
    ((64,), 128, 128),
    ((100,), 867, 28),      # reference patch projection 867 -> 28
    ((17,), 1296, 136),     # reference head layer 1296 -> 136
    ((2, 5), 64, 32),       # leading axes
])
def test_dense_activation_matches_oracle(lead, k, n):
    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.models.vit_detector import (
        _dense_activation)

    rngs = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(rngs[0], lead + (k,), jnp.float32)
    layer = {"kernel": jax.random.normal(rngs[1], (k, n)) * 0.05,
             "bias": jax.random.normal(rngs[2], (n,))}
    out = _dense_activation(x, layer, DetectorConfig(), jnp.float32)
    assert out.shape == lead + (n,)
    xn, wn, bn = (np.asarray(t, np.float64)
                  for t in (x, layer["kernel"], layer["bias"]))
    z = xn @ wn + bn
    want = z * np.tanh(np.log1p(np.exp(z)))
    np.testing.assert_allclose(np.asarray(out), want, atol=3e-5, rtol=3e-5)


def test_dense_activation_gradients_match_oracle():
    """Gradients of dense+mish for x, kernel AND bias match autodiff of
    the plain expression mish(x @ w + b)."""
    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.models.vit_detector import (
        _dense_activation)

    rngs = jax.random.split(jax.random.PRNGKey(0), 4)
    x = jax.random.normal(rngs[0], (3, 40, 96), jnp.float32)
    w = jax.random.normal(rngs[1], (96, 176), jnp.float32) * 0.1
    b = jax.random.normal(rngs[2], (176,), jnp.float32) * 0.1
    cot = jax.random.normal(rngs[3], (3, 40, 176), jnp.float32)
    cfg = DetectorConfig()

    def layer_loss(x, w, b):
        out = _dense_activation(x, {"kernel": w, "bias": b}, cfg,
                                jnp.float32)
        return jnp.sum(out * cot)

    def oracle(x, w, b):
        return jnp.sum(mish(x @ w + b) * cot)

    got = jax.grad(layer_loss, argnums=(0, 1, 2))(x, w, b)
    want = jax.grad(oracle, argnums=(0, 1, 2))(x, w, b)
    for a, c in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 128), (3, 7, 256), (1, 1, 128),
                                   (0, 7, 128)])
def test_layer_norm_fp32_contract(dtype, shape):
    """_layer_norm computes in fp32 whatever the input dtype and returns
    the input dtype: it matches a float64 NumPy oracle to fp32 rounding
    (bf16 inputs to the output's bf16 rounding), the empty batch
    included."""
    from vision_transformer_detector.models.vit_detector import (
        _layer_norm)

    x = (jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float32) * 3
         + 1).astype(dtype)
    gamma = jax.random.normal(jax.random.PRNGKey(1), (shape[-1],))
    beta = jax.random.normal(jax.random.PRNGKey(2), (shape[-1],))
    got = _layer_norm(x, {"gamma": gamma, "beta": beta})
    assert got.dtype == x.dtype and got.shape == shape
    x64 = np.asarray(x, np.float64)
    mean = x64.mean(axis=-1, keepdims=True)
    var = x64.var(axis=-1, keepdims=True)
    want = ((x64 - mean) / np.sqrt(var + 1e-3) * np.asarray(gamma, np.float64)
            + np.asarray(beta, np.float64))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=tol, rtol=tol)
