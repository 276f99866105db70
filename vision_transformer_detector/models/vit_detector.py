"""Pure-functional ViT detector: patchify -> encoder -> detection head.

Re-design of the reference model for XLA
(vision_transformer_detector.py:239-583):
  * patch extraction is a pad+reshape+transpose (no gather), reproducing
    ``tf.image.extract_patches`` with ``padding='SAME'`` including the
    zero-padded last row/column when the image size is not a multiple of the
    patch size (vtd.py:189-199; 608 = 17*35 + 13),
  * the learned positional embedding keeps the reference's embedding_dim=1
    broadcast quirk (vtd.py:291-293) as a plain ``(P, 1)`` parameter,
  * the encoder is pre-LN MHA + a descending dense "pyramid" with mish
    (vtd.py:312-414); attention can route through the memory-bounded
    attention of kernels/flash_attention.py (cuDNN fused attention or a
    chunked custom VJP) and supports local windowing for the high-res
    variant,
  * the head is Dense-over-tokens + reshape + descending pyramid + Dense(6)
    with no sigmoid (vtd.py:417-495) — decode happens outside the model
    (ops/decode.py), preserving the reference's raw-logits contract.

Parameters live in a plain nested dict (pytree), so sharding rules,
checkpoint conversion and optax transforms stay transparent. Matmuls run in
``config.compute_dtype`` (bf16 on accelerators) with float32 accumulation
(``preferred_element_type``); layer norms and softmax statistics stay fp32.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from ..config import DetectorConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialisers (matching keras defaults so training dynamics carry over)
# ---------------------------------------------------------------------------

def _glorot_uniform(rng, shape, fan_in, fan_out, dtype):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(rng, shape, dtype, -limit, limit)


def _keras_fans(shape):
    """keras ``compute_fans`` semantics for arbitrary-rank kernels: every
    leading dim is receptive field; fan_in = shape[-2] * receptive,
    fan_out = shape[-1] * receptive. MultiHeadAttention's EinsumDense
    kernels are rank-3, so plain (prod(in), prod(out)) fans would start
    the attention projections ~2x wider than keras does."""
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return shape[-2] * receptive, shape[-1] * receptive


def _dense_init(rng, in_dim, out_dim, dtype):
    kernel = _glorot_uniform(rng, (in_dim, out_dim), in_dim, out_dim, dtype)
    return {"kernel": kernel, "bias": jnp.zeros((out_dim,), dtype)}


def _layer_norm_init(dim, dtype):
    return {"gamma": jnp.ones((dim,), dtype), "beta": jnp.zeros((dim,), dtype)}


def _mha_init(rng, embed_dim, num_heads, key_dim, dtype):
    """keras.layers.MultiHeadAttention parameter layout (vtd.py:364-369):
    per-head q/k/v projections D->(H,K) and output projection (H,K)->D."""
    rngs = jax.random.split(rng, 4)
    def proj(r):
        shape = (embed_dim, num_heads, key_dim)
        kernel = _glorot_uniform(r, shape, *_keras_fans(shape), dtype)
        return {"kernel": kernel,
                "bias": jnp.zeros((num_heads, key_dim), dtype)}
    out_shape = (num_heads, key_dim, embed_dim)
    out_kernel = _glorot_uniform(
        rngs[3], out_shape, *_keras_fans(out_shape), dtype)
    return {
        "query": proj(rngs[0]),
        "key": proj(rngs[1]),
        "value": proj(rngs[2]),
        "out": {"kernel": out_kernel, "bias": jnp.zeros((embed_dim,), dtype)},
    }


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(rng: jax.Array, config: DetectorConfig) -> Params:
    """Build the full parameter pytree for ``forward``.

    Runs as ONE jitted program: the eager version dispatched hundreds of
    small rng/init ops, one device dispatch each. ``config`` is static
    (hashable frozen dataclass), so repeat inits of the same config hit
    the jit cache.
    """
    _validate_grid_config(config)  # fail at init, not mid-training
    return _init_params_jit(rng, config)


@functools.partial(jax.jit, static_argnums=(1,))
def _init_params_jit(rng: jax.Array, config: DetectorConfig) -> Params:
    dtype = jnp.dtype(config.param_dtype)
    # Exact key budget — one per initialised tensor below, in consumption
    # order. (An approximate over-estimate once under-counted deep-head
    # configs and crashed with StopIteration inside jit; split(rng, n) is
    # prefix-stable in n, so sizing exactly does not change any key.)
    n_keys = (
        2  # linear_projection + position_embedding
        + config.encoder_blocks * (1 + len(config.encoder_mlp_units))
        + (1 if config.head_scales == (1,) else len(config.head_scales))
        + len(config.head_units) * config.head_block_repeats
        + 1  # head_output
    )
    keys = iter(jax.random.split(rng, n_keys))

    params: Params = {}

    # --- preprocessor (vtd.py:239-309) -------------------------------------
    params["linear_projection"] = _dense_init(
        next(keys), config.patch_dim, config.embedding_dim, dtype)
    # Reference: keras Embedding default uniform(-0.05, 0.05) (vtd.py:148-151)
    params["position_embedding"] = jax.random.uniform(
        next(keys), (config.num_patches, 1), dtype, -0.05, 0.05)

    # --- encoder blocks (vtd.py:312-414) ------------------------------------
    blocks = []
    d = config.embedding_dim
    for _ in range(config.encoder_blocks):
        block = {
            "ln1": _layer_norm_init(d, dtype),
            "mha": _mha_init(next(keys), d, config.num_heads,
                             config.key_dim, dtype),
            "ln2": _layer_norm_init(d, dtype),
            "mlp": [],
        }
        in_dim = d
        for units in config.encoder_mlp_units:
            block["mlp"].append(_dense_init(next(keys), in_dim, units, dtype))
            in_dim = units
        blocks.append(block)
    params["encoder"] = blocks

    # --- head (vtd.py:417-495) ----------------------------------------------
    if config.head_scales == (1,):
        params["head_token_dense"] = _dense_init(
            next(keys), d, config.max_objects, dtype)
        head_in_dim = config.num_patches
    else:
        # Multi-scale head: one token-dense per pooling scale; the per-slot
        # feature is the concatenation over scales (BASELINE configs[4]).
        gh, gw = config.grid_size
        params["head_token_dense"] = [
            _dense_init(next(keys), d, config.max_objects, dtype)
            for _ in config.head_scales]
        head_in_dim = sum(
            (gh // s) * (gw // s) for s in config.head_scales)
    head_mlp = []
    in_dim = head_in_dim
    for units in config.head_units:
        for _ in range(config.head_block_repeats):
            head_mlp.append(_dense_init(next(keys), in_dim, units, dtype))
            in_dim = units
    params["head_mlp"] = head_mlp
    params["head_output"] = _dense_init(next(keys), in_dim, 6, dtype)

    return params


def pad_attention_key_dim(params: Params, to: int = 64) -> Params:
    """Widen every attention projection's head dim with zero columns.

    Zero-padding the q/k/v kernels ``(D, H, K) -> (D, H, to)`` and the
    out kernel ``(H, K, D) -> (H, to, D)`` once at load widens a narrow
    head dim (the reference arch's 40) to a matmul-friendlier width with
    NO per-step pad work and EXACT numerics: padded q/k
    columns contribute 0 to the scores, padded v columns produce zero
    attention outputs which the zero out-kernel rows consume, and all
    gradients onto the padding are identically zero (so the columns stay
    zero under training too — tests/test_model.py asserts both).

    ``forward`` reads the physical head dim from the weights, so padded
    params are a drop-in; the softmax scale still uses config.key_dim.
    """
    def pad_mha(mha):
        key_dim = mha["query"]["kernel"].shape[-1]
        if key_dim >= to:
            return mha
        extra = to - key_dim
        def pad_proj(layer):
            return {"kernel": jnp.pad(layer["kernel"],
                                      ((0, 0), (0, 0), (0, extra))),
                    "bias": jnp.pad(layer["bias"], ((0, 0), (0, extra)))}
        return {
            "query": pad_proj(mha["query"]),
            "key": pad_proj(mha["key"]),
            "value": pad_proj(mha["value"]),
            "out": {"kernel": jnp.pad(mha["out"]["kernel"],
                                      ((0, 0), (0, extra), (0, 0))),
                    "bias": mha["out"]["bias"]},
        }

    out = dict(params)
    out["encoder"] = [dict(block, mha=pad_mha(block["mha"]))
                      for block in params["encoder"]]
    return out


# ---------------------------------------------------------------------------
# Forward building blocks
# ---------------------------------------------------------------------------

def mish(x: jnp.ndarray) -> jnp.ndarray:
    """x * tanh(softplus(x)) (tfa.activations.mish; vtd.py:119-129)."""
    return x * jnp.tanh(jax.nn.softplus(x))


def extract_patches(images: jnp.ndarray, patch_size: int) -> jnp.ndarray:
    """SAME-padded non-overlapping patchify (vtd.py:177-206).

    ``(B, H, W, 3) -> (B, ceil(H/p)*ceil(W/p), p*p*3)`` with the patch
    flattened row-major over (row, col, channel), exactly like
    ``tf.image.extract_patches`` followed by the reference's Reshape
    (vtd.py:276-280). SAME padding splits the remainder with the smaller
    half before (TF convention).
    """
    if images.ndim != 4:
        raise ValueError(
            f"expected batched images (B, H, W, 3), got shape "
            f"{images.shape}; add a leading batch axis")
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = -(-h // p), -(-w // p)
    pad_h, pad_w = gh * p - h, gw * p - w
    if pad_h or pad_w:
        images = jnp.pad(images, (
            (0, 0),
            (pad_h // 2, pad_h - pad_h // 2),
            (pad_w // 2, pad_w - pad_w // 2),
            (0, 0)))
    patches = images.reshape(b, gh, p, gw, p, c)
    patches = patches.transpose(0, 1, 3, 2, 4, 5)
    return patches.reshape(b, gh * gw, p * p * c)


def _dense(x, layer, compute_dtype):
    if "kernel_q" in layer:
        # Serving-only int8 path (kernels/quantization.py): the layer dict
        # carries int8 weights + per-channel scales instead of "kernel".
        from ..kernels.quantization import int8_dense
        return int8_dense(x, layer).astype(compute_dtype)
    kernel = layer["kernel"].astype(compute_dtype)
    y = jnp.dot(x.astype(compute_dtype), kernel,
                preferred_element_type=jnp.float32)
    return (y + layer["bias"].astype(jnp.float32)).astype(compute_dtype)


def _layer_norm(x, layer, eps: float = 1e-3):
    """LayerNormalization over the last axis in fp32.

    keras LayerNormalization default epsilon is 1e-3 (vtd.py:353-357 uses
    the default).
    """
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.var(x32, axis=-1, keepdims=True)
    normed = (x32 - mean) * jax.lax.rsqrt(var + eps)
    out = normed * layer["gamma"].astype(jnp.float32) + layer[
        "beta"].astype(jnp.float32)
    return out.astype(x.dtype)


def _dense_activation(x, layer, config: DetectorConfig, compute_dtype,
                      rng=None, train: bool = False):
    """Dense + activation (+ dropout) for the pyramid layers."""
    x = _dense(x, layer, compute_dtype)
    x = mish(x) if config.use_mish else jax.nn.gelu(x, approximate=False)
    return _dropout(x, config.dropout, rng, train)


def _dropout(x, rate, rng, train):
    if not train or rate is None or rate == 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)


def _attention(x, mha, config: DetectorConfig, compute_dtype,
               dropout_rng=None, train: bool = False, mesh=None,
               window_major: bool = False):
    """Multi-head self-attention (keras MHA semantics, vtd.py:364-369).

    Routes through kernels/flash_attention.py when
    ``config.use_flash_attention`` and applies local windowing when
    ``config.attention_window`` is set (high-res variant, BASELINE
    configs[4]).
    """
    b, n, _ = x.shape
    h = config.num_heads
    # The PHYSICAL head dim comes from the weights, not the config:
    # pad_attention_key_dim() widens the projections (e.g. 40 -> 64) with
    # exact zero columns; the softmax scale stays 1/sqrt(config.key_dim).
    # Int8-quantized projections flatten the kernel into kernel_q but
    # keep the unquantized (H, K) bias — read K off the bias there, so
    # quantize_params(pad_attention_key_dim(params)) serves correctly
    # (config.key_dim is the NOMINAL 40, and the reshape below would
    # fail against the physical 64).
    k = (mha["query"]["kernel"].shape[-1]
         if "kernel" in mha["query"]
         else mha["query"]["bias"].shape[-1])
    xc = x.astype(compute_dtype)
    window = config.attention_window
    # keras MHA applies dropout to the post-softmax probabilities whenever
    # configured (vtd.py:364-369); never silently drop it on an alternate
    # attention path.
    dropping = (train and config.dropout not in (None, 0.0)
                and dropout_rng is not None)

    # Legacy (B, N, H, K) layout paths: the ring kernel's shard_map specs
    # and the int8 serving layers expect tokens-major inputs; narrow
    # (non-64-multiple) head dims measure FASTER tokens-major in training
    # (config.attention_heads_major documents the measurements).
    # The auto rule reads the PHYSICAL head dim: pad_attention_key_dim'd
    # weights (40 -> 64) should take the heads-major fast path the
    # padding exists to enable, not the config's nominal 40.
    heads_major_ok = (config.attention_heads_major
                      if config.attention_heads_major is not None
                      else k % 64 == 0)
    legacy_layout = ((config.ring_attention and mesh is not None)
                     or "kernel_q" in mha["query"]
                     or (window is not None and not window_major)
                     or not heads_major_ok)
    if legacy_layout:
        attn_out = _attention_tokens_major(
            xc, mha, config, compute_dtype, b, n, h, k, window,
            dropping, dropout_rng, train, mesh, window_major)
    else:
        # Heads-major path: projections emit (B, H, N, K) directly, so
        # the chunked attention's (B*H, N, K) fold, the window fold and
        # the score/output einsum contractions are all free reshapes — no
        # per-layer layout transposes.
        def proj(layer):
            kernel = layer["kernel"].astype(compute_dtype)  # (D, H, K)
            y = jnp.einsum("bnd,dhk->bhnk", xc, kernel,
                           preferred_element_type=jnp.float32)
            return y + layer["bias"].astype(jnp.float32)[None, :, None, :]

        q = (proj(mha["query"])
             / math.sqrt(config.key_dim)).astype(compute_dtype)
        key = proj(mha["key"]).astype(compute_dtype)
        v = proj(mha["value"]).astype(compute_dtype)

        if window is not None:
            # Window-major tokens: fold windows into the head axis (a
            # pure reshape) and run plain per-"head" attention over
            # window-sized sequences.
            tokens = window * window
            num_windows = n // tokens
            q = q.reshape(b, h * num_windows, tokens, k)
            key = key.reshape(b, h * num_windows, tokens, k)
            v = v.reshape(b, h * num_windows, tokens, k)

        if config.use_flash_attention:
            # Training dropout uses the counter-based mask keyed on
            # position (kernels/flash_attention.py dropout_keep_mask)
            # with keras-MHA probability-dropout semantics.
            from ..kernels.flash_attention import flash_attention
            attn_out = flash_attention(
                q, key, v, layout="bhnk",
                dropout_rate=config.dropout if dropping else None,
                dropout_seed=jax.random.bits(dropout_rng, (), jnp.uint32)
                if dropping else None)
        else:
            # compute_dtype operands + fp32 accumulation.
            scores = jnp.einsum("bgnk,bgmk->bgnm", q, key,
                                preferred_element_type=jnp.float32)
            probs = jax.nn.softmax(scores, axis=-1)
            probs = _dropout(probs, config.dropout, dropout_rng, train)
            attn_out = jnp.einsum(
                "bgnm,bgmk->bgnk", probs.astype(compute_dtype), v,
                preferred_element_type=jnp.float32).astype(compute_dtype)
        if window is not None:
            attn_out = attn_out.reshape(b, h, n, k)

        out_kernel = mha["out"]["kernel"].astype(compute_dtype)  # (H, K, D)
        out = jnp.einsum("bhnk,hkd->bnd", attn_out.astype(compute_dtype),
                         out_kernel, preferred_element_type=jnp.float32)
        out = out + mha["out"]["bias"].astype(jnp.float32)
        return out.astype(compute_dtype)

    if "kernel_q" in mha["out"]:  # int8 serving path
        from ..kernels.quantization import int8_dense
        flat = attn_out.reshape(b, n, h * k)
        return int8_dense(flat, mha["out"]).astype(compute_dtype)
    out_kernel = mha["out"]["kernel"].astype(compute_dtype)  # (H, K, D)
    out = jnp.einsum("bnhk,hkd->bnd", attn_out.astype(compute_dtype),
                     out_kernel, preferred_element_type=jnp.float32)
    out = out + mha["out"]["bias"].astype(jnp.float32)
    return out.astype(compute_dtype)


def _attention_tokens_major(xc, mha, config, compute_dtype, b, n, h, k,
                            window, dropping, dropout_rng, train, mesh,
                            window_major=False):
    """(B, N, H, K)-layout attention paths: ring attention (shard_map
    specs shard the token axis at position 1), the int8 serving layers,
    and direct _windowed_attention calls on row-major token order."""

    def proj(layer):
        if "kernel_q" in layer:  # int8 serving path
            from ..kernels.quantization import int8_dense
            return int8_dense(xc, layer)          # fp32 (B, N, H, K)
        kernel = layer["kernel"].astype(compute_dtype)  # (D, H, K)
        y = jnp.einsum("bnd,dhk->bnhk", xc, kernel,
                       preferred_element_type=jnp.float32)
        return y + layer["bias"].astype(jnp.float32)

    q = proj(mha["query"]) / math.sqrt(config.key_dim)  # fp32 (B,N,H,K)
    key = proj(mha["key"])
    v = proj(mha["value"])

    if config.ring_attention and mesh is not None:
        from ..kernels.ring_attention import ring_attention_in_jit
        return ring_attention_in_jit(
            q.astype(compute_dtype), key.astype(compute_dtype),
            v.astype(compute_dtype), mesh,
            dropout_rate=config.dropout if dropping else None,
            dropout_seed=jax.random.bits(dropout_rng, (), jnp.uint32)
            if dropping else None)
    if window is not None:
        gh, gw = config.grid_size
        return _windowed_attention(
            q, key, v, gh, gw, window, config, compute_dtype,
            dropout_rng=dropout_rng if dropping else None, train=train,
            use_flash=config.use_flash_attention,
            window_major=window_major)
    if config.use_flash_attention:
        from ..kernels.flash_attention import flash_attention
        return flash_attention(
            q.astype(compute_dtype), key.astype(compute_dtype),
            v.astype(compute_dtype),
            dropout_rate=config.dropout if dropping else None,
            dropout_seed=jax.random.bits(dropout_rng, (), jnp.uint32)
            if dropping else None)
    scores = jnp.einsum("bnhk,bmhk->bhnm", q.astype(compute_dtype),
                        key.astype(compute_dtype),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(scores, axis=-1)
    probs = _dropout(probs, config.dropout, dropout_rng, train)
    return jnp.einsum(
        "bhnm,bmhk->bnhk", probs.astype(compute_dtype),
        v.astype(compute_dtype), preferred_element_type=jnp.float32)


def _windowed_attention(q, key, v, gh, gw, window, config, compute_dtype,
                        dropout_rng=None, train: bool = False,
                        use_flash: bool = False,
                        window_major: bool = False):
    """Non-overlapping local window attention over the patch grid.

    The token axis is reshaped to (gh/w, w, gw/w, w) windows; attention runs
    within each (w*w)-token window. This is the high-res sequence story
    (SURVEY.md §5 long-context): at 1024px/p16 the 4,096-token quadratic
    attention becomes 16 windows of 256 tokens. Training dropout applies to
    the per-window probabilities (keras MHA semantics, vtd.py:364-369,
    restricted to the local windows).

    ``use_flash`` folds the independent windows into the batch axis and
    routes through kernels/flash_attention.py: no per-window softmax
    probabilities are saved as residuals (the backward recomputes from
    q/k/v), unlike the einsum path, whose saved probabilities grow with
    batch x windows x heads.

    ``window_major`` means the caller already ordered the token axis
    window-major (forward() permutes ONCE at encoder entry), so the
    fold/unfold here is a free reshape instead of a per-layer transpose.
    """
    b, n, h, k = q.shape
    assert gh % window == 0 and gw % window == 0, (
        f"grid {gh}x{gw} not divisible by window {window}")
    nh, nw = gh // window, gw // window
    num_windows = nh * nw
    tokens = window * window

    if window_major:
        def to_windows(t):
            return t.reshape(b, num_windows, tokens, h, k)
    else:
        def to_windows(t):
            t = t.reshape(b, nh, window, nw, window, h, k)
            t = t.transpose(0, 1, 3, 2, 4, 5, 6)
            return t.reshape(b, num_windows, tokens, h, k)

    qw, kw, vw = to_windows(q), to_windows(key), to_windows(v)

    dropping = (train and config.dropout not in (None, 0.0)
                and dropout_rng is not None)
    if use_flash:
        from ..kernels.flash_attention import flash_attention
        out = flash_attention(
            qw.reshape(b * num_windows, tokens, h, k).astype(compute_dtype),
            kw.reshape(b * num_windows, tokens, h, k).astype(compute_dtype),
            vw.reshape(b * num_windows, tokens, h, k).astype(compute_dtype),
            dropout_rate=config.dropout if dropping else None,
            dropout_seed=jax.random.bits(dropout_rng, (), jnp.uint32)
            if dropping else None)
        out = out.reshape(b, num_windows, tokens, h, k)
    else:
        # compute_dtype operands + fp32 accumulation (see _attention).
        scores = jnp.einsum("bwnhk,bwmhk->bwhnm", qw.astype(compute_dtype),
                            kw.astype(compute_dtype),
                            preferred_element_type=jnp.float32)
        probs = jax.nn.softmax(scores, axis=-1)
        probs = _dropout(probs, config.dropout, dropout_rng, train)
        out = jnp.einsum("bwhnm,bwmhk->bwnhk", probs.astype(compute_dtype),
                         vw.astype(compute_dtype),
                         preferred_element_type=jnp.float32)
    if window_major:
        return out.reshape(b, n, h, k)
    out = out.reshape(b, nh, nw, window, window, h, k)
    out = out.transpose(0, 1, 3, 2, 4, 5, 6)
    return out.reshape(b, n, h, k)


def _maybe_shard_sequence(x, config: DetectorConfig):
    """Sequence parallelism: shard (batch, tokens, dim) activations as
    ('data', 'model', None) when enabled. A no-op without a mesh context;
    under a Mesh, XLA partitions the token axis across the model axis and
    inserts the collectives (SURVEY.md §2.4 SP row)."""
    if not config.sequence_sharding:
        return x
    from jax.sharding import PartitionSpec

    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
    return jax.lax.with_sharding_constraint(
        x, PartitionSpec(DATA_AXIS, MODEL_AXIS, None))


def _encoder_block(x, block, config: DetectorConfig, compute_dtype,
                   rng=None, train: bool = False, mesh=None,
                   window_major: bool = False):
    """Pre-LN MHA + descending mish pyramid, both residual (vtd.py:350-412)."""
    rngs = jax.random.split(rng, 2 + len(block["mlp"])) if rng is not None \
        else [None] * (2 + len(block["mlp"]))

    side = x
    x = _layer_norm(x, block["ln1"])
    x = _attention(x, block["mha"], config, compute_dtype,
                   dropout_rng=rngs[0], train=train, mesh=mesh,
                   window_major=window_major)
    x = x + side

    side = x
    x = _layer_norm(x, block["ln2"])
    for j, layer in enumerate(block["mlp"]):
        x = _dense_activation(x, layer, config, compute_dtype,
                              rngs[2 + j], train)
    return x + side


def _multi_scale_head_tokens(x, layers, config: DetectorConfig,
                             compute_dtype):
    """Multi-scale per-slot features (BASELINE configs[4]).

    The token grid is average-pooled at each configured stride, projected
    to the slot axis per scale, and concatenated along the per-slot feature
    axis: coarse scales see large objects cheaply, the fine scale keeps
    localisation detail. Output (B, max_objects, sum_s P_s). Every scale
    must evenly divide the grid — _validate_grid_config rejects non-divisor
    entries at init, so the VALID pooling below never drops cells.
    """
    b, _, d = x.shape
    gh, gw = config.grid_size
    grid = x.reshape(b, gh, gw, d)
    feats = []
    for scale, layer in zip(config.head_scales, layers):
        if scale == 1:
            pooled = grid
        else:
            pooled = jax.lax.reduce_window(
                grid.astype(jnp.float32), 0.0, jax.lax.add,
                (1, scale, scale, 1), (1, scale, scale, 1), "VALID",
            ) / float(scale * scale)
            pooled = pooled.astype(grid.dtype)
        ph, pw = gh // scale, gw // scale
        tokens = pooled.reshape(b, ph * pw, d)
        projected = _dense(tokens, layer, compute_dtype)   # (B, P_s, M)
        feats.append(projected.transpose(0, 2, 1))          # (B, M, P_s)
    return jnp.concatenate(feats, axis=-1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _validate_grid_config(config: DetectorConfig) -> None:
    """Grid-geometry checks with actionable messages.

    Without these, a non-divisible ``attention_window`` died deep inside
    a reshape ("cannot reshape array of shape ...") and a non-divisible
    ``head_scales`` entry SILENTLY floor-pooled, dropping the grid's
    edge rows/columns from the detection head (a scale larger than the
    grid contributed zero cells)."""
    gh, gw = config.grid_size
    w = config.attention_window
    if config.ring_attention and w is not None:
        raise ValueError(
            "ring_attention and attention_window are mutually exclusive: "
            "with a mesh the ring path runs exact GLOBAL attention "
            "(window ignored) while meshless calls would run WINDOWED "
            "attention — the same weights would silently execute two "
            "different architectures. Set attention_window=None for the "
            "ring variant (see highres_1024_ring) or drop ring_attention "
            "for the windowed one.")
    if w is not None and (w <= 0 or gh % w or gw % w):
        raise ValueError(
            f"attention_window={w} must evenly divide the patch grid "
            f"{gh}x{gw} (image_size {config.image_size} / patch_size "
            f"{config.patch_size})")
    for s in config.head_scales:
        if s <= 0 or gh % s or gw % s:
            raise ValueError(
                f"head_scales entry {s} must evenly divide the patch "
                f"grid {gh}x{gw}; a non-divisor silently drops edge "
                "cells from the detection head")


def forward(params: Params, images: jnp.ndarray, config: DetectorConfig,
            train: bool = False,
            dropout_rng: Optional[jax.Array] = None,
            mesh=None) -> jnp.ndarray:
    """Full detector forward: ``(B, H, W, 3) -> (B, max_objects, 6)`` raw
    logits (sigmoid stays outside, vtd.py:618-619)."""
    compute_dtype = jnp.dtype(config.compute_dtype)
    _validate_grid_config(config)

    # --- preprocessor (vtd.py:239-309) -------------------------------------
    patches = extract_patches(images.astype(compute_dtype), config.patch_size)
    x = _dense(patches, params["linear_projection"], compute_dtype)
    # dim-1 positional embedding broadcasts over the channel axis
    # (vtd.py:291-307).
    x = x + params["position_embedding"].astype(compute_dtype)[None]
    x = _maybe_shard_sequence(x, config)

    # Windowed attention: reorder the token axis window-major ONCE here so
    # every block's window fold/unfold is a free reshape. The MLP/LN/
    # residual stack is position-independent, so only this entry permute,
    # the exit inverse below, and the (order-sensitive) positional
    # embedding and head see the token order at all.
    window = config.attention_window
    window_major = window is not None and not config.ring_attention
    if window_major:
        gh, gw = config.grid_size
        nh, nw = gh // window, gw // window
        bsz, _, d = x.shape
        x = x.reshape(bsz, nh, window, nw, window, d)
        x = x.transpose(0, 1, 3, 2, 4, 5).reshape(bsz, nh * nw *
                                                  window * window, d)

    # --- encoder ------------------------------------------------------------
    n_blocks = len(params["encoder"])
    block_rngs = (jax.random.split(dropout_rng, n_blocks)
                  if dropout_rng is not None else [None] * n_blocks)

    def plain_block_fn(x, block, rng):
        return _encoder_block(x, block, config, compute_dtype, rng,
                              train=train, mesh=mesh,
                              window_major=window_major)

    # Close over the static arguments; jax.checkpoint in this JAX
    # version takes only pytree positionals.
    block_fn = plain_block_fn
    alternate = False
    if config.remat_encoder:
        if config.remat_policy == "dots":
            # Save matmul outputs, recompute only elementwise ops: most
            # of full remat's extra forward FLOPs are avoided while
            # activation memory stays bounded.
            block_fn = jax.checkpoint(
                plain_block_fn,
                policy=jax.checkpoint_policies
                .dots_with_no_batch_dims_saveable)
        elif config.remat_policy == "alternate":
            # Checkpoint every OTHER block: half the backward's forward
            # recompute of full remat at roughly half of no-remat's
            # activation memory — the middle point for presets where
            # remat-off OOMs but full remat wastes FLOPs (highres_1024).
            block_fn = jax.checkpoint(plain_block_fn)
            alternate = True
        elif config.remat_policy is None:
            block_fn = jax.checkpoint(plain_block_fn)
        else:
            raise ValueError(
                f"unknown remat_policy {config.remat_policy!r}; "
                "use None, 'dots' or 'alternate'")

    for i, (block, rng) in enumerate(zip(params["encoder"], block_rngs)):
        fn = plain_block_fn if (alternate and i % 2) else block_fn
        x = fn(x, block, rng)
        x = _maybe_shard_sequence(x, config)

    if window_major:
        # Inverse permute: the head's token-dense and multi-scale pooling
        # are position-sensitive and expect row-major grid order.
        x = x.reshape(bsz, nh, nw, window, window, d)
        x = x.transpose(0, 1, 3, 2, 4, 5).reshape(bsz, nh * nw *
                                                  window * window, d)

    # --- head (vtd.py:417-495) ----------------------------------------------
    b = x.shape[0]
    if config.head_scales == (1,):
        x = _dense(x, params["head_token_dense"], compute_dtype)  # (B, P, M)
        # The reference uses keras Reshape (a plain reshape, NOT a
        # transpose) to go (B, P, M) -> (B, M, P) (vtd.py:460-463); kept
        # bit-identical.
        x = x.reshape(b, config.max_objects, config.num_patches)
    else:
        x = _multi_scale_head_tokens(x, params["head_token_dense"],
                                     config, compute_dtype)

    head_rngs = (jax.random.split(jax.random.fold_in(dropout_rng, 7),
                                  len(params["head_mlp"]))
                 if dropout_rng is not None else [None] * len(
                     params["head_mlp"]))
    for layer, rng in zip(params["head_mlp"], head_rngs):
        # head dropout (vtd.py:485-486) rides the same helper.
        x = _dense_activation(x, layer, config, compute_dtype, rng, train)

    logits = _dense(x, params["head_output"], compute_dtype)
    return logits.astype(jnp.float32)


def count_params(params: Params) -> int:
    return sum(p.size for p in jax.tree_util.tree_leaves(params))
