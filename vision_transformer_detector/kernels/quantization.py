"""Int8 weight quantization for the serving path.

The detector's FLOPs are overwhelmingly dense matmuls (encoder pyramid +
head, SURVEY.md §3.2 hot loop), so post-training int8 is a serving lever
beside batching. This module is OPT-IN and serving-only:

  * ``quantize_params(params)`` — walk the parameter pytree and replace
    every dense kernel with symmetric per-output-channel int8
    (``kernel_q`` int8 (in, out_flat) + ``scale`` fp32 (out_flat,); the
    bias array's shape encodes the static output block shape); biases,
    layer norms and the positional embedding stay fp32. Works on any
    param pytree from
    ``models.vit_detector.init_params`` (incl. MHA projection kernels,
    which are flattened to 2-D).
  * ``int8_dense(x, layer)`` — dynamic symmetric per-row activation
    quantization, the int8 x int8 products formed in bf16 with fp32
    accumulation, fp32 rescale
    (+bias). The model's ``_dense``/attention projections dispatch here
    whenever a layer carries ``kernel_q`` (models/vit_detector.py), so the
    quantized pytree is a drop-in for ``forward``.

No reference counterpart (the reference has no serving or quantization
story); accuracy is guarded by tests/test_quantization.py: decode
agreement on random weights and AP retention on an overfit-trained model.
Its speed against the bf16 path on the GPU is not measured.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _quantize_kernel(kernel: np.ndarray):
    """(in..., out...) kernel -> 2-D int8 + per-output-channel scales."""
    arr = np.asarray(kernel, np.float32)
    if arr.ndim == 3:        # MHA projection (D, H, K) or (H, K, D)
        # Flatten so the CONTRACTED side is first: q/k/v kernels contract
        # dim 0 (D); the output projection contracts (H, K) = dims 0-1.
        # Both flatten to (in_flat, out_flat) with row-major reshape when
        # the contracted dims lead; callers pass kernels contracted-first.
        in_dim = arr.shape[0]
        arr2 = arr.reshape(in_dim, -1)
        out_shape = arr.shape[1:]
    elif arr.ndim == 2:
        arr2 = arr
        out_shape = (arr.shape[1],)
    else:
        raise ValueError(f"cannot quantize kernel of rank {arr.ndim}")
    amax = np.max(np.abs(arr2), axis=0)
    scale = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(arr2 / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32), out_shape


def _quantize_mha_out_kernel(kernel: np.ndarray):
    """Output projection (H, K, D): contracted dims are (H, K)."""
    arr = np.asarray(kernel, np.float32)
    h, k, d = arr.shape
    q, scale, _ = _quantize_kernel(arr.reshape(h * k, d))
    return q, scale, (d,)


def _quantize_dense_layer(layer: dict, mha_out: bool = False) -> dict:
    kernel = np.asarray(layer["kernel"])
    if mha_out:
        q, scale, out_shape = _quantize_mha_out_kernel(kernel)
    else:
        q, scale, out_shape = _quantize_kernel(kernel)
    bias = np.asarray(layer["bias"], np.float32)
    assert bias.shape == out_shape, (bias.shape, out_shape)
    # The output shape is NOT stored separately: it must stay jit-static,
    # and the bias array's shape already encodes it.
    return {
        "kernel_q": jnp.asarray(q),
        "scale": jnp.asarray(scale),
        "bias": jnp.asarray(bias),
    }


def quantize_params(params: Any) -> Any:
    """Parameter pytree -> drop-in quantized pytree for forward()."""
    out = {}
    out["linear_projection"] = _quantize_dense_layer(
        params["linear_projection"])
    out["position_embedding"] = params["position_embedding"]

    out["encoder"] = []
    for block in params["encoder"]:
        qblock = {
            "ln1": block["ln1"],
            "ln2": block["ln2"],
            "mha": {
                "query": _quantize_dense_layer(block["mha"]["query"]),
                "key": _quantize_dense_layer(block["mha"]["key"]),
                "value": _quantize_dense_layer(block["mha"]["value"]),
                "out": _quantize_dense_layer(block["mha"]["out"],
                                             mha_out=True),
            },
            "mlp": [_quantize_dense_layer(l) for l in block["mlp"]],
        }
        out["encoder"].append(qblock)

    if isinstance(params["head_token_dense"], list):
        out["head_token_dense"] = [
            _quantize_dense_layer(l) for l in params["head_token_dense"]]
    else:
        out["head_token_dense"] = _quantize_dense_layer(
            params["head_token_dense"])
    out["head_mlp"] = [_quantize_dense_layer(l) for l in params["head_mlp"]]
    out["head_output"] = _quantize_dense_layer(params["head_output"])
    return out


def int8_dense(x: jnp.ndarray, layer: dict) -> jnp.ndarray:
    """x @ kernel with dynamic per-row int8 activation quantization.

    Returns fp32 ``(..., *bias.shape)`` with bias added — the bias array's
    (static) shape defines the output block shape, e.g. (H, K) for MHA
    projections.
    """
    x32 = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
    x_scale = jnp.maximum(amax, 1e-8) / 127.0
    xq = jnp.clip(jnp.round(x32 / x_scale), -127, 127).astype(jnp.int8)

    # Every int8 value is exact in bf16, so each product is exact and the
    # fp32 sums are exact up to 2**24 (fp32-rounded beyond). An s8 x s8
    # -> s32 dot would say the same, but XLA:GPU (JAX 0.9.0) miscompiles
    # it once the quantization above fuses into it: on an H100 the tiny
    # drop-in model of tests/test_quantization.py came out with
    # objectness off by 0.52, where this form matches the CPU.
    acc = jax.lax.dot_general(
        xq.astype(jnp.bfloat16), layer["kernel_q"].astype(jnp.bfloat16),
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)          # (..., out_flat)
    y = acc * x_scale * layer["scale"]
    y = y + layer["bias"].reshape(-1)
    return y.reshape(x.shape[:-1] + layer["bias"].shape)


def is_quantized(layer: Any) -> bool:
    return isinstance(layer, dict) and "kernel_q" in layer

