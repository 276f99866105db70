"""Memory-bounded softmax attention with a choice of implementation.

Replaces the reference's ``keras.layers.MultiHeadAttention`` O(N^2)
materialised-scores attention (vision_transformer_detector.py:364-369).
``flash_attention`` takes one of two routes, chosen by
``attention_implementation`` from what it can observe:

  * ``"cudnn"`` — ``jax.nn.dot_product_attention(implementation="cudnn")``:
    cuDNN's fused attention, which keeps the scores out of device memory,
    differentiated by cuDNN's own backward. GPU only, bf16/fp16 only, no
    dropout.
  * ``"chunked"`` — a custom VJP over plain ``jax.numpy``: the forward and
    the backward each walk the fused batch*head axis in groups
    (``_chunk_group``), so at most a group's N x N fp32 scores are live at
    once, and the backward recomputes them instead of saving them. It
    carries the counter-based probability dropout (``dropout_keep_mask``)
    that the cuDNN route lacks, and runs in every dtype on every backend.

Numerics contract: inputs carry any 1/sqrt(K) scaling already (the caller
applies it); softmax statistics are fp32; the output matches
``reference_attention`` to ~2e-2 in bf16 and to fp32 rounding in float32
(on a GPU under the default matmul precision, float32 dots run in TF32).
tests/test_kernels.py pins both routes' contracts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

CUDNN = "cudnn"
CHUNKED = "chunked"


def attention_implementation(platform: str, dtype, dropout: bool,
                             head_dim: int) -> str:
    """The attention route for one call: ``"cudnn"`` or ``"chunked"``.

    cuDNN's fused attention is taken on the GPU for half-precision inputs
    without dropout at head dims it accepts (multiples of 8 up to 128).
    Everything else (float32, probability dropout, other backends, other
    head dims) takes the chunked custom VJP. A cuDNN failure on a call
    this rule sends to cuDNN is raised, never rerouted.
    """
    half = jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16),
                                jnp.dtype(jnp.float16))
    if (platform == "gpu" and half and not dropout
            and head_dim % 8 == 0 and head_dim <= 128):
        return CUDNN
    return CHUNKED


def _keep_threshold(rate: float) -> int:
    """Static uint32 threshold: hash < threshold <=> keep."""
    return min(2 ** 32 - 1, int(round((1.0 - rate) * 4294967296.0)))


def dropout_keep_mask(seed, bh_idx, q_idx, k_idx, threshold: int):
    """Counter-based dropout mask: keep iff hash(seed, bh, qi, kj) < t.

    A murmur3-finalizer hash over the GLOBAL (batch*head, query, key)
    coordinates, so the mask is a pure function of position: the chunked
    forward generates it per score block, the chunked backward
    regenerates the IDENTICAL mask during recomputation, and ring
    attention (kernels/ring_attention.py) reproduces it shard by shard.
    All arithmetic is uint32 with logical shifts.
    """
    x = (jnp.asarray(seed).astype(jnp.uint32)
         + bh_idx.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
         + q_idx.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)
         + k_idx.astype(jnp.uint32) * jnp.uint32(0xC2B2AE35))
    x = x ^ jax.lax.shift_right_logical(x, jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ jax.lax.shift_right_logical(x, jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ jax.lax.shift_right_logical(x, jnp.uint32(16))
    return x < jnp.uint32(threshold)


def flash_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                    layout: str = "bnhk",
                    dropout_rate: float | None = None,
                    dropout_seed=None,
                    bwd_variant: str = "fp32",
                    implementation: str | None = None) -> jnp.ndarray:
    """Softmax attention ``softmax(q k^T) v``; in/out layout per ``layout``.

    ``layout="bnhk"``: (B, N, H, K) tensors. ``layout="bhnk"``: (B, H, N,
    K) tensors — heads-major, so folding to the chunked route's
    (B*H, N, K) shape is a free reshape (models/vit_detector.py produces
    heads-major projections). The cuDNN route takes (B, N, H, K) and
    transposes a heads-major call.

    ``implementation`` is ``"cudnn"`` or ``"chunked"``; None applies
    ``attention_implementation`` to the default backend, the dtype, the
    dropout switch and the head dim.

    ``dropout_rate``/``dropout_seed`` enable probability dropout
    (training path; keras-MHA semantics). The mask is a pure function of
    (seed, batch*head, query, key) position (dropout_keep_mask), so the
    chunked backward replays it exactly during recomputation.

    ``bwd_variant`` selects the chunked backward's intermediate shape:
      * ``"fp32"`` (default) — fp32 score/probability intermediates,
        softmax-gradient rowsum computed as rowsum(dp * p).
      * ``"delta"`` — flash-v2 delta trick: recompute o = pd @ v and
        use rowsum(g * o) for the softmax-gradient correction, trading
        an N x N fp32 elementwise+reduce for an N x K matmul.
      * ``"bf16_delta"`` — delta trick plus bf16 probability streaming:
        p/dp round through bf16 after fp32 accumulation, halving the
        N x N bytes (the delta rowsum stays fp32 via the N x K path, so
        no long bf16 reductions).
    """
    if layout not in ("bnhk", "bhnk"):
        raise ValueError(f"unknown layout {layout!r}")
    if dropout_rate in (None, 0.0):
        seed = jnp.zeros((1,), jnp.uint32)
        rate = None
    else:
        rate = float(dropout_rate)
        if not 0.0 < rate < 1.0:
            raise ValueError(
                f"dropout_rate must be in (0, 1), got {rate} (1.0 would "
                "drop everything; larger values wrap the keep threshold)")
        if dropout_seed is None:
            raise ValueError("dropout_rate needs a dropout_seed")
        seed = jnp.asarray(dropout_seed).astype(jnp.uint32).reshape((1,))
    if bwd_variant not in ("fp32", "delta", "bf16_delta"):
        raise ValueError(f"unknown bwd_variant {bwd_variant!r}")
    if implementation is None:
        implementation = attention_implementation(
            jax.default_backend(), q.dtype, rate is not None, q.shape[-1])
    if implementation == CUDNN:
        if rate is not None:
            raise ValueError("the cudnn route has no probability dropout")
        if layout == "bhnk":
            q, k, v = (t.transpose(0, 2, 1, 3) for t in (q, k, v))
        out = jax.nn.dot_product_attention(q, k, v, scale=1.0,
                                           implementation="cudnn")
        return out.transpose(0, 2, 1, 3) if layout == "bhnk" else out
    if implementation != CHUNKED:
        raise ValueError(f"unknown implementation {implementation!r}")
    return _chunked_attention(q, k, v, seed, layout, rate, bwd_variant)


# Per-iteration fp32 score memory bound for the chunked routes: a group of
# heads keeps about ``score_buffers`` N x N fp32 arrays live, and their sum
# stays under this budget. At small N (windowed attention: 256-token
# windows fold into a large batch*head axis) a group of 1 would instead
# spend the step in loop iterations, so heads are grouped until the loop
# runs at most _CHUNK_MAX_ITERATIONS times. Neither constant has been tuned
# on the GPU.
_CHUNK_BUDGET_BYTES = 96 * 1024 * 1024
_CHUNK_MAX_ITERATIONS = 128


def _chunk_group(bh: int, n: int, score_buffers: int = 3) -> int:
    """Heads per chunked-attention iteration: the fewest that keep the
    loop at or under _CHUNK_MAX_ITERATIONS, capped by the score-memory
    budget, rounded down to a divisor of ``bh``."""
    budget = max(1, _CHUNK_BUDGET_BYTES // (score_buffers * 4 * n * n))
    target = -(-bh // _CHUNK_MAX_ITERATIONS)
    group = max(1, min(target, budget, bh))
    while bh % group:
        group -= 1
    return group


def _to_groups(t, layout: str, group: int):
    """(B, N, H, K) or (B, H, N, K) -> (B*H/group, group, N, K)."""
    if layout == "bnhk":
        t = t.transpose(0, 2, 1, 3)
    b, h, n, kdim = t.shape
    return t.reshape(b * h // group, group, n, kdim)


def _from_groups(t, layout: str, b: int, h: int):
    """Inverse of _to_groups."""
    n, kdim = t.shape[-2:]
    t = t.reshape(b, h, n, kdim)
    return t.transpose(0, 2, 1, 3) if layout == "bnhk" else t


def _batch_head_dims(q, layout: str):
    if layout == "bhnk":
        b, h, n, _ = q.shape
    else:
        b, n, h, _ = q.shape
    return b, h, n


# dot_general dimension numbers over a (group, ...) leading batch axis.
_BATCH_LAST = (((2,), (2,)), ((0,), (0,)))   # (g,n,K)x(g,m,K)->(g,n,m)
_BATCH_MID = (((1,), (1,)), ((0,), (0,)))    # (g,n,m)x(g,n,K)->(g,m,K)
_BATCH_LM = (((2,), (1,)), ((0,), (0,)))     # (g,n,m)x(g,m,K)->(g,n,K)


def _dropout_scale(seed, bhi, n: int, rate: float, dtype):
    """(group, N, N) keep-mask scaled by 1/keep: the forward and the
    backward call this with the same arguments, so both see one mask."""
    pos = jnp.arange(n, dtype=jnp.uint32)
    keep = dropout_keep_mask(seed[0], bhi[:, None, None], pos[None, :, None],
                             pos[None, None, :], _keep_threshold(rate))
    return jnp.where(keep, 1.0 / (1.0 - rate), 0.0).astype(dtype)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def _chunked_attention(q, k, v, seed, layout, rate, bwd_variant):
    return _chunked_forward(q, k, v, seed, layout, rate)


def _chunked_forward(q, k, v, seed, layout: str, rate: float | None):
    """Attention forward over head groups; fp32 scores and softmax, the
    probability dropout applied after the softmax (keras-MHA order)."""
    b, h, n = _batch_head_dims(q, layout)
    bh = b * h
    group = _chunk_group(bh, n, score_buffers=4 if rate is not None else 2)
    qf, kf, vf = (_to_groups(t, layout, group) for t in (q, k, v))
    bh_idx = jnp.arange(bh, dtype=jnp.uint32).reshape(bh // group, group)

    def heads(args):
        qi, ki, vi, bhi = args
        # Input-dtype operands with fp32 accumulation.
        s = jax.lax.dot_general(qi, ki, _BATCH_LAST,
                                preferred_element_type=jnp.float32)
        p = jax.nn.softmax(s, axis=-1)
        if rate is not None:
            p = p * _dropout_scale(seed, bhi, n, rate, jnp.float32)
        o = jax.lax.dot_general(p.astype(vi.dtype), vi, _BATCH_LM,
                                preferred_element_type=jnp.float32)
        return o.astype(qi.dtype)

    out = jax.lax.map(heads, (qf, kf, vf, bh_idx))
    return _from_groups(out, layout, b, h)


def _chunked_fwd(q, k, v, seed, layout, rate, bwd_variant):
    out = _chunked_forward(q, k, v, seed, layout, rate)
    return out, (q, k, v, seed)


def _chunked_bwd(layout, rate, bwd_variant, residuals, g):
    q, k, v, seed = residuals
    dq, dk, dv = _flash_bwd_chunked((q, k, v), g, layout, rate=rate,
                                    seed=seed, variant=bwd_variant)
    return dq, dk, dv, np.zeros(seed.shape, jax.dtypes.float0)


def _flash_bwd_chunked(residuals, g, layout: str = "bnhk",
                       rate: float | None = None, seed=None,
                       variant: str = "fp32"):
    """Attention backward, recomputed per (batch*head) chunk.

    Standard softmax-attention gradients with fp32 softmax statistics:
      p  = softmax(q k^T)          ds = p * (dp - rowsum(dp * p))
      dv = p^T g                   dq = ds k,  dk = ds^T q
    Memory is bounded by chunking the fused batch*head axis through
    lax.map (_chunk_group heads' N x N score blocks at a time).

    ``variant`` (see flash_attention's ``bwd_variant``): "delta" swaps
    the rowsum(dp * p) correction for the flash-v2 delta
    rowsum(g * (pd @ v)) — an N x K matmul instead of an N x N fp32
    elementwise+reduce; "bf16_delta" additionally streams p/dp through
    bf16 after their fp32 accumulations.

    With dropout (``rate``/``seed``), the forward's mask is replayed from
    the global coordinates (dropout_keep_mask is a pure function of
    position) and the gradient chain becomes, with Pd = mask * p / keep:
      dv = Pd^T g
      dpm = mask/keep * (g v^T)
      ds = p * (dpm - rowsum(p * dpm))
    which is exactly autodiff through dropout-after-softmax.
    """
    q, k, v = residuals
    b, h, n = _batch_head_dims(q, layout)
    bh = b * h
    # The dropout replay adds a keep-mask + scale array per score block
    # (~2 more N x N buffers live at once): shrink the group to keep the
    # same memory budget.
    group = _chunk_group(bh, n, score_buffers=5 if rate is not None else 3)
    qf, kf, vf, gf = (_to_groups(t, layout, group) for t in (q, k, v, g))
    bh_idx = jnp.arange(bh, dtype=jnp.uint32).reshape(bh // group, group)

    use_delta = variant in ("delta", "bf16_delta")
    score_dtype = jnp.bfloat16 if variant == "bf16_delta" else jnp.float32

    def heads(args):
        qi, ki, vi, gi, bhi = args
        s = jax.lax.dot_general(qi, ki, _BATCH_LAST,
                                preferred_element_type=jnp.float32)
        p = jax.nn.softmax(s, axis=-1).astype(score_dtype)
        dp = jax.lax.dot_general(gi, vi, _BATCH_LAST,
                                 preferred_element_type=jnp.float32
                                 ).astype(score_dtype)
        if rate is not None:
            scale = _dropout_scale(seed, bhi, n, rate, score_dtype)
            dp = dp * scale
            pd = p * scale
        else:
            pd = p
        dv = jax.lax.dot_general(pd.astype(gi.dtype), gi, _BATCH_MID,
                                 preferred_element_type=jnp.float32)
        if use_delta:
            # Flash-v2 delta: rowsum(p * dp) == rowsum(g * (pd @ v)),
            # including the dropout-scaled case (both sides reduce
            # pd * (g v^T)).
            o = jax.lax.dot_general(pd.astype(vi.dtype), vi, _BATCH_LM,
                                    preferred_element_type=jnp.float32)
            delta = jnp.sum(gi.astype(jnp.float32) * o, axis=-1,
                            keepdims=True)
            ds = p * (dp - delta.astype(score_dtype))
        else:
            ds = p * (dp - jnp.sum(dp * p, axis=-1, keepdims=True))
        dsc = ds.astype(qi.dtype)
        dq = jax.lax.dot_general(dsc, ki, _BATCH_LM,
                                 preferred_element_type=jnp.float32)
        dk = jax.lax.dot_general(dsc, qi, _BATCH_MID,
                                 preferred_element_type=jnp.float32)
        return (dq.astype(qi.dtype), dk.astype(ki.dtype),
                dv.astype(vi.dtype))

    dqf, dkf, dvf = jax.lax.map(heads, (qf, kf, vf, gf, bh_idx))
    return tuple(_from_groups(t, layout, b, h) for t in (dqf, dkf, dvf))


_chunked_attention.defvjp(_chunked_fwd, _chunked_bwd)


def reference_attention(q: jnp.ndarray, k: jnp.ndarray,
                        v: jnp.ndarray) -> jnp.ndarray:
    """Materialised-softmax oracle on (B, N, H, K) inputs."""
    scores = jnp.einsum("bnhk,bmhk->bhnm", q.astype(jnp.float32),
                        k.astype(jnp.float32),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("bhnm,bmhk->bnhk", probs.astype(v.dtype), v,
                     preferred_element_type=jnp.float32)
    return out.astype(q.dtype)
