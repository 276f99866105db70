"""Ring attention: context parallelism over the token axis.

For the high-res variant's global attention (SURVEY.md §5 long-context:
~4k tokens at 1024px/p16), the token axis is sharded across the 'model'
mesh axis and K/V shards rotate around the ring while each device
accumulates its queries' streaming-softmax statistics — attention memory
and FLOPs divide by the ring size, and the K/V exchange is a
jax.lax.ppermute between neighbouring devices (NCCL over NVLink on GPUs;
XLA can overlap the collective with the local compute).

This is the framework's answer to the "sequence/context parallelism" row of
SURVEY.md §2.4 (absent in the reference). Windowed attention
(models/vit_detector.py) covers the local-attention design point; ring
attention covers exact global attention at sequence lengths that exceed
one chip's appetite.

Layout contract: inputs are (B, N, H, K) with any 1/sqrt(K) scaling
applied by the caller (same contract as kernels/flash_attention.py);
N must divide by the ring size.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..parallel.mesh import MODEL_AXIS

_NEG_INF = -1e30


def _ring_attention_local(q, k, v, seed=None, *, axis_name: str,
                          axis_size: int, dropout: tuple | None = None,
                          batch_axis_name: str | None = None):
    """Runs inside shard_map: q/k/v are this device's token shards
    (B, n_local, H, K). Rotates K/V ``axis_size`` times, accumulating
    streaming-softmax statistics in fp32.

    ``dropout=(threshold, inv_keep)`` applies keras-MHA probability
    dropout with the flash kernel's counter-based positional mask
    (kernels/flash_attention.py:dropout_keep_mask) keyed on GLOBAL
    (batch*head, query, key) coordinates — each ring step reconstructs
    the rotated block's global kv offset from the step count, so the
    mask is identical no matter how the tokens are sharded, and autodiff
    through the loop replays it exactly.
    """
    b, n_q, h, kd = q.shape

    perm = [(j, (j + 1) % axis_size) for j in range(axis_size)]

    m0 = jnp.full((b, h, n_q), _NEG_INF, jnp.float32)
    l0 = jnp.zeros((b, h, n_q), jnp.float32)
    acc0 = jnp.zeros((b, h, n_q, kd), jnp.float32)

    if dropout is not None:
        from .flash_attention import dropout_keep_mask

        threshold, inv_keep = dropout
        my_index = jax.lax.axis_index(axis_name)
        # Global batch index: when the batch axis is sharded over 'data',
        # offset by this shard's position so masks stay decorrelated
        # across data shards and match the unsharded flash oracle.
        b_base = jnp.uint32(0)
        if batch_axis_name is not None:
            b_base = (jax.lax.axis_index(batch_axis_name).astype(jnp.uint32)
                      * jnp.uint32(b))
        bh_idx = ((b_base + jnp.arange(b, dtype=jnp.uint32))[:, None] * h
                  + jnp.arange(h, dtype=jnp.uint32)[None, :])
        q_pos = (my_index.astype(jnp.uint32) * n_q
                 + jnp.arange(n_q, dtype=jnp.uint32))

    def block(carry, k_blk, v_blk, step):
        m, l, acc = carry
        # Input-dtype operands + fp32 accumulation: tensor-core path for
        # bf16 shards, identical numerics (bf16 is a subset of fp32).
        s = jnp.einsum("bnhk,bmhk->bhnm", q, k_blk,
                       preferred_element_type=jnp.float32)
        m_new = jnp.maximum(m, jnp.max(s, axis=-1))
        alpha = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[..., None])
        l_new = l * alpha + jnp.sum(p, axis=-1)
        if dropout is not None:
            # After ``step`` rotations this device holds the block that
            # originated on device (my_index - step) mod ring.
            origin = jnp.mod(my_index - step, axis_size)
            k_pos = (origin.astype(jnp.uint32) * k_blk.shape[1]
                     + jnp.arange(k_blk.shape[1], dtype=jnp.uint32))
            keep = dropout_keep_mask(
                seed, bh_idx[:, :, None, None],
                q_pos[None, None, :, None], k_pos[None, None, None, :],
                threshold)
            p = p * (keep.astype(jnp.float32) * inv_keep)
        acc_new = acc * alpha[..., None] + jnp.einsum(
            "bhnm,bmhk->bhnk", p.astype(v_blk.dtype), v_blk,
            preferred_element_type=jnp.float32)
        return m_new, l_new, acc_new

    carry = (m0, l0, acc0)
    k_cur, v_cur = k, v
    for step in range(axis_size):
        # Kick off the rotation before consuming the current block so XLA
        # can overlap the ppermute with the local attention math.
        if step + 1 < axis_size:
            k_next = jax.lax.ppermute(k_cur, axis_name, perm)
            v_next = jax.lax.ppermute(v_cur, axis_name, perm)
        carry = block(carry, k_cur, v_cur, step)
        if step + 1 < axis_size:
            k_cur, v_cur = k_next, v_next

    _, l, acc = carry
    out = acc / l[..., None]
    return out.transpose(0, 2, 1, 3).astype(q.dtype)  # (B, n_q, H, K)


def ring_attention_in_jit(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                      mesh: Mesh,
                      axis_name: str = MODEL_AXIS,
                      dropout_rate: float | None = None,
                      dropout_seed=None) -> jnp.ndarray:
    """Ring attention for use INSIDE an enclosing jit (no device_put):
    shard_map partitions the token axis over ``axis_name`` and GSPMD wires
    the surrounding program around it. ``dropout_rate``/``dropout_seed``
    enable training probability-dropout (see _ring_attention_local)."""
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    axis_size = mesh.shape[axis_name]
    n = q.shape[1]
    assert n % axis_size == 0, (
        f"token axis {n} must divide ring size {axis_size}")
    # Shard the batch over the data axis whenever it divides: a
    # batch-replicated spec made GSPMD all-gather the global batch and
    # every data shard recompute ALL of attention — 'data'x the FLOPs
    # and activation memory under DP (round-3 review finding). The
    # replicated fallback keeps small-batch/test callers working.
    from ..parallel.mesh import DATA_AXIS
    data_size = dict(mesh.shape).get(DATA_AXIS, 1)
    shard_batch = data_size > 1 and q.shape[0] % data_size == 0
    batch_axis = DATA_AXIS if shard_batch else None
    spec = P(batch_axis, axis_name, None, None)
    if dropout_rate in (None, 0.0):
        dropout = None
        seed = jnp.zeros((), jnp.uint32)
    else:
        from .flash_attention import _keep_threshold

        rate = float(dropout_rate)
        if not 0.0 < rate < 1.0:
            raise ValueError(
                f"dropout_rate must be in (0, 1), got {rate}")
        if dropout_seed is None:
            raise ValueError("dropout_rate needs a dropout_seed")
        dropout = (_keep_threshold(rate), 1.0 / (1.0 - rate))
        seed = jnp.asarray(dropout_seed).astype(jnp.uint32).reshape(())
    fn = shard_map(
        functools.partial(_ring_attention_local, axis_name=axis_name,
                          axis_size=axis_size, dropout=dropout,
                          batch_axis_name=batch_axis),
        mesh=mesh, in_specs=(spec, spec, spec, P()), out_specs=spec)
    return fn(q, k, v, seed)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "axis_name", "dropout_rate"))
def ring_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                   mesh: Mesh,
                   axis_name: str = MODEL_AXIS,
                   dropout_rate: float | None = None,
                   dropout_seed=None) -> jnp.ndarray:
    """Exact global attention with the token axis sharded over
    ``axis_name``. (B, N, H, K) in and out; N % ring_size == 0.
    Standalone entry: delegates to ring_attention_in_jit (one wiring,
    dropout support included)."""
    return ring_attention_in_jit(q, k, v, mesh, axis_name=axis_name,
                                 dropout_rate=dropout_rate,
                                 dropout_seed=dropout_seed)
