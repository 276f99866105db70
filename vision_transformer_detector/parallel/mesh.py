"""Device mesh + sharding rules for SPMD execution.

The reference has no parallelism of any kind (SURVEY.md §2.4); this module
is the communication layer it lacks: a ``jax.sharding.Mesh`` over
('data', 'model') axes, NamedShardings for the batch and the parameter
pytree, and XLA-emitted collectives (psum for DP gradient reduction,
all-gathers for TP, ppermute for ring attention) instead of a hand-written
transport. On GPUs XLA hands those collectives to NCCL.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(data: Optional[int] = None, model: int = 1,
                devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Mesh over ('data', 'model'). ``data=None`` uses all remaining
    devices for data parallelism."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    # Real raises, not asserts — `python -O` strips asserts, leaving only
    # a cryptic numpy reshape error for bad data/model arguments.
    if data is None:
        if n % model != 0:
            raise ValueError(
                f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} available devices")
    # A plain reshape in device order: the cards of one host are joined
    # all to all, so no placement puts an axis on faster links than
    # another, and the mesh follows the algorithm alone.
    grid = np.asarray(devices).reshape(data, model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _kernel_spec(path: str, shape) -> P:
    """Tensor-parallel PartitionSpec for one detector parameter.

    Megatron-style rules adapted to this architecture:
      * attention q/k/v kernels (D, H, K): shard heads (axis 1),
      * attention out kernel (H, K, D): shard heads (axis 0) — a
        row-parallel pair with q/k/v, so XLA inserts one reduce per block,
      * encoder/head pyramid kernels alternate column/row parallel by
        position so activations stay sharded between consecutive layers,
      * everything else (biases, norms, position embedding) is replicated.
    Dims that do not divide by the model-axis size are replicated.
    """
    parts = path.split("/")
    if "mha" in parts:
        if parts[-1] != "kernel":
            return P()
        if "out" in parts:
            return P(MODEL_AXIS, None, None)
        return P(None, MODEL_AXIS, None)
    if parts[-1] == "kernel" and ("mlp" in parts or "head_mlp" in parts):
        # position within the pyramid decides column (even) vs row (odd)
        try:
            idx = int(parts[parts.index("kernel") - 1])
        except ValueError:
            idx = 0
        if idx % 2 == 0:
            return P(None, MODEL_AXIS)
        return P(MODEL_AXIS, None)
    return P()


def _divisible(shape, spec: P, model_size: int) -> bool:
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axis == MODEL_AXIS and dim % model_size != 0:
            return False
    return True


def param_shardings(params, mesh: Mesh):
    """NamedSharding pytree for the detector params.

    With a singleton model axis everything is replicated (pure DP). With a
    larger model axis, kernels follow `_kernel_spec` when their sharded
    dims divide evenly, else fall back to replication.
    """
    model_size = mesh.shape[MODEL_AXIS]

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    treedef = jax.tree_util.tree_structure(params)

    shardings = []
    for key_path, leaf in flat:
        path = "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in key_path)
        if model_size == 1:
            shardings.append(NamedSharding(mesh, P()))
            continue
        spec = _kernel_spec(path, leaf.shape)
        if not _divisible(leaf.shape, spec, model_size):
            spec = P()
        shardings.append(NamedSharding(mesh, spec))
    return jax.tree_util.tree_unflatten(treedef, shardings)
