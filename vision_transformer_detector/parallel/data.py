"""Multi-host SPMD data feeding.

Each host loads its shard of the input files (data.pipeline
CocoDetectionDataset with shard_index=jax.process_index()) and assembles
its process-local batch; these helpers lift local batches into global
jax.Arrays laid out over the mesh so the jitted train step sees one global
batch (SURVEY.md §5 distributed-communication row).

Single-host is the degenerate case (process_count == 1): the helpers then
reduce to a plain device_put, which is what the tests exercise.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import jax
import numpy as np

from .mesh import batch_sharding


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None) -> None:
    """Multi-host bring-up: jax.distributed.initialize with explicit args
    or the cluster auto-detection JAX supports (e.g. SLURM). Call before
    device use; repeated calls in an already-initialized process are
    no-ops (one process may run
    several CLI commands — train then evaluate — against the same
    process group)."""
    if jax.distributed.is_initialized():
        return
    if coordinator_address is None and (num_processes is not None
                                        or process_id is not None):
        raise ValueError(
            "num_processes/process_id were given without "
            "coordinator_address; partial explicit configuration would "
            "be silently ignored and auto-detection could pick a "
            "different topology")
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def process_batch_indices(mesh, global_batch_size: int) -> range:
    """The rows of the GLOBAL batch this process must load.

    ``global_batch_from_local`` requires each process's local array to be
    exactly its addressable shard of the sharded batch — and on an
    arbitrary mesh (e.g. 2x2 data x model over 4 hosts) the mapping from
    process index to batch rows is decided by the mesh's device order,
    NOT by ``process_index * per_host`` arithmetic (mesh_utils may
    permute devices for topology). This helper reads the mapping off the
    sharding itself; a multi-host loader feeds
    ``dataset[process_batch_indices(mesh, B)]``.

    Model-parallel-only meshes (data axis 1) replicate the batch: every
    process loads the full range.
    """
    sharding = batch_sharding(mesh)
    index_map = sharding.devices_indices_map((global_batch_size,))
    starts = sorted({
        (idx[0].start or 0)
        for device, idx in index_map.items()
        if device.process_index == jax.process_index()})
    if not starts:
        raise ValueError("this process holds no shard of the batch")
    # Rows per shard from the slice itself (all shards are equal-sized).
    any_slice = next(iter(index_map.values()))[0]
    per = (any_slice.stop or global_batch_size) - (any_slice.start or 0)
    if len(starts) > 1 and any(
            b - a != per for a, b in zip(starts, starts[1:])):
        raise NotImplementedError(
            "this process's batch shards are non-contiguous; feed "
            "per-shard with jax.make_array_from_single_device_arrays")
    return range(starts[0], starts[-1] + per)


def process_shard_spec(mesh, global_batch_size: int
                       ) -> Tuple[int, int, int]:
    """This process's input-shard assignment for pod loaders.

    Returns ``(shard_index, num_shards, local_batch)``: feed the dataset
    ``image_paths[shard_index::num_shards]`` with ``local_batch`` rows
    per batch and ``global_batch_from_local`` assembles full global
    batches. Processes that hold the SAME rows of the batch (model-axis
    replication, e.g. a 2x2 data x model mesh or a TP-only mesh) get the
    same ``shard_index``, so every replica loads identical data — the
    mapping comes off the batch sharding itself (process_batch_indices),
    not process-index arithmetic.
    """
    from .mesh import DATA_AXIS

    data_size = mesh.shape[DATA_AXIS]
    if global_batch_size % data_size != 0:
        raise ValueError(
            f"global batch size {global_batch_size} is not divisible by "
            f"the data-parallel axis ({data_size} shards); "
            "process_batch_indices' equal-shard mapping (and the train "
            "step itself) requires divisibility")
    rows = process_batch_indices(mesh, global_batch_size)
    local = len(rows)
    # The strided image_paths[shard_index::num_shards] layout only
    # expresses equal-sized, aligned shards. Unequal per-process row
    # counts (processes holding different numbers of data-axis shards)
    # would floor-divide into overlapping/garbage assignments here —
    # e.g. a process with rows [4,16) of 16 would get shard 0 of 1 and
    # load the ENTIRE dataset while its peer loads a quarter.
    if global_batch_size % local != 0 or rows.start % local != 0:
        raise NotImplementedError(
            f"this process holds rows [{rows.start}, {rows.stop}) of the "
            f"{global_batch_size}-row global batch — not an aligned "
            "equal-size shard; strided path sharding cannot express "
            "this layout, feed per-shard with "
            "jax.make_array_from_single_device_arrays")
    return rows.start // local, global_batch_size // local, local


def global_batch_from_local(mesh, local_batch: np.ndarray) -> jax.Array:
    """Assemble a global array from this process's local batch shard.

    The global batch size is ``local * process_count``; the leading axis is
    sharded over the 'data' mesh axis. On one process this is just a
    sharded device_put.
    """
    sharding = batch_sharding(mesh)
    if jax.process_count() == 1:
        return jax.device_put(local_batch, sharding)
    return jax.make_array_from_process_local_data(sharding, local_batch)


def global_batches(mesh, local_iterator: Iterable
                   ) -> Iterator[Tuple[jax.Array, jax.Array]]:
    """Wrap a per-host (images, labels) iterator into global arrays."""
    for images, labels in local_iterator:
        yield (global_batch_from_local(mesh, np.asarray(images)),
               global_batch_from_local(mesh, np.asarray(labels)))


def synced_global_eval_batches(mesh, local_iterator: Iterable
                               ) -> Iterator[Tuple[jax.Array, jax.Array,
                                                   jax.Array]]:
    """Lockstep eval rounds that tolerate uneven per-process shards.

    Each process feeds its LOCAL ``(images, labels)`` eval batches; every
    round the processes agree (host allgather) on a common padded local
    row count, pad ragged or missing batches with inert rows (zero
    images, EMPTY_SLOT labels), and yield
    ``(global_images, global_labels, global_valid)``. The loop ends only
    when EVERY process is exhausted — so a 5-vs-4-image shard split or a
    differing per-process batch count can no longer desync the
    collectives inside the jitted eval step (which would hang the pod at
    the first eval epoch).

    ``valid`` marks the real rows. ``evaluate_map`` zeroes the decoded
    predictions of padded rows (objectness 0 is below every positivity
    threshold) and EMPTY_SLOT labels carry no ground truth, so a padded
    row is an exact metric no-op (property-tested in
    tests/test_fast_map.py::test_inert_padding_rows_are_noop).

    Single-process this degenerates to ragged-tail padding only, which
    keeps the final batch shardable over the data axis.
    """
    from ..config import EMPTY_SLOT_VALUE
    from .mesh import DATA_AXIS

    # Local rows must be exactly this process's addressable shard, so
    # they must stay divisible by the data-axis devices this process
    # holds (1 on a one-device-per-host pod; >1 single-process).
    local_data = mesh.local_mesh.shape.get(DATA_AXIS, 1)

    def describe(arr):
        """(dtype char code, *trailing_shape) — the consensus row format.
        The char round-trips through np.dtype(chr(code)); dtype.num does
        not reconstruct."""
        return (ord(arr.dtype.char),) + tuple(arr.shape[1:])

    it = iter(local_iterator)
    exhausted = False
    template = None  # ((img dtype_num, *tail), (lab dtype_num, *tail))
    while True:
        batch = None
        if not exhausted:
            batch = next(it, None)
            exhausted = batch is None
        if batch is not None:
            images = np.asarray(batch[0])
            labels = np.asarray(batch[1])
            n = images.shape[0]
            template = (describe(images), describe(labels))
        else:
            n = 0
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            # One vector per round: this process's count, whether its
            # iterator is truly EXHAUSTED (a yielded zero-row batch is
            # not — conflating the two used to end the whole eval early
            # and score a truncated dataset), and its batch layout
            # (dtype + trailing dims for images and labels). A process
            # whose shard is exhausted (or empty from round 1) pads with
            # the layout of a process that still has data —
            # config-derived float32 defaults would dtype/shape-mismatch
            # a uint8 or off-config stream and desync the assembly, the
            # exact failure mode these rounds exist to prevent.
            row = [n, int(exhausted)] + (
                [v for part in template for v in part]
                if template is not None else [])
            width = 16  # generous fixed width for the layout encoding
            row = (row + [-1] * width)[:width]
            table = np.asarray(multihost_utils.process_allgather(
                np.asarray(row, np.int32)))
            table = np.atleast_2d(table)
            round_n = int(table[:, 0].max())
            if bool(table[:, 1].all()):
                return          # every process's iterator is done
            if round_n == 0:
                continue        # an all-empty round, but streams remain
            if template is None:
                donor = table[int(table[:, 0].argmax())]
                vals = [int(v) for v in donor[2:] if v != -1]
                img_len = len(vals) - 3  # labels carry dtype + 2 dims
                template = ((vals[0],) + tuple(vals[1:img_len]),
                            tuple(vals[img_len:]))
        else:
            if exhausted:
                return
            round_n = n
            if round_n == 0:
                continue        # zero-row batch mid-stream: skip, don't end
        round_n = -(-round_n // local_data) * local_data
        if batch is None:
            (img_dt, *img_tail), (lab_dt, *lab_tail) = template
            images = np.zeros((0,) + tuple(img_tail), np.dtype(chr(img_dt)))
            labels = np.zeros((0,) + tuple(lab_tail), np.dtype(chr(lab_dt)))
        pad = round_n - n
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            labels = np.concatenate(
                [labels, np.full((pad,) + labels.shape[1:],
                                 EMPTY_SLOT_VALUE, labels.dtype)])
        valid = np.arange(round_n) < n
        yield (global_batch_from_local(mesh, images),
               global_batch_from_local(mesh, labels),
               global_batch_from_local(mesh, valid))
