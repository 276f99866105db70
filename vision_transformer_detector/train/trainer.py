"""SPMD training loop: jitted train/eval steps, best-AP checkpointing,
structured metrics.

The equivalent of the reference's notebook driver + callback
stack (ipynb cell 7; SaveModelHighestAP at
vision_transformer_detector.py:2063-2184):

  * one jitted train step (forward + loss + grads + Adam + weight clip);
    under a multi-device mesh the batch is sharded over the 'data' axis and
    XLA inserts the psum gradient reduction — the reference's missing DP,
  * a jitted eval step returning decoded predictions; the streaming mAP
    metric consumes them host-side through its
    ``use_transform_predictions=False`` seam,
  * the dual-model graph/eager dance of SaveModelHighestAP (vtd.py:2066-2069,
    a TF workaround) disappears: the same params serve both steps,
  * checkpoints hold {params, opt_state, step, best_ap} — unlike the
    reference, optimizer state resumes too (SURVEY.md §5 checkpoint),
  * metrics stream to a jsonl file for the plotting tool.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import DetectorConfig, LossConfig, TrainConfig
from ..metrics.mean_average_precision import MeanAveragePrecision
from ..models.vit_detector import forward, init_params
from ..ops.decode import transform_predictions
from ..ops.loss import detection_loss
from ..parallel import mesh as mesh_lib
from ..utils import checkpoint as ckpt_lib
from .optimizer import clip_weights, make_optimizer

TrainState = Dict[str, Any]  # {"params", "opt_state", "step"}


def create_train_state(rng: jax.Array, config: DetectorConfig,
                       optimizer: optax.GradientTransformation) -> TrainState:
    # One jitted program for the whole init: eager optimizer.init alone
    # dispatches two small zeros-ops per parameter leaf — hundreds of
    # device dispatches.
    # The jit is built per call (init runs once per process), closing
    # over config/optimizer to avoid static-arg hashing of optax state.
    @jax.jit
    def _init(rng):
        params = init_params(rng, config)
        return {
            "params": params,
            "opt_state": optimizer.init(params),
            "step": jnp.zeros((), jnp.int32),
        }

    return _init(rng)


def _maybe_normalize(images: jnp.ndarray) -> jnp.ndarray:
    """Fuse the [-1,1] normalisation (vtu.py:442-447) into the device
    program when the pipeline ships uint8."""
    if images.dtype == jnp.uint8:
        return images.astype(jnp.float32) / 127.5 - 1.0
    return images


def make_train_step_body(config: DetectorConfig,
                         loss_config: LossConfig,
                         optimizer: optax.GradientTransformation,
                         mesh=None):
    """The un-jitted train-step function, shared by the per-call jit
    (make_train_step) and the device-resident scan (make_multi_step)."""
    # Train-only attention override (config.train_use_flash_attention):
    # the flash-vs-einsum choice may differ between training and
    # inference, so the train step may trace a different attention path
    # than eval.
    if config.train_use_flash_attention is not None:
        config = config.replace(
            use_flash_attention=config.train_use_flash_attention)

    def train_step(state: TrainState, images, labels, rng
                   ) -> Tuple[TrainState, jnp.ndarray]:
        images = _maybe_normalize(images)

        def loss_fn(params):
            logits = forward(params, images, config,
                             train=config.dropout is not None,
                             dropout_rng=rng, mesh=mesh)
            return detection_loss(labels, logits, config, loss_config)

        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        updates, opt_state = optimizer.update(
            grads, state["opt_state"], state["params"])
        params = optax.apply_updates(state["params"], updates)
        if config.clip_weight:
            params = clip_weights(params, config.max_weight)
        new_state = {
            "params": params,
            "opt_state": opt_state,
            "step": state["step"] + 1,
        }
        return new_state, loss

    return train_step


def make_train_step(config: DetectorConfig,
                    loss_config: LossConfig,
                    optimizer: optax.GradientTransformation,
                    donate: bool = True,
                    mesh=None):
    """Build the jitted train step. Sharding of inputs decides DP/TP; XLA
    emits the collectives."""
    train_step = make_train_step_body(config, loss_config, optimizer, mesh)
    donate_argnums = (0,) if donate else ()
    return jax.jit(train_step, donate_argnums=donate_argnums)


def make_multi_step(config: DetectorConfig,
                    loss_config: LossConfig,
                    optimizer: optax.GradientTransformation,
                    donate: bool = True,
                    mesh=None):
    """Device-resident multi-epoch train loop: ``lax.scan`` over
    ``n_epochs * batches_per_epoch`` train steps in ONE dispatch.

    The per-epoch host loop pays a fixed host round-trip per step (rng
    split, dispatch, loss fetch). The reference cannot do
    this at all (Keras model.fit returns to Python between steps); under
    XLA the whole K-epoch window compiles into one program and the host
    syncs once per window.

    The rng chain is carried through the scan with the SAME
    ``jax.random.split`` sequence as the host loop, so dropout-active
    trajectories are identical between the two paths (tests/test_train.py
    asserts it). Returns ``(state, epoch_losses[n_epochs], rng)``;
    ``n_epochs`` is static (one compile per distinct chunk length).
    """
    body = make_train_step_body(config, loss_config, optimizer, mesh)

    def multi_step(state: TrainState, images_stack, labels_stack, rng,
                   n_epochs: int):
        batches = images_stack.shape[0]

        def scan_body(carry, i):
            state, rng = carry
            rng, step_rng = jax.random.split(rng)
            images = jax.lax.dynamic_index_in_dim(
                images_stack, i % batches, keepdims=False)
            labels = jax.lax.dynamic_index_in_dim(
                labels_stack, i % batches, keepdims=False)
            state, loss = body(state, images, labels, step_rng)
            return (state, rng), loss

        (state, rng), losses = jax.lax.scan(
            scan_body, (state, rng), jnp.arange(n_epochs * batches))
        epoch_losses = losses.reshape(n_epochs, batches).mean(axis=1)
        return state, epoch_losses, rng

    donate_argnums = (0,) if donate else ()
    return jax.jit(multi_step, static_argnums=(4,),
                   donate_argnums=donate_argnums)


def make_eval_step(config: DetectorConfig, mesh=None):
    """Jitted forward + on-device decode -> (B, max_objects, 6) decoded."""

    def eval_step(params, images):
        images = _maybe_normalize(images)
        logits = forward(params, images, config, train=False, mesh=mesh)
        return transform_predictions(logits, config)

    return jax.jit(eval_step)


def make_predict_step(config: DetectorConfig):
    """Jitted forward returning raw logits (the reference's model.predict)."""

    def predict_step(params, images):
        images = _maybe_normalize(images)
        return forward(params, images, config, train=False)

    return jax.jit(predict_step)


@jax.jit
def _zero_padded_rows(decoded, valid):
    """Inert-ify decoded predictions of padded eval rows: objectness 0 is
    below every positivity threshold, so the metric ignores them."""
    return jnp.where(valid[:, None, None], decoded, 0.0)


def evaluate_map(params, dataset: Iterable, config: DetectorConfig,
                 eval_step=None,
                 metric: Optional[MeanAveragePrecision] = None,
                 put_fn=None, mesh=None) -> float:
    """Run the streaming mAP over a dataset (SaveModelHighestAP's evaluate,
    vtd.py:2162-2172).

    ``put_fn`` places each image batch on device (Trainer passes
    ``_put_images`` so eval batches shard over the data axis like train
    batches do — without it a mesh run evaluates from one device's copy
    and GSPMD pays an all-to-all reshard per batch).

    ``mesh`` (multi-process only): each process feeds its process-LOCAL
    eval shard and the rounds are synchronized+padded across processes
    (parallel.data.synced_global_eval_batches) so uneven shard sizes or
    batch counts cannot desync the collectives, labels join the decoded
    predictions' global layout, and padded rows are exact metric no-ops."""
    if eval_step is None:
        eval_step = make_eval_step(config)
    if metric is None:
        metric = MeanAveragePrecision(config)
    metric.reset_state()
    host_metric = isinstance(metric, MeanAveragePrecision)
    if host_metric and jax.process_count() > 1:
        raise NotImplementedError(
            "the host-oracle MeanAveragePrecision cannot evaluate under "
            "multi-process SPMD (decoded predictions are global arrays "
            "with non-addressable shards); use the jitted metric "
            "(Trainer(fast_metric=True), the default)")
    if mesh is not None and jax.process_count() > 1:
        from ..parallel.data import synced_global_eval_batches
        rounds = synced_global_eval_batches(mesh, dataset)
    else:
        if put_fn is None:
            put_fn = jnp.asarray
        rounds = ((put_fn(images), labels, None)
                  for images, labels in dataset)
    for images, labels, valid in rounds:
        decoded = eval_step(params, images)
        if valid is not None:
            decoded = _zero_padded_rows(decoded, valid)
        # Only the host oracle needs the device->host copy; the jitted
        # metric consumes the device array directly (forcing np.asarray
        # re-added the round-trip it exists to eliminate).
        metric.update_state(labels,
                            np.asarray(decoded) if host_metric else decoded,
                            use_transform_predictions=False)
    return float(metric.result())


class MetricsWriter:
    """Structured jsonl metrics (replaces history.history + the pandas
    records table, ipynb cells 6-9)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def write(self, **record):
        if self._f is not None:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()


class Trainer:
    """End-to-end training driver (ipynb cell 7 + SaveModelHighestAP)."""

    def __init__(self,
                 config: DetectorConfig,
                 loss_config: LossConfig = LossConfig(),
                 train_config: TrainConfig = TrainConfig(),
                 steps_per_epoch: int = 1,
                 mesh=None,
                 checkpoint_dir: Optional[str] = None,
                 metrics_path: Optional[str] = None,
                 fast_metric: bool = True,
                 async_checkpointing: bool = False,
                 keep_checkpoints: Optional[int] = None,
                 check_weights_every: Optional[int] = None,
                 check_weights_start: int = 0,
                 weight_threshold: float = 1.0):
        self.config = config
        self.loss_config = loss_config
        self.train_config = train_config
        self.mesh = mesh
        self.checkpoint_dir = checkpoint_dir
        self.optimizer = make_optimizer(train_config, steps_per_epoch)
        self.train_step = make_train_step(config, loss_config, self.optimizer,
                                          mesh=mesh)
        self.eval_step = make_eval_step(config, mesh=mesh)
        if fast_metric:
            # Jitted on-device metric (metrics/fast_map.py), equivalence-
            # tested against the host oracle on the 13 reference cases.
            from ..metrics.fast_map import JitMeanAveragePrecision
            self.metric = JitMeanAveragePrecision(config)
        else:
            self.metric = MeanAveragePrecision(config)
        # Multi-host: only process 0 streams metrics — N processes
        # appending the same jsonl interleave records (every process
        # computes identical replicated values anyway).
        self.metrics = MetricsWriter(
            metrics_path if jax.process_index() == 0 else None)
        # Async checkpointing: saves overlap training (the loop pays only
        # the device->host snapshot); fit() joins pending writes on exit.
        self._async_ckpt = (ckpt_lib.AsyncCheckpointManager()
                            if async_checkpointing else None)
        # Rolling history: every periodic save also writes a step-stamped
        # checkpoint and prunes to the newest ``keep_checkpoints``
        # ("highest_ap"/"ongoing" are never pruned). None = reference
        # behaviour (overwrite-only, no history).
        self.keep_checkpoints = keep_checkpoints
        # CheckModelWeight twin (vtd.py:650-687): on a cadence, scan the
        # params and report NEW extrema beyond +-weight_threshold; the
        # running extremes start at the threshold so early growth doesn't
        # spam (vtd.py:656-658).
        self.check_weights_every = check_weights_every
        self.check_weights_start = check_weights_start
        self._weight_watermarks = [-weight_threshold, weight_threshold]
        self.best_ap = 0.0
        self.ap_record = []
        self.loss_record = []
        # Resume-correct ResumableDataset state for the batch the trainer
        # last consumed (maintained by _device_prefetch; None until a
        # stateful dataset streams through fit()).
        self.dataset_resume_state = None

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        rng = jax.random.PRNGKey(
            self.train_config.seed if seed is None else seed)
        if self.mesh is not None and jax.process_count() > 1:
            return self._init_state_multiprocess(rng)
        params = init_params(rng, self.config)
        if self.mesh is not None:
            # Shard params first; optimizer.init builds its moments with
            # zeros_like, which inherits the param shardings, so mu/nu are
            # laid out exactly like the params with no resharding churn.
            params = jax.device_put(
                params, mesh_lib.param_shardings(params, self.mesh))
        opt_state = self.optimizer.init(params)
        step = jnp.zeros((), jnp.int32)
        if self.mesh is not None:
            step = jax.device_put(step, mesh_lib.replicated(self.mesh))
            # The moments inherited the param shardings through
            # zeros_like, but optax's scalar leaves (Adam's count, the
            # schedule step) were created fresh on the default device,
            # UNCOMMITTED. That mix trains fine — jit treats uncommitted
            # arrays as reshardable — but a checkpoint restore commits
            # every leaf to its template sharding, and a later train
            # step then sees committed device-0 scalars next to
            # committed mesh arrays and refuses ("incompatible
            # devices"). Replicate the scalars over the mesh up front so
            # live state and restored state share one layout.
            rep = mesh_lib.replicated(self.mesh)
            opt_state = jax.tree_util.tree_map(
                lambda x: (jax.device_put(x, rep)
                           if getattr(x, "ndim", None) == 0 else x),
                opt_state)
        return {"params": params, "opt_state": opt_state, "step": step}

    def _init_state_multiprocess(self, rng) -> TrainState:
        """Init under real multi-process SPMD (jax.distributed).

        ``jax.device_put(host_array, sharding)`` cannot target another
        process's devices, so the single-process path above raises on a
        multi-host mesh. Instead the whole init runs as ONE jitted
        program whose params carry sharding constraints; every process
        executes it and receives its addressable shards of the same
        global arrays (moments inherit the param layout through
        optimizer.init's zeros_like, as in the single-process path).
        The rng is passed as a host numpy array — jit treats host inputs
        as replicated, which is exactly right since every process
        derives the identical key.
        """
        shardings = mesh_lib.param_shardings(
            jax.eval_shape(lambda r: init_params(r, self.config), rng),
            self.mesh)

        def _init(raw_key):
            params = init_params(raw_key, self.config)
            params = jax.tree_util.tree_map(
                jax.lax.with_sharding_constraint, params, shardings)
            return {
                "params": params,
                "opt_state": self.optimizer.init(params),
                "step": jnp.zeros((), jnp.int32),
            }

        with self.mesh:
            return jax.jit(_init)(np.asarray(rng))

    def _mesh_context(self):
        """Trace/jit inside the Mesh context so bare-PartitionSpec sharding
        constraints (e.g. sequence_sharding) resolve against it."""
        if self.mesh is not None:
            return self.mesh
        return contextlib.nullcontext()

    def _device_prefetch(self, iterator):
        """Yield device-resident batches one step ahead: the async
        device_put of batch i+1 overlaps the train step on batch i (the
        device half of the host+device prefetch pipeline).

        The one-batch lookahead advances a ResumableDataset's counter
        past the batch the consumer is actually on; this wrapper snapshots
        the dataset state AS OF each yielded batch into
        ``self.dataset_resume_state`` so checkpointing resumes without
        skipping the prefetched-but-untrained batch (round-3 review
        finding)."""
        get_state = getattr(iterator, "get_state", None)
        previous = None
        for batch in iterator:
            state_now = get_state() if callable(get_state) else None
            current = (self._put_batch(*batch), state_now)
            if previous is not None:
                batch_dev, snapshot = previous
                if snapshot is not None:
                    self.dataset_resume_state = snapshot
                yield batch_dev
            previous = current
        if previous is not None:
            batch_dev, snapshot = previous
            if snapshot is not None:
                self.dataset_resume_state = snapshot
            yield batch_dev

    def _put_images(self, images):
        """Device placement for EVAL image batches: sharded over the data
        axis like train batches. Eval tolerates what train rejects — a
        final ragged batch that doesn't divide the data axis runs
        unsharded instead of raising (mAP must include every image).
        Multi-process eval does not route through here: evaluate_map's
        ``mesh`` path assembles synchronized global rounds instead."""
        if self.mesh is not None and jax.process_count() > 1:
            from ..parallel.data import global_batch_from_local
            return global_batch_from_local(self.mesh, np.asarray(images))
        images = jnp.asarray(images)
        if self.mesh is None:
            return images
        data_size = self.mesh.shape[mesh_lib.DATA_AXIS]
        if images.shape[0] % data_size != 0:
            return images
        return jax.device_put(images, mesh_lib.batch_sharding(self.mesh))

    def _put_batch(self, images, labels):
        if self.mesh is not None and jax.process_count() > 1:
            # Multi-host: each process holds only its local shard; a
            # plain device_put against a sharding with non-addressable
            # devices raises. The parallel.data helper assembles the
            # global array from per-process locals.
            from ..parallel.data import global_batch_from_local
            return (global_batch_from_local(self.mesh, np.asarray(images)),
                    global_batch_from_local(self.mesh, np.asarray(labels)))
        images = jnp.asarray(images)
        labels = jnp.asarray(labels)
        if self.mesh is not None:
            data_size = self.mesh.shape[mesh_lib.DATA_AXIS]
            if images.shape[0] % data_size != 0:
                raise ValueError(
                    f"batch size {images.shape[0]} is not divisible by the "
                    f"data-parallel axis ({data_size} devices); choose a "
                    f"batch size that is a multiple of {data_size}")
            sharding = mesh_lib.batch_sharding(self.mesh)
            images = jax.device_put(images, sharding)
            labels = jax.device_put(labels, sharding)
        return images, labels

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, train_data, epochs: int,
            eval_data=None, epochs_per_call: int = 1) -> TrainState:
        """Epoch loop with warm-up-gated periodic eval + best-AP checkpoint
        (SaveModelHighestAP semantics, vtd.py:2142-2180).

        ``epochs_per_call > 1`` (materialized datasets only) runs up to
        that many epochs per device dispatch via ``make_multi_step`` —
        the host syncs once per window instead of once per epoch, which
        removes the per-epoch round-trip latency.
        Eval/checkpoint/weight-check cadences are exact: a window always
        ends at the next epoch any of them fires on. Choosing a value
        that divides ``skip_epochs`` avoids extra scan compilations."""
        tc = self.train_config
        rng = jax.random.PRNGKey(tc.seed + 1)
        tic = time.time()

        # Materialized datasets (lists of batches) are moved to device once;
        # re-transferring identical host arrays every epoch would make the
        # host->device link the bottleneck (the 8-image overfit feeds the
        # same 35MB batch 12k times).
        if isinstance(train_data, (list, tuple)):
            train_data = [self._put_batch(*batch) for batch in train_data]

        materialized = isinstance(train_data, (list, tuple))
        if epochs_per_call > 1:
            if not materialized:
                raise ValueError(
                    "epochs_per_call > 1 requires a materialized dataset "
                    "(a list of (images, labels) batches): a streaming "
                    "dataset cannot be stacked on device for the scan")
            if jax.process_count() > 1:
                raise NotImplementedError(
                    "epochs_per_call > 1 is single-process only (the "
                    "scanned window would need per-process global-array "
                    "assembly of the stacked batches)")
            return self._fit_scanned(state, train_data, epochs, eval_data,
                                     epochs_per_call, tic, rng)
        for epoch in range(epochs):
            epoch_losses = []
            # Both branches yield device-resident batches already (the
            # materialized list was put once before the loop; the streaming
            # path puts inside _device_prefetch).
            epoch_data = (train_data if materialized
                          else self._device_prefetch(train_data))
            for images, labels in epoch_data:
                rng, step_rng = jax.random.split(rng)
                with self._mesh_context():
                    state, loss = self.train_step(
                        state, images, labels, step_rng)
                epoch_losses.append(loss)
            if not epoch_losses:
                try:
                    n = len(train_data)
                except TypeError:
                    n = None
                if n == 0:
                    raise ValueError(
                        "train_data is empty: no image paths matched, or "
                        "batch_size exceeds the dataset size (an "
                        "incomplete final batch is dropped)")
                raise ValueError(
                    f"train_data yielded no batches in epoch {epoch}; pass "
                    "a re-iterable dataset (a list of batches or a dataset "
                    "object), not a one-shot generator that is already "
                    "exhausted")
            epoch_loss = float(jnp.mean(jnp.stack(epoch_losses)))
            self._epoch_tail(state, epoch, epochs, eval_data, epoch_loss, tic)
        if self._async_ckpt is not None:
            self._async_ckpt.wait()
        return state

    def _fit_scanned(self, state: TrainState, train_data, epochs: int,
                     eval_data, epochs_per_call: int, tic: float, rng
                     ) -> TrainState:
        """fit()'s device-resident windowed driver (epochs_per_call > 1):
        stack the materialized batches once, then run each window of
        epochs as ONE make_multi_step dispatch. Windows end exactly at
        event epochs (eval / checkpoint / weight-check cadences), so
        observable behaviour matches the per-epoch loop — including the
        rng split chain, which the scan carries identically."""
        if not train_data:
            raise ValueError(
                "train_data is empty: no image paths matched, or "
                "batch_size exceeds the dataset size (an incomplete "
                "final batch is dropped)")
        shapes = {(b[0].shape, b[1].shape) for b in train_data}
        if len(shapes) > 1:
            # jnp.stack's "all input arrays must have the same shape"
            # would surface with no hint at the real cause.
            raise ValueError(
                "epochs_per_call > 1 requires uniform batch shapes to "
                f"stack the dataset for the scan; got {sorted(shapes)}. "
                "Drop or pad the ragged final batch, or use "
                "epochs_per_call=1 (the per-epoch loop handles ragged "
                "batches).")
        # Batches are device-resident already (fit put them); the stack
        # runs on device. Under a mesh, reshard so the per-step
        # dynamic_index yields batches laid out like _put_batch's.
        images_stack = jnp.stack([b[0] for b in train_data])
        labels_stack = jnp.stack([b[1] for b in train_data])
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            stacked = NamedSharding(
                self.mesh, PartitionSpec(None, mesh_lib.DATA_AXIS))
            images_stack = jax.device_put(images_stack, stacked)
            labels_stack = jax.device_put(labels_stack, stacked)
        multi_step = make_multi_step(self.config, self.loss_config,
                                     self.optimizer, mesh=self.mesh)
        has_eval = eval_data is not None
        # rng comes from fit() — the SAME chain the per-epoch loop would
        # consume, so the two drivers' trajectories stay bit-equal (a
        # locally re-derived key here would silently fork if fit's seed
        # derivation ever changed).
        epoch = 0
        while epoch < epochs:
            window = min(epochs_per_call, epochs - epoch)
            for j in range(window):
                if self._is_event_epoch(epoch + j, epochs, has_eval):
                    window = j + 1
                    break
            with self._mesh_context():
                state, losses, rng = multi_step(
                    state, images_stack, labels_stack, rng, window)
            losses = np.asarray(losses)  # one host sync per window
            for j in range(window):
                self._epoch_tail(state, epoch + j, epochs, eval_data,
                                 float(losses[j]), tic)
            epoch += window
        if self._async_ckpt is not None:
            self._async_ckpt.wait()
        return state

    # The three cadence predicates are shared by _is_event_epoch (the
    # scanned driver's window-cut test) and _epoch_tail (the actions
    # themselves) so they cannot drift: a divergence would make the
    # scanned driver hand _epoch_tail end-of-window state at an epoch
    # it didn't cut a window for, silently checkpointing/evaluating the
    # wrong params under that epoch's label.
    def _weight_check_due(self, epoch: int) -> bool:
        return bool(self.check_weights_every
                    and epoch >= self.check_weights_start
                    and (epoch - self.check_weights_start)
                    % self.check_weights_every == 0)

    def _eval_due(self, epoch: int) -> bool:
        # skip_epochs <= 0 disables the periodic cadence (it used to
        # ZeroDivisionError here mid-training, after the warm-up epochs).
        tc = self.train_config
        return (tc.skip_epochs > 0
                and epoch >= tc.epochs_warm_up
                and (epoch - tc.epochs_warm_up) % tc.skip_epochs == 0)

    def _ckpt_due(self, epoch: int, epochs: int) -> bool:
        # The final-epoch checkpoint always fires; skip_epochs <= 0
        # disables only the periodic ones.
        tc = self.train_config
        return bool(self.checkpoint_dir
                    and ((tc.skip_epochs > 0
                          and epoch % tc.skip_epochs == 0)
                         or epoch == epochs - 1))

    def _is_event_epoch(self, epoch: int, epochs: int,
                        has_eval: bool) -> bool:
        """True when _epoch_tail does more than record the loss at this
        epoch — the scanned driver must surface the live state then."""
        return (self._weight_check_due(epoch)
                or (has_eval and self._eval_due(epoch))
                or self._ckpt_due(epoch, epochs))

    def _epoch_tail(self, state: TrainState, epoch: int, epochs: int,
                    eval_data, epoch_loss: float, tic: float) -> None:
        """Everything the epoch loop does after the train steps: loss
        record, weight watchdog, warm-up-gated eval + best-AP save,
        periodic "ongoing"/rolling checkpoints, metrics record."""
        self.loss_record.append(epoch_loss)

        record = {"epoch": epoch, "loss": epoch_loss,
                  "wall_s": time.time() - tic}

        if self._weight_check_due(epoch):
            record.update(self._check_weights(state["params"], epoch))

        if eval_data is not None and self._eval_due(epoch):
            with self._mesh_context():
                ap = evaluate_map(
                    state["params"], eval_data, self.config,
                    self.eval_step, self.metric,
                    put_fn=self._put_images,
                    # Multi-process: rounds synchronize+pad across
                    # processes (uneven shards must not desync the
                    # collectives) and labels join the decoded
                    # predictions' global layout.
                    mesh=self.mesh)
            self.ap_record.append(ap)
            record["ap"] = ap
            if ap > self.best_ap:
                self.best_ap = ap
                if self.checkpoint_dir:
                    self.save(state, name="highest_ap")

        # Crash-resumability must not depend on eval being configured
        # or on the warm-up having passed: the periodic "ongoing" /
        # rolling checkpoints run on their own cadence from epoch 0
        # (a run that dies at epoch 499 used to leave an EMPTY
        # checkpoint dir — round-3 review finding).
        if self._ckpt_due(epoch, epochs):
            self.save(state, name="ongoing")
            if self.keep_checkpoints:
                self.save_rolling(state)

        self.metrics.write(**record)

    # ------------------------------------------------------------------
    def save(self, state: TrainState, name: str = "ongoing") -> None:
        from ..config import save_configs

        # Multi-host: the orbax tree save below is collective (every
        # process participates, each writing its addressable shards),
        # but the plain host files (config.json, the dataset sidecar)
        # must be written by ONE process — concurrent writers racing on
        # shared checkpoint storage can interleave/truncate them.
        primary = jax.process_index() == 0
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        config_path = os.path.join(self.checkpoint_dir, "config.json")
        if primary and not os.path.exists(config_path):
            # The run is reproducible from its checkpoint dir alone.
            save_configs(config_path, self.config, self.loss_config,
                         self.train_config)
        path = os.path.join(self.checkpoint_dir, name)
        tree = {"params": state["params"],
                "opt_state": state["opt_state"],
                "step": state["step"],
                "best_ap": self._global_scalar(self.best_ap)}
        if self._async_ckpt is not None:
            self._async_ckpt.save(path, tree)
        else:
            ckpt_lib.save_checkpoint(path, tree)
        if primary:
            self._save_dataset_state(path)

    def _config_mismatch_hint(self) -> Optional[str]:
        """When a restore fails, say WHY if the checkpoint's own
        config.json disagrees with the live DetectorConfig — a raw orbax
        shape error ('Requested shape (16,) is not compatible...') does
        not tell the user they passed the wrong --preset/--image-size."""
        import dataclasses

        from ..config import load_configs

        config_path = os.path.join(self.checkpoint_dir, "config.json")
        if not os.path.exists(config_path):
            return None
        try:
            saved, _, _ = load_configs(config_path)
        except Exception:
            return None
        if saved == self.config:
            return None
        diffs = [
            f"{f.name}: checkpoint={getattr(saved, f.name)!r} "
            f"current={getattr(self.config, f.name)!r}"
            for f in dataclasses.fields(self.config)
            if getattr(saved, f.name) != getattr(self.config, f.name)]
        return ("The checkpoint directory's config.json does not match "
                "the current DetectorConfig — differing fields: "
                + "; ".join(diffs)
                + ". Load the run's own config (config.load_configs) or "
                "pass the matching preset/overrides.")

    def _global_scalar(self, value: float) -> jnp.ndarray:
        """fp32 scalar for the checkpoint tree: plain on one process, a
        replicated GLOBAL array on a multi-process mesh (orbax cannot
        serialize host-local single-device arrays in a multi-host save —
        every leaf must be a global jax.Array there)."""
        if self.mesh is None or jax.process_count() == 1:
            return jnp.float32(value)
        return jax.make_array_from_process_local_data(
            mesh_lib.replicated(self.mesh),
            np.asarray(value, np.float32))

    def _save_dataset_state(self, ckpt_path: str) -> None:
        """Persist the input-stream position NEXT TO the model checkpoint.

        A sidecar ``<name>.dataset.json`` (not inside the checkpoint
        directory — orbax owns that path: async saves land via an atomic
        temp-dir rename that would drop a foreign file). Written
        synchronously; it is a few bytes. Without this, the
        ResumableDataset position tracked by ``_device_prefetch`` dies
        with the process and a resumed run replays data from scratch —
        the exact behaviour ResumableDataset exists to prevent."""
        sidecar = ckpt_path + ".dataset.json"
        if self.dataset_resume_state is None:
            # A stale sidecar from a previous run under the same name
            # must not resurrect as this run's input position.
            if os.path.exists(sidecar):
                os.remove(sidecar)
            return
        tmp = sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.dataset_resume_state, f)
        os.replace(tmp, sidecar)

    def save_rolling(self, state: TrainState) -> str:
        """Step-stamped checkpoint + GC to the newest ``keep_checkpoints``.

        With async checkpointing the newest write may still be in flight;
        pruning only ever removes OLDER step directories, so the pending
        write is never touched.
        """
        step = int(state["step"])
        name = ckpt_lib.step_checkpoint_name(step)
        self.save(state, name=name)
        if self.keep_checkpoints and jax.process_index() == 0:
            # pending_step: with async checkpointing the save above is
            # still in flight (invisible to the directory listing) but
            # must occupy one of the keep slots.
            ckpt_lib.prune_checkpoints(
                self.checkpoint_dir, self.keep_checkpoints,
                pending_step=step if self._async_ckpt is not None
                else None)
        return os.path.join(self.checkpoint_dir, name)

    def restore_latest(self, state: TrainState) -> TrainState:
        """Resume from the newest *readable* step-stamped checkpoint.

        A crash mid-write (async or not) can leave the newest ``step_*``
        directory partial; instead of failing hard, walk backwards through
        older step checkpoints and finally "ongoing" (ADVICE round 2).
        """
        candidates = [os.path.basename(path) for _, path in
                      reversed(ckpt_lib.list_step_checkpoints(
                          self.checkpoint_dir))]
        candidates.append("ongoing")
        last_error: Exception | None = None
        for name in candidates:
            if name != "ongoing" and not os.path.isdir(
                    os.path.join(self.checkpoint_dir, name)):
                continue
            try:
                restored = self.restore(state, name=name)
            except Exception as exc:  # partial/corrupt write — try older
                last_error = exc
                # logger, not print: CLI consumers parse stdout as JSON.
                logging.getLogger(__name__).warning(
                    "restore_latest: checkpoint %r unreadable (%s); "
                    "trying an older one.", name, exc)
                continue
            return restored
        raise last_error  # every candidate (incl. "ongoing") failed

    def _check_weights(self, params, epoch: int) -> Dict[str, float]:
        """CheckModelWeight semantics (vtd.py:663-687): report when the
        max/min weight passes the previous watermark."""
        from ..utils.debugging import param_extrema

        minima, maxima = param_extrema(params)
        logger = logging.getLogger(__name__)
        if maxima > self._weight_watermarks[1]:
            self._weight_watermarks[1] = maxima
            logger.info("Largest_weight changed to: %.3f, at epoch %d.",
                        maxima, epoch)
        elif minima < self._weight_watermarks[0]:
            self._weight_watermarks[0] = minima
            logger.info("Smallest_weight changed to: %.3f, at epoch %d.",
                        minima, epoch)
        return {"min_weight": minima, "max_weight": maxima}

    def wait_for_checkpoints(self) -> None:
        """Join pending async checkpoint writes (fit() does this on exit;
        call it after explicit save() calls before reading the files)."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    def restore(self, state: TrainState, name: str = "ongoing") -> TrainState:
        path = os.path.join(self.checkpoint_dir, name)
        template = {"params": state["params"],
                    "opt_state": state["opt_state"],
                    "step": state["step"],
                    "best_ap": self._global_scalar(0.0)}
        try:
            if self._async_ckpt is not None:
                restored = self._async_ckpt.restore(path, template)
            else:
                restored = ckpt_lib.restore_checkpoint(path, template)
        except Exception as exc:
            hint = self._config_mismatch_hint()
            if hint:
                raise ValueError(f"{exc}\n{hint}") from exc
            raise
        self.best_ap = float(restored.pop("best_ap"))
        restored["step"] = jnp.asarray(restored["step"], jnp.int32)
        # Input-stream position travels with the model checkpoint (only
        # read once the tree restore SUCCEEDED — restore_latest probes
        # partial checkpoints, whose sidecar must not leak in). The
        # caller applies it: ``dataset.set_state(trainer.dataset_resume_state)``.
        sidecar = path + ".dataset.json"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                self.dataset_resume_state = json.load(f)
        return restored
