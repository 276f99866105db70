"""Training-loop tests: loss decreases on a tiny overfit run, weight clip,
LR schedule boundaries, checkpoint round-trip, eval mAP path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_transformer_detector.config import (
    DetectorConfig, LossConfig, TrainConfig)
from vision_transformer_detector.train.optimizer import (
    clip_weights, make_lr_schedule, make_optimizer)
from vision_transformer_detector.train.trainer import (
    Trainer, create_train_state, evaluate_map, make_eval_step,
    make_train_step)

TINY = DetectorConfig(
    image_size=(34, 34), embedding_dim=8, num_heads=2, key_dim=4,
    encoder_blocks=1, encoder_mlp_layers=2, head_last_units=8, head_layers=1)
LOSS = LossConfig()
TC = TrainConfig(learning_rate=1e-3)


def _batch(batch_size=2):
    rng = np.random.default_rng(0)
    h, w = TINY.image_size
    images = rng.uniform(-1, 1, (batch_size, h, w, 3)).astype(np.float32)
    labels = np.full((batch_size, TINY.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    labels[0, 0] = (1, 5, 17.0, 17.0, 10.0, 10.0)
    labels[1, 0] = (1, 40, 10.0, 20.0, 8.0, 12.0)
    return jnp.asarray(images), jnp.asarray(labels)


def test_train_step_reduces_loss():
    # lr matches the reference's measured 8e-5 (ipynb cell 7); the class
    # term (9*err)^2 makes larger rates diverge on a fresh tiny model.
    tc = TrainConfig(learning_rate=8e-5)
    optimizer = make_optimizer(tc)
    state = create_train_state(jax.random.PRNGKey(0), TINY, optimizer)
    train_step = make_train_step(TINY, LOSS, optimizer, donate=False)
    images, labels = _batch()
    rng = jax.random.PRNGKey(1)
    losses = []
    for _ in range(60):
        state, loss = train_step(state, images, labels, rng)
        losses.append(float(loss))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert int(state["step"]) == 60


def test_weight_clip_applied():
    params = {"kernel": jnp.asarray([np.nan, 100.0, -100.0, 3.0])}
    clipped = clip_weights(params, 10.0)["kernel"]
    np.testing.assert_array_equal(np.asarray(clipped), [1.0, 10.0, -10.0, 3.0])


def test_lr_schedule_boundaries():
    tc = TrainConfig(learning_rate=1e-3, epochs_first_lr_decay=10,
                     epochs_second_lr_decay=20, epochs_third_lr_decay=30,
                     rate_lr_decay=0.1, allowed_decay_times=3)
    schedule = make_lr_schedule(tc)
    assert float(schedule(0)) == pytest.approx(1e-3)
    assert float(schedule(10)) == pytest.approx(1e-4)
    assert float(schedule(30)) == pytest.approx(1e-5)   # 10 + 20
    assert float(schedule(60)) == pytest.approx(1e-6)   # 10 + 20 + 30
    assert float(schedule(1000)) == pytest.approx(1e-6)


def test_lr_schedule_allowed_decay_times():
    tc = TrainConfig(learning_rate=1e-3, epochs_first_lr_decay=10,
                     epochs_second_lr_decay=20, epochs_third_lr_decay=30,
                     allowed_decay_times=1)
    schedule = make_lr_schedule(tc)
    assert float(schedule(10)) == pytest.approx(1e-4)
    assert float(schedule(60)) == pytest.approx(1e-4)  # no further decay


def test_eval_and_metric_path():
    optimizer = make_optimizer(TC)
    state = create_train_state(jax.random.PRNGKey(0), TINY, optimizer)
    images, labels = _batch()
    ap = evaluate_map(state["params"], [(images, labels)], TINY)
    assert 0.0 <= ap <= 1.0


def test_uint8_batch_accepted():
    eval_step = make_eval_step(TINY)
    optimizer = make_optimizer(TC)
    state = create_train_state(jax.random.PRNGKey(0), TINY, optimizer)
    h, w = TINY.image_size
    uint8_images = jnp.zeros((1, h, w, 3), jnp.uint8)
    decoded = eval_step(state["params"], uint8_images)
    assert bool(jnp.all(jnp.isfinite(decoded)))


def test_device_normalize_within_one_ulp_of_host():
    """The documented contract of the uint8 ingest path (CLI datasets,
    protocol eval): the jitted _maybe_normalize may compile /127.5 as
    multiply-by-reciprocal, so device inputs can differ from
    pipeline.normalize_image by at most 1 ulp of [-1,1] (1.2e-7) —
    never more."""
    from vision_transformer_detector.data.pipeline import (
        normalize_image)
    from vision_transformer_detector.train.trainer import (
        _maybe_normalize)

    every_byte = np.arange(256, dtype=np.uint8)
    host = normalize_image(every_byte)
    device = np.asarray(jax.jit(_maybe_normalize)(jnp.asarray(every_byte)))
    assert device.dtype == np.float32
    np.testing.assert_allclose(device, host, atol=1.2e-7, rtol=0.0)


def test_checkpoint_roundtrip(tmp_path):
    trainer = Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    trainer.best_ap = 0.5
    trainer.save(state, name="ongoing")
    template = trainer.init_state(seed=123)
    restored = trainer.restore(template, name="ongoing")
    assert trainer.best_ap == pytest.approx(0.5)
    orig = jax.tree_util.tree_leaves(state["params"])
    rest = jax.tree_util.tree_leaves(restored["params"])
    for a, b in zip(orig, rest):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_trainer_fit_smoke(tmp_path):
    trainer = Trainer(
        TINY, LOSS,
        TrainConfig(learning_rate=1e-3, epochs_warm_up=0, skip_epochs=1),
        checkpoint_dir=str(tmp_path),
        metrics_path=str(tmp_path / "metrics.jsonl"))
    state = trainer.init_state()
    images, labels = _batch()
    data = [(np.asarray(images), np.asarray(labels))]
    state = trainer.fit(state, data, epochs=3, eval_data=data)
    assert len(trainer.loss_record) == 3
    assert len(trainer.ap_record) == 3
    assert (tmp_path / "metrics.jsonl").exists()


def _two_batch_data():
    images1, labels1 = _batch()
    rng = np.random.default_rng(3)
    h, w = TINY.image_size
    images2 = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    labels2 = np.full((2, TINY.max_objects, 6), -8.0, np.float32)
    labels2[..., 0] = 0.0
    labels2[0, 0] = (1, 12, 20.0, 12.0, 6.0, 9.0)
    return [(np.asarray(images1), np.asarray(labels1)),
            (images2, labels2)]


@pytest.mark.parametrize("dropout,use_mesh", [
    (None, False), (0.25, False),
    # Mesh branch of _fit_scanned: the stacked batches are resharded to
    # P(None, 'data') and the scan runs under the mesh (round-3 advisor
    # finding: this path was CLI-reachable but untested).
    (None, True), (0.25, True),
])
def test_fit_scanned_matches_loop(tmp_path, dropout, use_mesh):
    """epochs_per_call > 1 (the device-resident lax.scan window) must be
    observably identical to the per-epoch loop: same rng split chain ->
    same per-epoch losses (exactly so with dropout active), same eval
    cadence, same final params."""
    config = TINY.replace(dropout=dropout) if dropout else TINY
    data = _two_batch_data()
    eval_data = [data[0]]
    mesh = None
    if use_mesh:
        from vision_transformer_detector.parallel.mesh import create_mesh
        mesh = create_mesh(data=2, model=1, devices=jax.devices()[:2])

    def run(epochs_per_call, tag):
        trainer = Trainer(
            config, LOSS,
            TrainConfig(learning_rate=1e-3, epochs_warm_up=2,
                        skip_epochs=3),
            mesh=mesh,
            checkpoint_dir=str(tmp_path / tag),
            metrics_path=str(tmp_path / f"{tag}.jsonl"))
        state = trainer.init_state()
        state = trainer.fit(state, data, epochs=7, eval_data=eval_data,
                            epochs_per_call=epochs_per_call)
        return trainer, state

    t_loop, s_loop = run(1, "loop")
    t_scan, s_scan = run(4, "scan")  # does not divide the cadence: windows
    # must still end exactly at eval epochs 2, 5 and ckpt epochs 0, 3, 6
    np.testing.assert_allclose(t_loop.loss_record, t_scan.loss_record,
                               rtol=2e-5, atol=1e-6)
    assert len(t_scan.loss_record) == 7
    assert t_scan.ap_record == pytest.approx(t_loop.ap_record)
    assert len(t_scan.ap_record) == 2  # epochs 2 and 5
    for a, b in zip(jax.tree_util.tree_leaves(s_loop["params"]),
                    jax.tree_util.tree_leaves(s_scan["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    assert int(s_scan["step"]) == 7 * len(data)
    # metrics jsonl carries one record per epoch either way
    assert sum(1 for _ in open(tmp_path / "scan.jsonl")) == 7
    # the periodic "ongoing" checkpoint exists (epoch 0/3/6 cadence)
    assert (tmp_path / "scan" / "ongoing").is_dir()


def test_fit_scanned_rejects_streaming_dataset():
    trainer = Trainer(TINY, LOSS, TC)
    state = trainer.init_state()

    def gen():
        yield _batch()

    with pytest.raises(ValueError, match="materialized"):
        trainer.fit(state, gen(), epochs=2, epochs_per_call=2)


def test_fit_rejects_exhausted_generator():
    """A one-shot generator passed as train_data yields zero batches from
    epoch 2 on; the trainer must raise a descriptive error instead of an
    opaque jnp.stack([]) failure (round-1 advisor finding)."""
    trainer = Trainer(TINY, LOSS, TC)
    state = trainer.init_state()
    one_shot = iter([_batch()])
    with pytest.raises(ValueError, match="re-iterable"):
        trainer.fit(state, one_shot, epochs=2)


def test_async_checkpointing_roundtrip(tmp_path):
    """Async orbax saves overlap training and resume exactly (ROADMAP
    round-2 item): train with async_checkpointing=True, restore, and the
    restored state must equal the live one."""
    trainer = Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path / "ck"),
                      async_checkpointing=True)
    state = trainer.init_state()
    data = [_batch()]
    trainer.best_ap = 0.25
    state = trainer.fit(state, data, epochs=2)
    trainer.save(state, name="ongoing")   # non-blocking
    trainer.wait_for_checkpoints()

    trainer2 = Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path / "ck"),
                       async_checkpointing=True)
    fresh = trainer2.init_state()
    restored = trainer2.restore(fresh, name="ongoing")
    assert int(restored["step"]) == int(state["step"]) == 2
    assert trainer2.best_ap == pytest.approx(0.25)
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(state["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_check_weights_cadence(tmp_path, caplog):
    """The CheckModelWeight twin (vtd.py:650-687): on the configured
    cadence the params are scanned, extrema land in the metrics record,
    and new watermarks are reported (via logging, not stdout — CLI
    consumers parse stdout as JSON)."""
    import json as _json
    import logging

    metrics = str(tmp_path / "m.jsonl")
    trainer = Trainer(TINY, LOSS, TC, metrics_path=metrics,
                      check_weights_every=2, check_weights_start=1,
                      weight_threshold=0.0)
    state = trainer.init_state()
    with caplog.at_level(logging.INFO,
                         logger="vision_transformer_detector.train"
                                ".trainer"):
        trainer.fit(state, [_batch()], epochs=4)
    assert any("Largest_weight changed to:" in r.message
               for r in caplog.records)
    with open(metrics) as f:
        records = [_json.loads(line) for line in f]
    checked = [r for r in records if "max_weight" in r]
    assert [r["epoch"] for r in checked] == [1, 3]
    assert all(np.isfinite(r["max_weight"]) for r in checked)


@pytest.mark.slow
def test_gradient_accumulation():
    """Two properties of accumulate_steps=k:

    1. micro-gradients decompose: the average of the k micro-batch
       gradients equals the big-batch gradient (requires equal positive
       counts per micro-batch — the loss's mean-over-positives terms,
       ops/loss.py, only decompose then);
    2. optax.MultiSteps holds params frozen for k-1 micro steps and
       applies one real update on the k-th.

    (Exact param equality with the big-batch Adam step is NOT asserted:
    Adam's first-step update is ~lr*sign(g), which amplifies fp noise on
    near-zero gradient elements.)
    """
    from vision_transformer_detector.models.vit_detector import forward
    from vision_transformer_detector.ops.loss import detection_loss

    rng_np = np.random.default_rng(0)
    h, w = TINY.image_size
    big_images = jnp.asarray(
        rng_np.uniform(-1, 1, (4, h, w, 3)).astype(np.float32))
    labels = np.full((4, TINY.max_objects, 6), -8.0, np.float32)
    labels[..., 0] = 0.0
    for i in range(4):  # one positive per image -> decomposable means
        labels[i, 0] = (1, 5 + i, 17.0, 17.0, 10.0, 10.0)
    big_labels = jnp.asarray(labels)

    opt = make_optimizer(TrainConfig(learning_rate=1e-3))
    state = create_train_state(jax.random.PRNGKey(0), TINY, opt)

    def loss_fn(p, im, lb):
        return detection_loss(lb, forward(p, im, TINY), TINY, LOSS)

    g_big = jax.grad(loss_fn)(state["params"], big_images, big_labels)
    g1 = jax.grad(loss_fn)(state["params"], big_images[:2], big_labels[:2])
    g2 = jax.grad(loss_fn)(state["params"], big_images[2:], big_labels[2:])
    for a, b1, b2 in zip(jax.tree_util.tree_leaves(g_big),
                         jax.tree_util.tree_leaves(g1),
                         jax.tree_util.tree_leaves(g2)):
        avg = (np.asarray(b1) + np.asarray(b2)) / 2
        scale = max(1.0, float(np.max(np.abs(np.asarray(a)))))
        np.testing.assert_allclose(avg, np.asarray(a), atol=2e-4 * scale)

    # MultiSteps cadence: no param change after micro step 1, change
    # after micro step 2.
    opt_acc = make_optimizer(
        TrainConfig(learning_rate=1e-3, accumulate_steps=2))
    state_acc = create_train_state(jax.random.PRNGKey(0), TINY, opt_acc)
    step_acc = make_train_step(TINY, LOSS, opt_acc, donate=False)
    rng = jax.random.PRNGKey(1)
    before = jax.tree_util.tree_leaves(state_acc["params"])
    state_acc, _ = step_acc(state_acc, big_images[:2], big_labels[:2], rng)
    mid = jax.tree_util.tree_leaves(state_acc["params"])
    for a, b in zip(before, mid):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    state_acc, _ = step_acc(state_acc, big_images[2:], big_labels[2:], rng)
    after = jax.tree_util.tree_leaves(state_acc["params"])
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(mid, after))


def test_config_travels_with_checkpoint(tmp_path):
    """Trainer.save writes config.json; loading it reconstructs the exact
    config triple (tuples restored from JSON lists)."""
    from vision_transformer_detector.config import load_configs

    cfg = TINY.replace(head_scales=(1, 2))
    trainer = Trainer(cfg, LOSS, TC, checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    trainer.save(state, name="ongoing")
    det, loss, train = load_configs(str(tmp_path / "config.json"))
    assert det == cfg
    assert loss == LOSS
    assert train == TC
    # Round-tripped config drives the model (hashable, jit-static).
    from vision_transformer_detector.models.vit_detector import forward
    h, w = det.image_size
    out = forward(state["params"], jnp.zeros((1, h, w, 3)), det)
    assert out.shape == (1, det.max_objects, 6)


def test_rolling_checkpoints_keep_last_k(tmp_path):
    """keep_checkpoints=k: step-stamped history is bounded, named
    checkpoints survive GC, and restore_latest resumes the newest step."""
    from vision_transformer_detector.utils import checkpoint as ckpt_lib

    trainer = Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path),
                      keep_checkpoints=2)
    state = trainer.init_state()
    trainer.save(state, name="highest_ap")
    for step in (3, 7, 11):
        state["step"] = jnp.asarray(step, jnp.int32)
        trainer.save_rolling(state)

    kept = ckpt_lib.list_step_checkpoints(str(tmp_path))
    assert [s for s, _ in kept] == [7, 11]
    assert (tmp_path / "highest_ap").exists()  # never pruned

    restored = trainer.restore_latest(trainer.init_state(seed=9))
    assert int(restored["step"]) == 11
    orig = jax.tree_util.tree_leaves(state["params"])
    rest = jax.tree_util.tree_leaves(restored["params"])
    for a, b in zip(orig, rest):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_latest_falls_back_to_ongoing(tmp_path):
    trainer = Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    state["step"] = jnp.asarray(5, jnp.int32)
    trainer.save(state, name="ongoing")
    restored = trainer.restore_latest(trainer.init_state(seed=9))
    assert int(restored["step"]) == 5


def test_restore_latest_skips_partial_checkpoint(tmp_path):
    """A crash mid-write leaves the newest step_* directory partial;
    restore_latest must fall back to the next-newest intact checkpoint
    instead of failing hard (ADVICE round 2)."""
    import shutil

    from vision_transformer_detector.utils import checkpoint as ckpt_lib

    trainer = Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    state["step"] = jnp.asarray(3, jnp.int32)
    trainer.save_rolling(state)

    # Simulate a torn write of a newer step: directory exists, contents
    # truncated to nothing.
    torn = tmp_path / ckpt_lib.step_checkpoint_name(9)
    torn.mkdir()
    (torn / "junk").write_text("not a checkpoint")

    restored = trainer.restore_latest(trainer.init_state(seed=9))
    assert int(restored["step"]) == 3

    # With every step checkpoint torn, 'ongoing' is the last resort.
    state["step"] = jnp.asarray(4, jnp.int32)
    trainer.save(state, name="ongoing")
    shutil.rmtree(tmp_path / ckpt_lib.step_checkpoint_name(3))
    (tmp_path / ckpt_lib.step_checkpoint_name(3)).mkdir()
    restored = trainer.restore_latest(trainer.init_state(seed=9))
    assert int(restored["step"]) == 4


def test_bf16_adam_moments_track_fp32_dynamics():
    """Reduced-precision Adam moment state (TrainConfig.adam_mu_dtype /
    adam_nu_dtype): updates computed in fp32, state rounded to bf16 —
    training must track the fp32 optimizer closely on a short overfit.
    VERDICT r2 next-step #3."""
    images, labels = _batch()
    rng = jax.random.PRNGKey(0)
    losses = {}
    for name, tc in (("fp32", TC),
                     ("mu", dataclasses.replace(TC, adam_mu_dtype="bfloat16")),
                     ("munu", dataclasses.replace(
                         TC, adam_mu_dtype="bfloat16",
                         adam_nu_dtype="bfloat16"))):
        optimizer = make_optimizer(tc)
        state = create_train_state(jax.random.PRNGKey(1), TINY, optimizer)
        step = make_train_step(TINY, LOSS, optimizer, donate=False)
        trace = []
        for _ in range(12):
            state, loss = step(state, images, labels, rng)
            trace.append(float(loss))
        losses[name] = trace
        assert all(np.isfinite(trace)), name
        assert trace[-1] < trace[0], (name, trace)
    # bf16 state must not change the trajectory materially over a short
    # horizon (all arithmetic fp32; only state storage is rounded).
    for name in ("mu", "munu"):
        rel = abs(losses[name][-1] - losses["fp32"][-1]) / losses["fp32"][-1]
        assert rel < 0.02, (name, losses)


def test_bf16_moment_state_dtypes_and_checkpoint(tmp_path):
    """The compact Adam state really is bf16, and it round-trips through
    the checkpoint machinery."""
    tc = dataclasses.replace(TC, adam_mu_dtype="bfloat16",
                             adam_nu_dtype="bfloat16")
    trainer = Trainer(TINY, LOSS, tc, checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    leaves = jax.tree_util.tree_leaves(state["opt_state"])
    dtypes = {str(l.dtype) for l in leaves if hasattr(l, "dtype")
              and l.ndim > 0}
    assert "bfloat16" in dtypes
    images, labels = _batch()
    state, _ = trainer.train_step(state, images, labels,
                                  jax.random.PRNGKey(0))
    trainer.save(state, name="ongoing")
    restored = trainer.restore(trainer.init_state(seed=9), name="ongoing")
    for a, b in zip(jax.tree_util.tree_leaves(state["opt_state"]),
                    jax.tree_util.tree_leaves(restored["opt_state"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_nu_stochastic_rounding_escapes_absorption():
    """nu's per-step change (0.1%) is below bf16's ulp (~0.4%):
    round-to-nearest freezes it forever, stochastic rounding tracks the
    target in expectation (code-review round-3 finding)."""
    import optax

    from vision_transformer_detector.train.optimizer import (
        scale_by_adam_compact)

    g = {"w": jnp.full((512,), jnp.sqrt(2.0))}   # g^2 = 2.0
    results = {}
    for sr in (False, True):
        tx = scale_by_adam_compact(stochastic_rounding=sr)
        state = tx.init({"w": jnp.zeros((512,))})
        # Seed nu at 1.0: the target shifts to 2.0 but each step only
        # moves it 0.1% — sub-ulp in bf16.
        state = optax.ScaleByAdamState(
            count=state.count, mu=state.mu,
            nu={"w": jnp.ones((512,), jnp.bfloat16)})
        step = jax.jit(tx.update)
        for _ in range(1500):
            _, state = step(g, state)
        results[sr] = float(
            np.asarray(state.nu["w"], np.float32).mean())
    assert results[False] == 1.0, results      # frozen by absorption
    # b2=0.999 over 1500 steps: exact fp32 nu would be
    # 2 - 1*0.999^1500 ~= 1.78; SR must track it closely in the mean.
    assert 1.6 < results[True] < 2.0, results


def test_stochastic_rounding_is_deterministic_per_step():
    """Counter-based bits: same state + grads -> identical rounded nu
    (replay/restore safety)."""
    from vision_transformer_detector.train.optimizer import (
        scale_by_adam_compact)

    tx = scale_by_adam_compact()
    g = {"w": jnp.linspace(0.1, 2.0, 64)}
    s1 = tx.init({"w": jnp.zeros((64,))})
    s2 = tx.init({"w": jnp.zeros((64,))})
    for _ in range(5):
        _, s1 = tx.update(g, s1)
        _, s2 = tx.update(g, s2)
    np.testing.assert_array_equal(np.asarray(s1.nu["w"], np.float32),
                                  np.asarray(s2.nu["w"], np.float32))


def test_train_flash_override_is_train_only():
    """config.train_use_flash_attention flips the TRAIN step's attention
    path (loss matches the einsum step to kernel tolerance) while the
    eval/inference path is untouched (bit-identical decoded outputs)."""
    optimizer = make_optimizer(TC)
    flash_cfg = dataclasses.replace(TINY, train_use_flash_attention=True)
    images, labels = _batch()
    rng = jax.random.PRNGKey(1)

    losses = {}
    for name, cfg in (("einsum", TINY), ("flash", flash_cfg)):
        state = create_train_state(jax.random.PRNGKey(0), cfg, optimizer)
        step = make_train_step(cfg, LOSS, optimizer, donate=False)
        _, loss = step(state, images, labels, rng)
        losses[name] = float(loss)
    assert losses["flash"] == pytest.approx(losses["einsum"], rel=1e-4)

    state = create_train_state(jax.random.PRNGKey(0), TINY,
                               optimizer)
    eval_einsum = make_eval_step(TINY)(state["params"], images)
    eval_flash = make_eval_step(flash_cfg)(state["params"], images)
    np.testing.assert_array_equal(np.asarray(eval_einsum),
                                  np.asarray(eval_flash))


class _StatefulBatches:
    """Duck-typed ResumableDataset: synthetic batches + get/set_state,
    mirroring data/pipeline.py state semantics (batch counts consumed;
    end of epoch rolls epoch+=1, batch=0)."""

    def __init__(self, n_batches=3):
        self.n = n_batches
        self.epoch = 0
        self.batch = 0

    def get_state(self):
        return {"epoch": self.epoch, "batch": self.batch, "seed": 0}

    def set_state(self, state):
        self.epoch = int(state["epoch"])
        self.batch = int(state["batch"])

    def __len__(self):
        return self.n

    def __iter__(self):
        if self.batch >= self.n:
            self.epoch += 1
            self.batch = 0
        while self.batch < self.n:
            self.batch += 1
            yield _batch()
        self.epoch += 1
        self.batch = 0


def test_dataset_state_persists_with_checkpoint(tmp_path):
    """The input-stream position saves as a sidecar next to the model
    checkpoint and restore() loads it back — a resumed run continues the
    data stream instead of replaying it from scratch."""
    import json as _json
    import os as _os

    tc = dataclasses.replace(TC, skip_epochs=1, epochs_warm_up=0)
    trainer = Trainer(TINY, LOSS, tc, checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    ds = _StatefulBatches(n_batches=3)
    trainer.fit(state, ds, epochs=1)

    sidecar = tmp_path / "ongoing.dataset.json"
    assert sidecar.exists()
    saved = _json.loads(sidecar.read_text())
    # End of epoch 0: all 3 batches consumed.
    assert saved == {"epoch": 0, "batch": 3, "seed": 0}

    fresh = Trainer(TINY, LOSS, tc, checkpoint_dir=str(tmp_path))
    assert fresh.dataset_resume_state is None
    fresh.restore(fresh.init_state(seed=9), name="ongoing")
    assert fresh.dataset_resume_state == saved
    # Applying it rewinds a new stream to the exact next batch.
    ds2 = _StatefulBatches(n_batches=3)
    ds2.set_state(fresh.dataset_resume_state)
    first_epoch_batches = list(ds2)
    assert len(first_epoch_batches) == 3      # rolls into epoch 1
    assert ds2.epoch == 2


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_dataset_sidecar_gc_and_staleness(tmp_path, async_ckpt):
    """Rolling GC removes pruned checkpoints' sidecars; a save with no
    dataset state clears a stale same-name sidecar. Same behaviour with
    async checkpointing (the sidecar write is synchronous either way)."""
    from vision_transformer_detector.utils import checkpoint as ckpt_lib

    trainer = Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path),
                      keep_checkpoints=2, async_checkpointing=async_ckpt)
    state = trainer.init_state()
    for step in (3, 7, 11):
        state["step"] = jnp.asarray(step, jnp.int32)
        trainer.dataset_resume_state = {"epoch": 0, "batch": step,
                                        "seed": 0}
        trainer.save_rolling(state)
        # Async: join the pending write so each save_rolling's GC sees
        # the materialized directory (pruning is defined over
        # materialized checkpoints only).
        trainer.wait_for_checkpoints()

    names = {p.name for p in tmp_path.iterdir()}
    kept = {ckpt_lib.step_checkpoint_name(s) for s in (7, 11)}
    assert kept <= names
    assert {n + ".dataset.json" for n in kept} <= names
    doomed = ckpt_lib.step_checkpoint_name(3)
    assert doomed not in names
    assert doomed + ".dataset.json" not in names

    # Same trainer, state cleared (e.g. switched to a materialized list):
    # overwriting "ongoing" must not leave last run's sidecar behind.
    trainer.save(state, name="ongoing")
    assert (tmp_path / "ongoing.dataset.json").exists()
    trainer.dataset_resume_state = None
    trainer.save(state, name="ongoing")
    assert not (tmp_path / "ongoing.dataset.json").exists()


def test_restore_mismatch_names_the_config_diff(tmp_path):
    """Restoring with the wrong DetectorConfig fails with the differing
    fields named (the raw orbax shape error doesn't say why)."""
    trainer = Trainer(TINY, LOSS, TC, checkpoint_dir=str(tmp_path))
    trainer.save(trainer.init_state(), "ongoing")

    other = dataclasses.replace(TINY, embedding_dim=16)
    t2 = Trainer(other, LOSS, TC, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="embedding_dim: checkpoint=8"):
        t2.restore(t2.init_state(), "ongoing")


def test_lr_schedule_accumulation_counts_optimizer_steps():
    """optax.MultiSteps advances the inner schedule once per k
    micro-batches; boundaries must be quantized to OPTIMIZER steps or
    every decay lands k x too many epochs late (round-4 review)."""
    tc = TrainConfig(learning_rate=1e-3, epochs_first_lr_decay=10,
                     epochs_second_lr_decay=20, epochs_third_lr_decay=30,
                     rate_lr_decay=0.1, accumulate_steps=4)
    # 100 micro-batches/epoch, k=4 -> 25 optimizer steps per epoch.
    schedule = make_lr_schedule(tc, steps_per_epoch=100, every_k=4)
    assert float(schedule(10 * 25 - 1)) == pytest.approx(1e-3)
    assert float(schedule(10 * 25)) == pytest.approx(1e-4)
    assert float(schedule(30 * 25)) == pytest.approx(1e-5)
    # make_optimizer wires every_k from the config itself.
    from vision_transformer_detector.train.optimizer import (
        make_lr_schedule as mk)
    direct = mk(tc, steps_per_epoch=100, every_k=tc.accumulate_steps)
    assert float(direct(250)) == float(schedule(250))


def test_lr_schedule_zero_length_interval_matches_reference():
    """vtd.py:716-727: coincident boundaries decay ONCE at that epoch
    and the unconsumed budget unit carries to the next DISTINCT
    boundary (the old dict comprehension silently dropped a decay and
    the truncation consumed budget on the duplicate)."""
    tc = TrainConfig(learning_rate=1e-3, epochs_first_lr_decay=10,
                     epochs_second_lr_decay=0, epochs_third_lr_decay=30,
                     rate_lr_decay=0.1, allowed_decay_times=2)
    schedule = make_lr_schedule(tc)
    assert float(schedule(10)) == pytest.approx(1e-4)   # one decay at 10
    assert float(schedule(40)) == pytest.approx(1e-5)   # budget carried

    from vision_transformer_detector.api import learning_rate_step_decay
    lr = 1e-3
    seen = []
    for epoch in range(50):
        lr = learning_rate_step_decay(epoch, lr, 10, 0, 30, 0.1,
                                      allowed_decay_times=2)
        seen.append(lr)
    assert seen[10] == pytest.approx(1e-4)
    assert seen[40] == pytest.approx(1e-5)


def test_trainer_skip_epochs_zero_disables_periodic(tmp_path):
    """skip_epochs=0 disables the periodic eval/checkpoint cadence
    instead of ZeroDivisionError-ing mid-training; the final-epoch
    checkpoint still fires."""
    import os

    tc = TrainConfig(learning_rate=1e-4, skip_epochs=0, epochs_warm_up=0)
    trainer = Trainer(TINY, LOSS, tc, checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    images, labels = _batch()
    state = trainer.fit(state, [(images, labels)], epochs=2,
                        eval_data=[(images, labels)])
    assert int(state["step"]) == 2
    assert trainer.best_ap == 0.0, "periodic eval disabled"
    assert os.listdir(str(tmp_path)), "final-epoch checkpoint written"


def test_fit_scanned_ragged_batches_diagnosed():
    """epochs_per_call > 1 with ragged batch shapes raises an actionable
    error, not jnp.stack's opaque shape mismatch."""
    trainer = Trainer(TINY, LOSS, TC)
    state = trainer.init_state()
    images, labels = _batch()
    data = [(images, labels), (images[:1], labels[:1])]
    with pytest.raises(ValueError, match="uniform batch shapes"):
        trainer.fit(state, data, epochs=4, epochs_per_call=2)


def test_host_and_device_class_confidence_agree():
    """metrics._class_confidence (the host twin used by both scorers)
    matches ops.decode.classification_confidence bit-for-bit in fp32."""
    from vision_transformer_detector.metrics.mean_average_precision \
        import _class_confidence
    from vision_transformer_detector.ops.decode import (
        classification_confidence)

    v = np.linspace(-1.0, 80.0, 971, dtype=np.float32)
    np.testing.assert_array_equal(
        _class_confidence(v), np.asarray(classification_confidence(v)))
