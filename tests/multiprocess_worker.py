"""Worker for tests/test_multiprocess.py: one REAL jax.distributed process.

Run as:  python multiprocess_worker.py <pid> <nprocs> <port> <out.json>

Each process owns ONE CPU device of an nprocs-device global mesh (true
multi-host SPMD topology, the shape a multi-host GPU job uses — gloo
collectives stand in for NCCL). The worker:

  1. brings up jax.distributed (parallel.data.initialize_distributed),
  2. builds the trainer state as GLOBAL arrays (Trainer.init_state's
     multi-process path),
  3. assembles global batches from process-LOCAL shards
     (parallel.data.global_batch_from_local via Trainer._put_batch),
  4. runs two DP train steps whose gradient psum crosses the process
     boundary,
  5. computes the same two steps single-device on the full batch as the
     ground truth, and writes both losses as JSON (process 0).
"""

import json
import os
import sys

import numpy as np


def main() -> None:
    pid, nprocs, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "dp"
    phase = int(sys.argv[6]) if len(sys.argv) > 6 else 1
    import jax

    jax.config.update("jax_platforms", "cpu")
    # Same persistent compile cache the suite uses (tests/conftest.py):
    # the worker programs repeat across modes/phases/runs.
    from vision_transformer_detector.utils.runtime import (
        enable_compilation_cache)

    enable_compilation_cache()

    if mode == "cli":
        # The CLI owns the jax.distributed bring-up here (--distributed):
        # do NOT initialize in the worker.
        _cli_train_mode(pid, nprocs, port, out_path)
        return

    from vision_transformer_detector.parallel.data import (
        initialize_distributed)

    initialize_distributed(f"127.0.0.1:{port}", nprocs, pid)
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.local_device_count() == 1

    import jax.numpy as jnp

    from vision_transformer_detector.config import (
        DetectorConfig, LossConfig, TrainConfig)
    from vision_transformer_detector.parallel.mesh import create_mesh
    from vision_transformer_detector.train.trainer import (
        Trainer, create_train_state, make_train_step)

    cfg = DetectorConfig(
        image_size=(32, 32), patch_size=16, embedding_dim=8, num_heads=2,
        key_dim=4, encoder_blocks=1, encoder_mlp_layers=2,
        head_last_units=8, head_layers=1)
    tc = TrainConfig(learning_rate=1e-3)

    # Deterministic FULL batch, identical on every process; each process
    # feeds only its contiguous shard (batch 4 = 2 per process).
    rng = np.random.default_rng(0)
    full_images = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    full_labels = np.full((4, cfg.max_objects, 6), -8.0, np.float32)
    full_labels[..., 0] = 0.0
    for i in range(4):
        full_labels[i, 0] = (1, i % 80, 16.0, 16.0, 10.0, 10.0)
    if mode == "input":
        _input_pipeline_mode(pid, nprocs, out_path, jax, jnp)
        return

    if mode in ("dp", "resume"):
        mesh = create_mesh(data=nprocs, model=1)
    elif mode == "dp_tp":  # the pod topology: both axes cross processes
        mesh = create_mesh(data=nprocs // 2, model=2)
    else:  # tp/ring: batch replicated over the model axis, params (tp)
        # or the token axis (ring) sharded.
        mesh = create_mesh(data=1, model=nprocs)
    if mode == "ring":
        # Exact global attention with K/V rotating around the 'model'
        # ring (kernels/ring_attention.py ppermute) — here the ring hop
        # IS the process boundary.
        cfg = cfg.replace(ring_attention=True)

    # Which global-batch rows THIS process must feed is a property of the
    # sharding (mesh device order), not pid arithmetic.
    from vision_transformer_detector.parallel.data import (
        process_batch_indices)
    rows = process_batch_indices(mesh, 4)
    local_images = full_images[rows.start:rows.stop]
    local_labels = full_labels[rows.start:rows.stop]
    trainer = Trainer(cfg, LossConfig(), tc, mesh=mesh)
    state = trainer.init_state()
    # Global arrays: every process sees the full logical shape.
    assert state["params"]["linear_projection"]["kernel"].ndim == 2
    step_rng = jax.random.PRNGKey(7)

    if mode == "resume":
        # Crash-and-resume across process-GROUP generations: phase 1
        # trains and collectively checkpoints; phase 2 is a brand-new
        # jax.distributed group that restores and continues. The
        # combined trajectory must equal 4 uninterrupted single-device
        # steps — the actual pod recovery flow.
        trainer.checkpoint_dir = out_path + ".ckpt"
        if phase == 2:
            state = trainer.restore(state, name="ongoing")
        losses_dist = []
        for _ in range(2):
            images, labels = trainer._put_batch(local_images, local_labels)
            with mesh:
                state, loss = trainer.train_step(state, images, labels,
                                                 step_rng)
            losses_dist.append(float(loss))
        if phase == 1:
            trainer.save(state, name="ongoing")
            result = {"phase1": losses_dist}
        else:
            cfg_ref = cfg
            optimizer = trainer.optimizer
            ref_state = create_train_state(jax.random.PRNGKey(tc.seed),
                                           cfg_ref, optimizer)
            ref_step = make_train_step(cfg_ref, LossConfig(), optimizer,
                                       donate=False)
            singles = []
            for _ in range(4):
                ref_state, loss = ref_step(
                    ref_state, jnp.asarray(full_images),
                    jnp.asarray(full_labels), step_rng)
                singles.append(float(loss))
            result = {"phase2": losses_dist, "single4": singles}
        if pid == 0:
            with open(out_path, "w") as f:
                json.dump(result, f)
        print(f"proc {pid}: {result}", flush=True)
        return

    # Row-ASSIGNMENT check: the training-loss comparison below is
    # permutation-invariant over the batch, so it cannot catch a loader
    # that feeds the right rows into the wrong shard slots (the failure
    # process_batch_indices exists to prevent). An order-weighted sum
    # over the global batch is not.
    images_g, _ = trainer._put_batch(local_images, local_labels)
    weights = jnp.arange(1.0, 5.0, dtype=jnp.float32)
    with mesh:
        got = float(jax.jit(
            lambda a: jnp.einsum("bhwc,b->", a, weights))(images_g))
    want = float(np.einsum("bhwc,b->", full_images,
                           np.arange(1.0, 5.0, dtype=np.float32)))
    assert abs(got - want) <= abs(want) * 1e-5, (got, want)

    ring_has_ppermute = None
    losses_dist = []
    for _ in range(2):
        images, labels = trainer._put_batch(local_images, local_labels)
        assert images.shape[0] == 4, images.shape  # global batch
        if mode == "ring" and ring_has_ppermute is None:
            # The correctness claim below (ring == plain einsum) is only
            # meaningful if the K/V rotation actually compiled in.
            with mesh:
                hlo = trainer.train_step.lower(
                    state, images, labels, step_rng).compile().as_text()
            ring_has_ppermute = "collective-permute" in hlo
        with mesh:
            state, loss = trainer.train_step(state, images, labels,
                                             step_rng)
        losses_dist.append(float(loss))

    # Ground truth: the same two steps, one device, full batch. For the
    # ring mode the reference runs PLAIN einsum attention — ring
    # attention is mathematically exact global attention, so the match
    # is itself the correctness claim.
    cfg_ref = cfg.replace(ring_attention=False) if mode == "ring" else cfg
    optimizer = trainer.optimizer
    ref_state = create_train_state(jax.random.PRNGKey(tc.seed), cfg_ref,
                                   optimizer)
    ref_step = make_train_step(cfg_ref, LossConfig(), optimizer,
                               donate=False)
    losses_single = []
    for _ in range(2):
        ref_state, loss = ref_step(ref_state, jnp.asarray(full_images),
                                   jnp.asarray(full_labels), step_rng)
        losses_single.append(float(loss))

    result = {"dist": losses_dist, "single": losses_single}
    if ring_has_ppermute is not None:
        result["ring_has_ppermute"] = ring_has_ppermute

    if mode == "dp":
        # Multi-process evaluation with UNEVEN per-process shards: the
        # rows-0:2 holder feeds TWO single-image batches, the rows-2:4
        # holder ONE two-image batch — differing batch counts and ragged
        # rounds used to desync the collectives and hang the pod.
        # evaluate_map's mesh path synchronizes+pads the rounds (padded
        # rows are metric no-ops), so the result must equal the
        # single-device evaluation over the same global row order:
        # round 1 assembles [g0, pad, g2, g3], round 2 [g1, pad].
        from vision_transformer_detector.metrics.fast_map import (
            JitMeanAveragePrecision)
        from vision_transformer_detector.train.trainer import (
            evaluate_map, make_eval_step)

        # uint8 stream: the lockstep padder must agree on dtype/layout
        # across processes (an exhausted process pads from the allgathered
        # template, not config-derived float32 defaults).
        u8_images = ((full_images + 1.0) * 127.5).astype(np.uint8)
        if rows.start == 0:
            local_eval = [(u8_images[0:1], full_labels[0:1]),
                          (u8_images[1:2], full_labels[1:2])]
        else:
            local_eval = [(u8_images[2:4], full_labels[2:4])]
        with mesh:
            ap_dist = evaluate_map(
                state["params"], local_eval, cfg,
                trainer.eval_step, JitMeanAveragePrecision(cfg),
                mesh=mesh)
        single_order = [(u8_images[[0, 2, 3]], full_labels[[0, 2, 3]]),
                        (u8_images[[1]], full_labels[[1]])]
        ap_single = evaluate_map(
            ref_state["params"], single_order, cfg,
            make_eval_step(cfg), JitMeanAveragePrecision(cfg))
        result["ap_dist"] = ap_dist
        result["ap_single"] = ap_single

        # One process's shard EMPTY from round 1: it never sees a batch,
        # so its padding layout comes from the allgathered donor row.
        empty_side = [] if rows.start != 0 else [
            (u8_images[0:2], full_labels[0:2])]
        with mesh:
            ap_empty = evaluate_map(
                state["params"], empty_side, cfg,
                trainer.eval_step, JitMeanAveragePrecision(cfg),
                mesh=mesh)
        ap_empty_single = evaluate_map(
            ref_state["params"], [(u8_images[0:2], full_labels[0:2])], cfg,
            make_eval_step(cfg), JitMeanAveragePrecision(cfg))
        result["ap_empty"] = ap_empty
        result["ap_empty_single"] = ap_empty_single

    if mode == "tp":
        # Multi-process checkpoint roundtrip: the orbax save is
        # collective (each process writes its addressable shards of the
        # TP-sharded params); restore into a fresh global template and
        # compare on-device (np.asarray of a non-fully-addressable
        # array is not allowed — reduce to a replicated scalar).
        import tempfile

        ckpt_dir = f"{out_path}.ckpt"
        trainer.checkpoint_dir = ckpt_dir
        trainer.save(state, name="ongoing")
        fresh = trainer.init_state(seed=99)
        restored = trainer.restore(fresh, name="ongoing")

        def sq_diff(a, b):
            return sum(jnp.sum((x - y) ** 2)
                       for x, y in zip(jax.tree_util.tree_leaves(a),
                                       jax.tree_util.tree_leaves(b)))

        with mesh:
            result["ckpt_param_sq_diff"] = float(
                jax.jit(sq_diff)(state["params"], restored["params"]))
            result["fresh_param_sq_diff"] = float(
                jax.jit(sq_diff)(state["params"], fresh["params"]))

    if pid == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    print(f"proc {pid}: {result}", flush=True)




def _cli_train_mode(pid, nprocs, port, out_path) -> None:
    """``cli train --distributed`` end to end: every process runs the
    SAME command line (the pod launch pattern). The CLI brings up
    jax.distributed itself, reads each process's input shard off the
    batch sharding (parallel.data.process_shard_spec), trains with
    cross-process DP, evaluates over lockstep rounds, and saves a
    collective checkpoint. The test asserts both processes report the
    SAME global loss and the checkpoint exists."""
    import contextlib
    import io

    from PIL import Image

    from vision_transformer_detector.cli import main as cli_main

    # Private per-process copy of the SAME deterministic dataset (no
    # cross-process file races). 10 images: training trims to 8 usable
    # (2 shards x batch 2 x 2 batches); eval keeps all shard batches.
    data_dir = f"{out_path}.clidata{pid}"
    images_dir = os.path.join(data_dir, "images")
    os.makedirs(images_dir, exist_ok=True)
    annotations = {}
    for i in range(10):
        Image.fromarray(
            np.full((32, 32, 3), i * 20, np.uint8)).save(
            os.path.join(images_dir, f"{i:012d}.png"))
        annotations[str(i)] = [[1, 16.0, 16.0, 8.0, 8.0, 64.0]]
    ann = os.path.join(data_dir, "ann.json")
    with open(ann, "w") as f:
        json.dump(annotations, f)

    ckpt = out_path + ".clickpt"  # SHARED dir: collective orbax save
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main([
            "train", "--preset", "tiny_96", "--image-size", "32",
            "--train-images", images_dir, "--train-annotations", ann,
            "--val-images", images_dir, "--val-annotations", ann,
            "--epochs", "2", "--epochs-warm-up", "0", "--skip-epochs", "1",
            "--batch-size", "4", "--data-parallel", str(nprocs),
            # --resumable + --shuffle: the checkpointable input stream
            # under real multi-process — per-epoch shuffled shards,
            # equalized lengths, sidecar state beside the checkpoints.
            "--resumable", "--shuffle", "--seed", "5",
            "--distributed", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(nprocs), "--process-id", str(pid),
            "--checkpoint-dir", ckpt,
            "--metrics", out_path + ".metrics.jsonl"])
    result = json.loads(buf.getvalue().strip().splitlines()[-1])

    # `cli evaluate --distributed` from the collective checkpoint: the
    # same process group stays up (bring-up is idempotent per process —
    # _maybe_mesh calls initialize_distributed only once per process
    # here because evaluate reuses the already-initialized runtime).
    buf2 = io.StringIO()
    with contextlib.redirect_stdout(buf2):
        cli_main([
            "evaluate", "--preset", "tiny_96", "--image-size", "32",
            "--val-images", images_dir, "--val-annotations", ann,
            "--batch-size", "4", "--data-parallel", str(nprocs),
            "--distributed", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(nprocs), "--process-id", str(pid),
            "--restore", "final", "--checkpoint-dir", ckpt])
    eval_result = json.loads(buf2.getvalue().strip().splitlines()[-1])

    with open(f"{out_path}.cli{pid}", "w") as f:
        json.dump({"final_loss": result["final_loss"],
                   "best_ap": result["best_ap"],
                   "eval_map": eval_result["mAP"],
                   "ckpt_exists": os.path.isdir(
                       os.path.join(ckpt, "final"))}, f)
    print(f"proc {pid}: cli {result} eval {eval_result}", flush=True)


def _input_pipeline_mode(pid, nprocs, out_path, jax, jnp) -> None:
    """The multi-host INPUT pipeline end to end with real files: each
    process lists the same dataset, takes its per-host shard
    (ResumableDataset shard_index/num_shards), and parallel.data
    assembles global batches — content AND row placement checked
    against the deterministic epoch order."""
    from PIL import Image

    from vision_transformer_detector.config import DetectorConfig
    from vision_transformer_detector.data.pipeline import (
        ResumableDataset)
    from vision_transformer_detector.parallel.data import (
        global_batches)
    from vision_transformer_detector.parallel.mesh import (
        batch_sharding, create_mesh)

    cfg = DetectorConfig(image_size=(32, 32))
    # Private per-process copy of the SAME deterministic dataset (no
    # cross-process file races): image i is a constant-value canvas.
    data_dir = f"{out_path}.data{pid}"
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for i in range(8):
        p = os.path.join(data_dir, f"{i:012d}.png")  # PNG: lossless value
        Image.fromarray(
            np.full((32, 32, 3), i * 25, np.uint8)).save(p)
        paths.append(p)
    annotations = {str(i): [[1, 16.0, 16.0, 8.0, 8.0, 64.0]]
                   for i in range(8)}

    ds = ResumableDataset(paths, annotations, cfg, batch_size=2,
                          shuffle=True, seed=3, shard_index=pid,
                          num_shards=nprocs)
    mesh = create_mesh(data=nprocs, model=1)

    # Expected epoch order: every process can reconstruct both shards
    # (same file list), and the sharding's device map says which
    # process's shard lands in which global rows.
    rng = np.random.default_rng([3, 0])
    full = list(paths)
    rng.shuffle(full)
    shards = [full[s::nprocs] for s in range(nprocs)]
    index_map = batch_sharding(mesh).devices_indices_map((2 * nprocs,))
    row_owner = {}
    for device, idx in index_map.items():
        row_owner[idx[0].start or 0] = device.process_index
    # value encoded in the filename -> the constant pixel value
    def value_of(path):
        return int(os.path.basename(path)[:12]) * 25

    batch_checks = []
    for b, (images, labels) in enumerate(global_batches(mesh, iter(ds))):
        assert images.shape == (2 * nprocs, 32, 32, 3)
        weights = jnp.arange(1.0, 2.0 * nprocs + 1.0, dtype=jnp.float32)
        with mesh:
            got = float(jax.jit(
                lambda a, w: jnp.einsum("bhwc,b->", a.astype(jnp.float32),
                                        w))(images, weights))
        # Each process contributes its local 2-row batch b at its rows.
        want = 0.0
        for start, owner in row_owner.items():
            shard_paths = shards[owner][b * 2:(b + 1) * 2]
            for j, sp in enumerate(shard_paths):
                # normalized pixel value fills the whole 32x32x3 canvas
                v = value_of(sp) / 127.5 - 1.0
                want += (start + j + 1.0) * v * 32 * 32 * 3
        batch_checks.append((got, want))
        assert abs(got - want) <= max(1.0, abs(want)) * 1e-5, (b, got, want)
    assert len(batch_checks) == 2   # 8 imgs / 2 shards / batch 2

    if pid == 0:
        with open(out_path, "w") as f:
            json.dump({"batches": batch_checks}, f)
    print(f"proc {pid}: input-pipeline ok {batch_checks}", flush=True)


if __name__ == "__main__":
    main()
