"""Command-line driver: train / evaluate / predict / visualize / stats / plot.

The reference has no CLI — its driver is a notebook (SURVEY.md §1 L6). This
module exposes the same workflows as subcommands:

  python -m vision_transformer_detector.cli train \
      --train-images DIR --train-annotations train_annotations_dict.json \
      --epochs 12502 --batch-size 8 [--preset reference_608]
  python -m vision_transformer_detector.cli evaluate ...
  python -m vision_transformer_detector.cli predict --images DIR ...
  python -m vision_transformer_detector.cli visualize ...
  python -m vision_transformer_detector.cli stats --annotations ...
  python -m vision_transformer_detector.cli plot --metrics metrics.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import (DetectorConfig, LossConfig, TrainConfig, get_config)


def _positive_int(value: str) -> int:
    n = int(value)
    if n <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer, "
                                         f"got {value}")
    return n


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="reference_608",
                   help="config preset name (see config.PRESETS)")
    p.add_argument("--image-size", type=_positive_int, default=None)
    p.add_argument("--batch-size", type=_positive_int, default=8)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute dtype")
    p.add_argument("--flash-attention", action="store_true")
    p.add_argument("--no-flash-attention", action="store_true",
                   help="force the einsum attention path everywhere "
                        "(overrides preset defaults incl. the train-only "
                        "flash override)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--restore", default=None,
                   help="checkpoint name to restore (e.g. 'ongoing'), or "
                        "'latest' for the newest step-stamped checkpoint")
    p.add_argument("--keep-checkpoints", type=int, default=None,
                   help="also write step-stamped checkpoints at each "
                        "periodic save, GC'd to the newest K (ongoing/"
                        "highest_ap are never pruned)")
    p.add_argument("--params-npz", default=None,
                   help="load params from a .npz export "
                        "(tools/convert_tf_checkpoint.py output)")


def _build_config(args) -> DetectorConfig:
    config = get_config(args.preset)
    overrides = {}
    if args.image_size:
        overrides["image_size"] = (args.image_size, args.image_size)
    if args.bf16:
        overrides["compute_dtype"] = "bfloat16"
    if args.flash_attention and args.no_flash_attention:
        raise SystemExit("--flash-attention and --no-flash-attention "
                         "are mutually exclusive")
    if args.flash_attention:
        overrides["use_flash_attention"] = True
    if args.no_flash_attention:
        overrides["use_flash_attention"] = False
        overrides["train_use_flash_attention"] = False
    return config.replace(**overrides) if overrides else config


def _build_dataset(args, config, images_arg, annotations_arg, shuffle=False,
                   resumable=False, mesh=None, equalize_shards=False,
                   drop_remainder=True):
    """Construct the input pipeline; under multi-process SPMD (``mesh``
    on >1 process) each process loads only ITS shard of the batch, with
    the shard assignment read off the batch sharding
    (parallel.data.process_shard_spec).

    ``equalize_shards`` (training): trim the path list so every process
    yields the SAME number of full batches — differing batch counts
    would desync the train step's collectives and hang the pod (eval
    doesn't need it: evaluate_map's lockstep rounds pad instead, so no
    image is dropped)."""
    import jax

    from .data.annotations import load_annotations_dict
    from .data.pipeline import (
        CocoDetectionDataset, ResumableDataset, list_image_paths)

    annotations = load_annotations_dict(annotations_arg)
    start, end = args.images_range
    paths = list_image_paths(
        images_arg, images_range=(start, end if end >= 0 else None),
        # ResumableDataset owns shuffling (a fresh deterministic
        # permutation per epoch, seeded by (seed, epoch)) — pre-shuffling
        # the path list here would just permute its input once.
        shuffle=shuffle and not resumable,
        # --seed must vary the data order too; a hardcoded 0 made every
        # non-resumable shuffled run train on identical batch sequences.
        seed=getattr(args, "seed", 0))
    batch_size = args.batch_size
    shard = {}
    if mesh is not None and jax.process_count() > 1:
        from .parallel.data import process_shard_spec

        if not paths:
            # Raised on EVERY process (they list the same directory):
            # a local-shard emptiness check would SystemExit on one
            # process while its peers proceed into collectives and hang.
            raise SystemExit(f"no images under {images_arg!r}")
        shard_index, num_shards, batch_size = process_shard_spec(
            mesh, args.batch_size)
        shard = {"shard_index": shard_index, "num_shards": num_shards}
        if equalize_shards and not resumable:
            # Training collectives need the SAME number of full batches
            # per process. ResumableDataset equalizes per epoch AFTER
            # its shuffle (so the dropped remainder rotates); a one-time
            # trim here would permanently exclude the tail images from
            # every epoch.
            usable = (len(paths) // (num_shards * batch_size)
                      ) * num_shards * batch_size
            if usable == 0:
                raise SystemExit(
                    f"{len(paths)} images cannot fill one global batch "
                    f"of {args.batch_size} across {num_shards} input "
                    "shards")
            paths = paths[:usable]
        elif not equalize_shards:
            # Eval: keep every image — lockstep rounds pad uneven/ragged
            # shards instead of dropping them (the single-host custom
            # metric keeps the reference's drop_remainder parity; a
            # sharded run would otherwise drop a DIFFERENT subset and
            # diverge from the single-host number for no reason).
            drop_remainder = False
    on_corrupt = getattr(args, "on_corrupt", "raise")
    if on_corrupt == "skip" and jax.process_count() > 1:
        raise SystemExit(
            "--on-corrupt skip is single-process only: dropped files "
            "can give processes different batch counts and desync the "
            "collectives")
    if resumable:
        if on_corrupt == "skip":
            raise SystemExit(
                "--on-corrupt skip is incompatible with --resumable "
                "(the resume position is path-index arithmetic that "
                "skip+backfill breaks)")
        # normalize=False: the CLI's consumers are the jitted train/eval
        # steps, whose _maybe_normalize seam fuses the [-1,1] arithmetic
        # into the device program — shipping uint8 moves 4x less
        # host->device traffic (35.5 -> 8.9 MB per 608px b8 batch; the
        # round-5 protocol-eval measurement rode this from 975 to 246 s).
        return ResumableDataset(
            paths, annotations, config, batch_size=batch_size,
            shuffle=shuffle, seed=getattr(args, "seed", 0),
            normalize=False,
            fast_decode=getattr(args, "fast_decode", False),
            pool=getattr(args, "decode_pool", "thread"), **shard)
    return CocoDetectionDataset(
        paths, annotations, config, batch_size=batch_size,
        drop_remainder=drop_remainder, on_corrupt=on_corrupt,
        normalize=False,
        fast_decode=getattr(args, "fast_decode", False),
        pool=getattr(args, "decode_pool", "thread"), **shard)


def _maybe_mesh(args):
    if getattr(args, "distributed", False):
        # Multi-host bring-up must precede any backend use; after it,
        # jax.devices() is the GLOBAL device list the mesh spans.
        from .parallel.data import initialize_distributed
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)
    if args.data_parallel <= 1 and args.model_parallel <= 1:
        if getattr(args, "distributed", False):
            raise SystemExit(
                "--distributed requires a mesh: pass --data-parallel "
                "and/or --model-parallel covering all devices in the "
                "process group")
        return None
    from .parallel.mesh import create_mesh
    return create_mesh(data=args.data_parallel, model=args.model_parallel)


def _reject_mesh_flags(args, command: str) -> None:
    """Refuse --data-parallel/--model-parallel on single-device
    subcommands — silently ignoring them mislabels the run (the user
    believes N chips served their request), the same bug class the
    round-3 benchmark fix removed."""
    if args.data_parallel > 1 or args.model_parallel > 1:
        raise SystemExit(
            f"`{command}` runs single-device; --data-parallel/"
            "--model-parallel are not supported here (use `evaluate`/"
            "`train` for sharded execution)")


def _restore_state(trainer, state, restore: str):
    """--restore with one contract for EVERY subcommand: 'latest'
    resolves to the newest step-stamped checkpoint (the flag's help
    promises this; four subcommands used to pass the literal string
    into Trainer.restore and fail on a nonexistent path)."""
    if restore == "latest":
        return trainer.restore_latest(state)
    return trainer.restore(state, restore)


def cmd_train(args) -> None:
    from .train.trainer import Trainer
    from .utils.checkpoint import load_params_npz

    config = _build_config(args)
    moments = "bfloat16" if args.bf16_moments else None
    train_config = TrainConfig(
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        epochs=args.epochs, epochs_warm_up=args.epochs_warm_up,
        skip_epochs=args.skip_epochs, seed=args.seed,
        adam_mu_dtype=moments, adam_nu_dtype=moments)
    loss_config = LossConfig()

    epochs_per_call = getattr(args, "epochs_per_call", 1)
    if epochs_per_call > 1:
        # The scanned window replays the SAME stacked batches every
        # epoch; features that change the stream between epochs cannot
        # compose with it (and the trainer itself rejects streaming
        # datasets / multi-process meshes).
        for flag, name in ((args.shuffle, "--shuffle"),
                           (args.resumable, "--resumable"),
                           (getattr(args, "distributed", False),
                            "--distributed")):
            if flag:
                raise SystemExit(
                    f"--epochs-per-call > 1 is incompatible with {name}: "
                    "the scanned window stacks the materialized batches "
                    "on device once and replays them each epoch")

    mesh = _maybe_mesh(args)  # multi-host bring-up happens here, first
    train_data = _build_dataset(args, config, args.train_images,
                                args.train_annotations, shuffle=args.shuffle,
                                resumable=args.resumable, mesh=mesh,
                                equalize_shards=True)
    if epochs_per_call > 1:
        # Materialize for the device-resident scan. Refuse datasets whose
        # stacked images would strain device memory — the scan is an
        # overfit/small-set accelerator, not a general training mode.
        h, w = config.image_size
        # Images + labels of the stacked dataset. This is deliberately a
        # conservative DATA-ONLY estimate: params, Adam moments, and the
        # scan's live activations ride on top, so the threshold is held
        # far below the device's memory (a 4 GiB images-only check could
        # still OOM once training state was added).
        n_images = len(train_data) * args.batch_size
        # 1 byte/pixel: the CLI datasets ship uint8 (normalize=False
        # above) and the scan normalizes on device per step, so the
        # stacked residency is the uint8 stack (a 4-bytes/pixel estimate
        # here rejected runs that actually fit — round-5 review finding).
        total_bytes = (n_images * h * w * 3
                       + n_images * config.max_objects * 6 * 4)
        if total_bytes > 3 << 30:
            raise SystemExit(
                f"--epochs-per-call: stacking {len(train_data)} batches "
                f"of {args.batch_size}x{h}x{w} images (+labels) needs "
                f"~{total_bytes / (1 << 30):.1f} GiB of device memory "
                "for the data "
                "alone, before params/optimizer state/activations; use "
                "the default per-epoch streaming loop for datasets this "
                "size")
        train_data = [batch for batch in train_data]
    eval_data = None
    if args.val_images and args.val_annotations:
        eval_data = _build_dataset(args, config, args.val_images,
                                   args.val_annotations, mesh=mesh)

    trainer = Trainer(config, loss_config, train_config,
                      steps_per_epoch=max(1, len(train_data)),
                      mesh=mesh,
                      checkpoint_dir=args.checkpoint_dir,
                      keep_checkpoints=args.keep_checkpoints,
                      metrics_path=args.metrics)
    state = trainer.init_state()
    if args.params_npz:
        state["params"] = load_params_npz(args.params_npz, state["params"])
    if args.restore:
        state = _restore_state(trainer, state, args.restore)
    if args.resumable and trainer.dataset_resume_state is not None:
        # restore() loaded the input position saved beside the checkpoint;
        # rewind the stream to the exact next batch.
        train_data.set_state(trainer.dataset_resume_state)
    state = trainer.fit(state, train_data, epochs=args.epochs,
                        eval_data=eval_data,
                        epochs_per_call=epochs_per_call)
    trainer.save(state, name="final")
    print(json.dumps({"best_ap": trainer.best_ap,
                      "final_loss": trainer.loss_record[-1]
                      if trainer.loss_record else None}))


def cmd_evaluate(args) -> None:
    from .train.trainer import Trainer, evaluate_map
    from .utils.checkpoint import load_params_npz

    config = _build_config(args)
    protocol = getattr(args, "protocol", "custom")
    if getattr(args, "distributed", False) and protocol != "custom":
        raise SystemExit(
            "--distributed evaluation supports --protocol custom only "
            "(the COCO-protocol evaluators run a host-side loop; score a "
            "--dump-detections results file with `score-coco` instead)")
    mesh = _maybe_mesh(args)
    trainer = Trainer(config, checkpoint_dir=args.checkpoint_dir, mesh=mesh)
    state = trainer.init_state()
    if args.params_npz:
        state["params"] = load_params_npz(args.params_npz, state["params"])
    elif args.restore:
        state = _restore_state(trainer, state, args.restore)
    dump = getattr(args, "dump_detections", None)
    if dump and protocol != "coco-original":
        raise SystemExit("--dump-detections requires "
                         "--protocol coco-original (detections are "
                         "dumped in original-frame pixels)")
    if protocol == "coco-original":
        from .data.annotations import load_annotations_dict
        from .metrics.coco_eval import (
            evaluate_coco_protocol_original_frame)

        start, end = args.images_range
        summary = evaluate_coco_protocol_original_frame(
            state["params"], args.val_images,
            load_annotations_dict(args.val_annotations), config,
            batch_size=args.batch_size,
            objectness_threshold=args.objectness_threshold,
            images_range=(start, end if end >= 0 else None),
            dump_detections=dump,
            per_category=args.per_category,
            fast_decode=getattr(args, "fast_decode", False))
        out = {"protocol": "coco-original", **summary}
        if dump:
            out["dumped_detections"] = dump
        print(json.dumps(out))
        return
    data = _build_dataset(args, config, args.val_images,
                          args.val_annotations, mesh=mesh,
                          # The reference's metric drops the ragged final
                          # batch like its tf.data pipeline did
                          # (vtu.py:609-610, parity); the OFFICIAL
                          # protocol must score every image.
                          drop_remainder=(protocol != "coco"))
    import jax as _jax

    if len(data) == 0 and not (mesh is not None
                               and _jax.process_count() > 1):
        # Multi-process: an EMPTY LOCAL shard is legal (the lockstep
        # rounds pad it from a donor process); exiting here on one
        # process while peers enter collectives would hang the pod.
        # The global-emptiness case raises inside _build_dataset on
        # every process alike.
        raise SystemExit(
            f"no evaluation batches: {args.val_images!r} matched no "
            "images, or --batch-size exceeds the dataset size")
    if protocol == "coco":
        from .metrics.coco_eval import evaluate_coco_protocol

        summary = evaluate_coco_protocol(
            state["params"], data, config,
            objectness_threshold=args.objectness_threshold,
            per_category=args.per_category)
        print(json.dumps({"protocol": "coco", **summary}))
    else:
        # The mesh shards eval batches over the data axis (single
        # process) or assembles lockstep global rounds from the
        # per-process shards (--distributed).
        with trainer._mesh_context():
            ap = evaluate_map(state["params"], data, config,
                              trainer.eval_step, trainer.metric,
                              put_fn=trainer._put_images, mesh=mesh)
        print(json.dumps({"mAP": ap}))


def cmd_score_coco(args) -> None:
    """Standalone official-protocol scoring: any COCO results JSON vs
    ground truth, no model or device involved (the pycocotools
    ``COCOeval(gt, dt, 'bbox')`` flow, using this framework's evaluator
    + native matcher core)."""
    from .metrics.coco_eval import score_coco_results

    summary = score_coco_results(args.annotations, args.results,
                                 per_category=args.per_category)
    print(json.dumps({"protocol": "coco", **summary}))


def cmd_predict(args) -> None:
    import numpy as np

    from .data.pipeline import list_image_paths, load_and_letterbox_image
    from .train.trainer import Trainer, make_eval_step
    from .utils.checkpoint import load_params_npz

    _reject_mesh_flags(args, "predict")
    config = _build_config(args)
    trainer = Trainer(config, checkpoint_dir=args.checkpoint_dir)
    state = trainer.init_state()
    if args.params_npz:
        state["params"] = load_params_npz(args.params_npz, state["params"])
    elif args.restore:
        state = _restore_state(trainer, state, args.restore)

    eval_step = make_eval_step(config)
    start, end = args.images_range
    paths = list_image_paths(args.images,
                             images_range=(start, end if end >= 0 else None))
    outputs = []
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        images = np.stack([
            load_and_letterbox_image(
                p, config,
                fast_decode=getattr(args, "fast_decode", False))[0]
            for p in chunk])
        decoded = np.asarray(eval_step(state["params"], images))
        for path, dets in zip(chunk, decoded):
            outputs.append({"image": path, "detections": dets.tolist()})
    json.dump(outputs, sys.stdout)
    print()


def cmd_visualize(args) -> None:
    import numpy as np

    from .data.pipeline import list_image_paths, load_and_letterbox_image
    from .train.trainer import Trainer, make_predict_step
    from .utils.checkpoint import load_params_npz
    from .utils.visualize import visualize_predictions

    _reject_mesh_flags(args, "visualize")
    config = _build_config(args)
    trainer = Trainer(config, checkpoint_dir=args.checkpoint_dir)
    state = trainer.init_state()
    if args.params_npz:
        state["params"] = load_params_npz(args.params_npz, state["params"])
    elif args.restore:
        state = _restore_state(trainer, state, args.restore)

    predict_step = make_predict_step(config)
    start, end = args.images_range
    paths = list_image_paths(args.images,
                             images_range=(start, end if end >= 0 else None))
    # Chunk like cmd_predict: stacking thousands of 608px images into
    # one array (and one giant-batch compile) OOMs the host/device.
    written: list = []
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        images = np.stack([
            load_and_letterbox_image(
                p, config,
                fast_decode=getattr(args, "fast_decode", False))[0]
            for p in chunk])
        raw = np.asarray(predict_step(state["params"], images))
        written.extend(visualize_predictions(
            images, raw, args.output_dir,
            objectness_threshold=args.objectness_threshold,
            classification_threshold=args.classification_threshold,
            config=config, start_index=i))
    out = {"written": written}
    if args.contact_sheet:
        from .utils.visualize import write_contact_sheet
        out["contact_sheet"] = write_contact_sheet(
            written, args.contact_sheet)
    print(json.dumps(out))


def _parse_sweep_value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text  # bare strings (e.g. compute_dtype=bfloat16)


def cmd_sweep(args) -> None:
    from .train.sweep import format_records, run_sweep

    if not args.synthetic and not (args.train_images
                                   and args.train_annotations):
        # Without this the run crashes deep in the data layer with an
        # opaque TypeError from open(None)/os.walk(None).
        raise SystemExit(
            "sweep needs --train-images and --train-annotations, "
            "or --synthetic")
    config = _build_config(args)
    train_config = TrainConfig(
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        epochs=args.epochs, epochs_warm_up=args.epochs_warm_up,
        skip_epochs=args.skip_epochs, seed=args.seed)

    grid = {}
    for spec in args.sweep:
        name, _, values = spec.partition("=")
        if not values:
            raise SystemExit(
                f"--sweep expects PARAM=V1,V2,... got {spec!r}")
        grid[name] = [_parse_sweep_value(v) for v in values.split(",")]

    if args.synthetic:
        from .data.pipeline import synthetic_batches

        def make_data(cfg, tc):
            data = list(synthetic_batches(
                cfg, batch_size=tc.batch_size,
                num_batches=args.synthetic_batches, seed=tc.seed))
            return data, data
    else:
        def make_data(cfg, tc):
            # Datasets must follow the SWEPT train config: a
            # batch_size=8,32 sweep that built both datasets from the
            # base CLI batch size trained identical batches under
            # different labels (round-3 review finding).
            batch_args = argparse.Namespace(**vars(args))
            batch_args.batch_size = tc.batch_size
            train_data = _build_dataset(
                batch_args, cfg, args.train_images, args.train_annotations,
                shuffle=args.shuffle)
            eval_data = None
            if args.val_images and args.val_annotations:
                eval_data = _build_dataset(batch_args, cfg, args.val_images,
                                           args.val_annotations)
            return train_data, eval_data

    records = run_sweep(
        grid, make_data, base_config=config, base_train_config=train_config,
        # When 'epochs' is itself a swept axis, the per-point
        # TrainConfig.epochs must win (a fixed epochs=args.epochs
        # silently overrode the sweep — review finding).
        epochs=None if "epochs" in grid else args.epochs,
        out_dir=args.out_dir, mesh=_maybe_mesh(args))
    print(format_records(records))
    print(json.dumps({"records": len(records),
                      "out_dir": args.out_dir,
                      "best_AP": max(r["best_AP"] for r in records)}))


def cmd_stats(args) -> None:
    from .data.annotations import load_annotations_dict
    from .data.statistics import (
        coco_statistics, coco_statistics_multi_processing)

    annotations = load_annotations_dict(args.annotations)
    names = list(annotations)[: args.images_quantity or None]
    if args.multi_processing:
        result = coco_statistics_multi_processing(names, annotations)
    else:
        result = coco_statistics(names, annotations)
    print(json.dumps(result, indent=2))


def cmd_serve(args) -> None:
    from .serving import DetectionService, ExportedDetectionService

    _reject_mesh_flags(args, "serve")
    if args.from_export:
        # Refuse-over-silently-ignore: the frozen artifact owns its
        # weights and precision; an operator passing --int8 would
        # otherwise believe they are serving quantized weights while
        # recording full-precision latency/AP numbers.
        ignored = [flag for flag, given in (
            ("--int8", args.int8),
            ("--params-npz", args.params_npz),
            ("--restore", args.restore)) if given]
        if ignored:
            raise SystemExit(
                "--from-export serves the frozen artifact and cannot "
                f"honour {', '.join(ignored)}; bake the model into the "
                "artifact at `export` time instead")
        service = ExportedDetectionService(
            args.from_export,
            iou_threshold=args.nms_iou_threshold,
            score_threshold=args.score_threshold,
            fast_decode=getattr(args, "fast_decode", False))
        _serve(args, service)
        return

    from .train.trainer import Trainer
    from .utils.checkpoint import load_params_npz

    config = _build_config(args)
    trainer = Trainer(config, checkpoint_dir=args.checkpoint_dir)
    state = trainer.init_state()
    if args.params_npz:
        state["params"] = load_params_npz(args.params_npz, state["params"])
    elif args.restore:
        state = _restore_state(trainer, state, args.restore)

    params = state["params"]
    if args.int8:
        from .kernels.quantization import quantize_params
        params = quantize_params(params)
    service = DetectionService(config, params,
                               iou_threshold=args.nms_iou_threshold,
                               score_threshold=args.score_threshold,
                               fast_decode=getattr(args, "fast_decode",
                                                   False))
    _serve(args, service)


def _serve(args, service) -> None:
    import signal
    import threading

    from .serving import DetectionServer
    server = DetectionServer(service, host=args.host, port=args.port,
                             batching=args.batching,
                             max_batch=args.max_batch,
                             max_wait_ms=args.batch_window_ms,
                             request_timeout=args.request_timeout,
                             max_body_bytes=args.max_body_mb * 1024 * 1024,
                             max_inflight=args.max_inflight)
    from .data import pipeline as _pipe
    print(json.dumps({"serving": f"http://{args.host}:{server.port}",
                      "endpoints": ["/healthz", "/stats",
                                    "POST /predict"],
                      # Which JPEG decode core handles request payloads
                      # (round-4 verdict #2: a silent PIL fallback looked
                      # identical to the native path from the outside).
                      "decode_core": ("native" if _pipe.native_available()
                                      else "pil")}),
          flush=True)
    # Serve on a worker thread so SIGTERM/SIGINT can drive a graceful
    # stop (shutdown() must not be called from the serving thread).
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    stop.wait()
    print(json.dumps({"stopping": True}), flush=True)
    server.stop()   # drains in-flight batches, then stops the batcher


def cmd_export(args) -> None:
    from .export import save_exported
    from .models.vit_detector import init_params
    from .train.trainer import Trainer
    from .utils.checkpoint import load_params_npz

    import jax

    config = _build_config(args)
    if args.params_npz:
        params = init_params(jax.random.PRNGKey(0), config)
        params = load_params_npz(args.params_npz, params)
    elif args.restore:
        trainer = Trainer(config, checkpoint_dir=args.checkpoint_dir)
        state = trainer.init_state()
        state = _restore_state(trainer, state, args.restore)
        params = state["params"]
    else:
        params = init_params(jax.random.PRNGKey(0), config)
    batch = args.batch_sizes if args.batch_sizes else args.batch_size
    postprocess = None
    if args.bake_postprocess:
        postprocess = {"k": args.nms_k,
                       "iou_threshold": args.nms_iou_threshold,
                       "score_threshold": args.score_threshold,
                       "per_class": not args.class_agnostic_nms}
    path = save_exported(args.output_dir, params, config,
                         batch_size=batch,
                         platforms=args.platforms,
                         postprocess=postprocess)
    print(json.dumps({"exported": path, "batch_size": batch,
                      "platforms": args.platforms or ["native"],
                      "postprocess": postprocess}))


def cmd_plot(args) -> None:
    from .utils.plotting import plot_training_curves

    path = plot_training_curves(args.metrics, args.output)
    print(json.dumps({"written": path}))


def cmd_doctor(args) -> None:
    """Environment health report: the devices JAX finds in this process
    (platform, kind, count), native extensions, and virtual-mesh
    capability. One JSON object on stdout; exit code 0 iff JAX found an
    accelerator."""
    import subprocess
    import sys as _sys

    import jax

    report: dict = {}
    if getattr(args, "build_native", False):
        from . import _native
        report["native_build"] = _native.build(force=True, verbose=True)
    try:
        devices = jax.devices()
    except RuntimeError as exc:  # e.g. JAX_PLATFORMS names a missing one
        report["device"] = {"ok": False, "error": str(exc)}
    else:
        report["device"] = {"ok": devices[0].platform != "cpu",
                            "platform": devices[0].platform,
                            "kind": devices[0].device_kind,
                            "count": len(devices)}

    from .data import annotations as _ann
    from .data import pipeline as _pipe
    from .metrics import coco_eval as _ce
    report["native"] = {
        "coco_json": _ann.native_parser_available(),
        "pipeline": _pipe.native_available(),
        "coco_eval": _ce.native_matcher_available(),
    }

    # Virtual CPU mesh (what tests and dryrun_multichip rely on): checked
    # in a CPU-only subprocess, since it needs XLA_FLAGS set before
    # backend init.
    mesh_code = (
        "import os; os.environ['XLA_FLAGS'] = "
        "os.environ.get('XLA_FLAGS', '') + "
        "' --xla_force_host_platform_device_count=8'; "
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "print('VTD_MESH', len(jax.devices()))")
    try:
        mesh = subprocess.run([_sys.executable, "-c", mesh_code],
                              capture_output=True, text=True,
                              timeout=args.probe_timeout)
        report["virtual_mesh_8"] = (
            mesh.returncode == 0
            and any(line.strip() == "VTD_MESH 8"
                    for line in mesh.stdout.splitlines()))
    except subprocess.TimeoutExpired:
        report["virtual_mesh_8"] = False

    print(json.dumps(report))
    if not report["device"]["ok"]:
        raise SystemExit(1)


def cmd_benchmark(args) -> None:
    """Standardized throughput measurement for any config on this host's
    device — the reference measured throughput by eyeballing notebook
    cell-15 wall clock; this times N steps chained by a data dependency
    after a compiling warm-up, and waits for the last one's result."""
    import time

    import jax
    import jax.numpy as jnp

    from .models.vit_detector import forward, init_params
    from .ops.decode import transform_predictions

    config = _build_config(args)
    h, w = config.image_size
    batch = args.batch_size
    images = jax.random.uniform(jax.random.PRNGKey(1), (batch, h, w, 3),
                                minval=-1.0, maxval=1.0)
    iterations = args.iterations

    # --data-parallel/--model-parallel apply to BOTH modes: the
    # inference path used to accept the flags but silently time a
    # single device, mislabeling the result (round-3 review finding) —
    # and the train path did the same until round 4.
    mesh = _maybe_mesh(args)
    if mesh is not None:
        from .parallel import mesh as mesh_lib

        data_size = mesh.shape[mesh_lib.DATA_AXIS]
        if batch % data_size != 0:
            raise SystemExit(
                f"--batch-size {batch} is not divisible by "
                f"--data-parallel {data_size}")

    if args.mode == "inference":
        import contextlib

        # Only this branch uses the standalone params; train mode's
        # Trainer.init_state() builds its own (a second init would hold a
        # params-sized device allocation alive through the timed run).
        params = init_params(jax.random.PRNGKey(0), config)
        if mesh is not None:
            params = jax.device_put(
                params, mesh_lib.param_shardings(params, mesh))
            images = jax.device_put(images, mesh_lib.batch_sharding(mesh))

        @jax.jit
        def chained(params, images, eps):
            out = transform_predictions(
                forward(params, images + eps, config, mesh=mesh), config)
            return out, out.mean() * 0.0

        with mesh if mesh is not None else contextlib.nullcontext():
            eps = jnp.float32(0.0)
            out, eps = chained(params, images, eps)
            float(eps)                                   # compile + sync
            tic = time.perf_counter()
            for _ in range(iterations):
                out, eps = chained(params, images, eps)  # chained via eps
            float(eps)
            elapsed = time.perf_counter() - tic
    else:
        import numpy as np

        from .train.trainer import Trainer

        trainer = Trainer(config, LossConfig(), TrainConfig(
            learning_rate=1e-4, batch_size=batch), mesh=mesh)
        state = trainer.init_state()
        labels = np.full((batch, config.max_objects, 6), -8.0, np.float32)
        labels[..., 0] = 0.0
        labels[:, 0] = (1, 3, h / 2, w / 2, h / 4, w / 4)
        images_d, labels_d = trainer._put_batch(np.asarray(images), labels)
        rng = jax.random.PRNGKey(0)
        # Same mesh context Trainer.fit uses: sequence_sharding configs
        # trace with_sharding_constraint and need an enclosing Mesh.
        with trainer._mesh_context():
            state, loss = trainer.train_step(state, images_d, labels_d, rng)
            float(loss)                              # compile + sync
            tic = time.perf_counter()
            for _ in range(iterations):
                # Chained through the state pytree: step i+1 consumes
                # step i's updated params, so the device cannot reorder.
                state, loss = trainer.train_step(
                    state, images_d, labels_d, rng)
            float(loss)
            elapsed = time.perf_counter() - tic

    ms = elapsed / iterations * 1e3
    print(json.dumps({
        "preset": args.preset, "mode": args.mode,
        "device": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "image_size": [h, w], "batch": batch,
        "compute_dtype": config.compute_dtype,
        "iterations": iterations,
        "ms_per_step": round(ms, 2),
        "img_per_s": round(batch * 1e3 / ms, 1)}))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vision_transformer_detector")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, needs_train=False, needs_val=False, needs_images=False):
        _add_model_args(p)
        p.add_argument("--images-range", type=int, nargs=2,
                       default=(0, -1), metavar=("START", "END"))
        p.add_argument("--data-parallel", type=int, default=1)
        p.add_argument("--model-parallel", type=int, default=1)
        p.add_argument("--distributed", action="store_true",
                       help="multi-host SPMD: jax.distributed bring-up "
                            "before device use; every process runs the "
                            "same command and loads only its input "
                            "shard (--batch-size stays the GLOBAL "
                            "batch). Pass --coordinator + "
                            "--num-processes + --process-id")
        p.add_argument("--coordinator", default=None,
                       help="host:port of process 0")
        p.add_argument("--num-processes", type=int, default=None)
        p.add_argument("--process-id", type=int, default=None)
        p.add_argument("--on-corrupt", choices=("raise", "skip"),
                       default="raise",
                       help="policy for undecodable image files "
                            "(zero-byte/truncated/non-image): 'raise' "
                            "(default) stops with the offending path; "
                            "'skip' logs+drops each and backfills the "
                            "batch. 'skip' is single-process only (it "
                            "can desync multi-process batch counts) and "
                            "incompatible with --resumable")
        p.add_argument("--fast-decode", action="store_true",
                       help="DCT-domain reduced-scale JPEG decode "
                            "(libjpeg scale_num/8, PIL draft() in the "
                            "fallback): ~1.3-1.6x host decode when the "
                            "canvas is much smaller than the sources "
                            "(224px canvas). "
                            "Letterbox geometry/labels are unaffected; "
                            "pixel values differ by <=3/255 vs the "
                            "exact path (no-op when no scaling "
                            "engages, e.g. 608px on COCO-sized files)")
        p.add_argument("--decode-pool", choices=("thread", "process"),
                       default="thread",
                       help="decode worker pool: 'thread' (default; the "
                            "native libjpeg core releases the GIL) or "
                            "'process' for GIL-hostile hosts (PIL "
                            "fallback, Python-heavy label work)")
        if needs_train:
            p.add_argument("--train-images", required=True)
            p.add_argument("--train-annotations", required=True)
            p.add_argument("--shuffle", action="store_true")
        if needs_val:
            p.add_argument("--val-images", required=needs_val == "required")
            p.add_argument("--val-annotations",
                           required=needs_val == "required")
        if needs_images:
            p.add_argument("--images", required=True)

    p = sub.add_parser("train", help="train a detector")
    common(p, needs_train=True, needs_val=True)
    p.add_argument("--epochs", type=int, default=12_502)
    p.add_argument("--learning-rate", type=float, default=8e-5)
    p.add_argument("--epochs-warm-up", type=int, default=500)
    p.add_argument("--skip-epochs", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", default="metrics.jsonl")
    p.add_argument("--bf16-moments", action="store_true",
                   help="store Adam moment state in bf16 (fp32 "
                        "arithmetic; half the optimizer state's memory "
                        "— tools/bench_opt_dtypes)")
    p.add_argument("--resumable", action="store_true",
                   help="checkpointable input stream (ResumableDataset): "
                        "the data position is saved next to every "
                        "checkpoint and --restore resumes mid-epoch at "
                        "the exact next batch instead of replaying from "
                        "scratch (the reference restarts its dataset on "
                        "every resume)")
    p.add_argument("--epochs-per-call", type=_positive_int, default=1,
                   help="device-resident training window: materialize the "
                        "dataset on device once and run K epochs per "
                        "dispatch via lax.scan (trainer.make_multi_step) "
                        "— removes the per-epoch host round-trip. "
                        "Small datasets only (the whole dataset is "
                        "stacked in device memory); incompatible with "
                        "--shuffle/--resumable/--distributed. Cadence "
                        "and rng chain match the per-epoch loop exactly")
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("evaluate", help="compute mAP on a dataset")
    common(p, needs_val="required")
    p.add_argument("--protocol",
                   choices=("custom", "coco", "coco-original"),
                   default="custom",
                   help="'custom' = the reference's streaming metric "
                        "(vtd.py:1268, bit-compatible); 'coco' = the "
                        "official COCO protocol on letterboxed-frame "
                        "boxes; 'coco-original' = the official protocol "
                        "in ORIGINAL image coordinates with real COCO "
                        "areas (metrics/coco_eval.py)")
    p.add_argument("--objectness-threshold", type=float, default=0.0,
                   help="coco protocol only: drop detections at or below "
                        "this objectness (default keeps all, the "
                        "COCOeval convention)")
    p.add_argument("--dump-detections", default=None, metavar="PATH",
                   help="coco-original protocol only: also write every "
                        "detection in the standard COCO results format "
                        "(original-frame pixels, COCO category ids) for "
                        "re-scoring with pycocotools elsewhere")
    p.add_argument("--per-category", action="store_true",
                   help="coco protocols: include the per-class AP "
                        "breakdown (AP_per_category) in the summary")
    p.set_defaults(func=cmd_evaluate)

    p = sub.add_parser(
        "score-coco",
        help="score a COCO results JSON against ground truth (official "
             "protocol; no model involved — a pycocotools replacement)")
    p.add_argument("--annotations", required=True,
                   help="a full COCO instances JSON (bbox/area/iscrowd "
                        "used directly, crowd-ignore semantics) or an "
                        "annotation-dict JSON (data/annotations.py)")
    p.add_argument("--results", required=True,
                   help="standard COCO results list (what evaluate "
                        "--dump-detections writes)")
    p.add_argument("--per-category", action="store_true",
                   help="include the per-class AP breakdown")
    p.set_defaults(func=cmd_score_coco)

    p = sub.add_parser("predict", help="decoded detections as json")
    common(p, needs_images=True)
    p.set_defaults(func=cmd_predict)

    p = sub.add_parser("visualize", help="render detections to PNGs")
    common(p, needs_images=True)
    p.add_argument("--output-dir", default="visualizations")
    p.add_argument("--objectness-threshold", type=float, default=0.5)
    p.add_argument("--classification-threshold", type=float, default=0.5)
    p.add_argument("--contact-sheet", default=None, metavar="PATH",
                   help="also bundle the PNGs into one self-contained "
                        "interactive HTML sheet (keyboard stepping, "
                        "the reference cv2 viewer's q/s controls)")
    p.set_defaults(func=cmd_visualize)

    p = sub.add_parser(
        "sweep", help="hyperparameter grid sweep (ipynb cells 6/7/9)")
    common(p)
    p.add_argument("--sweep", action="append", required=True,
                   metavar="PARAM=V1,V2",
                   help="sweep axis; repeatable; values parsed as JSON "
                        "(e.g. --sweep patch_size=16,17 "
                        "--sweep learning_rate=8e-5,4e-5)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=8e-5)
    p.add_argument("--epochs-warm-up", type=int, default=0)
    p.add_argument("--skip-epochs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="sweep")
    p.add_argument("--train-images")
    p.add_argument("--train-annotations")
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--val-images")
    p.add_argument("--val-annotations")
    p.add_argument("--synthetic", action="store_true",
                   help="sweep on synthetic batches (smoke/benchmarking)")
    p.add_argument("--synthetic-batches", type=int, default=1)
    p.set_defaults(func=cmd_sweep)

    p = sub.add_parser("stats", help="COCO dataset statistics")
    p.add_argument("--annotations", required=True)
    p.add_argument("--images-quantity", type=int, default=0)
    p.add_argument("--multi-processing", action="store_true")
    p.set_defaults(func=cmd_stats)

    p = sub.add_parser("serve", help="HTTP detection endpoint")
    common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--nms-iou-threshold", type=float, default=0.5)
    p.add_argument("--score-threshold", type=float, default=0.0)
    p.add_argument("--int8", action="store_true",
                   help="serve int8-quantized weights "
                        "(AP-retention-tested, kernels/quantization.py)")
    batching = p.add_mutually_exclusive_group()
    batching.add_argument(
        "--batching", dest="batching", action="store_true",
        help="route concurrent requests through the micro-batcher (one "
             "device call serves up to --max-batch requests); which "
             "dispatch mode is faster on the GPU is not measured")
    batching.add_argument(
        "--no-batching", dest="batching", action="store_false",
        help="dispatch each request directly (the default)")
    p.set_defaults(batching=False)
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batcher cap (device call batch size)")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="max extra latency spent collecting a batch "
                        "(closes early when --max-batch is reached)")
    p.add_argument("--request-timeout", type=float, default=30.0,
                   help="seconds before a queued request gets HTTP 503")
    p.add_argument("--max-body-mb", type=int, default=32,
                   help="reject request bodies above this size (HTTP 413)")
    p.add_argument("--max-inflight", type=int, default=64,
                   help="bound concurrent predictions (excess gets "
                        "HTTP 429)")
    p.add_argument("--from-export", default=None, metavar="DIR",
                   help="serve a StableHLO export artifact (cli export) "
                        "instead of building the model — pins the graph "
                        "against code drift; pair with a multi-batch "
                        "bundle for the micro-batcher")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser(
        "export", help="serialize a StableHLO inference artifact")
    _add_model_args(p)
    p.add_argument("--output-dir", default="exported_model")
    p.add_argument("--batch-sizes", type=int, nargs="*", default=None,
                   help="export a bundle with one graph per batch size; "
                        "the loader routes requests to the smallest "
                        "fitting graph (overrides --batch-size)")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="lowering platforms (e.g. cuda cpu); default: "
                        "the current backend")
    p.add_argument("--bake-postprocess", action="store_true",
                   help="bake NMS + top-k (ops/nms.py) into the exported "
                        "graphs: artifacts return (scores, class_ids, "
                        "boxes, valid) with leading (batch, k) — the "
                        "whole serving compute path in one frozen "
                        "program; 'serve --from-export' honors the "
                        "baked spec")
    p.add_argument("--nms-k", type=int, default=17,
                   help="top-k kept per image when baking postprocess")
    p.add_argument("--nms-iou-threshold", type=float, default=0.5)
    p.add_argument("--score-threshold", type=float, default=0.0)
    p.add_argument("--class-agnostic-nms", action="store_true",
                   help="suppress across classes (default: per-class)")
    p.set_defaults(func=cmd_export)

    p = sub.add_parser("plot", help="loss/AP training curves")
    p.add_argument("--metrics", required=True)
    p.add_argument("--output", default="loss-AP-scatters.html")
    p.set_defaults(func=cmd_plot)

    p = sub.add_parser(
        "benchmark",
        help="throughput of a config on this device")
    common(p)
    p.add_argument("--mode", choices=("inference", "train"),
                   default="inference")
    p.add_argument("--iterations", type=_positive_int, default=10)
    p.set_defaults(func=cmd_benchmark)

    p = sub.add_parser(
        "doctor",
        help="environment health: device probe (hang-safe), native "
             "extensions, virtual-mesh capability")
    p.add_argument("--probe-timeout", type=float, default=120.0,
                   help="seconds before the virtual-mesh check is "
                        "reported failed")
    p.add_argument("--build-native", action="store_true",
                   help="force a rebuild of the C++ extensions (clears "
                        "a cached build failure, streams compiler "
                        "output) before reporting")
    p.set_defaults(func=cmd_doctor)

    return parser


def main(argv=None) -> None:
    from .utils.runtime import enable_compilation_cache

    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    if (getattr(args, "distributed", False)
            and args.command not in ("train", "evaluate")):
        # Refuse rather than silently run single-process: the other
        # subcommands never reach _maybe_mesh's bring-up.
        raise SystemExit(
            f"--distributed is supported by train/evaluate, not "
            f"{args.command!r}")
    args.func(args)


if __name__ == "__main__":
    main()
