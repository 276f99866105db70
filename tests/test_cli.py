"""CLI smoke tests: every subcommand end-to-end on the tiny preset.

These run the same flows the reference's notebook drives (train -> eval ->
visualize -> plot -> stats), through the outermost public surface.
"""

import json
import os

import numpy as np
import pytest

from vision_transformer_detector.cli import main


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from PIL import Image, ImageDraw

    root = tmp_path_factory.mktemp("coco")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    annotations = {}
    for i in range(4):
        img = Image.new("RGB", (96, 80), (20, 30, 40))
        draw = ImageDraw.Draw(img)
        x0, y0 = int(rng.integers(5, 40)), int(rng.integers(5, 30))
        w, h = 30, 28
        draw.rectangle((x0, y0, x0 + w, y0 + h), fill=(250, 220, 30))
        img.save(images / f"{i:012d}.jpg")
        annotations[str(i)] = [
            [1, x0 + w / 2, y0 + h / 2, float(h), float(w), float(w * h)]]
    ann_path = root / "ann.json"
    ann_path.write_text(json.dumps(annotations))
    return {"images": str(images), "annotations": str(ann_path),
            "root": root}


def common(dataset, tmp_path):
    return ["--preset", "tiny_96", "--batch-size", "4",
            "--checkpoint-dir", str(tmp_path / "ckpt")]


@pytest.mark.slow
def test_cli_train_eval_visualize_plot(dataset, tmp_path, capsys):
    metrics = str(tmp_path / "metrics.jsonl")
    main(["train",
          "--train-images", dataset["images"],
          "--train-annotations", dataset["annotations"],
          "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"],
          "--epochs", "3", "--learning-rate", "1e-4",
          "--epochs-warm-up", "1", "--skip-epochs", "1",
          "--metrics", metrics, *common(dataset, tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(out)
    assert "best_ap" in result and np.isfinite(result["final_loss"])
    assert os.path.exists(metrics)

    main(["evaluate", "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"],
          "--restore", "final", *common(dataset, tmp_path)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= result["mAP"] <= 1.0

    # Mesh-sharded evaluation (the flags used to be silently ignored):
    # same mAP as the single-device run above.
    main(["evaluate", "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"],
          "--restore", "final", "--data-parallel", "4",
          "--model-parallel", "2", *common(dataset, tmp_path)])
    sharded = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sharded["mAP"] == pytest.approx(result["mAP"], abs=1e-6)

    # batch 3 over 4 images: the OFFICIAL protocol must score the ragged
    # final batch too (the reference-twin metric above drops it, parity
    # with vtu.py:609-610).
    main(["evaluate", "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"],
          "--restore", "final", "--protocol", "coco", "--batch-size", "3",
          "--checkpoint-dir", str(tmp_path / "ckpt"), "--preset",
          "tiny_96"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["protocol"] == "coco"
    for key in ("AP", "AP50", "AP75", "AR@1", "AR@10", "AR@100"):
        assert key in result
        assert result[key] == -1.0 or 0.0 <= result[key] <= 1.0

    main(["visualize", "--images", dataset["images"],
          "--images-range", "0", "2", "--restore", "final",
          "--output-dir", str(tmp_path / "viz"),
          "--objectness-threshold", "0.0",
          "--classification-threshold", "0.0",
          "--contact-sheet", str(tmp_path / "viz" / "sheet.html"),
          *common(dataset, tmp_path)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(result["written"]) == 2
    assert all(os.path.exists(p) for p in result["written"])
    # Interactive contact sheet: every PNG embedded, keyboard handler on
    # board (the reference cv2 viewer's replacement, vtd.py:2342-2354).
    sheet = open(result["contact_sheet"]).read()
    assert sheet.count("<figure>") == 2
    assert "data:image/png;base64," in sheet and "keydown" in sheet

    main(["plot", "--metrics", metrics,
          "--output", str(tmp_path / "curves.html")])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.exists(result["written"])


def test_cli_predict(dataset, tmp_path, capsys):
    main(["predict", "--images", dataset["images"],
          "--images-range", "0", "2", *common(dataset, tmp_path)])
    out = json.loads(capsys.readouterr().out.strip())
    assert len(out) == 2
    assert len(out[0]["detections"]) == 17


@pytest.mark.slow
def test_cli_sweep_synthetic(tmp_path, capsys):
    """One command reproduces a 2x2 mini-sweep with the records table
    (replaces the notebook's nested sweep loops, ipynb cells 6/7/9)."""
    out_dir = str(tmp_path / "sweep")
    main(["sweep", "--preset", "tiny_96", "--batch-size", "2",
          "--synthetic", "--epochs", "2",
          "--sweep", "embedding_dim=8,16",
          "--sweep", "learning_rate=8e-5,4e-5",
          "--out-dir", out_dir])
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["records"] == 4
    # Table header carries the swept columns + records columns.
    assert "embedding_dim" in out[0] and "lowest_loss" in out[0]
    records_path = os.path.join(out_dir, "records.jsonl")
    with open(records_path) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 4
    assert {(r["embedding_dim"], r["learning_rate"]) for r in records} == {
        (8, 8e-5), (8, 4e-5), (16, 8e-5), (16, 4e-5)}
    assert all(np.isfinite(r["final_loss"]) for r in records)
    assert all(os.path.exists(r["metrics_path"]) for r in records)


def test_cli_sweep_dataset(dataset, tmp_path, capsys):
    """Sweep over real dataset files with eval (best_AP column live)."""
    out_dir = str(tmp_path / "sweepd")
    main(["sweep", "--preset", "tiny_96", "--batch-size", "4",
          "--epochs", "2", "--epochs-warm-up", "0", "--skip-epochs", "1",
          "--train-images", dataset["images"],
          "--train-annotations", dataset["annotations"],
          "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"],
          "--sweep", "learning_rate=1e-4",
          "--out-dir", out_dir])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["records"] == 1
    assert 0.0 <= summary["best_AP"] <= 1.0


def test_sweep_rejects_unknown_param(tmp_path):
    from vision_transformer_detector.train.sweep import split_overrides
    with pytest.raises(KeyError, match="not a field"):
        split_overrides({"nonexistent_param": 1})


def test_cli_stats(dataset, capsys):
    main(["stats", "--annotations", dataset["annotations"]])
    result = json.loads(capsys.readouterr().out)
    assert result["images"] == 4
    assert result["most_frequent_category"] == 1


def test_cli_export_and_reload(tmp_path, capsys):
    out_dir = str(tmp_path / "exported")
    main(["export", "--preset", "tiny_96", "--batch-size", "2",
          "--output-dir", out_dir])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["exported"] == out_dir
    assert os.path.exists(os.path.join(out_dir, "model.stablehlo"))

    from vision_transformer_detector.export import load_exported
    detector = load_exported(out_dir)
    out = detector(np.zeros((2, 96, 96, 3), np.float32))
    assert out.shape == (2, 17, 6)


def test_cli_sweep_batch_size_reaches_datasets(dataset, tmp_path, capsys):
    """Swept batch_size must drive the DATASET construction, not just the
    TrainConfig label (round-3 review: both grid points used to train on
    identical base-batch data), and swept epochs must not be overridden
    by the CLI default."""
    out_dir = str(tmp_path / "sweep_bs")
    main(["sweep", "--preset", "tiny_96",
          "--train-images", dataset["images"],
          "--train-annotations", dataset["annotations"],
          "--epochs", "1",
          "--sweep", "batch_size=2,4",
          "--out-dir", out_dir, "--checkpoint-dir",
          str(tmp_path / "ckpt")])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["records"] == 2
    # 4 fixture images: batch_size 2 -> 2 steps/epoch, 4 -> 1 step/epoch;
    # count the per-run metric records' train batches via the metrics
    # files (each fit epoch writes one record; the loss differs when the
    # number of batches differs, but steps/epoch is directly visible in
    # the trainer's steps_per_epoch -> use the datasets' lengths via
    # per-run metrics presence).
    with open(os.path.join(out_dir, "records.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert {r["batch_size"] for r in records} == {2, 4}
    assert all("plot_path" in r for r in records)   # persisted with plot


def test_cli_benchmark_inference_and_train(tmp_path, capsys):
    main(["benchmark", *common({}, tmp_path), "--batch-size", "2",
          "--preset", "tiny_96", "--iterations", "2"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["mode"] == "inference" and result["batch"] == 2
    assert result["ms_per_step"] > 0 and result["img_per_s"] > 0

    main(["benchmark", *common({}, tmp_path), "--batch-size", "2",
          "--preset", "tiny_96", "--iterations", "2", "--mode", "train"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["mode"] == "train"
    assert result["ms_per_step"] > 0 and result["img_per_s"] > 0


def test_cli_benchmark_inference_honors_mesh_flags(tmp_path, capsys):
    """--data-parallel/--model-parallel used to be silently ignored in
    inference mode (single-device numbers mislabeled as the requested
    config — round-3 review finding); now the batch/params shard, and a
    non-divisible batch errors instead of measuring something else."""
    import pytest

    main(["benchmark", *common({}, tmp_path), "--batch-size", "8",
          "--preset", "tiny_96", "--iterations", "2",
          "--data-parallel", "4", "--model-parallel", "2"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["mode"] == "inference" and result["batch"] == 8
    assert result["ms_per_step"] > 0

    with pytest.raises(SystemExit, match="not divisible"):
        main(["benchmark", *common({}, tmp_path), "--batch-size", "6",
              "--preset", "tiny_96", "--iterations", "2",
              "--data-parallel", "8"])


def test_cli_no_flash_attention_override(tmp_path, capsys):
    """--no-flash-attention forces einsum everywhere, including clearing
    a preset's train-only flash override; combining both flags errors."""
    import pytest

    from vision_transformer_detector.cli import (
        _build_config, build_parser)

    parser = build_parser()
    args = parser.parse_args(
        ["benchmark", "--preset", "reference_608", "--no-flash-attention"])
    config = _build_config(args)
    assert config.use_flash_attention is False
    assert config.train_use_flash_attention is False

    args = parser.parse_args(
        ["benchmark", "--preset", "tiny_96",
         "--flash-attention", "--no-flash-attention"])
    with pytest.raises(SystemExit):
        _build_config(args)


def test_cli_train_resumable_resume(dataset, tmp_path, capsys):
    """--resumable: the input position is checkpointed beside the model
    state, and --restore picks the stream up instead of replaying it."""
    args = ["--train-images", dataset["images"],
            "--train-annotations", dataset["annotations"],
            "--epochs", "2", "--learning-rate", "1e-4",
            "--skip-epochs", "1", "--epochs-warm-up", "0",
            "--metrics", str(tmp_path / "m.jsonl"),
            "--resumable", *common(dataset, tmp_path)]
    main(["train", *args])
    capsys.readouterr()
    ckpt = tmp_path / "ckpt"
    sidecar = ckpt / "ongoing.dataset.json"
    assert sidecar.exists()
    saved = json.loads(sidecar.read_text())
    assert saved["seed"] == 0 and saved["epoch"] >= 0

    main(["train", "--restore", "ongoing", *args])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert np.isfinite(json.loads(out)["final_loss"])
    resumed = json.loads(sidecar.read_text())
    # The stream moved forward from the restored position.
    assert (resumed["epoch"], resumed["batch"]) > (
        saved["epoch"], saved["batch"])


def test_cli_train_epochs_per_call(dataset, tmp_path, capsys):
    """--epochs-per-call K: the device-resident scanned window drives the
    same run as the per-epoch loop — one metrics record per epoch, eval
    cadence intact — and rejects stream-mutating flag combinations."""
    metrics = str(tmp_path / "m.jsonl")
    main(["train",
          "--train-images", dataset["images"],
          "--train-annotations", dataset["annotations"],
          "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"],
          "--epochs", "5", "--learning-rate", "1e-4",
          "--epochs-warm-up", "1", "--skip-epochs", "2",
          "--epochs-per-call", "3",
          "--metrics", metrics, *common(dataset, tmp_path)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["final_loss"])
    assert 0.0 <= result["best_ap"] <= 1.0
    records = [json.loads(line) for line in open(metrics)]
    assert [r["epoch"] for r in records] == list(range(5))
    # eval fired at warm-up cadence epochs 1 and 3 despite the windows
    assert [r["epoch"] for r in records if "ap" in r] == [1, 3]

    for bad in ("--shuffle", "--resumable"):
        with pytest.raises(SystemExit, match="incompatible"):
            main(["train",
                  "--train-images", dataset["images"],
                  "--train-annotations", dataset["annotations"],
                  "--epochs", "2", "--epochs-per-call", "2", bad,
                  *common(dataset, tmp_path)])


def test_cli_score_coco(tmp_path, capsys):
    """score-coco: standalone official-protocol scoring of a results
    JSON, no model/checkpoint involved."""
    gt = {
        "images": [{"id": 1}],
        "annotations": [{"image_id": 1, "category_id": 1,
                         "bbox": [10, 10, 40, 40], "area": 1600.0,
                         "iscrowd": 0, "id": 1}],
        "categories": [{"id": 1, "name": "person"}],
    }
    results = [{"image_id": 1, "category_id": 1,
                "bbox": [10, 10, 40, 40], "score": 0.9}]
    gt_path = tmp_path / "gt.json"
    dt_path = tmp_path / "dt.json"
    gt_path.write_text(json.dumps(gt))
    dt_path.write_text(json.dumps(results))
    main(["score-coco", "--annotations", str(gt_path),
          "--results", str(dt_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["protocol"] == "coco"
    assert out["AP"] == pytest.approx(1.0)
    assert out["AP75"] == pytest.approx(1.0)


def test_cli_doctor_reports_dead_backend(tmp_path, capsys):
    """doctor: the devices of this process are reported in process
    (platform, kind, count); with no accelerator the device is not ok and
    the exit code is nonzero; native-extension flags are present."""
    import jax

    with pytest.raises(SystemExit) as exc:
        main(["doctor", "--probe-timeout", "0.05"])
    assert exc.value.code == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == {"ok": False, "platform": "cpu",
                                "kind": jax.devices()[0].device_kind,
                                "count": len(jax.devices())}
    assert set(report["native"]) == {"coco_json", "pipeline", "coco_eval"}


def test_cli_evaluate_rejects_empty_dataset(dataset, tmp_path, capsys):
    """A typo'd --val-images used to report mAP 0.0 as if the model were
    bad; a nonexistent dir now raises, and an existing dir with no
    matching images exits with a clear message."""
    with pytest.raises(FileNotFoundError):
        main(["evaluate", "--val-images", str(tmp_path / "nope"),
              "--val-annotations", dataset["annotations"],
              *common(dataset, tmp_path)])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no evaluation batches"):
        main(["evaluate", "--val-images", str(empty),
              "--val-annotations", dataset["annotations"],
              *common(dataset, tmp_path)])


def test_cli_fast_decode_reaches_every_decode_site(dataset, tmp_path,
                                                   capsys, monkeypatch):
    """--fast-decode must actually arrive at the decoder on each
    CLI path that decodes files (review finding: the flag parsed
    everywhere but predict/visualize/coco-original ignored it)."""
    from vision_transformer_detector.data import pipeline as pl

    seen = []
    real = pl.load_and_letterbox_image

    def spy(path, config, normalize=True, use_native=None,
            fast_decode=False):
        seen.append(fast_decode)
        return real(path, config, normalize=normalize,
                    use_native=use_native, fast_decode=fast_decode)

    monkeypatch.setattr(pl, "load_and_letterbox_image", spy)
    # predict and visualize import the symbol inside the command body,
    # so patching the module attribute is enough.
    main(["predict", "--images", dataset["images"],
          "--images-range", "0", "2", "--fast-decode",
          *common(dataset, tmp_path)])
    capsys.readouterr()
    assert seen and all(seen), "predict dropped --fast-decode"

    seen.clear()
    main(["visualize", "--images", dataset["images"],
          "--images-range", "0", "2", "--fast-decode",
          "--output-dir", str(tmp_path / "viz"),
          *common(dataset, tmp_path)])
    capsys.readouterr()
    assert seen and all(seen), "visualize dropped --fast-decode"

    seen.clear()
    main(["evaluate", "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"],
          "--protocol", "coco-original", "--fast-decode",
          *common(dataset, tmp_path)])
    capsys.readouterr()
    assert seen and all(seen), "coco-original evaluate dropped --fast-decode"

    # The dataset-backed path (train/evaluate default protocol) takes the
    # CocoDetectionDataset constructor instead; pin the kwarg there.
    captured = {}
    real_ds = pl.CocoDetectionDataset

    class SpyDataset(real_ds):
        def __init__(self, *a, **kw):
            captured["fast_decode"] = kw.get("fast_decode", False)
            super().__init__(*a, **kw)

    monkeypatch.setattr(pl, "CocoDetectionDataset", SpyDataset)
    import vision_transformer_detector.cli as cli_mod
    monkeypatch.setattr(cli_mod, "CocoDetectionDataset", SpyDataset,
                        raising=False)
    main(["evaluate", "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"], "--fast-decode",
          *common(dataset, tmp_path)])
    capsys.readouterr()
    assert captured.get("fast_decode") is True


def test_cli_restore_latest_everywhere(dataset, tmp_path, capsys):
    """--restore latest resolves to the newest step-stamped checkpoint
    in EVERY subcommand (evaluate/predict used to pass the literal
    string into Trainer.restore and die on a nonexistent path)."""
    main(["train",
          "--train-images", dataset["images"],
          "--train-annotations", dataset["annotations"],
          "--epochs", "2", "--learning-rate", "1e-4",
          "--epochs-warm-up", "10", "--skip-epochs", "1",
          "--keep-checkpoints", "2", *common(dataset, tmp_path)])
    capsys.readouterr()

    main(["evaluate", "--val-images", dataset["images"],
          "--val-annotations", dataset["annotations"],
          "--restore", "latest", *common(dataset, tmp_path)])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= result["mAP"] <= 1.0

    main(["predict", "--images", dataset["images"],
          "--images-range", "0", "1", "--restore", "latest",
          *common(dataset, tmp_path)])
    out = json.loads(capsys.readouterr().out.strip())
    assert len(out) == 1


def test_cli_single_device_commands_reject_mesh_flags(dataset, tmp_path):
    """predict/visualize/serve refuse --data-parallel/--model-parallel
    instead of silently running on one device (round-4 review)."""
    for cmd, extra in (
            ("predict", ["--images", dataset["images"]]),
            ("visualize", ["--images", dataset["images"],
                           "--output-dir", str(tmp_path / "viz")]),
            ("serve", [])):
        with pytest.raises(SystemExit, match="single-device"):
            main([cmd, *extra, "--data-parallel", "2",
                  *common(dataset, tmp_path)])


def test_cli_serve_from_export_refuses_model_flags(tmp_path):
    """--from-export + --int8/--params-npz/--restore is refused: the
    frozen artifact owns its weights, and silently ignoring --int8 made
    operators record full-precision numbers as quantized."""
    with pytest.raises(SystemExit, match="cannot honour --int8"):
        main(["serve", "--from-export", str(tmp_path / "artifact"),
              "--int8"])


def test_cli_sweep_requires_data_or_synthetic(tmp_path):
    with pytest.raises(SystemExit, match="--synthetic"):
        main(["sweep", "--preset", "tiny_96",
              "--sweep", "learning_rate=1e-4",
              "--out-dir", str(tmp_path / "s")])


def test_cli_benchmark_rejects_nonpositive_iterations(capsys):
    with pytest.raises(SystemExit):
        main(["benchmark", "--preset", "tiny_96", "--iterations", "0"])
    assert "positive integer" in capsys.readouterr().err


def test_cli_shuffle_seed_varies_order(dataset, tmp_path):
    """--seed reaches the path shuffle: two seeds give two orders (a
    hardcoded seed=0 used to make every run train on identical batch
    sequences)."""
    import argparse

    from vision_transformer_detector.cli import (_build_dataset,
                                                     build_parser)
    from vision_transformer_detector.config import get_config

    def build(seed):
        args = build_parser().parse_args(
            ["train", "--train-images", dataset["images"],
             "--train-annotations", dataset["annotations"],
             "--seed", str(seed), "--batch-size", "1",
             "--preset", "tiny_96"])
        ds = _build_dataset(args, get_config("tiny_96"),
                            dataset["images"], dataset["annotations"],
                            shuffle=True)
        return list(ds.image_paths)

    orders = {tuple(build(seed)) for seed in range(6)}
    assert len(orders) > 1


def test_cli_benchmark_train_honors_mesh_flags(tmp_path, capsys):
    """Train mode runs under the trainer's mesh context (it used to call
    train_step with no enclosing Mesh — sequence_sharding configs failed
    at trace time) and gets the same divisibility guard as inference."""
    main(["benchmark", *common({}, tmp_path), "--batch-size", "8",
          "--preset", "tiny_96", "--iterations", "2", "--mode", "train",
          "--data-parallel", "4", "--model-parallel", "2"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["mode"] == "train" and result["batch"] == 8
    assert result["ms_per_step"] > 0

    with pytest.raises(SystemExit, match="not divisible"):
        main(["benchmark", *common({}, tmp_path), "--batch-size", "6",
              "--preset", "tiny_96", "--iterations", "2",
              "--mode", "train", "--data-parallel", "8"])


def test_cli_datasets_ship_uint8(dataset):
    """The CLI's datasets ship uint8 batches (4x less host->device
    traffic; the jitted train/eval steps normalize on device via
    _maybe_normalize) — round-5 ingest lever."""
    from vision_transformer_detector.cli import (_build_dataset,
                                                     build_parser)
    from vision_transformer_detector.config import get_config

    args = build_parser().parse_args(
        ["train", "--train-images", dataset["images"],
         "--train-annotations", dataset["annotations"],
         "--batch-size", "2", "--preset", "tiny_96"])
    ds = _build_dataset(args, get_config("tiny_96"),
                        dataset["images"], dataset["annotations"])
    images, labels = next(iter(ds))
    assert images.dtype == np.uint8
    assert labels.dtype == np.float32

    args = build_parser().parse_args(
        ["train", "--train-images", dataset["images"],
         "--train-annotations", dataset["annotations"],
         "--batch-size", "2", "--preset", "tiny_96", "--resumable"])
    rds = _build_dataset(args, get_config("tiny_96"),
                         dataset["images"], dataset["annotations"],
                         resumable=True)
    images, _labels = next(iter(rds))
    assert images.dtype == np.uint8
