"""Model-zoo OOD evaluation sweep CLI of the port (counterpart of ``rba_tpu.evalx.sweep``).

After the reference RbA code's ``evaluate_ood.py``: iterate a models folder (each
subdirectory holding ``config.yaml`` and the weights: ``params.npz``, or a released
Detectron2 ``model_final.pth``/``.pkl``, converted on first use and cached as
``params.npz``), evaluate each model on each dataset, skip the (model, dataset)
pairs already in ``results.pkl`` (resumable sweeps), optionally dump anomaly-score
maps, and write ``results.pkl`` / ``results.json``.  ``--tta`` (multi-scale and flip
test-time augmentation, ``TEST.AUG``) and ``--sliding-window`` (1024×1024 tiles)
score each image's blended ``sem_seg`` with exact all-pixel metrics.

Usage:
    python -m rba_tpu_torch.evalx.sweep \\
        --models_folder ckpts/ --datasets_folder datasets/ \\
        --model_mode all --dataset_mode all --score_func rba --precision fast

It runs on the card unless ``--device`` names another (``--device cpu``).
``--attention`` picks Swin's window-attention branch: ``fused`` (Kernel A, the
default), ``fused_softmax`` (Kernel C) or ``xla`` (``rba_tpu``'s default chain in
plain PyTorch), where ``rba_tpu`` reads its environment switches.  Pass
``--shard i/n`` to run the i-th shard of the (model, dataset) work list; results
merge by file layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
from pprint import pprint

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--models_folder", default="ckpts/")
    p.add_argument("--datasets_folder", default="datasets/")
    p.add_argument("--model_mode", default="all", help="'all' or comma list of model dirs")
    p.add_argument("--dataset_mode", default="all", help="'all' or comma list of dataset names")
    p.add_argument("--score_func", default="rba", choices=["rba", "pebal", "dense_hybrid"])
    p.add_argument("--out_path", default="results/")
    p.add_argument("--models_list", nargs="*", default=None)
    p.add_argument("--selected_models", nargs="*", default=[],
                   help="used with --model_mode selected (reference CLI)")
    p.add_argument("--selected_datasets", nargs="*", default=[],
                   help="used with --dataset_mode selected (reference CLI)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--store_anomaly_scores", action="store_true")
    p.add_argument("--upper_limit", type=int, default=1300)
    # accepted for reference-CLI compatibility (the evaluator runs at batch 1 with
    # its own prefetch thread)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device of the models: the GPU by default, 'cpu' to run on the CPU")
    p.add_argument("--smoothing", action="store_true")
    p.add_argument("--tta", action="store_true",
                   help="multi-scale + flip test-time augmentation (TEST.AUG semantics)")
    p.add_argument("--sliding-window", action="store_true",
                   help="tiled inference for very high-res inputs (Mapillary)")
    p.add_argument("--exact", action="store_true",
                   help="all-pixel sklearn-equivalent metrics instead of streaming histograms")
    p.add_argument("--precision", default="fast", choices=["fast", "parity", "fp32"],
                   help="model numerics: 'fast' (fast_serving: bf16 pixel decoder inputs, bf16 "
                        "attention softmax, bf16 one-hot deformable sampling), 'parity' (bf16 backbone, "
                        "fp32-pinned pixel decoder, the reference's AMP semantics), 'fp32' (everything fp32)")
    p.add_argument("--attention", default="fused", choices=["fused", "fused_softmax", "xla"],
                   help="Swin's window-attention branch: 'fused' (Kernel A), 'fused_softmax' (Kernel C; "
                        "under --precision fast the bf16 softmax of 'xla'), 'xla' (rba_tpu's default chain "
                        "in plain PyTorch)")
    p.add_argument("--shard", default=None, help="i/n work-list sharding for multi-host sweeps")
    p.add_argument("--fuse_models", action="store_true",
                   help="upload each image once and score it with ALL models "
                        "before the next (streaming path only): amortizes the "
                        "host->device transfer over the model zoo "
                        "(evaluator.evaluate_dataset_multi)")
    return p.parse_args(argv)


def result_exists(out_path: str, model_name: str) -> bool:
    return os.path.exists(os.path.join(out_path, model_name, "results.pkl"))


def load_results(out_path: str, model_name: str) -> dict:
    """Existing per-model results ({dataset: metrics}), or {}."""
    p = os.path.join(out_path, model_name, "results.pkl")
    if not os.path.exists(p):
        return {}
    with open(p, "rb") as f:
        return pickle.load(f)


def save_results(out_path: str, model_name: str, results: dict, verbose: bool):
    """Merge ``results`` into the on-disk per-model dict and write it.

    Merge-on-write (instead of overwrite) keeps concurrent --shard i/n runs
    of the same model on different datasets from clobbering each other, and
    incremental callers (one save per finished dataset) resumable."""
    results = {**load_results(out_path, model_name), **results}
    if verbose:
        pprint(results)
    store = os.path.join(out_path, model_name)
    os.makedirs(store, exist_ok=True)
    with open(os.path.join(store, "results.pkl"), "wb") as f:
        pickle.dump(results, f)
    with open(os.path.join(store, "results.json"), "w") as f:
        json.dump(results, f, indent=2)


def load_model(model_dir: str, precision: str = "fast", device=None):
    """(config, model) from ``model_dir``: ``config.yaml`` and ``params.npz`` or
    ``model_final.pth``/``.pkl``."""
    from ..config import fast_serving, load_d2_config
    from ..convert import load_checkpoint_params

    cfg = load_d2_config(os.path.join(model_dir, "config.yaml"))
    if precision == "fast":
        cfg = fast_serving(cfg)
    elif precision == "fp32":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    return cfg, load_checkpoint_params(model_dir, cfg, device=device)


def store_score_pngs(scores: np.ndarray, path: str, names=None):
    """Visualization PNGs (reference behavior) plus raw per-image ``.npy``
    score maps named after the source images — the format SegmentMeIfYouCan
    submissions consume."""
    os.makedirs(path, exist_ok=True)
    if names is None:
        names = [f"score_{i}" for i in range(len(scores))]
    for i, s in enumerate(scores):
        base = os.path.splitext(os.path.basename(names[i]))[0]
        np.save(os.path.join(path, base + ".npy"), s.squeeze().astype(np.float32))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.image as mpimg

        for i, s in enumerate(scores):
            base = os.path.splitext(os.path.basename(names[i]))[0]
            mpimg.imsave(os.path.join(path, base + ".png"), s.squeeze(), cmap="viridis")
    except ImportError:
        pass


def _variant_metrics(evaluator, dataset, args) -> dict:
    """Exact all-pixel metrics of the RbA or energy score of each image's ``--tta`` or
    ``--sliding-window`` sem_seg (optionally Gaussian-smoothed)."""
    from ..models.maskformer import energy_score, rba_score
    from ..models.sliding_window import sliding_window_sem_seg
    from ..models.tta import tta_inference
    from .evaluator import _gaussian_blur, _names
    from .metrics import exact_ood_metrics

    infer = tta_inference if args.tta else sliding_window_sem_seg
    score_op = rba_score if args.score_func == "rba" else energy_score
    scores, gts = [], []
    for i, sample in enumerate(dataset):
        if i >= args.upper_limit:
            break
        sem = infer(evaluator.model, evaluator.cfg, sample.image, attention=evaluator.attention)
        s = score_op(sem[None])
        if args.smoothing:
            s = _gaussian_blur(s)
        scores.append(s[0].cpu().numpy())
        gts.append(sample.label)
    return _names(exact_ood_metrics(np.stack(scores).reshape(-1), np.stack(gts).reshape(-1)))


def main(argv=None):
    args = parse_args(argv)
    variant = args.tta or args.sliding_window
    if args.fuse_models and (variant or args.exact or args.store_anomaly_scores):
        raise SystemExit(
            "--fuse_models applies to the streaming path only "
            "(not --tta/--sliding-window/--exact/--store_anomaly_scores)"
        )
    if variant and args.score_func == "dense_hybrid":
        # dense_hybrid needs the model's ood_pred head, which the blended sem_seg does not carry
        raise SystemExit("--score_func dense_hybrid is not supported with --tta/--sliding-window")
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("the sweep runs on the GPU by default and none is available; "
                           "pass --device cpu to run on the CPU")
    device = args.device or "cuda"
    from ..data.ood_datasets import get_datasets
    from .evaluator import OODEvaluator

    datasets = get_datasets(args.datasets_folder)
    if args.dataset_mode != "all":
        # reference semantics: "selected" reads the --selected_datasets list; a
        # comma list is accepted too
        if args.dataset_mode == "selected":
            keep = set(args.selected_datasets)
            if not keep:
                # an empty selection would read as "all clean"
                raise SystemExit("--dataset_mode selected requires --selected_datasets")
        else:
            keep = set(args.dataset_mode.split(","))
        if "synthetic" in keep:
            # procedural no-file-IO dataset: a self-contained end-to-end smoke of
            # the whole sweep (model load -> inference -> scores -> metrics ->
            # results.pkl)
            from ..data.ood_datasets import SyntheticAnomaly

            datasets["synthetic"] = SyntheticAnomaly()
        datasets = {k: v for k, v in datasets.items() if k in keep}

    if args.model_mode == "selected" or args.models_list:
        # --selected_models only applies under --model_mode selected; an empty
        # selection is an error, not an empty sweep
        names = args.models_list or args.selected_models
        if not names:
            raise SystemExit("--model_mode selected requires --selected_models")
        model_dirs = [os.path.join(args.models_folder, m) for m in names]
    elif args.model_mode == "all":
        model_dirs = sorted(
            os.path.join(args.models_folder, d)
            for d in os.listdir(args.models_folder)
            if os.path.isdir(os.path.join(args.models_folder, d))
        )
    else:
        model_dirs = [os.path.join(args.models_folder, m) for m in args.model_mode.split(",")]

    work = [(m, d) for m in model_dirs for d in sorted(datasets)]
    if args.shard:
        i, n = (int(v) for v in args.shard.split("/"))
        work = work[i::n]

    if args.fuse_models:
        from .evaluator import evaluate_dataset_multi

        by_ds: dict = {}
        for model_dir, ds_name in work:
            by_ds.setdefault(ds_name, []).append(model_dir)
        # --fuse_models keys evaluators and results.pkl rows by basename; two zoo
        # dirs sharing a basename would silently collide
        bases: dict = {}
        for model_dir, _ in work:
            base = os.path.basename(model_dir.rstrip("/"))
            if bases.setdefault(base, model_dir) != model_dir:
                raise SystemExit(
                    f"--fuse_models: duplicate model basename {base!r} "
                    f"({bases[base]} vs {model_dir}) — results would collide; "
                    "rename one of the zoo directories"
                )
        for ds_name, dirs in sorted(by_ds.items()):
            evs = {}
            for model_dir in dirs:
                model_name = os.path.basename(model_dir.rstrip("/"))
                if ds_name in load_results(args.out_path, model_name):
                    print(f"skip {model_name}/{ds_name}: already in results.pkl")
                    continue
                cfg, model = load_model(model_dir, precision=args.precision, device=device)
                evs[model_name] = OODEvaluator(cfg, model, score=args.score_func,
                                               use_gaussian_smoothing=args.smoothing, attention=args.attention)
            if not evs:
                continue
            print(f"evaluating {len(evs)} models on {ds_name} "
                  f"({len(datasets[ds_name])} images, fused uploads)")
            results = evaluate_dataset_multi(evs, datasets[ds_name], upper_limit=args.upper_limit)
            for model_name, metrics in results.items():
                print(f"  {model_name}: {metrics}")
                save_results(args.out_path, model_name, {ds_name: metrics}, args.verbose)
        return

    loaded = {}
    for model_dir, ds_name in work:
        model_name = os.path.basename(model_dir.rstrip("/"))
        # resumability is per (model, dataset): a partial results.pkl from an
        # interrupted or sharded run only skips its finished datasets
        if ds_name in load_results(args.out_path, model_name):
            print(f"skip {model_name}/{ds_name}: already in results.pkl")
            continue
        if model_dir not in loaded:
            print(f"loading {model_name} ...")
            cfg, model = load_model(model_dir, precision=args.precision, device=device)
            loaded.clear()  # keep one model in memory
            loaded[model_dir] = OODEvaluator(cfg, model, score=args.score_func,
                                             use_gaussian_smoothing=args.smoothing, attention=args.attention)
        evaluator = loaded[model_dir]
        print(f"evaluating {model_name} on {ds_name} ({len(datasets[ds_name])} images)")
        if variant:
            metrics = _variant_metrics(evaluator, datasets[ds_name], args)
        elif args.exact or args.store_anomaly_scores:
            scores, gts = evaluator.compute_anomaly_scores(datasets[ds_name], upper_limit=args.upper_limit)
            if args.store_anomaly_scores:
                names = [os.path.basename(p) for p in datasets[ds_name].images[: len(scores)]]
                store_score_pngs(scores, os.path.join("anomaly_scores", model_name, ds_name), names)
            metrics = evaluator.evaluate_ood(scores, gts)
        else:
            metrics = evaluator.evaluate_dataset(datasets[ds_name], upper_limit=args.upper_limit)
        print(f"  {metrics}")
        # save after EVERY finished dataset: a crash loses at most the in-flight
        # dataset, and shards merge instead of clobbering
        save_results(args.out_path, model_name, {ds_name: metrics}, args.verbose)


if __name__ == "__main__":
    main()
