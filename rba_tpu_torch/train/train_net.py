"""The trainer CLI (counterpart of ``rba_tpu/train/train_net.py``).

Usage:
    python -m rba_tpu_torch.train.train_net --config-file configs/cityscapes/swin_b_1dl_ood_coco.yaml \
        --data-root datasets/cityscapes [--coco-root datasets/coco] [--weights MODEL_DIR] \
        [--max-iter N] [--batch-size B] [--grad-accum K] [--resume] [--device cpu] \
        [--eval-only] [--eval-period N] [--eval-max-images N] [--num-gpus N]
    torchrun --nproc_per_node=N -m rba_tpu_torch.train.train_net --config-file ... (as above)

``--config-file`` is a Detectron2 YAML or a native one (``config.load_config``), such as
the non-Swin recipes under ``configs/cityscapes/semantic-segmentation/`` (ResNet, MiT,
MViT, ViT, WiderResNet-38: every backbone family trains).  A config-driven loop on one GPU or
several (``--device`` asks for another device, e.g. the CPU): the
mapper named by ``INPUT.DATASET_MAPPER_NAME`` fed by mapper threads, the train step of
``train/train_step.py`` (the batch goes to the card), ``metrics.jsonl`` every
``--log-period`` steps (the losses, ``grad_norm``, images/s and, with the COCO-mix
mapper, ``ood_images``: the step's images with a pasted object), and a checkpoint every ``--checkpoint-period`` steps and at the
end (``convert/checkpoint.py``: ``step_N/params.npz``, which ``load_checkpoint_params``
and ``rba_tpu`` read, and the optimizer, step and generator state).  ``--weights`` starts
from a model directory (its ``params.npz`` or Detectron2 ``model_final.pth``), as
Detectron2's ``MODEL.WEIGHTS`` does; without it the weights are seeded random.

Evaluation (``run_val_eval``): every ``--eval-period`` steps (default
``TEST.EVAL_PERIOD``; 0 disables) the val split of the first ``DATASETS.TEST`` name that
resolves (Cityscapes val under ``--data-root``, or a name of ``data/catalog.py`` under
its parent, the datasets directory) is scored, and the result goes to ``metrics.jsonl``
with its step: mIoU (``SemSegEvaluator``), or for a panoptic split such as
``coco_2017_val_panoptic_open`` PQ (``OpenPanopticEvaluator``) and, as
``MODEL.MASK_FORMER.TEST`` asks, mIoU and mask AP.  ``--eval-only`` scores the latest
checkpoint of ``--output-dir`` (or the ``--weights``), adds a test-time-augmentation pass
where ``TEST.AUG.ENABLED``, and exits.  An evaluation runs under ``torch.inference_mode``
in eval mode (on the card Kernel A), and leaves the training stream as it was: the
parameters, the optimizer, the criterion's generator and the mapper threads' draws.

Every mapper of the reference is taken: the semantic ones (plain, COCO-mix, void as
outlier, StreetHazards plain and COCO-mix), the panoptic and instance ones (plain,
open-panoptic, and the LSJ ``coco_panoptic_lsj`` and ``coco_instance_lsj``).
``DATASETS.TRAIN`` may list several names, read as one ``ConcatDataset``; a name whose
data is missing is skipped with a warning, and only where none resolves does the trainer
raise.  Panoptic names give (image, ids, segments) to the panoptic mappers, and through
``InstanceFromPanoptic`` (image, masks, classes) to the instance ones.

Every head trains: the masked decoder, MaskFormer v1's decoder and the simple decoder
through the criterion, the per-pixel baseline heads on their cross-entropy.

Several GPUs (data parallelism, ``parallel/mesh.py``): ``--num-gpus N`` > 1 starts N
worker processes, one per GPU, that rendezvous through a file under ``--output-dir``, as
Detectron2's ``launch`` does; under torchrun's environment (``RANK``, ``WORLD_SIZE``, ...),
or inside a process group that the caller has formed, the trainer joins that group
whatever ``--num-gpus`` says.  NCCL on the card, gloo with ``--device cpu``.  The global
batch must divide by the ranks × ``--grad-accum``; each rank reads and maps only its
rows of each global batch (the samples' draws are seeded by stream position, so the
ranks' rows together are the 1-process batch), and the train step completes its sums
and gradients over the ranks (``train/train_step.py``), so N ranks train the 1-process
run's function.  Rank 0 logs the global metrics and writes ``metrics.jsonl``, the
checkpoints and the evaluations; every rank restores.  ``--num-gpus 1`` outside torchrun
is the 1-process loop.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import queue
import random
import sys
import threading
import time
from typing import Iterator

import numpy as np

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--data-root", required=True, help="cityscapes root (leftImg8bit/gtFine)")
    p.add_argument("--coco-root", default=None, help="COCO root for OOD mixing")
    p.add_argument("--output-dir", default="output/")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="global batch (default SOLVER.IMS_PER_BATCH)")
    p.add_argument("--checkpoint-period", type=int, default=5000)
    p.add_argument("--log-period", type=int, default=20)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=None,
                   help="mapper threads feeding the prefetch queue (default: DATALOADER.NUM_WORKERS)")
    p.add_argument("--mapper", default=None,
                   choices=[None, "mask_former_semantic", "mask_former_semantic_coco_mix",
                            "mask_former_semantic_void", "mask_former_semantic_street_hazards",
                            "mask_former_semantic_street_hazards_coco_mix"])
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per update (global batch = batch_size, split into grad_accum parts)")
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate the val split from the latest checkpoint (or --weights) and exit")
    p.add_argument("--eval-period", type=int, default=None,
                   help="in-train val-eval period in steps (default: TEST.EVAL_PERIOD; 0 disables)")
    p.add_argument("--eval-max-images", type=int, default=None, help="cap val images per in-train eval")
    p.add_argument("--weights", default=None,
                   help="model directory to start from (params.npz or model_final.pth), as MODEL.WEIGHTS")
    p.add_argument("--device", default=None, help="torch device (default: the GPU; 'cpu' asks for the CPU)")
    p.add_argument("--num-gpus", type=int, default=1,
                   help="worker processes to start, one per GPU (under torchrun: its group, whatever this says)")
    return p.parse_args(argv)


def build_mapper(cfg, args):
    """The mapper of INPUT.DATASET_MAPPER_NAME, overridable with --mapper: the geometry of
    the config's INPUT section, the static target padding capped at the queries."""
    from ..data.mappers import (
        COCOProxyDataset,
        InstanceDatasetMapper,
        InstanceLSJDatasetMapper,
        MapperConfig,
        PanopticDatasetMapper,
        PanopticLSJDatasetMapper,
        SemanticCocoMixDatasetMapper,
        SemanticDatasetMapper,
        SemanticVoidDatasetMapper,
        StreetHazardsCocoMixMapper,
        StreetHazardsMapper,
    )

    mapper_name = args.mapper or cfg.input.dataset_mapper_name
    mcfg = MapperConfig(
        min_sizes=cfg.input.min_size_train,
        max_size=cfg.input.max_size_train,
        crop_hw=tuple(cfg.input.crop_size),
        single_category_max_area=cfg.input.single_category_max_area,
        color_aug=cfg.input.color_aug_ssd,
        flip=cfg.input.random_flip,
        ignore_label=cfg.sem_seg_head_ignore_value,
        ood_label=cfg.ood.ood_label,
        size_divisibility=cfg.input.train_size_divisibility,
        max_instances=min(32, cfg.decoder.num_queries),  # each target needs a distinct query
        repeat_instance_masks=cfg.input.repeat_instance_masks,
    )

    def coco():
        # --coco-root wins; else INPUT.COCO_ROOT, relative to the datasets dir (the parent of --data-root)
        root = args.coco_root
        if not root:
            root = cfg.input.coco_root
            if not os.path.isabs(root):
                root = os.path.join(os.path.dirname(os.path.abspath(args.data_root)), root)
            if not os.path.isdir(root):
                raise ValueError(f"--coco-root required for coco_mix mappers (INPUT.COCO_ROOT fallback {root!r} "
                                 "does not exist)")
        return COCOProxyDataset(root, proxy_size=cfg.input.coco_proxy_size)

    if mapper_name == "mask_former_semantic_coco_mix":
        return SemanticCocoMixDatasetMapper(mcfg, coco(), ood_prob=cfg.ood.ood_prob, seed=args.seed)
    if mapper_name == "mask_former_semantic_void":
        return SemanticVoidDatasetMapper(mcfg, seed=args.seed)
    if mapper_name == "mask_former_semantic_street_hazards":
        return StreetHazardsMapper(mcfg, seed=args.seed)
    if mapper_name == "mask_former_semantic_street_hazards_coco_mix":
        return StreetHazardsCocoMixMapper(mcfg, coco(), ood_prob=cfg.ood.ood_prob, seed=args.seed)
    if mapper_name in ("mask_former_panoptic", "open_panoptic_coco_mapper"):
        unseen = _unseen_label_set(cfg, args) if mapper_name == "open_panoptic_coco_mapper" else None
        return PanopticDatasetMapper(mcfg, seed=args.seed, unseen_label_set=unseen)
    if mapper_name == "mask_former_instance":
        return InstanceDatasetMapper(mcfg, seed=args.seed)
    if mapper_name == "coco_panoptic_lsj":
        return PanopticLSJDatasetMapper(mcfg, seed=args.seed, image_size=cfg.input.image_size,
                                        min_scale=cfg.input.min_scale, max_scale=cfg.input.max_scale,
                                        unseen_label_set=_unseen_label_set(cfg, args))
    if mapper_name == "coco_instance_lsj":
        return InstanceLSJDatasetMapper(mcfg, seed=args.seed, image_size=cfg.input.image_size,
                                        min_scale=cfg.input.min_scale, max_scale=cfg.input.max_scale)
    return SemanticDatasetMapper(mcfg, seed=args.seed)


def _unseen_label_set(cfg, args):
    """DATASETS.UNSEEN_LABEL_SET (a file of class names, relative to the datasets dir, the
    parent of --data-root) → contiguous class indices against the ``thing_classes`` of the
    first DATASETS.TRAIN name that has them.  The reference resolves the path against its
    working directory, where ``datasets/`` is the datasets dir, so both
    ``datasets/unknown/unknown_K20.txt`` and ``unknown/unknown_K20.txt`` are read.  None,
    with a warning, where the config names no file, the file is missing or no train name
    has class names: then every class is supervised."""
    from ..data import catalog
    from ..data.mappers import load_unseen_label_set

    path = cfg.unseen_label_set
    if not path:
        return None
    datasets_dir = os.path.dirname(os.path.abspath(args.data_root))
    if not os.path.isabs(path):
        candidates = [os.path.join(datasets_dir, path)]
        if path.startswith("datasets/"):
            candidates.append(os.path.join(datasets_dir, path[len("datasets/"):]))
        path = next((c for c in candidates if os.path.isfile(c)), candidates[0])
    if not os.path.isfile(path):
        print(f"WARNING: DATASETS.UNSEEN_LABEL_SET {path!r} not found; training with full supervision")
        return None
    catalog.register_standard_datasets(datasets_dir)
    names: list = []
    for name in cfg.datasets_train:
        names = list(catalog.metadata(name).get("thing_classes", []))
        if names:
            break
    if not names:
        print("WARNING: no thing_classes metadata for DATASETS.TRAIN; unseen-label names cannot be resolved — "
              "full supervision")
        return None
    return load_unseen_label_set(path, names)


def prefetching_iterator(ds, mapper, batch_size: int, seed: int, workers: int = 4, rows=None):
    """Infinite shuffled batch iterator with ``workers`` mapper threads.  ``rows``: the
    rows of each global batch of ``batch_size`` to read, map and collate (a data rank's,
    ``parallel.mesh.data_rows``); default all.

    A coordinator thread feeds seeded per-epoch permutations, batch by batch, to an index
    queue; worker threads read, map and collate.  Each sample's augmentation draws come
    from a ``random.Random`` seeded by (seed, stream position), and a reorder buffer
    yields batches in stream order, so two runs with the same ``seed`` see the same
    crops, flips and mixes in the same order for any number of workers.  The queues are
    bounded; closing the iterator (``close()``, or dropping it) stops the threads once
    each has finished the batch in its hands."""
    from ..data.mappers import collate

    rows = list(range(batch_size)) if rows is None else list(rows)
    if len(ds) < batch_size:
        raise ValueError(f"dataset has {len(ds)} samples < batch size {batch_size} "
                         "(the loader drops partial batches)")
    idx_q: queue.Queue = queue.Queue(maxsize=2 * max(workers, 1))
    out_q: queue.Queue = queue.Queue(maxsize=4 + max(workers, 1))
    stop = threading.Event()

    def put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def coordinator():
        rng = np.random.RandomState(seed)
        pos = 0  # stream position, monotonic across epochs
        bseq = 0
        while True:
            idx = rng.permutation(len(ds))
            for start in range(0, len(idx) - batch_size + 1, batch_size):
                if not put(idx_q, (bseq, pos + start, idx[start : start + batch_size])):
                    return
                bseq += 1
            pos += len(idx)

    class _WorkerError:
        def __init__(self, exc):
            self.exc = exc

    def worker():
        wmapper = copy.copy(mapper)  # its own rng slot; shares the heavy state
        while not stop.is_set():
            try:
                bseq, pos0, ib = idx_q.get(timeout=0.1)
            except queue.Empty:
                continue
            # a raising worker still delivers its sequence number, or the consumer waits forever
            try:
                samples = []
                for j in rows:
                    s = ds[int(ib[j])]
                    wmapper.rng = random.Random(seed * 0x9E3779B1 + pos0 + j)
                    # panoptic and instance readers give the tuple of their mapper's arguments
                    samples.append(wmapper(*s) if isinstance(s, tuple) else wmapper(s.image, s.label))
                put(out_q, (bseq, collate(samples)))
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer
                put(out_q, (bseq, _WorkerError(e)))

    threading.Thread(target=coordinator, daemon=True).start()
    for _ in range(max(workers, 1)):
        threading.Thread(target=worker, daemon=True).start()
    pending: dict = {}
    want = 0
    try:
        while True:
            while want not in pending:
                bseq, batch = out_q.get()
                pending[bseq] = batch
            batch = pending.pop(want)
            if isinstance(batch, _WorkerError):
                raise batch.exc
            yield batch
            want += 1
    finally:
        stop.set()


def _resolve_dataset(name: str, data_root: str, semantic_only: bool = True):
    """A DATASETS.TRAIN / TEST name → its reader.  The Cityscapes semantic names read
    --data-root; every other name goes through ``data/catalog.py`` rooted at the parent
    of --data-root (Detectron2's datasets directory, where coco/ and mapillary_vistas/
    are siblings of cityscapes/).  With ``semantic_only`` only (image, label) readers are
    taken, else also panoptic ones.  Raises KeyError, ValueError or OSError where the name
    or its data is missing."""
    from ..data import catalog
    from ..data.ood_datasets import CityscapesSemSeg, OODDataset, PanopticDataset

    if name.startswith("cityscapes_") and ("sem_seg" in name or name.endswith("_mix")):
        split = "train" if name.endswith(("_train", "_mix")) else "val" if name.endswith("_val") else "test"
        return CityscapesSemSeg(data_root, split)
    catalog.register_standard_datasets(os.path.dirname(os.path.abspath(data_root)))
    ds = catalog.get(name)
    if not isinstance(ds, (OODDataset,) if semantic_only else (OODDataset, PanopticDataset)):
        raise ValueError(f"dataset {name!r} is not a {'semantic (image, label)' if semantic_only else 'training'} "
                         "reader")
    return ds


def _instance_view(ds, name: str):
    """The instance mappers' reader: panoptic ground truth → (image, masks, classes) of
    the thing segments, the thing ids from the catalog metadata (the reference loads
    instances from COCO's annotations; see ``InstanceFromPanoptic``)."""
    from ..data import catalog
    from ..data.ood_datasets import InstanceFromPanoptic, PanopticDataset

    if not isinstance(ds, PanopticDataset):
        raise ValueError(f"dataset {name!r} has no instance annotations (need panoptic ground truth)")
    thing_ids = None
    m = catalog.metadata(name).get("thing_dataset_id_to_contiguous_id")
    if m:  # the open metadata maps the unknown things to 255, which is no class
        thing_ids = sorted(v for v in set(m.values()) if v != 255)
    return InstanceFromPanoptic(ds, thing_ids)


def run_val_eval(cfg, model, data_root: str, max_images=None, tta: bool = False):
    """Val-split metrics of ``model`` (the reference's ``Trainer.test``; ``tta`` its
    ``test_with_TTA``).  The dataset is the first ``DATASETS.TEST`` name that resolves,
    else Cityscapes val under ``data_root``; a panoptic split goes to PQ instead of mIoU.
    None where there is no val data.  Runs under ``torch.inference_mode`` with the model
    in eval mode, and puts the model's mode back."""
    import torch

    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            return _val_eval(cfg, model, data_root, max_images, tta)
    finally:
        model.train(was_training)


def _val_eval(cfg, model, data_root: str, max_images, tta: bool):
    from ..data.ood_datasets import CityscapesSemSeg, PanopticDataset
    from ..evalx.seg_evaluators import SemSegEvaluator

    ds, ds_name = None, None
    for name in cfg.datasets_test or ():
        try:
            d = _resolve_dataset(name, data_root, semantic_only=False)
        except (KeyError, ValueError, OSError):
            continue
        if len(d) > 0:
            ds, ds_name = d, name
            break
    if ds is None:
        try:
            ds = CityscapesSemSeg(data_root, split="val")
        except FileNotFoundError:
            return None
    if len(ds) == 0:
        return None
    if isinstance(ds, PanopticDataset):
        # the reference has no panoptic TTA: PQ is not re-run under an augmented label
        return None if tta else _run_panoptic_val_eval(cfg, model, ds, ds_name, max_images)
    ev = SemSegEvaluator(cfg, model)
    n = len(ds) if not max_images else min(int(max_images), len(ds))
    for i in range(n):
        s = ds[i]
        if tta:
            from ..models.tta import tta_inference

            ev.add(tta_inference(model, cfg, s.image).argmax(0), s.label)
        else:
            ev.process(s.image, s.label)
    out = ev.evaluate()
    out.pop("IoU_per_class", None)
    out["eval_images"] = n
    return out


def _run_panoptic_val_eval(cfg, model, ds, ds_name, max_images=None):
    """PQ on a panoptic DATASETS.TEST split (the reference routes ``coco_panoptic_seg`` to
    its open-panoptic evaluator), with mIoU under ``TEST.SEMANTIC_ON`` and mask AP under
    ``TEST.INSTANCE_ON`` over the same images.  The thing ids are the catalog metadata's
    contiguous thing ids."""
    from ..data import catalog
    from ..data.ood_datasets import InstanceFromPanoptic, SemSegFromPanoptic
    from ..evalx.seg_evaluators import InstanceEvaluator, OpenPanopticEvaluator, SemSegEvaluator

    thing_ids = None
    if ds_name is not None:
        m = catalog.metadata(ds_name).get("thing_dataset_id_to_contiguous_id")
        if m:  # the open metadata maps the unknown things to 255, which is no class
            thing_ids = tuple(sorted(v for v in set(m.values()) if v != 255))
    ev = OpenPanopticEvaluator(cfg, model, thing_ids=thing_ids) if thing_ids is not None \
        else OpenPanopticEvaluator(cfg, model)
    n = len(ds) if not max_images else min(int(max_images), len(ds))
    out = {}
    # PANOPTIC_ON asks for PQ (the open mapper always does); PQ also where no TEST flag asks
    # for anything, so that an evaluation never comes back empty
    if (cfg.test.panoptic_on or "open_panoptic" in cfg.input.dataset_mapper_name
            or not (cfg.test.semantic_on or cfg.test.instance_on)):
        for i in range(n):
            ev.process(*ds[i])
        for split, stats in ev.evaluate().items():
            if isinstance(stats, dict):
                out.update({f"{split}_{k}": float(v) for k, v in stats.items() if isinstance(v, (int, float))})
            elif isinstance(stats, (int, float)):
                out[split] = float(stats)
    if cfg.test.semantic_on:  # mIoU over the labels of the same panoptic ground truth
        sem_ev = SemSegEvaluator(cfg, model)
        sv = SemSegFromPanoptic(ds)
        for i in range(n):
            s = sv[i]
            sem_ev.process(s.image, s.label)
        sem_out = sem_ev.evaluate()
        sem_out.pop("IoU_per_class", None)
        out.update(sem_out)
    if cfg.test.instance_on:  # mask AP over the thing segments of the same split
        inst_ev = InstanceEvaluator(cfg, model)
        iv = InstanceFromPanoptic(ds, thing_ids)
        for i in range(n):
            inst_ev.process(*iv[i])
        out.update({f"instance_{k}": float(v) for k, v in inst_ev.evaluate().items() if isinstance(v, (int, float))})
    out["eval_images"] = n
    return out


def train_dataset(cfg, args):
    """The reader of DATASETS.TRAIN: one name's, or a ``ConcatDataset`` over every name
    that resolves, semantic or panoptic (through ``_instance_view`` for the instance
    mappers) as the mapper's name asks.  A missing name is skipped with a warning;
    FileNotFoundError where none resolves."""
    from ..data.ood_datasets import ConcatDataset

    mapper_name = args.mapper or cfg.input.dataset_mapper_name
    semantic_only = not ("panoptic" in mapper_name or "instance" in mapper_name)
    parts, errors = [], []
    for name in cfg.datasets_train or ("cityscapes_fine_sem_seg_train",):
        try:
            d = _resolve_dataset(name, args.data_root, semantic_only)
            if "instance" in mapper_name:
                d = _instance_view(d, name)
            if len(d) == 0:
                raise FileNotFoundError("no samples found")
            parts.append(d)
        except (KeyError, ValueError, OSError) as e:
            errors.append(f"{name}: {e}")
    if errors:
        print(f"WARNING: skipped train dataset(s): {'; '.join(errors)}")
    if not parts:
        raise FileNotFoundError(f"none of DATASETS.TRAIN {list(cfg.datasets_train)} found under {args.data_root} "
                                "(or its parent datasets dir)")
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)


def data_iterator(cfg, args, batch_size: int, rows=None) -> Iterator[dict]:
    """Infinite shuffled, mapped and collated batches of DATASETS.TRAIN (``train_dataset``);
    ``rows`` of each (``prefetching_iterator``)."""
    ds = train_dataset(cfg, args)
    return prefetching_iterator(ds, build_mapper(cfg, args), batch_size, args.seed,
                                workers=args.workers or cfg.solver.num_workers, rows=rows)


def _global_count(n: int, mesh, device) -> int:
    """``n`` summed over the data ranks (a logged count of each rank's rows)."""
    if mesh is None:
        return n
    import torch
    import torch.distributed as dist

    t = torch.tensor(n, dtype=torch.int64, device=device)
    dist.all_reduce(t, group=mesh.data_group)
    return int(t)


def _log(log_path: str, m: dict) -> None:
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in m.items()}), flush=True)
    with open(log_path, "a") as f:
        f.write(json.dumps(m) + "\n")


def _joins_group(args) -> bool:
    import torch.distributed as dist

    return args.num_gpus > 1 or "RANK" in os.environ or dist.is_initialized()


def _die_with_launcher() -> None:
    """On Linux, have the kernel stop this rank when its launcher dies (prctl
    PR_SET_PDEATHSIG), so no rank outlives a launcher that was killed."""
    import signal

    if sys.platform.startswith("linux"):
        import ctypes

        ctypes.CDLL(None).prctl(1, int(signal.SIGTERM))  # 1: PR_SET_PDEATHSIG


def _worker(rank: int, world: int, init_method: str, argv):
    """One spawned rank of ``--num-gpus``: join the group, train, leave the group."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed

    args = parse_args(argv)
    _die_with_launcher()
    init_distributed("cpu" if args.device == "cpu" else "cuda", rank=rank, world_size=world,
                     init_method=init_method)
    try:
        _train(args)
    finally:
        dist.destroy_process_group()


def launch(args, argv):
    """Start ``--num-gpus`` ranks (Detectron2's ``launch``) and wait for them; raise, and
    stop the others, where one fails."""
    import multiprocessing
    import tempfile

    from ..config import load_config
    from ..parallel.mesh import data_rows

    cfg = load_config(args.config_file)
    data_rows(args.batch_size or cfg.solver.ims_per_batch, 0, args.num_gpus, max(1, args.grad_accum))  # splits?
    os.makedirs(args.output_dir, exist_ok=True)
    rendezvous = tempfile.mkdtemp(prefix=".rendezvous_", dir=args.output_dir)
    init_method = "file://" + os.path.join(os.path.abspath(rendezvous), "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, args.num_gpus, init_method, argv)) for r in range(args.num_gpus)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"train_net: rank(s) {failed} failed (exit codes "
                                   f"{[procs[r].exitcode for r in failed]})")
            time.sleep(0.2)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"train_net: rank(s) {failed} failed (exit codes {[procs[r].exitcode for r in failed]})")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        import shutil

        shutil.rmtree(rendezvous, ignore_errors=True)


def main(argv=None):
    """Train (or evaluate) as the arguments say; returns the train state, or the
    evaluation's metrics with ``--eval-only`` (None on the ranks other than 0 and in the
    launcher of ``--num-gpus``)."""
    args = parse_args(argv)
    if not _joins_group(args):
        return _train(args)
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed

    if not dist.is_initialized() and "RANK" not in os.environ:  # --num-gpus N > 1: start the ranks
        return launch(args, sys.argv[1:] if argv is None else list(argv))
    formed = not dist.is_initialized()
    init_distributed("cpu" if args.device == "cpu" else "cuda")
    try:
        return _train(args)
    finally:
        if formed:
            dist.destroy_process_group()


def _train(args):
    import torch.distributed as dist

    from ..config import load_config
    from ..convert.checkpoint import latest_step, load_checkpoint_params, restore_train_state, save_train_state
    from ..models.maskformer import resolve_device
    from .train_step import make_train_state, make_train_step

    cfg = load_config(args.config_file)
    mesh = None
    if _joins_group(args):
        from ..parallel.mesh import local_device, make_mesh

        device = "cpu" if args.device == "cpu" else "cuda"
        mesh = make_mesh(device=device)
        device = local_device(device)
    else:
        device = resolve_device(args.device, "train_net")
    lead = mesh is None or mesh.data_rank == 0  # the rank that logs, checkpoints and evaluates
    os.makedirs(args.output_dir, exist_ok=True)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    batch_size = args.batch_size or cfg.solver.ims_per_batch
    max_iter = args.max_iter or cfg.solver.max_iter
    grad_accum = max(1, args.grad_accum)
    rows = None
    if mesh is not None:
        from ..parallel.mesh import data_rows

        rows = data_rows(batch_size, mesh.data_rank, mesh.data_size, grad_accum)  # ValueError where it does not split

    model = load_checkpoint_params(args.weights, cfg, device=device) if args.weights else None
    state = make_train_state(cfg, device=device, seed=args.seed, model=model, mesh=mesh)
    start = 0
    if args.resume or args.eval_only:
        step0 = latest_step(ckpt_dir)
        if step0 is not None:
            restore_train_state(ckpt_dir, state, step0)
            start = step0
            print(f"resumed from step {step0}")
        elif args.eval_only and not args.weights:
            print("WARNING: --eval-only with no checkpoint and no --weights: seeded random weights")
    log_path = os.path.join(args.output_dir, "metrics.jsonl")

    if args.eval_only:
        if not lead:
            dist.barrier()
            return None
        res = run_val_eval(cfg, state.model, args.data_root, args.eval_max_images)
        if res is None:
            raise FileNotFoundError(f"no val data for DATASETS.TEST {list(cfg.datasets_test)} under {args.data_root}")
        if cfg.test.aug_enabled:  # TEST.AUG.ENABLED adds a test-time-augmentation pass
            res_tta = run_val_eval(cfg, state.model, args.data_root, args.eval_max_images, tta=True)
            if res_tta is not None:
                res.update({f"{k}_TTA": v for k, v in res_tta.items() if k != "eval_images"})
        res["step"] = start
        _log(log_path, res)
        if mesh is not None:
            dist.barrier()
        return res

    eval_period = cfg.test.eval_period if args.eval_period is None else args.eval_period
    step_fn = make_train_step(cfg, grad_accum=grad_accum, mesh=mesh)
    it = data_iterator(cfg, args, batch_size, rows)
    t0 = time.time()
    for i in range(start, max_iter):
        batch = next(it)
        metrics = step_fn(state, batch)
        if (i + 1) % args.log_period == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=i + 1, imgs_per_sec=batch_size * args.log_period / (time.time() - t0))
            if "outlier_masks" in batch:  # images of this step with a pasted object
                m["ood_images"] = _global_count(int((batch["outlier_masks"] == 1).any(axis=(1, 2)).sum()), mesh,
                                                device)
            t0 = time.time()
            if lead:
                _log(log_path, m)
        if (args.checkpoint_period > 0 and (i + 1) % args.checkpoint_period == 0) or (i + 1) == max_iter:
            if lead:
                save_train_state(ckpt_dir, state, i + 1)
                print(f"saved checkpoint at step {i + 1}", flush=True)
            if mesh is not None:
                dist.barrier()
        if eval_period > 0 and (i + 1) % eval_period == 0:
            res = run_val_eval(cfg, state.model, args.data_root, args.eval_max_images) if lead else None
            if res is not None:
                res["step"] = i + 1
                _log(log_path, res)
            if mesh is not None:
                dist.barrier()
    it.close()  # stops the mapper threads
    return state


if __name__ == "__main__":
    main()
