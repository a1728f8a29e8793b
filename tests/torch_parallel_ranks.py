"""Several-process runs of the port for the tests of its data and tensor parallelism
(tests/test_torch_parallel.py, tests/test_torch_tp.py).  NOT a test module, and it
imports neither JAX nor ``rba_tpu``: each rank is a spawned process that imports only
torch, numpy and the port.

``run_ranks(fn, world, tmp_path)`` starts ``world`` processes that join one gloo group
through a ``FileStore`` under ``tmp_path`` (no TCP port: the test workers run side by
side), each with one or two torch threads, runs ``fn(rank, world, *args)`` in each and
returns their results in rank order.  A rank that does not finish within ``timeout``
seconds is killed and the run raises, so a stuck collective fails its test instead of
holding up the run.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch

RANK_TIMEOUT_S = 120
THREADS = 2

OOD = dict(outlier_supervision=True, outlier_loss_target="nls", score_norm="tanh", outlier_loss_func="squared_hinge")
HW, T = (32, 32), 3


def _entry(fn, rank, world, store_path, out_path, args):
    torch.set_num_threads(THREADS)
    if os.name == "posix" and os.uname().sysname == "Linux":  # die with the test process
        import ctypes
        import signal

        ctypes.CDLL(None).prctl(1, int(signal.SIGTERM))
    try:
        import torch.distributed as dist

        store = dist.FileStore(str(store_path), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        result = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        payload = ("ok", result)
    except Exception:  # noqa: BLE001 — relayed to the parent
        payload = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(payload, f)


def run_ranks(fn, world: int, tmp_path, args=(), timeout: float = RANK_TIMEOUT_S):
    """``fn(rank, world, *args)`` in ``world`` spawned gloo ranks; their results."""
    ctx = multiprocessing.get_context("spawn")
    tmp = Path(tmp_path)
    store = tmp / "dist_store"
    outs = [tmp / f"rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, outs[r], args), daemon=True)
             for r in range(world)]
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    try:
        for p in procs:
            p.start()
    finally:
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env
    import time

    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if stuck:
        raise TimeoutError(f"rank(s) {stuck} did not finish within {timeout} s")
    results = []
    for r, path in enumerate(outs):
        if not path.exists():
            raise RuntimeError(f"rank {r} exited with code {procs[r].exitcode} and no result")
        status, value = pickle.loads(path.read_bytes())
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        results.append(value)
    return results


# ---------------------------------------------------------------------------
# the training setup that the ranks and the 1-rank yardstick share
# ---------------------------------------------------------------------------

def train_cfg():
    from rba_tpu_torch import config as tconfig

    c = tconfig.tiny_test_config()
    return dataclasses.replace(c, ood=dataclasses.replace(c.ood, **OOD),
                               loss=dataclasses.replace(c.loss, train_num_points=48))


def variant_cfg(name: str):
    """``train_cfg`` with the other global batch sums of the criterion switched on:
    ``"smooth_sparse_gambler"`` (the smoothness, sparsity and gambler losses),
    ``"densehybrid"`` (the DenseHybrid head and loss), ``"bce"`` (the outlier loss's
    binary cross-entropy), ``"per_pixel"`` (the per-pixel head's CE at PointRend's points,
    drawn at the global batch's shape)."""
    c = train_cfg()
    if name == "smooth_sparse_gambler":
        return dataclasses.replace(c, ood=dataclasses.replace(c.ood, smoothness_loss=True, smoothness_score="energy",
                                                              sparsity_loss=True, gambler_loss=True))
    if name == "densehybrid":
        return dataclasses.replace(c, ood=dataclasses.replace(c.ood, densehybrid_loss=True),
                                   decoder=dataclasses.replace(c.decoder, ood_prediction=True))
    if name == "bce":
        return dataclasses.replace(c, ood=dataclasses.replace(c.ood, outlier_loss_func="binary_cross_entropy"))
    if name == "per_pixel":
        return dataclasses.replace(c, sem_seg_head_name="PerPixelBaselineHead",
                                   loss=dataclasses.replace(c.loss, use_point_rend=True))
    raise KeyError(name)


VARIANTS = ("smooth_sparse_gambler", "densehybrid", "bce", "per_pixel")


def train_batch(seed: int, b: int) -> dict:
    """A seeded global batch: raw images, T class targets from a label map with a pasted
    outlier block, one invalid target."""
    rs = np.random.RandomState(seed)
    h, w = HW
    sem = rs.randint(0, 4, (b, h, w)).astype(np.int64)
    sem[:, 12:20, 8:14] = 254
    sem[0, :, :] = np.where(sem[0] == 254, 1, sem[0])  # an image without an outlier
    batch = dict(images=(rs.rand(b, h, w, 3) * 255).astype(np.float32),
                 gt_labels=np.tile(np.arange(T, dtype=np.int64), (b, 1)),
                 gt_masks=np.stack([[sem[i] == c for c in range(T)] for i in range(b)]).astype(np.float32),
                 gt_valid=np.ones((b, T), np.float32), sem_seg=sem, outlier_masks=(sem == 254).astype(np.int64))
    batch["gt_valid"][-1, -1] = 0.0
    return batch


def train_run(cfg, batches, grad_accum: int, mesh=None, tp: bool = False, seed: int = 0):
    """Steps of the port's trainer from seeded weights, one per global batch: (each
    step's metrics, the first step's gradients by parameter name, the final parameters).
    With ``mesh`` each rank steps on its rows (``shard_batch``)."""
    from rba_tpu_torch.models.maskformer import build_model
    from rba_tpu_torch.parallel.mesh import shard_batch
    from rba_tpu_torch.train.train_step import make_train_state, make_train_step

    model = build_model(cfg, device="cpu", seed=seed)
    state = make_train_state(cfg, model=model, seed=seed, mesh=mesh, tp=tp)
    names = {p: n for n, p in model.named_parameters()}
    grads = {}

    def snapshot(opt, args, kwargs):
        if not grads:
            for group in opt.param_groups:
                for p in group["params"]:
                    grads[names[p]] = p.grad.detach().clone().numpy()

    state.optimizer.register_step_pre_hook(snapshot)
    step = make_train_step(cfg, grad_accum=grad_accum, mesh=mesh, tp=tp)
    metrics = []
    for batch in batches:
        local = batch if mesh is None or mesh.data_size == 1 else shard_batch(mesh, batch, grad_accum)
        metrics.append({k: float(v) for k, v in step(state, local).items()})
    params = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    return metrics, grads, params


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def dp_rank(rank, world, cfg, batches, accums, eval_args):
    """Data parallelism on a (world, 1) mesh: the steps of each ``grad_accum``, the
    launch counts of the all-reduces, the steps of each of ``VARIANTS``, then the sharded
    evaluation's histograms."""
    from rba_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(device="cpu")
    out = {}
    for accum in accums:
        pmesh.reset_counts()
        out[accum] = train_run(cfg, batches, accum, mesh=mesh) + (dict(pmesh.COUNTS),)
    for name in VARIANTS:
        out[name] = train_run(variant_cfg(name), batches, 1, mesh=mesh)
    out["hist"] = sharded_eval_rank(mesh, *eval_args)
    return out


def sharded_eval_rank(mesh, cfg, n_images, hw, bins):
    from rba_tpu_torch.data.ood_datasets import SyntheticAnomaly
    from rba_tpu_torch.models.maskformer import build_model
    from rba_tpu_torch.parallel.sharded_eval import evaluate_dataset_sharded, sharded_histograms

    model = build_model(cfg, device="cpu", seed=1)
    ds = SyntheticAnomaly(n=n_images, hw=hw)
    pos, neg = sharded_histograms(cfg, model, ds, mesh, bins=bins)
    return pos, neg, evaluate_dataset_sharded(cfg, model, ds, mesh, bins=bins)


def tp_rank(rank, world, cfg, batches, image):
    """Tensor parallelism on a (1, world) mesh: the shard shapes, the TP steps, TP
    inference on ``image``, and Kernel D's gathered weights."""
    from rba_tpu_torch.models.maskformer import build_model, maskformer_infer_rba
    from rba_tpu_torch.parallel import mesh as pmesh
    from rba_tpu_torch.parallel.tp import full_linear, shard_params_tp

    mesh = pmesh.make_mesh(model_axis=world, device="cpu")
    pmesh.reset_counts()
    steps = train_run(cfg, batches, 1, mesh=mesh, tp=True)
    counts = dict(pmesh.COUNTS)
    model = shard_params_tp(build_model(cfg, device="cpu", seed=0), mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    with torch.no_grad():
        score = maskformer_infer_rba(model, cfg, torch.from_numpy(image), attention="xla").numpy()
        fc1 = model.backbone.layers[0].blocks[0].mlp["fc1"]
        whole = [t.numpy() for t in full_linear(fc1)]
    return dict(steps=steps, counts=counts, shapes=shapes, score=score, fc1_whole=whole, model_rank=mesh.model_rank)
