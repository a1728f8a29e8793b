#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold each
against its plain PyTorch version at the serving paths' shapes, serve Swin-B RbA
requests at 1024x2048 through both serving paths and check the score maps, then the
other phases below, the non-Swin backbones last.

- Path 1: ``maskformer_infer_rba(..., attention="fused")`` on ``swin_b_1dl()``:
  Kernel A (window attention) in every Swin block, Kernel B (RbA score) once.
- Path 2: ``maskformer_infer_rba(..., attention="fused_softmax")`` on ``swin_b_1dl()``
  with ``mlp_impl="fused"``: Kernel C (masked softmax) in every block, Kernel D
  (fused MLP) in the blocks of stages 0 and 1, Kernel B once.
- Fast serve cell: path 1 on ``fast_serving(swin_b_1dl())`` (bf16 pixel-decoder
  inputs, bf16 window-attention softmax where the path has one, bf16 one-hot
  deformable sampling): Kernel A in every block, Kernel B once; the one-hot
  sampling's kernels and their share of the pixel decoder's busy time.
- ``attention="xla"``: rba_tpu's default window attention in plain PyTorch, at
  parity and at ``fast_serving``, beside path 1 (reported, not gated).
- Evaluation: ``OODEvaluator(cfg, model).evaluate_dataset`` over structured synthetic
  1024x2048 scenes through path 1 (Kernel A in every block, Kernel B once per image),
  with score histograms on the card, and the exact all-pixel path beside it; then
  ``OODEvaluator(fast_serving(cfg), model)`` over the same scenes.
- ``d2``: a seeded full-width Detectron2 ``model_final.pth`` of swin_b_1dl (under the
  gitignored ``build/``) loaded with ``load_checkpoint_params``: every parameter equal
  to its Detectron2 array, the ``params.npz`` cache, one path-1 request per load.
- ``tta``: ``tta_inference`` on one 1024x2048 frame, 6 sizes from 512x1024 to
  1792x3584, each plain and flipped (Kernel A in every block of the 12 variants).
- ``sliding``: ``sliding_window_sem_seg`` in 1024x1024 tiles, on a 1024x2048 frame (3
  tiles) and a 3072x4096 frame (20 tiles).
- ``dense_hybrid``: one ``OODEvaluator(score="dense_hybrid")`` request with the
  DenseHybrid head.
- ``sweep_cli``: the sweep CLI over a zoo that holds only ``config.yaml`` and
  ``model_final.pth``, plain, with ``--tta`` and with ``--sliding-window``.
- ``lsap``: Kernel E (the matcher's exact assignment) against its plain version and
  scipy at the matcher's B x 32 x 100, at 100 x 100, with ties and with padded rows.
- ``semseg``: ``python -m rba_tpu_torch.evalx.eval_semseg``'s ``main`` on the d2 phase's
  swin_b_1dl model directory over 8 synthetic 1024x2048 Cityscapes val frames (Kernel A
  in every block, never the "xla" chain), the device confusion counts against numpy's,
  the kernels against their plain versions at fp32 by argmax and mIoU.
- ``panoptic``: the COCO open-panoptic Swin-B config (three deformable levels, 9 decoder
  layers, 117 classes) through ``load_config``, a seeded full-width Detectron2 checkpoint
  of it converted onto the card, and 4 synthetic COCO-format 800x1067 frames through the
  trainer's panoptic evaluation (PQ with the Unknown split, mIoU, mask AP); Kernel B as
  the open branch's map, the card's panoptic map against the CPU function's, the
  three-level sampling at fp32 one-hot against the gather.
- ``train``: ``rba_tpu_torch.train.train_net.main`` on
  ``configs/cityscapes/swin_b_1dl_ood_coco.yaml`` (RbA's outlier-exposure fine-tune of
  Swin-B 1dl) at full width and depth from the seeded Detectron2 checkpoint, over a
  synthetic Cityscapes tree of 1024x2048 frames and a COCO proxy tree: 2 warm-up and 8
  timed steps at the global batch of 8 (the forward, deep supervision, Kernel E in the
  matcher, all losses, backward, clip and AdamW); Kernel E on a step's real costs; a
  step at fp32 through Kernel E and through the plain LSAP; the trained checkpoint
  serving one path-1 request.
- ``train_eval``: the trainer on the train phase's trees and checkpoint for 4 steps with
  ``--eval-period 2 --eval-max-images 2``, then ``--eval-only`` from its checkpoint: the
  evaluations in ``metrics.jsonl`` and through Kernel A.
- ``backbones``: six shipped configs with other backbones, from their YAMLs at full width
  and depth (R50, R101 1dl, MiT-B5 1dl, MViT in21k 1dl, ViT, WiderResNet-38 1dl), each
  served through ``maskformer_infer_rba`` at its precision and at ``fast_serving``:
  Kernel B once per request where the mask features are at stride 4 (R50, R101, MiT,
  MViT), never on ViT (stride 16) and WiderResNet-38 (stride 8); at fp32 the entry equals
  its plain version and ``maskformer_infer(...)["rba"]``; parameters, ms/image, busy
  time, idle share, busy per layer span and peak memory of each.
- ``r50_d2``: a D2-format R50 ``config.yaml`` and a seeded full-width ``model_final.pth``
  loaded with ``load_checkpoint_params`` (bit-equal to the CPU conversion), one request,
  and the sweep CLI over that model directory.
- ``train_backbones``: the non-Swin recipes' training steps (``train_backbones_phase``).
- ``swin_l``: ``swin_l_1dl()`` from a seeded full-width Detectron2 checkpoint (bit-equal to
  the CPU conversion), 1024x2048 requests on path 1 (A 24, B 1) and path 2 (C 24, no D at
  Swin-L's widths, B 1), fp32 kernels against plain and path 2 against path 1; then 720x1280
  StreetHazards frames read through the catalog and evaluated by ``OODEvaluator``.
- ``train_datasets``: ``train_net.main`` on the Swin-L Mapillary + Cityscapes fine-tune (a
  ``ConcatDataset``, from the swin_l checkpoint, then ``--eval-only`` on Mapillary val), the
  COCO open-panoptic Swin-B recipe (``coco_panoptic_lsj``) and Mapillary Vistas' 65 classes
  on R50 (then ``--eval-only``), at full width and depth over synthetic Mapillary
  (3072x4096) and COCO panoptic trees: Kernel E's launches, the frozen parameters, the
  unknown classes never targets, the sampling's forward and backward spans.
- ``heads``: the other heads on swin_b_1dl's backbone at full width and depth, from seeded
  Detectron2 checkpoints: MaskFormer v1 (``BasePixelDecoder`` + ``StandardTransformerDecoder``,
  ``v1_cfg``) on path 1 (A 24, B 1) and path 2 (C 24, D 4, B 1), its
  ``TransformerEncoderPixelDecoder`` variant, ``PerPixelBaselineHead`` and
  ``PerPixelBaselinePlusHead`` (A 24, B 0), each at fp32 against the plain versions and
  ``maskformer_infer``; ``train_net.main`` on the v1 model (Kernel E) and the Plus head.
- ``hf``: a full-width HF-named state dict of the three-level Swin-B Mask2Former
  (``hf_cityscapes_cfg``, the architecture of facebook/mask2former-swin-base-IN21k-cityscapes-semantic)
  through ``convert_hf_checkpoint``: parameters and score maps equal to the Detectron2-loaded
  model's, path 1 (A 24, B 1).

- ``parallel``: data parallelism on an NCCL group that the script forms through
  ``parallel/mesh.py`` (world size: the card count): ``train_net.main`` on the train
  phase's recipe, trees and checkpoint (1 + 3 steps, global batch 8), the port's counts
  of its loss and gradient all-reduces, Kernel E 2 per micro-batch, the first step's
  losses against the single-process train phase's within 1e-6; then
  ``evaluate_dataset_sharded`` over the eval phase's scenes, its histograms equal to the
  evaluator's (A 24, B 1 per image).
- ``int8``: ``swin_b_1dl()`` with int8 weights on path 1 (A 24, B 1) and path 2 (C 24,
  D 4 on the fp fc1 / fc2, B 1), kernels against plain versions and path 2 against path
  1 at fp32; ``count_quantized``, the weights' bytes, the score maps' distance from the
  fp weights'.
- ``tools``: ``analyze_model`` (its parameter count equal to the d2 phase's model's),
  ``selfcheck`` at the swin_b_1dl architecture with the port on the card (<= 1e-3),
  ``ablation`` (parity, fast, fast_int8) and ``device_trace`` of one request.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py [--out DIR]

It exits non-zero when there is no GPU, when a kernel fails to build or launch or
disagrees with its plain version, or when an end-to-end check fails (the training
phase's included).  Its last two
lines are a JSON object with every kernel's launches, error and times, and
``{"ok": true, "device": {...}}``.  With ``--out`` every measurement also goes to
DIR/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (dense): HBM bytes/s and fp32 CUDA-core / bf16 and TF32 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
# instructions per second over all lanes, from the fp32 peak (one fma per lane and clock):
# the ALU pipe has 128 lanes per SM, the special-function pipe (ex2, rcp) 16
ALU_OPS_PER_S = PEAK_FLOPS["float32"] / 2
SFU_OPS_PER_S = ALU_OPS_PER_S / 8

IMAGE_HW = (1024, 2048)
BIG_FRAME_HW = (3072, 4096)  # a Mapillary Vistas-sized frame, the sliding window's use
COCO_HW = (800, 1067)  # a 640x480 COCO image at MIN_SIZE_TEST 800: the panoptic phase's frames
MAPILLARY_EVAL_HW = (1536, 2048)  # a 3072x4096 Mapillary frame at MIN_SIZE_TEST 2048, MAX_SIZE_TEST 2048
STREET_HAZARDS_HW = (720, 1280)  # StreetHazards' frame size, 736x1280 once padded to 32
SELFCHECK_HW = (128, 256)  # the tools phase's selfcheck images
ABLATION_HW = (256, 512)  # the tools phase's ablation images
# the ablation's score maps against the fp32 torch model's, per mode (max, mean): the bf16
# backbone moves RbA scores (-sum of 19 tanh) by about 0.02 at most, a kernel fault by O(1)
ABLATION_SCORE_TOL = (0.05, 5e-3)
N_REQUESTS = 4  # distinct images served after one warm-up request
# Kernel F, and the plain gather's kernel that a request which runs it must not run
KERNEL_F = {"ms_deform_attn_kernel": "_scatter_gather_elementwise_kernel"}
# superseded kernels looked for only inside the deformable sampling's spans, not the whole
# request: the plain gather's kernel is also what ``index_select`` lowers to elsewhere
# (ViT's position tables, on torch 2.11)
SAMPLING_ONLY = ("_scatter_gather_elementwise_kernel",)
E2E_FP32_TOL = 1e-3  # score-map bound of rba_tpu's selfcheck
BF16_ULP = 2.0**-7  # one bf16 ulp, relative to the value, at most
BF16_TINY = 2.0**-133  # spacing of bf16's subnormals
BF16_SHARE = 0.999  # least share of bf16 outputs within one ulp of their own value
EVAL_IMAGES = 8  # images of the eval phase
BOUND_SLACK = 1e-12  # float64 rounding of the certified bounds' sums
HIST_REPS = 5  # histogram updates in the profile of the update


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def _smi(query: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<query>`` for card 0."""
    return subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms_batches(fn, iters: int = 20, warmup: int = 3, batches: int = 3) -> list:
    """Mean device time of ``fn`` in ms for each of ``batches`` batches, one after the
    other: CUDA events around ``iters`` calls, after ``warmup`` calls before the first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return means


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls after warm-up."""
    return cuda_ms_batches(fn, iters, warmup, batches=1)[0]


def _fmt(times) -> str:
    return "/".join(f"{t:.4f}" for t in times)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of one bf16 ulp of want (2**-7 |want|, and at least
    the subnormals' spacing)."""
    want = want.float()
    return float(((got.float() - want).abs() / (BF16_ULP * want.abs()).clamp_min(BF16_TINY)).max())


def bf16_ulp_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of the elements within one bf16 ulp of their own value (plus 1e-6), the
    per-element bound of tests/test_torch_window_attention.py."""
    want = want.float()
    return float(((got.float() - want).abs() <= BF16_ULP * want.abs() + 1e-6).float().mean())


def served_sizes(cfg):
    """Every input size that the driven phases give the backbone, padded to the size
    divisibility, in first-use order: the 1024x2048 request and the sweep's synthetic
    images, each whole, in its TTA variants and in its sliding-window tiles, the
    3072x4096 frame's tiles, the panoptic phase's COCO frames, the Mapillary evaluation's
    frames, StreetHazards' frames, and the tools phase's selfcheck and ablation images."""
    from rba_tpu_torch.data.ood_datasets import SyntheticAnomaly
    from rba_tpu_torch.models.sliding_window import tile_grid
    from rba_tpu_torch.models.tta import tta_variants

    sizes = []
    for hw in (IMAGE_HW, SyntheticAnomaly().hw):
        sizes += [hw, *((h, w) for h, w, _ in tta_variants(cfg, *hw)), tile_grid(*hw)[:2]]
    sizes += [tile_grid(*BIG_FRAME_HW)[:2], COCO_HW, MAPILLARY_EVAL_HW, STREET_HAZARDS_HW, SELFCHECK_HW, ABLATION_HW]
    return _padded(cfg, sizes)


def swin_l_sizes(cfg):
    """The input sizes of the swin_l and train_datasets phases, padded as ``served_sizes``:
    the 1024x2048 request, the Mapillary evaluation's frames, StreetHazards' frames."""
    return _padded(cfg, [IMAGE_HW, MAPILLARY_EVAL_HW, STREET_HAZARDS_HW])


def _padded(cfg, sizes):
    div = cfg.input.size_divisibility
    return list(dict.fromkeys((-(-h // div) * div, -(-w // div) * div) for h, w in sizes))


def stage_shapes(cfg, hw=IMAGE_HW):
    """The window-attention shapes of one request of ``hw`` (a multiple of 32), stage by
    stage, unshifted and shifted: (stage, shifted, nW, nh, C, hp, wp, calls per image)."""
    sw = cfg.swin
    ws = sw.window_size
    h, w = hw[0] // sw.patch_size, hw[1] // sw.patch_size
    for s in range(sw.num_layers):
        hs, wsz = -(-h // 2**s), -(-w // 2**s)
        hp, wp = -(-hs // ws) * ws, -(-wsz // ws) * ws
        nw = (hp // ws) * (wp // ws)
        for masked in (False, True):
            count = sw.depths[s] // 2 if masked else (sw.depths[s] + 1) // 2  # odd blocks are shifted
            yield s, masked, nw, sw.num_heads[s], sw.stage_dim(s), hp, wp, count


# ---------------------------------------------------------------------------
# Kernel A: window attention at the Swin-B and Swin-L 1024x2048 stage shapes (timed) and
# at every other shape that the driven phases give it
# ---------------------------------------------------------------------------

def _window_attention_timed(cfg, gen):
    """Kernel A against its plain version at bf16 and fp32, timed against it and SDPA, at
    each stage shape of one 1024x2048 request of ``cfg``: (rows, totals per image, worst
    bf16 error)."""
    from rba_tpu_torch.kernels.window_attention import window_attention, window_attention_reference
    from rba_tpu_torch.models.swin import shifted_window_mask

    ws, n = cfg.swin.window_size, cfg.swin.window_size**2
    rows, totals = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ms_batches=[0.0] * 3)
    worst = 0.0
    for s, masked, nw, nh, c, hp, wp, count in stage_shapes(cfg):
        hd = c // nh
        scale = hd**-0.5
        qkv = torch.randn(nw, n, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
        bias = torch.randn(nh, n, n, generator=gen, device="cuda")
        q, k, v = (x.contiguous() for x in qkv.reshape(nw, n, 3, nh, hd).permute(2, 0, 3, 1, 4))
        mask = torch.as_tensor(shifted_window_mask(hp, wp, ws, ws // 2), device="cuda") if masked else None
        # correctness: bf16 (the serving dtype) and fp32
        got = window_attention(qkv, bias, mask, nh, scale)
        want = window_attention_reference(qkv, bias, mask, nh, scale)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        tol = BF16_ULP * float(want.float().abs().max())  # one bf16 ulp of the largest output
        # and per element: the tensor cores sum in another order, so a few outputs may
        # round the other way, but a placement fault moves many by more than an ulp
        share = bf16_ulp_share(got, want)
        q32 = qkv.float()
        err32 = max_abs(window_attention(q32, bias, mask, nh, scale),
                        window_attention_reference(q32, bias, mask, nh, scale))
        tol32 = 1e-4
        ok = err <= tol and share >= BF16_SHARE and err32 <= tol32
        worst = max(worst, err)
        # times
        am = (bias[None] + mask[:, None] if masked else bias[None]).to(torch.bfloat16)
        t_all = cuda_ms_batches(lambda: window_attention(qkv, bias, mask, nh, scale))
        t_k = t_all[0]
        t_p = cuda_ms(lambda: window_attention_reference(qkv, bias, mask, nh, scale))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale))
        nbytes = qkv.numel() * 2 + nw * n * c * 2 + bias.numel() * 4 + (mask.numel() * 4 if masked else 0)
        flops = 4.0 * nw * nh * n * n * hd
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        row = dict(stage=s, masked=masked, nW=nw, nh=nh, N=n, hd=hd, blocks_per_image=count,
                   max_abs_err_bf16=err, tol_bf16=tol, bf16_ulp_share=share, max_abs_err_fp32=err32, tol_fp32=tol32,
                   ms=t_k, ms_batches=t_all, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                   flops=flops)
        rows.append(row)
        log(f"window_attention stage {s} {'shifted' if masked else 'plain   '} nW={nw:4d} nh={nh:2d}: "
            f"err bf16 {err:.3e} (tol {tol:.3e}), share within 1 ulp {share:.6f} (tol {BF16_SHARE}), "
            f"fp32 {err32:.3e} (tol {tol32:.0e}) | "
            f"kernel {t_k:.4f} ms (3 batches {_fmt(t_all)}), plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if not ok:
            raise RuntimeError(f"window_attention disagrees with its plain version: {row}")
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms)):
            totals[key] += count * t
        totals["ms_batches"] = [a + count * t for a, t in zip(totals["ms_batches"], t_all)]
    return rows, totals, worst


def window_attention_phase(cfg, gen, cfg_l):
    """Kernel A against its plain version, timed, at every stage shape of one 1024x2048
    request of ``cfg`` (Swin-B) and of ``cfg_l`` (Swin-L's head counts), then at every other
    shape that the driven phases give it.  Returns the rows, Swin-B's and Swin-L's totals
    per image, the worst bf16 error and the shapes held."""
    rows, totals, worst = _window_attention_timed(cfg, gen)
    rows_l, totals_l, worst_l = _window_attention_timed(cfg_l, gen)
    rows += [dict(r, config="swin_l") for r in rows_l]
    worst = max(worst, worst_l)
    # correctness alone at every other window-attention shape that the driven phases
    # give the kernel (served_sizes: TTA variants up to 1792x3584, 1024x1024 tiles, the
    # sweep's synthetic images, the Mapillary and StreetHazards frames, the selfcheck's
    # and the ablation's images; swin_l_sizes at
    # Swin-L's head counts), at bf16 and fp32; main() gates that these cover every shape
    # the kernel was launched at
    from rba_tpu_torch.kernels.window_attention import window_attention, window_attention_reference
    from rba_tpu_torch.models.swin import shifted_window_mask

    ws, n = cfg.swin.window_size, cfg.swin.window_size**2
    checked = {(nw, nh, c // nh, masked) for c_ in (cfg, cfg_l) for _, masked, nw, nh, c, _, _, _ in stage_shapes(c_)}
    for scfg, hw in [(cfg, hw) for hw in served_sizes(cfg)[1:]] + [(cfg_l, hw) for hw in swin_l_sizes(cfg_l)[1:]]:
        first = len(rows)
        for s, masked, nw, nh, c, hp, wp, _ in stage_shapes(scfg, hw):
            if (nw, nh, c // nh, masked) in checked:
                continue
            checked.add((nw, nh, c // nh, masked))
            qkv = torch.randn(nw, n, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
            bias = torch.randn(nh, n, n, generator=gen, device="cuda")
            mask = torch.as_tensor(shifted_window_mask(hp, wp, ws, ws // 2), device="cuda") if masked else None
            scale = (c // nh) ** -0.5
            got = window_attention(qkv, bias, mask, nh, scale)
            want = window_attention_reference(qkv, bias, mask, nh, scale)
            q32 = qkv.float()
            err32 = max_abs(window_attention(q32, bias, mask, nh, scale),
                            window_attention_reference(q32, bias, mask, nh, scale))
            err, tol, share = max_abs(got, want), BF16_ULP * float(want.float().abs().max()), bf16_ulp_share(got, want)
            rows.append(dict(image_hw=list(hw), nh_per_stage=list(scfg.swin.num_heads), stage=s, masked=masked, nW=nw,
                             nh=nh, max_abs_err_bf16=err,
                             tol_bf16=tol, bf16_ulp_share=share, max_abs_err_fp32=err32, tol_fp32=1e-4))
            if not (err <= tol and share >= BF16_SHARE and err32 <= 1e-4):
                raise RuntimeError(f"window_attention disagrees with its plain version at {hw}: {rows[-1]}")
            worst = max(worst, err)
        new = rows[first:]
        if new:
            log(f"window_attention at {hw[0]}x{hw[1]}, heads {scfg.swin.num_heads}, {len(new)} new shapes (nW "
                f"{sorted({r['nW'] for r in new}, reverse=True)}): worst bf16 err / tol "
                f"{max(r['max_abs_err_bf16'] / r['tol_bf16'] for r in new):.3f}, least share within 1 ulp "
                f"{min(r['bf16_ulp_share'] for r in new):.6f} (tol {BF16_SHARE}), worst fp32 err "
                f"{max(r['max_abs_err_fp32'] for r in new):.3e} (tol 1e-4)")
    return rows, totals, worst, checked, totals_l


# ---------------------------------------------------------------------------
# Kernel B: fused RbA score at Q = 100, K = 19, 256 x 512 masks
# ---------------------------------------------------------------------------

def fused_rba_phase(cfg, gen):
    from rba_tpu_torch.kernels.fused_rba import fused_rba_score, fused_rba_score_reference

    q, k = cfg.decoder.num_queries, cfg.num_classes
    h, w = IMAGE_HW[0] // 4, IMAGE_HW[1] // 4
    mask_cls = torch.randn(1, q, k + 1, generator=gen, device="cuda")
    masks = torch.randn(1, h, w, q, generator=gen, device="cuda") * 2  # bhwq
    got = fused_rba_score(mask_cls, masks, masks_layout="bhwq")
    want = fused_rba_score_reference(mask_cls, masks, masks_layout="bhwq")
    torch.cuda.synchronize()
    err, tol = max_abs(got, want), 1e-4
    t_all = cuda_ms_batches(lambda: fused_rba_score(mask_cls, masks, masks_layout="bhwq"))
    t_k = t_all[0]
    t_p = cuda_ms(lambda: fused_rba_score_reference(mask_cls, masks, masks_layout="bhwq"), iters=5)
    nbytes = masks.numel() * 4 + mask_cls.numel() * 4 + got.numel() * 4
    flops = 2.0 * q * k * got.numel()  # the class contraction alone
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    # The bound of the design as built: the contraction as three TF32 products on the
    # tensor cores, and per pixel the CUDA-core work around it: ex2 and rcp for each
    # query's sigmoid and each class's tanh, and about 9 ALU instructions per query
    # (blend, sigmoid's add and scale, the split into two TF32 terms).
    built = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "tf32 operations": 3 * flops / PEAK_FLOPS["tf32"] * 1e3,
             "special-function operations": 2.0 * (q + k) * got.numel() / SFU_OPS_PER_S * 1e3,
             "alu operations": 9.0 * q * got.numel() / ALU_OPS_PER_S * 1e3}
    bb_by = max(built, key=built.get)
    row = dict(Q=q, K=k, h=h, w=w, max_abs_err=err, tol=tol, ms=t_k, ms_batches=t_all, plain_ms=t_p, bound_ms=b_ms,
               bound_by=b_by, bound_built_ms=built[bb_by], bound_built_by=bb_by, bound_built_terms=built,
               bytes=nbytes, flops=flops)
    log(f"fused_rba_score Q={q} K={k} {h}x{w}: err {err:.3e} (tol {tol:.0e}) | kernel {t_k:.4f} ms "
        f"(3 batches {_fmt(t_all)}), plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}, fp32 CUDA-core contraction); "
        f"bound of the design as built {built[bb_by]:.4f} ms ({bb_by}; "
        + ", ".join(f"{k2} {v:.4f}" for k2, v in built.items()) + ")")
    if not err <= tol:
        raise RuntimeError(f"fused_rba_score disagrees with its plain version: {row}")
    # correctness alone: two batch elements with different cls, and a K that needs a
    # second pass of 24 classes, on masks whose width is not a whole tile of patches,
    # at StreetHazards' stride-4 logits of a 736x1280 padded frame and at those of the
    # tools phase's selfcheck and ablation images
    sh = [-(-d // 32) * 8 for d in STREET_HAZARDS_HW]
    tools = [(1, k, *(d // 4 for d in hw)) for hw in (SELFCHECK_HW, ABLATION_HW)]
    for b, k2, h2, w2 in ((2, k, 64, 200), (2, 40, 64, 200), (1, k, *sh), *tools):
        cls2 = torch.randn(b, q, k2 + 1, generator=gen, device="cuda")
        masks2 = torch.randn(b, h2, w2, q, generator=gen, device="cuda") * 2
        got2 = fused_rba_score(cls2, masks2, masks_layout="bhwq")
        torch.cuda.synchronize()
        err2 = max_abs(got2, fused_rba_score_reference(cls2, masks2, masks_layout="bhwq"))
        row[f"max_abs_err_B{b}_K{k2}_{h2}x{w2}"] = err2
        log(f"fused_rba_score B={b} Q={q} K={k2} {h2}x{w2}: err {err2:.3e} (tol {tol:.0e})")
        if not err2 <= tol:
            raise RuntimeError(f"fused_rba_score disagrees with its plain version at B={b}, K={k2}: {err2}")
    row["coco"] = _fused_rba_coco(gen)
    return row


def _fused_rba_coco(gen):
    """Kernel B as the open-panoptic RbA map of the COCO Swin-B model: Q = 100, K = 117,
    the (200, 272) stride-4 logits of an 800x1088 padded frame (bqhw, as the evaluator
    hands them over), against its plain version, timed."""
    from rba_tpu_torch.kernels.fused_rba import SMEM_LIMIT, fused_rba_score, fused_rba_score_reference, smem_bytes

    q, k, h, w = 100, 117, -(-COCO_HW[0] // 32) * 8, -(-COCO_HW[1] // 32) * 8
    mask_cls = torch.randn(1, q, k + 1, generator=gen, device="cuda") * 2
    low = torch.randn(1, q, h, w, generator=gen, device="cuda") * 4
    got = fused_rba_score(mask_cls, low)
    err, tol = max_abs(got, fused_rba_score_reference(mask_cls, low)), 1e-4
    t_all = cuda_ms_batches(lambda: fused_rba_score(mask_cls, low))
    t_p = cuda_ms(lambda: fused_rba_score_reference(mask_cls, low), iters=5)
    nbytes = low.numel() * 4 + mask_cls.numel() * 4 + got.numel() * 4
    flops = 2.0 * q * k * got.numel()
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    row = dict(Q=q, K=k, h=h, w=w, smem_bytes=smem_bytes(q, k), smem_limit=SMEM_LIMIT, max_abs_err=err, tol=tol,
               ms=t_all[0], ms_batches=t_all, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
    log(f"fused_rba_score Q={q} K={k} {h}x{w} (bqhw; COCO open panoptic, shared memory {row['smem_bytes']} of "
        f"{SMEM_LIMIT} B): err {err:.3e} (tol {tol:.0e}) | kernel {t_all[0]:.4f} ms (3 batches {_fmt(t_all)}), plain "
        f"{t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if not err <= tol:
        raise RuntimeError(f"fused_rba_score disagrees with its plain version at the COCO shape: {row}")
    return row


# ---------------------------------------------------------------------------
# Kernel C: masked softmax at the Swin-B 1024x2048 stage shapes
# ---------------------------------------------------------------------------

def masked_softmax_phase(cfg, gen):
    """Kernel C against its plain version on (nW, nh, 144, 144) fp32 scores, with the
    bf16 output the serving path writes and with fp32 output; times of the bf16 one."""
    from rba_tpu_torch.kernels.masked_softmax import masked_softmax, masked_softmax_reference
    from rba_tpu_torch.models.swin import shifted_window_mask

    ws, n = cfg.swin.window_size, cfg.swin.window_size**2
    rows, totals = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, cast_ms=0.0, ms_batches=[0.0] * 3)
    worst = 0.0
    for s, masked, nw, nh, c, hp, wp, count in stage_shapes(cfg):
        scores = torch.randn(nw, nh, n, n, generator=gen, device="cuda") * 3
        bias = torch.randn(nh, n, n, generator=gen, device="cuda")
        mask = torch.as_tensor(shifted_window_mask(hp, wp, ws, ws // 2), device="cuda") if masked else None
        got = masked_softmax(scores, bias, mask, torch.bfloat16)
        want = masked_softmax_reference(scores, bias, mask, torch.bfloat16)
        torch.cuda.synchronize()
        err, ulps = max_abs(got, want), bf16_ulps(got, want)
        err32 = max_abs(masked_softmax(scores, bias, mask, torch.float32),
                        masked_softmax_reference(scores, bias, mask, torch.float32))
        tol32 = 1e-6
        worst = max(worst, err)
        t_all = cuda_ms_batches(lambda: masked_softmax(scores, bias, mask, torch.bfloat16))
        t_k = t_all[0]
        t_p = cuda_ms(lambda: masked_softmax_reference(scores, bias, mask, torch.bfloat16))
        # the same fp32 reads and bf16 writes with no arithmetic, bias or mask: what the memory gives
        t_c = cuda_ms(lambda: scores.to(torch.bfloat16))
        nbytes = scores.numel() * (4 + 2) + bias.numel() * 4 + (mask.numel() * 4 if masked else 0)
        flops = 7.0 * scores.numel()  # per score: 1-2 adds, max, subtract, exp, sum, divide
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        row = dict(stage=s, masked=masked, nW=nw, nh=nh, N=n, blocks_per_image=count, max_abs_err_bf16=err,
                   max_bf16_ulps=ulps, max_abs_err_fp32=err32, tol_fp32=tol32, ms=t_k, ms_batches=t_all, plain_ms=t_p,
                   cast_ms=t_c, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        rows.append(row)
        log(f"masked_softmax stage {s} {'shifted' if masked else 'plain   '} nW={nw:4d} nh={nh:2d}: "
            f"err bf16 {err:.3e} ({ulps:.2f} ulp, tol 1) fp32 {err32:.3e} (tol {tol32:.0e}) | "
            f"kernel {t_k:.4f} ms (3 batches {_fmt(t_all)}), plain {t_p:.4f} ms, cast to bf16 alone {t_c:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if not (ulps <= 1.0 and err32 <= tol32):
            raise RuntimeError(f"masked_softmax disagrees with its plain version: {row}")
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", b_ms), ("cast_ms", t_c)):
            totals[key] += count * t
        totals["ms_batches"] = [a + count * t for a, t in zip(totals["ms_batches"], t_all)]
        if masked and s == 1:  # a batch of two images: window w takes mask[w % nW]
            scores2 = torch.randn(2 * nw, nh, n, n, generator=gen, device="cuda") * 3
            got2 = masked_softmax(scores2, bias, mask, torch.bfloat16)
            torch.cuda.synchronize()
            ulps2 = bf16_ulps(got2, masked_softmax_reference(scores2, bias, mask, torch.bfloat16))
            row["max_bf16_ulps_batch2"] = ulps2
            log(f"masked_softmax stage {s} shifted, batch 2 (2 nW = {2 * nw} windows): {ulps2:.2f} ulp (tol 1)")
            if not ulps2 <= 1.0:
                raise RuntimeError(f"masked_softmax disagrees with its plain version at batch 2: {ulps2} ulp")
    return rows, totals, worst


# ---------------------------------------------------------------------------
# Kernel D: fused MLP residual at the Swin-B 1024x2048 stage-0 and stage-1 shapes
# ---------------------------------------------------------------------------

# (T, C, calls per image): stages 0 and 1 on the path, then C = 512 (Swin-B stage 2,
# which the dispatch leaves unfused) and a ragged token count
FUSED_MLP_SHAPES = [(131072, 128, 2), (32768, 256, 2), (8192, 512, 0), (1000, 128, 0)]


def fused_mlp_phase(gen):
    """Kernel D against its plain version on inputs drawn as rba_tpu's fused-MLP test
    draws them, in bf16 and fp32; times of both."""
    from rba_tpu_torch.kernels.fused_mlp import fused_mlp_residual, fused_mlp_residual_reference

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    rows, totals = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ms_batches=[0.0] * 3)
    worst = 0.0
    for t, c, count in FUSED_MLP_SHAPES:
        x32 = randn(t, c) * 2
        params = (randn(c, scale=0.2, shift=1.0), randn(c, scale=0.1), randn(4 * c, c, scale=0.05),
                  randn(4 * c, scale=0.02), randn(c, 4 * c, scale=0.05), randn(c, scale=0.02))
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            got = fused_mlp_residual(x, *params)
            want = fused_mlp_residual_reference(x, *params)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            err = float(d.max())
            if dtype == torch.float32:
                tol, ok = 1e-4, err <= 1e-4
                share = None
            else:  # tests/test_torch_fused_mlp.py's bf16 bound
                tol = BF16_ULP * float(want.float().abs().max())
                share = float((d <= 2e-2 + 2e-2 * want.float().abs()).float().mean())
                ok = err <= tol and share >= 0.999
                if count:
                    worst = max(worst, err)
            t_all = cuda_ms_batches(lambda: fused_mlp_residual(x, *params))
            t_k = t_all[0]
            t_p = cuda_ms(lambda: fused_mlp_residual_reference(x, *params))
            nbytes = 2 * x.numel() * x.element_size() + sum(p.numel() for p in params) * 4
            flops = 2.0 * 2 * t * c * 4 * c
            dname = "bfloat16" if dtype == torch.bfloat16 else "float32"
            b_ms, b_by = bound_ms(nbytes, flops, dname)
            row = dict(T=t, C=c, dtype=dname, calls_per_image=count, max_abs_err=err, tol=tol,
                       share_within_2e_2=share, ms=t_k, ms_batches=t_all, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                       bytes=nbytes, flops=flops)
            rows.append(row)
            log(f"fused_mlp T={t:6d} C={c:3d} {dname:8s}: err {err:.3e} (tol {tol:.3e}"
                + (f", {share:.6f} within 2e-2" if share is not None else "") + ") | "
                f"kernel {t_k:.4f} ms (3 batches {_fmt(t_all)}), plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            if not ok:
                raise RuntimeError(f"fused_mlp_residual disagrees with its plain version: {row}")
            if dtype == torch.bfloat16:  # the serving dtype
                for key, tm in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", b_ms)):
                    totals[key] += count * tm
                totals["ms_batches"] = [a + count * tm for a, tm in zip(totals["ms_batches"], t_all)]
    return rows, totals, worst


# ---------------------------------------------------------------------------
# End to end: Swin-B RbA requests at 1024x2048
# ---------------------------------------------------------------------------

def _timed(fn, *args, **kw):
    """(result, ms) of one call, by the host clock around work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _plain(on: bool = True):
    """``kernels.plain_versions()`` where ``on``: the kernels' plain versions inside the
    block; else no switch, the kernels."""
    from rba_tpu_torch.kernels import plain_versions

    return plain_versions() if on else contextlib.nullcontext()


def _wrappers(lsap: bool = False, deform: bool = False):
    """Every kernel wrapper of the port's Pallas counterparts by name, with ``lsap``
    Kernel E's too and with ``deform`` Kernels F's, G's and H's (the deformable sampling,
    MiT's attention core and the relative-position attention core, counted on the
    serving paths); each counts its launches."""
    from rba_tpu_torch.kernels.fused_mlp import fused_mlp_residual
    from rba_tpu_torch.kernels.fused_rba import fused_rba_score
    from rba_tpu_torch.kernels.lsap import batched_linear_sum_assignment
    from rba_tpu_torch.kernels.masked_softmax import masked_softmax
    from rba_tpu_torch.kernels.ms_deform_attn import ms_deform_attn
    from rba_tpu_torch.kernels.rel_pos_attention import rel_pos_attention
    from rba_tpu_torch.kernels.sr_attention import sr_attention
    from rba_tpu_torch.kernels.window_attention import window_attention

    out = {"window_attention": window_attention, "fused_rba_score": fused_rba_score,
           "masked_softmax": masked_softmax, "fused_mlp_residual": fused_mlp_residual}
    if lsap:
        out["lsap"] = batched_linear_sum_assignment
    if deform:
        out["ms_deform_attn"] = ms_deform_attn
        out["sr_attention"] = sr_attention
        out["rel_pos_attention"] = rel_pos_attention
    return out


def _sr_per_request(cfg, model) -> int:
    """Kernel G launches of one request, at any batch: one per MiT block where
    ``kernels/sr_attention.py`` ``takes`` takes the block's core (no autograd in a
    request), else none."""
    from rba_tpu_torch.kernels.sr_attention import takes
    from rba_tpu_torch.models.mix_transformer import MiT

    mit = model.backbone
    if not isinstance(mit, MiT):
        return 0
    dtype = getattr(torch, cfg.compute_dtype)
    return sum(depth for depth, dim, heads in zip(mit.cfg.depths, mit.cfg.embed_dims, mit.cfg.num_heads)
               if takes(torch.device("cuda"), dtype, False, dim // heads))


def _rel_per_request(cfg, model) -> int:
    """Kernel H launches of one request, at any batch: one per MViT or ViT block with
    position tables where ``kernels/rel_pos_attention.py`` ``takes`` takes the block's
    core (no autograd in a request), else none."""
    from rba_tpu_torch.kernels.rel_pos_attention import takes
    from rba_tpu_torch.models.mvit import MViT
    from rba_tpu_torch.models.vit import ViT

    backbone = getattr(model.backbone, "vit", model.backbone)
    if not isinstance(backbone, (MViT, ViT)) or not backbone.cfg.use_rel_pos:
        return 0
    dtype = getattr(torch, cfg.compute_dtype)
    return sum(takes(torch.device("cuda"), dtype, False, blk.attn.rel_pos_h.shape[-1]) for blk in backbone.blocks)


def _rel_pos_spans_per_request(model) -> dict:
    """``rel_pos_attention`` and ``qkv_pool`` spans of one request, at any batch: one of
    each per MViT block, one ``rel_pos_attention`` per ViT block, none elsewhere."""
    from rba_tpu_torch.models.mvit import MViT
    from rba_tpu_torch.models.vit import ViT
    from rba_tpu_torch.utils.profiling import QKV_POOL, REL_POS_ATTENTION

    backbone = getattr(model.backbone, "vit", model.backbone)
    blocks = len(backbone.blocks) if isinstance(backbone, (MViT, ViT)) else 0
    return {REL_POS_ATTENTION: blocks, QKV_POOL: blocks if isinstance(backbone, MViT) else 0}


def _replays_per_request(cfg, model) -> int:
    """CUDA-graph replays of one request once its shape is captured: one per stretch of
    MiT's forward between two attention cores (blocks + 1) where
    ``models/mix_transformer.py`` ``graphs_take`` says so, one per ``qkv_pool`` and
    ``rel_pos_attention`` span of MViT's forward and one per stretch around them (4 ·
    blocks + 1) where ``models/mvit.py`` ``graphs_take`` says so (no autograd in a
    request), else none."""
    from rba_tpu_torch.models import mvit
    from rba_tpu_torch.models.mix_transformer import MiT, graphs_take

    backbone = model.backbone
    if isinstance(backbone, mvit.MViT):
        return 4 * len(backbone.blocks) + 1 if mvit.graphs_take(torch.device("cuda"), False) else 0
    if not isinstance(backbone, MiT) or not graphs_take(backbone.cfg, torch.device("cuda"),
                                                        getattr(torch, cfg.compute_dtype), False):
        return 0
    return sum(backbone.cfg.depths) + 1


def _deform_per_request(cfg, model, batch: int = 1, hw=IMAGE_HW) -> int:
    """Kernel F launches of one request of ``batch`` hw frames: one per encoder layer of
    a deformable pixel decoder whose levels' shapes and sampling forms
    ``kernels/ms_deform_attn.py`` ``takes`` takes, else none."""
    from rba_tpu_torch.kernels.ms_deform_attn import takes
    from rba_tpu_torch.models.pixel_decoder import PixelDecoder
    from rba_tpu_torch.ops.deform_sampling import sampling_methods

    if not isinstance(model.sem_seg_head["pixel_decoder"], PixelDecoder):
        return 0
    pd, div = cfg.pixel_decoder, max(cfg.input.size_divisibility, 1)
    hp, wp = (-(-x // div) * div for x in hw)
    strides = [model.backbone.out_strides[f] for f in pd.transformer_in_features]
    shapes = [(-(-hp // st), -(-wp // st)) for st in strides]
    lq, m = sum(h * w for h, w in shapes), pd.transformer_nheads
    methods = sampling_methods(batch, m, lq, shapes, pd.sampling_method, pd.sampling_onehot_cap)
    value, loc = (batch, lq, m, pd.conv_dim // m), (batch, lq, m, len(shapes), pd.enc_n_points, 2)
    return pd.transformer_enc_layers if takes(torch.device("cuda"), False, methods, pd.sampling_dtype, value, loc) \
        else 0


def serve_phase(name, cfg, model, images, attention, per_image):
    """Serve each image as one request through one path's kernels (the main path,
    counted: ``per_image`` launches of each kernel per request, Kernel F's by default
    ``_deform_per_request``) and, in turns, through the plain versions, which launch
    none; check the score maps.  Returns the measurements and the fp32 score maps of the
    kernels, for the comparison between paths."""
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    per_image = {"ms_deform_attn": _deform_per_request(cfg, model), **per_image}
    wrappers = _wrappers(lsap=True, deform=True)
    infer = functools.partial(maskformer_infer_rba, model, attention=attention)
    infer(cfg, images[0])  # warm-up requests, one per path
    with _plain():
        infer(cfg, images[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    scores, plain_scores, times, t_plain = [], [], [], []
    for i in range(1, N_REQUESTS + 1):  # kernel, plain, plain, kernel, ...
        for plain in ((False, True) if i % 2 else (True, False)):
            with _plain(plain):
                rba, ms = _timed(infer, cfg, images[i])
            (plain_scores if plain else scores).append(rba)
            (t_plain if plain else times).append(ms)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    clocks = _smi("clocks.sm,power.draw,temperature.gpu")

    for rba in scores:
        if tuple(rba.shape) != (1, *IMAGE_HW) or not bool(torch.isfinite(rba).all()):
            raise RuntimeError(f"{name}: bad score map: shape {tuple(rba.shape)}, "
                               f"finite {bool(torch.isfinite(rba).all())}")
    expected = {k: per_image.get(k, 0) * N_REQUESTS for k in wrappers}
    if launches != expected:
        raise RuntimeError(f"{name}: launches {launches}, expected {expected} ({per_image} per request)")
    log(f"{name} (attention={attention!r}, mlp_impl={cfg.swin.mlp_impl!r}) served {N_REQUESTS} requests: "
        f"launches {launches}; ms/image {statistics.median(times):.2f} (median; all {[round(t, 2) for t in times]}), "
        f"plain versions {statistics.median(t_plain):.2f} (all {[round(t, 2) for t in t_plain]}), "
        f"peak memory {peak_gib:.2f} GiB; right after: SM clock, power draw, temperature {clocks}")

    # fp32: kernels vs plain versions, gated at the selfcheck bound.  bf16 backbone:
    # reported, not gated.  Kernel and plain version sum the same fp32 math in other
    # orders, so their bf16 outputs differ by one ulp where a value sits near a rounding
    # edge; with random weights those flips grow through 24 blocks into differences far
    # above rounding.  The plain version's own bf16-vs-fp32 difference is printed for scale.
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    err32 = err16 = spread16 = 0.0
    scores32 = []
    for i in range(1, N_REQUESTS + 1):
        with _plain():
            plain32 = infer(cfg32, images[i])
        scores32.append(infer(cfg32, images[i]))
        err32 = max(err32, max_abs(scores32[-1], plain32))
        err16 = max(err16, max_abs(scores[i - 1], plain_scores[i - 1]))
        spread16 = max(spread16, max_abs(plain_scores[i - 1], plain32))
    log(f"{name} score map, kernels vs plain versions: fp32 max diff {err32:.3e} (bound {E2E_FP32_TOL:.0e}, gated); "
        f"bf16 backbone max diff {err16:.3e} (reported, not gated; the plain version's own bf16-vs-fp32 "
        f"diff is {spread16:.3e})")
    if not err32 <= E2E_FP32_TOL:
        raise RuntimeError(f"{name}: fp32 score maps differ by {err32} > {E2E_FP32_TOL}")
    out = dict(attention=attention, mlp_impl=cfg.swin.mlp_impl, launches=launches,
               ms_per_image=statistics.median(times), ms_all=times, plain_ms_per_image=statistics.median(t_plain),
               plain_ms_all=t_plain, peak_gib=peak_gib, clocks=clocks, fp32_max_diff=err32, fp32_bound=E2E_FP32_TOL,
               bf16_max_diff_not_gated=err16, bf16_plain_vs_fp32_diff=spread16)
    return out, scores, scores32


def _annotations():
    """The names of the port's spans (``utils/profiling.py`` ``ALL_SPANS``): a request, its
    upload and layers, each Kernel A call, each deformable-sampling call and its backward
    and the parts of a train step."""
    from rba_tpu_torch.utils.profiling import ALL_SPANS

    return ALL_SPANS


def _device_kernels(prof):
    """(name, device ms, calls) of a profile's device events, the longest first, less the
    annotation spans that mirror each record_function of ``_annotations()`` and torch's
    own optimizer spans (``Optimizer.step#AdamW.step``)."""
    from torch.autograd import DeviceType

    spans = _annotations()
    return sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in spans
                   and not e.key.startswith("Optimizer.")), key=lambda r: -r[1])


def _span_busy(device, layer_busy_ms, span: str):
    """Device busy ms of the kernels that start inside the ``span`` spans (the deformable
    sampling's, one per encoder layer; ``sr_attention``, one per MiT block), those kernels
    by name, and their share of the enclosing layer's busy time ``layer_busy_ms``."""
    spans = [e.time_range for e in device if e.name == span]
    spans_all = _annotations()
    inside = [e for e in device if e.name not in spans_all
              and any(sp.start <= e.time_range.start < sp.end for sp in spans)]
    by_name = {}
    for e in inside:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy = sum(ms for ms, _ in by_name.values())
    return dict(spans=len(spans), busy_ms=busy,
                share_of_layer=busy / layer_busy_ms if layer_busy_ms else None,
                kernels=[dict(kernel=k[:120], ms=ms, calls=c)
                         for k, (ms, c) in sorted(by_name.items(), key=lambda r: -r[1][0])])


def profile_phase(path, cfg, model, image, attention, redesigned, top: int = 10):
    """torch.profiler over one request through ``maskformer_infer_rba``: each layer's
    host span, device span and device busy time (read from the entry's own
    ``record_function`` spans), the card's idle share of the request's wall time, and
    the kernels that take the most device time.  ``redesigned`` maps the name of each
    kernel the path must run to the name of the kernel it superseded (or the fp32
    CUDA-core counterpart that a bf16 request must not take): fails unless the first
    ran and the second did not (inside the sampling's spans, for ``SAMPLING_ONLY``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rba_tpu_torch.models.maskformer import LAYERS, maskformer_infer_rba
    from rba_tpu_torch.ops.deform_sampling import SPAN
    from rba_tpu_torch.utils.profiling import QKV_POOL, REL_POS_ATTENTION, SR_ATTENTION

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        maskformer_infer_rba(model, cfg, image, attention=attention)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy_ms = sum(r[1] for r in kernels)
    if busy_ms == 0:
        log(f"{path} profile: the profiler recorded no device time (not measured)")
        return dict(wall_ms=wall_ms, busy_ms=None, idle_share=None, layers=None, top=[])
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    spans_all = _annotations()
    host_spans = {e.name: e.time_range for e in events if e.device_type == DeviceType.CPU and e.name in LAYERS}
    dev_spans = {e.name: e.time_range for e in device if e.name in LAYERS}
    missing = [name for name in LAYERS if name not in host_spans]
    if missing:
        raise RuntimeError(f"profile of maskformer_infer_rba shows no span for the layers {missing}")
    # a layer's device busy time: the device events that start inside its device-side span
    layers = {}
    for name in LAYERS:
        span = dev_spans.get(name)
        busy = (sum(e.time_range.elapsed_us() for e in device
                    if e.name not in spans_all and span.start <= e.time_range.start < span.end) / 1e3 if span else 0.0)
        layers[name] = dict(host_ms=host_spans[name].elapsed_us() / 1e3,
                            device_span_ms=span.elapsed_us() / 1e3 if span else 0.0, device_busy_ms=busy)
    sampling = _span_busy(device, layers["pixel_decoder"]["device_busy_ms"], SPAN)
    sr, rel, pool = (_span_busy(device, layers["backbone"]["device_busy_ms"], sp)
                     for sp in (SR_ATTENTION, REL_POS_ATTENTION, QKV_POOL))
    hand = []
    for new, old in redesigned.items():
        ran = [r for r in kernels if new in r[0]]
        names = [k["kernel"] for k in sampling["kernels"]] if old in SAMPLING_ONLY else [r[0] for r in kernels]
        stale = [k for k in names if old in k]
        if not ran or stale:
            raise RuntimeError(f"{path}: the request ran {[r[0] for r in ran]} and {stale}; expected {new} "
                               f"and no {old}")
        hand += ran
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms, layers=layers,
               top=[dict(kernel=k[:120], ms=t, calls=c) for k, t, c in kernels[:top]],
               hand_kernels=[dict(kernel=k[:120], ms=t, calls=c) for k, t, c in hand], sampling=sampling,
               sr_attention=sr, rel_pos_attention=rel, qkv_pool=pool)
    log(f"{path} profile of one request (profiler on): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {out['idle_share']:.3f}; by layer, host span / device span / device busy ms: "
        + "; ".join(f"{k} {v['host_ms']:.2f} / {v['device_span_ms']:.2f} / {v['device_busy_ms']:.2f}"
                    for k, v in layers.items()))
    share = sampling["share_of_layer"]
    log(f"{path} deformable sampling ({sampling['spans']} calls): device busy {sampling['busy_ms']:.3f} ms, "
        + (f"{share:.3f} of the pixel decoder's busy time" if share is not None else "pixel decoder not measured"))
    for title, row in (("spatial-reduction attention", sr), ("relative-position attention", rel),
                       ("q/k/v pooling", pool)):
        if row["spans"]:
            log(f"{path} {title} ({row['spans']} spans): device busy {row['busy_ms']:.3f} ms, "
                f"{row['share_of_layer']:.3f} of the backbone's busy time")
    for title, rows in ((f"{path} top kernels by device time:", out["top"]),
                        (f"{path} its hand kernels:", out["hand_kernels"]),
                        (f"{path} the deformable sampling's kernels:", sampling["kernels"]),
                        (f"{path} the attention cores' kernels:", sr["kernels"] + rel["kernels"])):
        log(title)
        for r in rows:
            log(f"  {r['ms']:8.3f} ms  x{r['calls']:<4d} {r['kernel']}")
    return out


# ---------------------------------------------------------------------------
# OOD evaluation of Swin-B RbA scores on 1024x2048 images (path 1)
# ---------------------------------------------------------------------------

def _eval_timed(fn, *args, **kw):
    """(result, seconds, whether the evaluation fell back to the exact path) of one call,
    by the host clock around work that ends in a synchronize."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, ms = _timed(fn, *args, **kw)
    fell_back = any("re-running the exact all-pixel path" in str(w.message) for w in caught)
    return out, ms / 1e3, fell_back


def _profile(name, fn, top: int = 8, spans=()):
    """torch.profiler over one call of ``fn``: wall, device busy time, idle share and the
    kernels that take the most device time; for each record_function name in ``spans``,
    how many such spans ran and the device time of the kernels launched inside them (the
    host-side span's ``device_time_total``: its ops' kernels, on whatever thread it ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy_ms = sum(r[1] for r in kernels)
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms or None, idle_share=1 - busy_ms / wall_ms if busy_ms else None,
               top=[dict(kernel=k[:120], ms=t, calls=c) for k, t, c in kernels[:top]],
               nccl_ms=sum(t for k, t, _ in kernels if "nccl" in k.lower()))
    if spans:
        host = [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name in spans]
        out["spans"] = {sp: dict(count=sum(e.name == sp for e in host),
                                 busy_ms=sum(e.device_time_total for e in host if e.name == sp) / 1e3) for sp in spans}
    log(f"{name}: profile (profiler on): wall {wall_ms:.2f} ms, device busy "
        + (f"{busy_ms:.2f} ms, idle share {out['idle_share']:.3f}" if busy_ms else "not measured"))
    for r in out["top"]:
        log(f"  {r['ms']:8.3f} ms  x{r['calls']:<4d} {r['kernel']}")
    return out


def _count_syncs(fn) -> int:
    """How many times one call of ``fn`` makes the host wait for the card, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def make_scenes():
    """EVAL_IMAGES structured synthetic 1024x2048 scenes, made in memory, and the host
    seconds that took."""
    from rba_tpu_torch.data.ood_datasets import SyntheticStructured

    t0 = time.perf_counter()
    ds = SyntheticStructured(n=EVAL_IMAGES, hw=IMAGE_HW, seed=0)
    samples = [ds[i] for i in range(len(ds))]
    gen_s = time.perf_counter() - t0
    log(f"eval: generated SyntheticStructured(n={EVAL_IMAGES}, hw={IMAGE_HW}, seed=0) in memory in {gen_s:.2f} s "
        "of host time (before any timing)")
    return samples, gen_s


def eval_phase(cfg, busy_ms, model, samples, gen_s):
    """The port's OOD evaluation at full Swin-B width on EVAL_IMAGES structured synthetic
    1024x2048 scenes (``make_scenes``), on ``model``: the streaming path at cohort 1
    (launches counted) and 4 (histograms equal count for count), the exact path and its
    host metrics, the exact metrics inside the certified bounds of histograms of the same
    score maps, fp32 kernels against their plain versions by metrics, the histogram's
    device time per image, and the energy score through asinh-binned histograms.
    ``busy_ms`` is one path-1 request's device busy time, for the histogram's share."""
    from rba_tpu_torch.evalx.evaluator import OODEvaluator, make_cohort_fn
    from rba_tpu_torch.evalx.metrics import (StreamingOODMetrics, histogram_update, metrics_from_histograms,
                                             to_device)
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    ev = OODEvaluator(cfg, model)
    wrappers = _wrappers()
    out = dict(images=EVAL_IMAGES, generate_s=gen_s)
    ev.score_fn(samples[0].image[None])  # warm-up, and the first metrics call's scipy import
    metrics_from_histograms(np.ones(2), np.ones(2), with_bounds=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the streaming path: evaluate_dataset at cohort 1, its launches counted, then the
    # device loop alone (score + histogram per image, no read-back) and cohort 4
    for fn in wrappers.values():
        fn.launches = 0
    m1, s1, fb1 = _eval_timed(ev.evaluate_dataset, samples, cohort=1)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    passes = 2 if fb1 else 1  # a fall-back scores every image again on the exact path
    n_blocks = sum(cfg.swin.depths)
    expected = {"window_attention": n_blocks * EVAL_IMAGES * passes, "fused_rba_score": EVAL_IMAGES * passes,
                "masked_softmax": 0, "fused_mlp_residual": 0}
    log(f"eval: evaluate_dataset(cohort=1) {s1:.3f} s, {EVAL_IMAGES / s1:.2f} images/s, "
        f"{'fell back to the exact path (not certified)' if fb1 else 'certified streaming result'}; "
        f"metrics {m1}; launches {launches}")
    if launches != expected:
        raise RuntimeError(f"eval: launches {launches}, expected {expected}")
    stream = StreamingOODMetrics()

    def stream_all():
        for smp in samples:
            stream.update(ev.score_fn(smp.image[None])[0], smp.label.astype("uint8"))

    _, s_loop = _timed(stream_all)
    s_loop /= 1e3
    t0 = time.perf_counter()  # what evaluate_dataset does after its loop, on the host
    stream_certified = not stream.clipped and stream.certified()
    qerr = stream.quantization_error(stream.compute())
    s_cert = time.perf_counter() - t0
    log(f"eval: streaming device loop alone (upload, score, histogram update per image, no read-back): "
        f"{s_loop:.3f} s, {EVAL_IMAGES / s_loop:.2f} images/s; then clipped + certified() + compute() "
        f"{s_cert:.3f} s of host time; certified {stream_certified}, quantization error {qerr}")
    probe = StreamingOODMetrics()

    def one_step():
        probe.update(ev.score_fn(samples[1].image[None])[0], samples[1].label.astype("uint8"))

    step = _profile("eval: one streaming step (upload, score, histogram update)", one_step)
    step["host_syncs"] = _count_syncs(one_step)
    log(f"eval: host synchronisations in one streaming step (sync-debug warnings): {step['host_syncs']}")
    m4, s4, fb4 = _eval_timed(ev.evaluate_dataset, samples, cohort=4)
    log(f"eval: evaluate_dataset(cohort=4) {s4:.3f} s, {EVAL_IMAGES / s4:.2f} images/s, fell back {fb4}; "
        f"metrics {m4}")
    cohort = StreamingOODMetrics()
    fn = make_cohort_fn(cfg, model, "rba", False, cohort.bins, cohort.range, "linear")
    for i in range(0, EVAL_IMAGES, 4):
        packed = torch.stack([torch.cat([to_device(smp.image, "cuda"),
                                         to_device(smp.label.astype("uint8"), "cuda")[..., None]], -1)
                              for smp in samples[i:i + 4]])
        cohort.absorb(*fn(packed), packed.shape[0] * IMAGE_HW[0] * IMAGE_HW[1])
    same = bool(torch.equal(cohort.counts, stream.counts)) and float(cohort.smin) == float(stream.smin) \
        and float(cohort.smax) == float(stream.smax)
    log(f"eval: cohort-4 histograms equal to cohort 1's count for count: {same}; metrics equal: {m4 == m1}")
    if not (same and m4 == m1 and fb4 == fb1):
        raise RuntimeError("eval: cohort 4 differs from cohort 1")

    # the exact path: scores to the host, then numpy's all-pixel metrics
    (scores, gts), s_scores, _ = _eval_timed(ev.compute_anomaly_scores, samples)
    t0 = time.perf_counter()
    exact = ev.evaluate_ood(scores, gts)
    s_host = time.perf_counter() - t0
    log(f"eval: exact path: scoring with score maps to the host {s_scores:.3f} s ({EVAL_IMAGES / s_scores:.2f} "
        f"images/s); exact_ood_metrics on {scores.size} pixels {s_host:.3f} s of host time; metrics {exact}")
    if fb1 and exact != m1:
        raise RuntimeError(f"eval: the fall-back gave {m1}, the exact path {exact}")
    fresh = StreamingOODMetrics()
    for s, lab in zip(scores, gts):
        fresh.update(to_device(s, "cuda"), lab.astype("uint8"))
    bounds = fresh.compute()
    clipped, certified = fresh.clipped, fresh.certified()
    names = {"auroc": "AUROC", "aupr": "AUPRC", "fpr95": "FPR@95TPR"}
    inside = {k: bounds[f"{n}_lo"] - BOUND_SLACK <= exact[k] <= bounds[f"{n}_hi"] + BOUND_SLACK
              for k, n in names.items()}
    log(f"eval: certified bounds of histograms of the same score maps (clipped {clipped}, certified {certified}): "
        + ", ".join(f"{k} {bounds[f'{n}_lo']:.6f} <= {exact[k]:.6f} <= {bounds[f'{n}_hi']:.6f}"
                    for k, n in names.items()))
    if clipped or not all(inside.values()):
        raise RuntimeError(f"eval: exact metrics outside their certified bounds: {inside} (clipped {clipped})")

    # fp32: the metrics of the kernels' score maps against the plain versions'
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    fp32 = {}
    for plain in (False, True):
        ev32 = OODEvaluator(cfg32, model, score=lambda x: maskformer_infer_rba(model, cfg32, to_device(x, "cuda")))
        with _plain(plain):
            fp32["plain" if plain else "kernels"] = ev32.evaluate_ood(*ev32.compute_anomaly_scores(samples[:2]))
    fp32_diff = max(abs(fp32["kernels"][k] - fp32["plain"][k]) for k in names)
    log(f"eval: fp32 metrics on 2 images, kernels {fp32['kernels']} vs plain versions {fp32['plain']}: "
        f"max diff {fp32_diff:.3e} (bound {E2E_FP32_TOL:.0e})")
    if not fp32_diff <= E2E_FP32_TOL:
        raise RuntimeError(f"eval: fp32 metrics of kernels and plain versions differ by {fp32_diff}")

    # the histogram's device time on one real score map of this evaluation
    s_dev, lab_dev = to_device(scores[0], "cuda"), to_device(gts[0].astype("uint8"), "cuda")
    hist_ms = cuda_ms_batches(lambda: histogram_update(s_dev, lab_dev))
    timing = StreamingOODMetrics()
    upd_ms = cuda_ms_batches(lambda: timing.update(s_dev, lab_dev))
    upd_prof = _profile(f"eval: {HIST_REPS} histogram updates (StreamingOODMetrics.update)",
                        lambda: [timing.update(s_dev, lab_dev) for _ in range(HIST_REPS)])
    # update must queue device work only: it raises here if it synchronises with the host
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        timing.update(s_dev, gts[0].astype("uint8"))  # labels from the host, through pinned memory
    finally:
        torch.cuda.set_sync_debug_mode(0)
    nbytes = s_dev.numel() * 5  # each score and label read once; the counts are the atomics' cost
    share = upd_ms[0] / busy_ms if busy_ms else None
    log(f"eval: histogram_update per image {_fmt(hist_ms)} ms (3 batches; zero-filled 2x2^22 int64 included), "
        f"StreamingOODMetrics.update per image {_fmt(upd_ms)} ms (the evaluation's own step), "
        f"bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; no host synchronisation in update (checked); "
        "share of a path-1 request's device busy time "
        + (f"{share:.3f}" if share is not None else "not measured"))

    # the energy score: unbounded, binned in asinh space
    m_e, s_e, fb_e = _eval_timed(OODEvaluator(cfg, model, score="energy").evaluate_dataset, samples[:2])
    log(f"eval: energy score on 2 images through asinh histograms: {m_e}, "
        f"{'fell back to the exact path' if fb_e else 'certified'}, {s_e:.3f} s")
    if not all(math.isfinite(v) for v in m_e.values()):
        raise RuntimeError(f"eval: energy metrics not finite: {m_e}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"eval: peak device memory of the phase {peak_gib:.2f} GiB")
    out.update(cohort1=dict(metrics=m1, s=s1, images_per_s=EVAL_IMAGES / s1, fell_back=fb1, launches=launches),
               streaming_loop=dict(s=s_loop, images_per_s=EVAL_IMAGES / s_loop, certified=stream_certified,
                                   quantization_error=qerr, certify_host_s=s_cert, profile_one_step=step),
               cohort4=dict(metrics=m4, s=s4, images_per_s=EVAL_IMAGES / s4, fell_back=fb4, histograms_equal=same),
               exact=dict(metrics=exact, scoring_s=s_scores, host_metrics_s=s_host, pixels=int(scores.size)),
               bounds=dict(bounds, clipped=clipped, certified=certified),
               fp32=dict(fp32, max_diff=fp32_diff, bound=E2E_FP32_TOL),
               histogram=dict(histogram_update_ms=hist_ms, update_ms=upd_ms, update_profile=upd_prof,
                              update_profile_reps=HIST_REPS, bytes_bound_ms=nbytes / HBM_BYTES_PER_S
                              * 1e3, share_of_busy=share),
               energy=dict(metrics=m_e, s=s_e, fell_back=fb_e), peak_gib=peak_gib)
    return out


# ---------------------------------------------------------------------------
# fast_serving and the "xla" branch on path 1's model
# ---------------------------------------------------------------------------

def fast_phase(cfg, model, images):
    """The fast serve cell: ``fast_serving(cfg)`` through path 1, counted (Kernel A in
    every block, Kernel B once per request, no Kernel C or D), against the plain
    versions on the same weights, and one request profiled: busy time, idle share, top
    kernels, and the one-hot sampling's kernels and share of the pixel decoder's busy
    time.  Gates: finite (1, 1024, 2048) maps, the launch counts, the fp32 requests
    against the plain versions (as on paths 1 and 2), and the redesigned kernels with
    none they superseded."""
    from rba_tpu_torch.config import fast_serving

    fcfg = fast_serving(cfg)
    per_image = {"window_attention": sum(cfg.swin.depths), "fused_rba_score": 1}
    serve, _, _ = serve_phase("fast", fcfg, model, images, "fused", per_image)
    prof = profile_phase("fast", fcfg, model, images[1], "fused",
                         {"window_attention_mma_kernel": "window_attention_kernel",
                          "fused_rba_mma_kernel": "fused_rba_kernel"})
    return dict(serve=serve, profile=prof)


def xla_phase(cfg, model, images):
    """rba_tpu's default window attention (``attention="xla"``, plain PyTorch, Kernel B
    only) at parity and at ``fast_serving``: ms/image (median of N_REQUESTS requests),
    launches, and one request profiled, beside path 1.  Reported, not gated, apart from
    the kernels the profile must show (Kernel B, and no Kernel A)."""
    from rba_tpu_torch.config import fast_serving
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    wrappers = _wrappers()
    out = {}
    for name, c in (("parity", cfg), ("fast", fast_serving(cfg))):
        infer = functools.partial(maskformer_infer_rba, model, c, attention="xla")
        infer(images[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        times, finite = [], True
        for i in range(1, N_REQUESTS + 1):
            rba, ms = _timed(infer, images[i])
            times.append(ms)
            finite = finite and tuple(rba.shape) == (1, *IMAGE_HW) and bool(torch.isfinite(rba).all())
        launches = {k: fn.launches for k, fn in wrappers.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"xla_{name} (attention='xla') served {N_REQUESTS} requests: launches {launches}; ms/image "
            f"{statistics.median(times):.2f} (median; all {[round(t, 2) for t in times]}), finite (1, 1024, 2048) "
            f"maps {finite}, peak memory {peak_gib:.2f} GiB")
        prof = profile_phase(f"xla_{name}", c, model, images[1], "xla",
                             {"fused_rba_mma_kernel": "window_attention"})
        out[name] = dict(launches=launches, ms_per_image=statistics.median(times), ms_all=times, finite=finite,
                         peak_gib=peak_gib, profile=prof)
    return out


def fast_eval_phase(cfg, model, samples):
    """``OODEvaluator(fast_serving(cfg), model).evaluate_dataset`` at cohort 1 over the
    eval phase's scenes: images/s, whether it certified, and its launches (gated)."""
    from rba_tpu_torch.config import fast_serving
    from rba_tpu_torch.evalx.evaluator import OODEvaluator

    ev = OODEvaluator(fast_serving(cfg), model)
    ev.score_fn(samples[0].image[None])  # warm-up
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    m, s, fell_back = _eval_timed(ev.evaluate_dataset, samples, cohort=1)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    passes = 2 if fell_back else 1  # a fall-back scores every image again on the exact path
    expected = {"window_attention": sum(cfg.swin.depths) * EVAL_IMAGES * passes,
                "fused_rba_score": EVAL_IMAGES * passes, "masked_softmax": 0, "fused_mlp_residual": 0}
    log(f"eval fast_serving: evaluate_dataset(cohort=1) {s:.3f} s, {EVAL_IMAGES / s:.2f} images/s, "
        f"{'fell back to the exact path (not certified)' if fell_back else 'certified streaming result'}; "
        f"metrics {m}; launches {launches}")
    if launches != expected:
        raise RuntimeError(f"eval fast_serving: launches {launches}, expected {expected}")
    if not all(math.isfinite(v) for v in m.values()):
        raise RuntimeError(f"eval fast_serving: metrics not finite: {m}")
    return dict(metrics=m, s=s, images_per_s=EVAL_IMAGES / s, fell_back=fell_back, launches=launches)


# ---------------------------------------------------------------------------
# Released checkpoints and the serving variants: the Detectron2 loader, test-time
# augmentation, sliding window, DenseHybrid and the sweep CLI, at Swin-B width
# ---------------------------------------------------------------------------

D2_CONFIG = Path("configs/cityscapes/swin_b_1dl.yaml")  # the Detectron2 YAML of swin_b_1dl
SCRATCH = Path("build/chip_smoke")  # gitignored: the checkpoint, the sweep's zoo and its results
def write_d2_checkpoint(cfg, path: Path, seed: int = 0) -> dict:
    """Write ``tests/d2_synthetic.py``'s seeded Detectron2 state dict of ``cfg``'s model
    (every parameter under its released name, the buffers that the conversion drops, and
    the pre-rename names ``static_query`` and a bare ``sem_seg_head.mask_features``) as a
    ``model_final.pth``.  Returns the dict, numpy arrays."""
    from tests.d2_synthetic import d2_state_dict

    sd = d2_state_dict(cfg, seed)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 89999}, path)
    return sd


@contextlib.contextmanager
def window_attention_shapes():
    """Record the (windows, heads, head dim, masked) of every Kernel A launch that Swin
    makes inside the block: its calls go through a recorder, and the wrapper itself, with
    its launch count, is the same."""
    from rba_tpu_torch.models import swin

    real, seen = swin.window_attention, set()

    def recorded(qkv, rel_bias, mask, nh, scale):
        if qkv.is_cuda:
            seen.add((qkv.shape[0], nh, qkv.shape[-1] // (3 * nh), mask is not None))
        return real(qkv, rel_bias, mask, nh, scale)

    swin.window_attention = recorded
    try:
        yield seen
    finally:
        swin.window_attention = real


def _zero_counts(lsap: bool = False, deform: bool = False):
    wrappers = _wrappers(lsap, deform)
    for fn in wrappers.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in wrappers.items()}


def d2_phase(image):
    """``load_checkpoint_params`` on a directory that holds the Detectron2 ``config.yaml``
    of swin_b_1dl and a seeded full-width ``model_final.pth``: converted onto the card,
    every parameter equal bit for bit to the same dict converted on the CPU (which the CPU
    tests hold leaf for leaf against rba_tpu's conversion), the ``params.npz`` cache
    written, and a second load from the cache equal to the first; both load times; one
    path-1 request from each model, finite and equal."""
    from rba_tpu_torch.config import load_d2_config, swin_b_1dl
    from rba_tpu_torch.convert import jax_params_to_state, load_checkpoint_params
    from rba_tpu_torch.convert.d2_mapping import convert_d2_state_dict
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    cfg = load_d2_config(str(D2_CONFIG))
    # the loader also keeps the raw MASK_FORMER.DEC_LAYERS and TRANSFORMER_IN_FEATURE, which
    # only the v1 decoder reads; every other field must be the preset's
    preset = swin_b_1dl()
    raw = dict(dec_layers_total=cfg.decoder.dec_layers_total, transformer_in_feature=cfg.decoder.transformer_in_feature)
    if cfg != dataclasses.replace(preset, decoder=dataclasses.replace(preset.decoder, **raw)):
        raise RuntimeError(f"d2: {D2_CONFIG} does not load as swin_b_1dl(): {cfg}")
    model_dir = SCRATCH / "d2" / "swin_b_1dl"
    shutil.rmtree(model_dir, ignore_errors=True)
    model_dir.mkdir(parents=True)
    shutil.copy(D2_CONFIG, model_dir / "config.yaml")
    t0 = time.perf_counter()
    sd = write_d2_checkpoint(cfg, model_dir / "model_final.pth")
    write_s = time.perf_counter() - t0
    want = {k: torch.from_numpy(v) for k, v in jax_params_to_state(convert_d2_state_dict(sd, cfg)).items()}
    mb = (model_dir / "model_final.pth").stat().st_size / 2**20
    t0 = time.perf_counter()
    converted = load_checkpoint_params(str(model_dir), cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not (model_dir / "params.npz").exists():
        raise RuntimeError("d2: the params.npz cache was not written")
    t0 = time.perf_counter()
    cached = load_checkpoint_params(str(model_dir), cfg)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    params = dict(converted.named_parameters())
    wrong = [n for n, p in params.items() if not (p.is_cuda and torch.equal(p.detach().cpu(), want[n]))]
    differ = [n for n, q in cached.named_parameters() if not torch.equal(params[n], q)]
    log(f"d2: model_final.pth of {len(sd)} arrays, {len(want)} parameters "
        f"({sum(v.numel() for v in want.values()) / 1e6:.2f} M, {mb:.1f} MiB) written in {write_s:.2f} s; "
        f"load_checkpoint_params converting it onto the card {load_s:.2f} s (params.npz cache written), from the "
        f"cache {cache_s:.2f} s; parameters not equal to the CPU conversion: {len(wrong)}; cache-loaded "
        f"parameters not equal: {len(differ)}")
    if wrong or differ or sorted(params) != sorted(want):
        raise RuntimeError(f"d2: parameters differ: {wrong[:5]} {differ[:5]}")
    maskformer_infer_rba(converted, cfg, image)  # warm-up
    counts = _zero_counts()
    rba, ms = _timed(maskformer_infer_rba, converted, cfg, image)
    launches = counts()
    rba_cached = maskformer_infer_rba(cached, cfg, image)
    finite = bool(torch.isfinite(rba).all())
    same = bool(torch.equal(rba, rba_cached))
    log(f"d2: one path-1 request from the converted model {ms:.2f} ms, launches {launches}, finite {finite}; "
        f"equal to the cache-loaded model's: {same} (max diff {max_abs(rba, rba_cached):.3e})")
    if not (finite and same and tuple(rba.shape) == (1, *IMAGE_HW)):
        raise RuntimeError("d2: the request is not finite or differs between the two loads")
    return dict(parameters=len(want), mib=mb, write_s=write_s, load_convert_s=load_s, load_cache_s=cache_s,
                request_ms=ms, launches=launches), model_dir / "model_final.pth"


def _sampling_form(cfg, hh: int, ww: int):
    """(form, one-hot row-matrix elements) of the deformable sampling on the res5 level of
    an hh×ww input: the "auto" dispatch of ``ops/deform_sampling.py``."""
    from rba_tpu_torch.ops.deform_sampling import sampling_methods

    pd, div = cfg.pixel_decoder, cfg.input.size_divisibility
    h5, w5 = -(-hh // div) * div // 32, -(-ww // div) * div // 32
    (method,) = sampling_methods(1, pd.transformer_nheads, h5 * w5, [(h5, w5)], pd.sampling_method,
                                 pd.sampling_onehot_cap)
    form = "onehot" if method == "onehot" and pd.sampling_dtype == "bfloat16" else "gather"
    return form, pd.transformer_nheads * (h5 * w5) ** 2


def tta_phase(cfg, model, image):
    """``tta_inference`` on one 1024x2048 frame with the config's TEST.AUG defaults (6
    sizes x flip) at ``fast_serving`` (the sweep's default) and at parity: ms/image, busy
    time and idle share of one profiled frame, peak memory, each scale's sampling form,
    launches (gated: Kernel A in every block of every variant, no Kernel B); then at an
    fp32 backbone the kernels against their plain versions on the averaged sem_seg and
    its RbA score (gated at E2E_FP32_TOL)."""
    from rba_tpu_torch.config import fast_serving
    from rba_tpu_torch.models.maskformer import rba_score
    from rba_tpu_torch.models.tta import tta_inference, tta_variants

    img = image[0]
    variants = tta_variants(cfg, *IMAGE_HW)
    n_blocks = sum(cfg.swin.depths)
    expected = {"window_attention": n_blocks * len(variants), "fused_rba_score": 0, "masked_softmax": 0,
                "fused_mlp_residual": 0}
    out = dict(variants=[list(v) for v in variants])
    for name, c in (("fast", fast_serving(cfg)), ("parity", cfg)):
        forms = {f"{hh}x{ww}": _sampling_form(c, hh, ww) for hh, ww, flipped in variants if not flipped}
        tta_inference(model, c, img)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = _zero_counts()
        sem, ms = _timed(tta_inference, model, c, img)
        launches = counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        prof = _profile(f"tta {name} (one frame, {len(variants)} variants)", lambda: tta_inference(model, c, img))
        finite = tuple(sem.shape) == (cfg.num_classes, *IMAGE_HW) and bool(torch.isfinite(sem).all())
        log(f"tta {name}: {ms:.2f} ms/image ({len(variants)} variants), launches {launches}, finite {finite}, "
            f"peak memory {peak_gib:.2f} GiB; sampling per scale (form, one-hot row-matrix elements): {forms}")
        if launches != expected or not finite:
            raise RuntimeError(f"tta {name}: launches {launches} (expected {expected}), finite {finite}")
        out[name] = dict(ms_per_image=ms, launches=launches, peak_gib=peak_gib, sampling=forms, profile=prof)
    fcfg = fast_serving(cfg)
    k16 = tta_inference(model, fcfg, img)
    with _plain():
        err16 = max_abs(k16, tta_inference(model, fcfg, img))
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    counts = _zero_counts()
    k = tta_inference(model, c32, img)
    launches32 = counts()
    with _plain():
        p = tta_inference(model, c32, img)
    err_sem, err_rba = max_abs(k, p), max_abs(rba_score(k[None]), rba_score(p[None]))
    log(f"tta fp32 backbone, kernels ({launches32['window_attention']} Kernel A launches) vs plain versions: "
        f"sem_seg max diff {err_sem:.3e}, rba_score {err_rba:.3e} (bound {E2E_FP32_TOL:.0e}, gated); at "
        f"fast_serving's bf16 backbone the sem_seg differs by {err16:.3e} (reported, not gated)")
    if not max(err_sem, err_rba) <= E2E_FP32_TOL or launches32 != expected:
        raise RuntimeError(f"tta: fp32 kernels and plain versions differ by {err_sem}, {err_rba}; "
                           f"launches {launches32}")
    out.update(fp32_sem_seg_max_diff=err_sem, fp32_rba_max_diff=err_rba, bf16_sem_seg_max_diff_not_gated=err16)
    return out


def sliding_phase(cfg, model, image, gen):
    """``sliding_window_sem_seg`` with 1024x1024 tiles and overlap 256 at ``fast_serving``:
    a 1024x2048 frame (3 tiles; launches gated; at an fp32 backbone the kernels against
    their plain versions, gated at E2E_FP32_TOL) and one 3072x4096 frame (20 tiles),
    timed."""
    from rba_tpu_torch.config import fast_serving
    from rba_tpu_torch.models.sliding_window import sliding_window_sem_seg, tile_grid

    fcfg = fast_serving(cfg)
    n_blocks = sum(cfg.swin.depths)
    big = torch.randint(0, 256, (*BIG_FRAME_HW, 3), generator=gen, device="cuda", dtype=torch.uint8)
    out = {}
    for name, frame in (("1024x2048", image[0]), ("3072x4096", big)):
        _, _, _, ys, xs = tile_grid(*frame.shape[:2])
        sliding_window_sem_seg(model, fcfg, frame)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = _zero_counts()
        sem, ms = _timed(sliding_window_sem_seg, model, fcfg, frame)
        launches = counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        tiles = len(ys) * len(xs)
        finite = tuple(sem.shape) == (cfg.num_classes, *frame.shape[:2]) and bool(torch.isfinite(sem).all())
        log(f"sliding {name}: {tiles} tiles at rows {ys}, columns {xs}; {ms:.2f} ms/image, launches {launches}, "
            f"finite {finite}, peak memory {peak_gib:.2f} GiB")
        if launches["window_attention"] != n_blocks * tiles or launches["fused_rba_score"] or not finite:
            raise RuntimeError(f"sliding {name}: launches {launches} for {tiles} tiles, finite {finite}")
        out[name] = dict(tiles=tiles, rows=ys, columns=xs, ms_per_image=ms, launches=launches, peak_gib=peak_gib)
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    counts = _zero_counts()
    k = sliding_window_sem_seg(model, c32, image[0])
    launches32 = counts()["window_attention"]
    with _plain():
        err = max_abs(k, sliding_window_sem_seg(model, c32, image[0]))
    log(f"sliding 1024x2048 fp32 backbone, kernels ({launches32} Kernel A launches) vs plain versions: sem_seg max "
        f"diff {err:.3e} (bound {E2E_FP32_TOL:.0e}, gated)")
    if not err <= E2E_FP32_TOL or launches32 != out["1024x2048"]["launches"]["window_attention"]:
        raise RuntimeError(f"sliding: fp32 kernels and plain versions differ by {err}; {launches32} launches")
    out["fp32_sem_seg_max_diff"] = err
    return out


def dense_hybrid_phase(image):
    """One ``OODEvaluator(score="dense_hybrid")`` request on ``fast_serving(swin_b_1dl())``
    with the DenseHybrid head: finite, launches counted; at an fp32 backbone the score
    through the kernels against its formula on the plain versions (gated at
    E2E_FP32_TOL)."""
    from rba_tpu_torch.config import fast_serving, swin_b_1dl
    from rba_tpu_torch.evalx.evaluator import OODEvaluator
    from rba_tpu_torch.models.maskformer import build_model, maskformer_infer

    base = swin_b_1dl()
    cfg = fast_serving(dataclasses.replace(base, decoder=dataclasses.replace(base.decoder, ood_prediction=True)))
    model = build_model(cfg, seed=1)
    ev = OODEvaluator(cfg, model, score="dense_hybrid")
    ev.score_fn(image)  # warm-up
    counts = _zero_counts()
    s, ms = _timed(ev.score_fn, image)
    launches = counts()
    finite = tuple(s.shape) == (1, *IMAGE_HW) and bool(torch.isfinite(s).all())
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    counts = _zero_counts()
    k = OODEvaluator(c32, model, score="dense_hybrid").score_fn(image)
    launches32 = counts()
    with _plain():
        o = maskformer_infer(model, c32, image.float())
    p = -torch.logsumexp(o["sem_seg"], 1) + torch.log(torch.softmax(o["ood_pred"], 1)[:, 1] + 1e-9)
    err = max_abs(k, p)
    log(f"dense_hybrid: one request {ms:.2f} ms, launches {launches}, finite {finite}, scores "
        f"[{float(s.min()):.4f}, {float(s.max()):.4f}]; fp32 backbone, kernels vs plain versions: max diff {err:.3e} "
        f"(bound {E2E_FP32_TOL:.0e}, gated)")
    expected = {"window_attention": sum(cfg.swin.depths), "fused_rba_score": 0, "masked_softmax": 0,
                "fused_mlp_residual": 0}
    if not finite or launches != expected or launches32 != expected or not err <= E2E_FP32_TOL:
        raise RuntimeError(f"dense_hybrid: finite {finite}, launches {launches} and {launches32} at fp32 "
                           f"(expected {expected}), diff {err}")
    return dict(ms=ms, launches=launches, fp32_max_diff=err)


def sweep_cli_phase(pth: Path):
    """``rba_tpu_torch.evalx.sweep.main`` on the card over a zoo that holds only the
    Detectron2 ``config.yaml`` and the seeded ``model_final.pth``, on the synthetic
    dataset, three times: plain, ``--tta`` and ``--sliding-window``.  Gates: each writes
    finite AUPRC, AUROC and FPR95, and the first leaves ``params.npz`` behind."""
    from rba_tpu_torch.evalx import sweep

    zoo = SCRATCH / "zoo"
    shutil.rmtree(zoo, ignore_errors=True)
    shutil.rmtree(SCRATCH / "sweep_out", ignore_errors=True)
    (zoo / "swin_b_1dl").mkdir(parents=True)
    shutil.copy(D2_CONFIG, zoo / "swin_b_1dl" / "config.yaml")
    os.link(pth, zoo / "swin_b_1dl" / "model_final.pth")
    out = {}
    for name, flags in (("plain", []), ("tta", ["--tta"]), ("sliding", ["--sliding-window"])):
        res_dir = SCRATCH / "sweep_out" / name
        counts = _zero_counts()
        _, ms = _timed(sweep.main, ["--models_folder", str(zoo), "--datasets_folder", str(SCRATCH / "no_datasets"),
                                    "--dataset_mode", "synthetic", "--out_path", str(res_dir), *flags])
        launches = counts()
        metrics = json.loads((res_dir / "swin_b_1dl" / "results.json").read_text())["synthetic"]
        cached = (zoo / "swin_b_1dl" / "params.npz").exists()
        log(f"sweep_cli {name}: {ms / 1e3:.2f} s, results {metrics}, launches {launches}, params.npz cached {cached}")
        if sorted(metrics) != ["aupr", "auroc", "fpr95"] or not all(math.isfinite(v) for v in metrics.values()) \
                or not cached:
            raise RuntimeError(f"sweep_cli {name}: results {metrics}, params.npz cached {cached}")
        out[name] = dict(s=ms / 1e3, metrics=metrics, launches=launches)
    return out


# ---------------------------------------------------------------------------
# Training: Kernel E (the matcher's exact assignment) and RbA's outlier-exposure
# fine-tune of swin_b_1dl through the trainer CLI
# ---------------------------------------------------------------------------

OOD_CONFIG = Path("configs/cityscapes/swin_b_1dl_ood_coco.yaml")  # RbA's COCO outlier-exposure fine-tune
TRAIN_FRAMES = 16  # synthetic 1024x2048 Cityscapes frames
TRAIN_BATCH = 8  # the config's SOLVER.IMS_PER_BATCH, the global batch of a step
TRAIN_WARMUP, TRAIN_TIMED = 2, 8  # steps
TRAIN_SEED = 3  # fixes the mapper's draws; printed with the pasted-object count
# Latency floor of one step of Kernel E's path loop, from the code: the dependent chain
# of one L2 hit (the cost row, ~260 cycles) and 7 warp shuffles (the 5-level argmin and
# the 2 broadcasts, ~26 cycles each), at the card's maximum SM clock.
LSAP_STEP_CYCLES = 260 + 7 * 26


def _lsap_costs(gen, b, r, c, kind, padded_rows=0):
    if kind == "int":
        cost = torch.randint(0, 4, (b, r, c), generator=gen, device="cuda").float()
    else:
        cost = torch.rand(b, r, c, generator=gen, device="cuda") * 10
    if padded_rows:
        cost[:, r - padded_rows:] = 1e6  # the matcher's padded targets
    return cost.contiguous()


def _scipy_lsap(cost: torch.Tensor):
    """scipy on the host over the same costs, the device-to-host copy and sync included:
    (col4row as int32, seconds)."""
    from scipy.optimize import linear_sum_assignment

    t0 = time.perf_counter()
    host = cost.cpu().numpy()
    out = np.stack([linear_sum_assignment(m)[1] for m in host]).astype(np.int32)
    return out, time.perf_counter() - t0


def _lsap_totals(cost_np, cols):
    rows = np.arange(cost_np.shape[1])
    return [float(m[rows, c].astype(np.float64).sum()) for m, c in zip(cost_np, cols)]


def lsap_check(name, cost, got=None):
    """Kernel E on ``cost`` (or its given result) against the plain version (int equality)
    and scipy (equal total cost); the plain version's time (on the host, copy included),
    scipy's, the steps of the paths, and the bounds."""
    from rba_tpu_torch.kernels.lsap import batched_linear_sum_assignment
    from rba_tpu_torch.ops import lsap as plain_lsap

    if got is None:
        got = batched_linear_sum_assignment(cost)
    torch.cuda.synchronize()
    host = cost.cpu().numpy()
    steps = []
    t0 = time.perf_counter()
    want = []
    for m in cost.cpu():
        plain_lsap.linear_sum_assignment.steps = 0
        want.append(plain_lsap.linear_sum_assignment(m))
        steps.append(plain_lsap.linear_sum_assignment.steps)
    plain_ms = (time.perf_counter() - t0) * 1e3
    want = torch.stack(want)
    sp, scipy_s = _scipy_lsap(cost)
    equal = bool(torch.equal(got.cpu(), want))
    optimal = _lsap_totals(host, got.cpu().numpy()) == _lsap_totals(host, sp)
    b, r, c = cost.shape
    nbytes = cost.numel() * 4 + got.numel() * 4
    flops = 4.0 * c * sum(steps)  # per column scan: the reduced cost (3 adds) and its compare
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    latency_ms = max(steps) * LSAP_STEP_CYCLES / (clock_mhz * 1e3)
    row = dict(shape=[b, r, c], equal=equal, optimal=optimal, max_abs_err=float((got.cpu() - want).abs().max()),
               plain_ms=plain_ms, scipy_ms=scipy_s * 1e3, steps_max=max(steps), steps_total=sum(steps),
               bound_ms=b_ms, bound_by=b_by, latency_bound_ms=latency_ms)
    if not (equal and optimal):
        raise RuntimeError(f"lsap {name}: Kernel E equal to the plain version {equal}, total cost equal to "
                           f"scipy's {optimal}: {row}")
    return row


def lsap_phase(gen):
    """Kernel E at the matcher's shape B x 32 x 100 (B = 1, 8, 16), at R = C = 100, on
    integer costs with ties and with padded rows: equal to the plain version and optimal
    as scipy's; ms per launch beside its bounds and scipy's host time."""
    from rba_tpu_torch.kernels.lsap import batched_linear_sum_assignment

    rows = {}
    for name, (b, r, c, kind, pad) in {
        "B1x32x100": (1, 32, 100, "rand", 14), "B8x32x100": (8, 32, 100, "rand", 14),
        "B16x32x100": (16, 32, 100, "rand", 14), "B4x100x100": (4, 100, 100, "rand", 0),
        "B8x32x100_int_ties": (8, 32, 100, "int", 0), "B8x32x100_no_padding": (8, 32, 100, "rand", 0),
    }.items():
        cost = _lsap_costs(gen, b, r, c, kind, pad)
        row = lsap_check(name, cost)
        row["ms"] = cuda_ms(lambda: batched_linear_sum_assignment(cost))
        rows[name] = row
        log(f"lsap {name} ({kind}, {pad} padded rows): equal to the plain version and optimal as scipy's | kernel "
            f"{row['ms']:.4f} ms per launch, plain version {row['plain_ms']:.2f} ms (host), scipy with the copy "
            f"{row['scipy_ms']:.3f} ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']}), latency bound "
            f"{row['latency_bound_ms']:.4f} ms ({row['steps_max']} serial steps of the longest matrix)")
    return rows


# ---------------------------------------------------------------------------
# Kernel F: the deformable sampling's gather at the encoder shapes of a 1024x2048 frame
# ---------------------------------------------------------------------------

SAMPLING_LEVELS = {"r50": [(128, 256), (64, 128), (32, 64)], "swin_b": [(32, 64)]}  # (H, W) per level
SAMPLING_CASES = (("r50", 1), ("swin_b", 1), ("swin_b", 4))  # the benchmark's camera cells and rig4


def _device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) of one call of ``fn``, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(calls for _, _, calls in _device_kernels(prof))


L1_BYTES_PER_CLOCK = 128  # an SM's L1 load path per clock


def _l1_rate() -> float:
    """Bytes/s of all SMs' L1 load paths at the card's maximum SM clock: the rate through
    which every gathered row passes, whether L1 or L2 served it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * L1_BYTES_PER_CLOCK * float(_smi("clocks.max.sm").split()[0]) * 1e6


def ms_deform_attn_phase(gen):
    """Kernel F against the plain gather at the deformable encoder's shapes of a
    1024x2048 frame (Lq = S, M = 8, D = 32, P = 4): R50's three levels and Swin-B's one,
    at batch 1 and at rig4's batch 4.  Locations over [-0.1, 1.1] (zero padding);
    max |kernel - plain| within 1e-5 of max |plain|; the kernel's ms per call beside the
    plain gather's, the bound (each input byte read and the output written once, at
    3.35 TB/s) and the gather floor (four D-float rows per sample through the SMs' L1 load
    paths, ``_l1_rate``); the device operations of one call of each."""
    from rba_tpu_torch.kernels.ms_deform_attn import ms_deform_attn
    from rba_tpu_torch.ops.deform_sampling import ms_deform_attn_core, ms_deform_attn_plain

    l1_rate = _l1_rate()
    rows = {"l1_bytes_per_s": l1_rate}
    m, d, p = 8, 32, 4
    for cfg_name, n in SAMPLING_CASES:
        levels = SAMPLING_LEVELS[cfg_name]
        s, nl = sum(h * w for h, w in levels), len(levels)
        value = torch.randn(n, s, m, d, generator=gen, device="cuda")
        loc = torch.rand(n, s, m, nl, p, 2, generator=gen, device="cuda") * 1.2 - 0.1
        attn = torch.softmax(torch.randn(n, s, m, nl * p, generator=gen, device="cuda"), -1).reshape(n, s, m, nl, p)
        with torch.no_grad():
            before = ms_deform_attn.launches
            got = ms_deform_attn_core(value, levels, loc, attn)
            torch.cuda.synchronize()
            launched = ms_deform_attn.launches - before
            want = ms_deform_attn_plain(value, levels, loc, attn)
            rel = max_abs(got, want) / float(want.abs().max())
            t_all = cuda_ms_batches(lambda: ms_deform_attn_core(value, levels, loc, attn))
            t_p = cuda_ms(lambda: ms_deform_attn_plain(value, levels, loc, attn), iters=5)
            kernel_ops = _device_ops(lambda: ms_deform_attn_core(value, levels, loc, attn))
        # the plain path as ms_deform_attn_core runs it where the kernel does not (here: under autograd)
        xs = [x.detach().requires_grad_() for x in (value, loc, attn)]
        plain_ops = _device_ops(lambda: ms_deform_attn_core(xs[0], levels, xs[1], xs[2]))
        samples = n * s * m * nl * p
        nbytes = (value.numel() + loc.numel() + attn.numel() + got.numel()) * 4
        b_ms, b_by = bound_ms(nbytes, 2.0 * 4 * samples * d, "float32")
        gather_bytes = 4.0 * samples * d * 4
        floor_ms = gather_bytes / l1_rate * 1e3
        name = f"{cfg_name}_B{n}"
        rows[name] = row = dict(
            levels=levels, n=n, lq=s, launches=launched, max_rel_err=rel, tol=1e-5, ms=t_all[0], ms_batches=t_all,
            plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, gather_bytes=gather_bytes,
            gather_floor_ms=floor_ms, gather_bytes_per_s=gather_bytes / (t_all[0] * 1e-3), kernel_device_ops=kernel_ops,
            plain_device_ops=plain_ops)
        log(f"ms_deform_attn {name} (levels {levels}, Lq = S = {s}): rel err {rel:.3e} (tol 1e-5), launches "
            f"{launched} | kernel {t_all[0]:.4f} ms (3 batches {_fmt(t_all)}), plain gather {t_p:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), gather floor {floor_ms:.4f} ms ({gather_bytes / 1e9:.3f} GB through L1 at "
            f"{l1_rate / 1e12:.1f} TB/s; the kernel gathers at {row['gather_bytes_per_s'] / 1e12:.2f} TB/s); device "
            f"operations per call: kernel {kernel_ops}, plain {plain_ops}")
        if not (rel <= 1e-5 and launched == 1 and kernel_ops == 1):
            raise RuntimeError(f"ms_deform_attn {name}: {row}")
        del value, loc, attn, got, want, xs
    return rows


# (heads, N, M, blocks) of MiT-B5's four stages on a 1024x2048 frame: 52 attention cores
MIT_B5_STAGES = ((1, 131072, 2048, 3), (2, 32768, 2048, 6), (5, 8192, 2048, 40), (8, 2048, 2048, 3))
SR_BIT_EQUAL_SHARE = 0.99  # least share of Kernel G's outputs bit-equal to the plain chain's
SR_MAX_ULPS = 2.0  # most |kernel - plain|, in bf16 ulps of the plain output row's largest |value|


def sr_attention_gap(got: torch.Tensor, want: torch.Tensor):
    """(share of the elements of ``got`` bit-equal to ``want``, largest |got - want| in
    bf16 ulps of the largest |want| of its row): Kernel G's measure against its plain
    chain, whose fp32 sums it takes in another order."""
    got, want = got.float(), want.float()
    row_max = want.abs().amax(-1, keepdim=True).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    return float((got == want).float().mean()), float(((got - want).abs() / ulp).max())


def sr_attention_phase(gen):
    """Kernel G against ``sr_attention_plain`` at MiT-B5's four stage shapes of a
    1024x2048 frame (head dim 64, M = 2,048 keys): at least ``SR_BIT_EQUAL_SHARE`` of the
    outputs bit-equal and none beyond ``SR_MAX_ULPS`` of its row's largest value; per
    call and per image (each stage's time times its blocks, 52 launches) the kernel's ms
    beside the bound (q·kᵀ and p·v at 989 TFLOP/s, or q, k, v and the output once at
    3.35 TB/s, the larger), the plain chain's and ``scaled_dot_product_attention``'s (the
    yardstick ``library_ms``; the port never calls it)."""
    from rba_tpu_torch.kernels.sr_attention import sr_attention
    from rba_tpu_torch.models.mix_transformer import sr_attention_plain

    hd = 64
    rows = {}
    image = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, launches=0)
    for heads, n, m, blocks in MIT_B5_STAGES:
        c = heads * hd
        q = torch.randn(1, n, c, generator=gen, device="cuda").bfloat16()
        kv = torch.randn(1, m, 2 * c, generator=gen, device="cuda").bfloat16()
        qh = q.view(1, n, heads, hd).transpose(1, 2)
        k, v = kv.view(1, m, 2, heads, hd).permute(2, 0, 3, 1, 4)
        with torch.no_grad():
            before = sr_attention.launches
            got = sr_attention(q, kv, heads)
            torch.cuda.synchronize()
            launched = sr_attention.launches - before
            want = sr_attention_plain(q, kv, heads)
            share, ulps = sr_attention_gap(got, want)
            finite = bool(torch.isfinite(got.float()).all())
            t_all = cuda_ms_batches(lambda: sr_attention(q, kv, heads))
            t_p = cuda_ms(lambda: sr_attention_plain(q, kv, heads), iters=5)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(qh, k, v), iters=5)
        b_ms, b_by = bound_ms(2.0 * (2 * n * c + 2 * m * c), 4.0 * n * m * c, "bfloat16")
        name = f"h{heads}_N{n}_M{m}"
        rows[name] = dict(heads=heads, n=n, m=m, head_dim=hd, blocks=blocks, launches=launched,
                          bit_equal_share=share, max_ulps=ulps, ms=t_all[0], ms_batches=t_all, plain_ms=t_p,
                          library_ms=t_l, bound_ms=b_ms, bound_by=b_by, roofline=b_ms / t_all[0])
        for key, t in (("ms", t_all[0]), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms)):
            image[key] += blocks * t
        image["launches"] += blocks * launched
        log(f"sr_attention {name} (x{blocks} blocks): bit-equal {share:.5f} (least {SR_BIT_EQUAL_SHARE}), worst "
            f"{ulps:.2f} ulps of the row's largest (most {SR_MAX_ULPS}), launches {launched} | kernel "
            f"{t_all[0]:.4f} ms (3 batches {_fmt(t_all)}), bound {b_ms:.4f} ms ({b_by}; "
            f"{100 * b_ms / t_all[0]:.1f} %), plain {t_p:.4f} ms, SDPA {t_l:.4f} ms")
        if not (share >= SR_BIT_EQUAL_SHARE and ulps <= SR_MAX_ULPS and launched == 1 and finite):
            raise RuntimeError(f"sr_attention {name}: {rows[name]}, finite {finite}")
        del q, kv, qh, k, v, got, want
    rows["per_image"] = image
    log(f"sr_attention per 1024x2048 MiT-B5 image ({image['launches']} launches): kernel {image['ms']:.3f} ms, "
        f"bound {image['bound_ms']:.3f} ms ({100 * image['bound_ms'] / image['ms']:.1f} %), plain "
        f"{image['plain_ms']:.3f} ms, SDPA {image['library_ms']:.3f} ms")
    return rows


# (calls, q_hw, kv_hw, blocks) of MViTv2-B's attention cores on a 1024x2048 frame (head dim
# 96; calls = windows x heads): stage 1's windows, stage 2's windowed blocks, the global
# block 4, stage 3's windowed blocks, the global block 20, stage 4's windows, block 23
MVIT_B_CORES = ((50, (56, 56), (14, 14), 2), (100, (28, 28), (28, 28), 1), (100, (28, 28), (14, 14), 1),
                (2, (128, 256), (32, 64), 1), (200, (14, 14), (28, 28), 1), (200, (14, 14), (14, 14), 14),
                (4, (64, 128), (32, 64), 1), (400, (7, 7), (14, 14), 1), (400, (7, 7), (7, 7), 1),
                (8, (32, 64), (32, 64), 1))
REL_KERNEL = "rel_pos_attention_kernel"  # Kernel H's symbol in a device trace


def rel_pos_inputs(gen, calls: int, q_hw, kv_hw, hd: int):
    """q, k, v (calls, tokens, hd) bf16 of unit scale and the two raw position tables
    (2 max(q, k) - 1, hd) fp32 of scale 0.1 (position terms near 1) of one core call."""
    nq, nk = q_hw[0] * q_hw[1], kv_hw[0] * kv_hw[1]
    q, k, v = (torch.randn(calls, n, hd, generator=gen, device="cuda").bfloat16() for n in (nq, nk, nk))
    tables = (0.1 * torch.randn(2 * max(q_hw[i], kv_hw[i]) - 1, hd, generator=gen, device="cuda") for i in (0, 1))
    return (q, k, v, *tables)


def rel_pos_attention_phase(gen):
    """Kernel H against ``rel_pos_attention_plain`` at every core shape of MViTv2-B on a
    1024x2048 frame (``MVIT_B_CORES``, head dim 96): at least ``SR_BIT_EQUAL_SHARE`` of
    the outputs bit-equal and none beyond ``SR_MAX_ULPS`` of its row's largest value; per
    call and per image (each shape's time times its blocks, 24 launches) the kernel's ms
    (its tables made beforehand by ``rel_pos_tables``) beside the bound (the four products at 989
    TFLOP/s, or q, k, v and the output once at 3.35 TB/s, the larger: 0.248 ms an
    image), the plain chain's and ``scaled_dot_product_attention``'s without the
    position terms (the yardstick ``library_ms``; the port never calls it)."""
    from rba_tpu_torch.kernels.rel_pos_attention import rel_pos_attention
    from rba_tpu_torch.models.vit import rel_pos_attention_plain, rel_pos_tables

    hd = 96
    rows = {}
    image = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, launches=0, flops=0.0, bytes=0.0)
    for calls, q_hw, kv_hw, blocks in MVIT_B_CORES:
        q, k, v, rel_h, rel_w = rel_pos_inputs(gen, calls, q_hw, kv_hw, hd)
        nq, nk = q.shape[1], k.shape[1]
        with torch.no_grad():
            rh, rw, rw_index = rel_pos_tables(rel_h, rel_w, q_hw, kv_hw)
            before = rel_pos_attention.launches
            got = rel_pos_attention(q, k, v, rh, rw, rw_index, q_hw, kv_hw)
            torch.cuda.synchronize()
            launched = rel_pos_attention.launches - before
            want = rel_pos_attention_plain(q, k, v, q_hw, kv_hw, rel_h, rel_w)
            share, ulps = sr_attention_gap(got, want)
            finite = bool(torch.isfinite(got.float()).all())
            t_all = cuda_ms_batches(lambda: rel_pos_attention(q, k, v, rh, rw, rw_index, q_hw, kv_hw))
            t_p = cuda_ms(lambda: rel_pos_attention_plain(q, k, v, q_hw, kv_hw, rel_h, rel_w), iters=5)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=5)
        flops = 4.0 * calls * nq * nk * hd + 2.0 * calls * nq * (kv_hw[0] + kv_hw[1]) * hd
        nbytes = 2.0 * (2 * calls * nq * hd + 2 * calls * nk * hd)
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        name = f"c{calls}_q{q_hw[0]}x{q_hw[1]}_k{kv_hw[0]}x{kv_hw[1]}"
        rows[name] = dict(calls=calls, q_hw=q_hw, kv_hw=kv_hw, head_dim=hd, blocks=blocks, launches=launched,
                          bit_equal_share=share, max_ulps=ulps, ms=t_all[0], ms_batches=t_all, plain_ms=t_p,
                          library_ms=t_l, bound_ms=b_ms, bound_by=b_by, roofline=b_ms / t_all[0])
        for key, t in (("ms", t_all[0]), ("plain_ms", t_p), ("library_ms", t_l), ("flops", flops), ("bytes", nbytes)):
            image[key] += blocks * t
        image["launches"] += blocks * launched
        log(f"rel_pos_attention {name} (x{blocks} blocks): bit-equal {share:.5f} (least {SR_BIT_EQUAL_SHARE}), "
            f"worst {ulps:.2f} ulps of the row's largest (most {SR_MAX_ULPS}), launches {launched} | kernel "
            f"{t_all[0]:.4f} ms (3 batches {_fmt(t_all)}), bound {b_ms:.4f} ms ({b_by}; "
            f"{100 * b_ms / t_all[0]:.1f} %), plain {t_p:.4f} ms, SDPA {t_l:.4f} ms")
        if not (share >= SR_BIT_EQUAL_SHARE and ulps <= SR_MAX_ULPS and launched == 1 and finite):
            raise RuntimeError(f"rel_pos_attention {name}: {rows[name]}, finite {finite}")
        del q, k, v, got, want
    image["bound_ms"], image["bound_by"] = bound_ms(image["bytes"], image["flops"], "bfloat16")
    rows["per_image"] = image
    log(f"rel_pos_attention per 1024x2048 MViTv2-B image ({image['launches']} launches): kernel "
        f"{image['ms']:.3f} ms, bound {image['bound_ms']:.3f} ms ({100 * image['bound_ms'] / image['ms']:.1f} %), "
        f"plain {image['plain_ms']:.3f} ms, SDPA without the position terms {image['library_ms']:.3f} ms")
    return rows


def _write_cityscapes_split(root: Path, split: str, frames: int, rs):
    """``frames`` 1024x2048 PNG frames of a Cityscapes-layout split under ``root`` with
    ``*_gtFine_labelTrainIds.png`` (blocks of the 19 classes and some void), from ``rs``."""
    from PIL import Image

    h, w = IMAGE_HW
    img_dir = root / "leftImg8bit" / split / "synth"
    gt_dir = root / "gtFine" / split / "synth"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    palette = rs.randint(0, 256, (19, 3))
    yy, xx = np.mgrid[0:h, 0:w]
    blk = h // 8  # 8 x 16 blocks of one class each
    for i in range(frames):
        lab = rs.randint(0, 19, (8, w // blk)).repeat(blk, 0).repeat(blk, 1).astype(np.uint8)
        lab[rs.rand(8, w // blk).repeat(blk, 0).repeat(blk, 1) < 0.05] = 255
        shade = ((xx + yy * (i + 1)) % 64).astype(np.int64)[..., None]
        img = np.clip(palette[np.minimum(lab, 18)] + shade - 32, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(img_dir / f"synth_{i:06d}_leftImg8bit.png", compress_level=1)
        Image.fromarray(lab).save(gt_dir / f"synth_{i:06d}_gtFine_labelTrainIds.png", compress_level=1)


def _write_train_trees(root: Path, seed: int = 0):
    """A Cityscapes-layout train split of TRAIN_FRAMES frames (``_write_cityscapes_split``)
    and a COCO proxy tree (``annotations/ood_seg_train2017/*.png`` with 254 on an ellipse,
    ``train2017/*.jpg``).  Returns the seconds it took."""
    from PIL import Image

    t0 = time.perf_counter()
    rs = np.random.RandomState(seed)
    h, w = IMAGE_HW
    _write_cityscapes_split(root / "cityscapes", "train", TRAIN_FRAMES, rs)
    ann, imgs = root / "coco" / "annotations" / "ood_seg_train2017", root / "coco" / "train2017"
    ann.mkdir(parents=True)
    imgs.mkdir(parents=True)
    oh, ow = h * 15 // 32, w * 5 // 16  # COCO-sized, 480x640 beside a 1024x2048 frame
    oy, ox = np.mgrid[0:oh, 0:ow]
    for i in range(8):
        cy, cx = rs.randint(oh // 3, 2 * oh // 3), rs.randint(ow // 4, 3 * ow // 4)
        ry, rx = rs.randint(oh // 12, oh // 4), rs.randint(ow // 16, ow // 5)
        mask = ((oy - cy) / ry) ** 2 + ((ox - cx) / rx) ** 2 <= 1
        Image.fromarray((mask * 254).astype(np.uint8)).save(ann / f"{i:012d}.png")
        Image.fromarray(rs.randint(0, 256, (oh, ow, 3)).astype(np.uint8)).save(imgs / f"{i:012d}.jpg")
    return time.perf_counter() - t0


def _mapped_batch(cfg, args, n: int = TRAIN_BATCH):
    """The first ``n`` frames read and mapped in this thread (read, COCO mix, resize, crop,
    colour augmentation, flip, targets) and collated: (batch, host ms per image).  No
    mapper thread runs beside what it times or what follows."""
    import random as _random

    from rba_tpu_torch.data.mappers import collate
    from rba_tpu_torch.train import train_net

    ds = train_net._resolve_dataset(cfg.datasets_train[0], args.data_root)
    mapper = train_net.build_mapper(cfg, args)
    samples = []
    t0 = time.perf_counter()
    for i in range(n):
        s = ds[i]
        mapper.rng = _random.Random(i)
        samples.append(mapper(s.image, s.label))
    return collate(samples), (time.perf_counter() - t0) * 1e3 / n


@contextlib.contextmanager
def _recorded_assignments(store: list):
    """Record the cost and the result of every Kernel E call that the matcher makes; the
    kernel's wrapper, with its launch count, is the same."""
    from types import SimpleNamespace

    from rba_tpu_torch.train import matcher

    real = matcher.kernel  # the matcher's route asks this module for its rule and its kernel

    def recorded(cost):
        out = real.batched_linear_sum_assignment(cost)
        if len(store) < 2:
            store.append((cost.clone(), out.clone()))
        return out

    matcher.kernel = SimpleNamespace(takes=real.takes, batched_linear_sum_assignment=recorded)
    try:
        yield store
    finally:
        matcher.kernel = real


def _train_args(root: Path, weights: Path, out: Path, micro: int, max_iter: int):
    return ["--config-file", str(OOD_CONFIG), "--data-root", str(root / "cityscapes"), "--coco-root",
            str(root / "coco"), "--weights", str(weights), "--output-dir", str(out), "--max-iter", str(max_iter),
            "--batch-size", str(TRAIN_BATCH), "--grad-accum", str(TRAIN_BATCH // micro), "--log-period", "1",
            "--checkpoint-period", "0", "--seed", str(TRAIN_SEED), "--workers", str(min(8, os.cpu_count() or 1))]


def train_phase(pth: Path, image):
    """``rba_tpu_torch.train.train_net.main`` on configs/cityscapes/swin_b_1dl_ood_coco.yaml
    at full width and depth, from the seeded Detectron2 checkpoint: 2 warm-up and 8 timed
    steps at the global batch of 8 (per step the largest of 8 / 4 / 2 images that fits,
    the rest by --grad-accum), over a synthetic Cityscapes tree and COCO proxy tree
    written first.  Gates: finite losses and grad_norm; outlier_loss present and at
    least one image with a pasted object; Kernel E launched (and no serving kernel), its
    assignments on one step's real costs equal to the plain version's; at fp32 a step
    with Kernel E and a step with the plain LSAP give equal losses; the written
    checkpoint serves a path-1 request."""
    from rba_tpu_torch.config import load_d2_config
    from rba_tpu_torch.convert import load_checkpoint_params
    from rba_tpu_torch.kernels.lsap import batched_linear_sum_assignment
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba
    from rba_tpu_torch.train import train_net
    from rba_tpu_torch.train.train_step import make_train_step

    root = SCRATCH / "train"
    shutil.rmtree(root, ignore_errors=True)
    write_s = _write_train_trees(root)
    weights = root / "weights"
    weights.mkdir()
    shutil.copy(OOD_CONFIG, weights / "config.yaml")
    os.link(pth, weights / "model_final.pth")
    cfg = load_d2_config(str(OOD_CONFIG))
    log(f"train: {TRAIN_FRAMES} synthetic 1024x2048 frames and 8 COCO proxy objects written in {write_s:.1f} s; "
        f"config {OOD_CONFIG}: crop {cfg.input.crop_size}, batch {cfg.solver.ims_per_batch}, mapper "
        f"{cfg.input.dataset_mapper_name}, OOD_PROB {cfg.ood.ood_prob}, outlier loss {cfg.ood.outlier_loss_func} "
        f"on {cfg.ood.outlier_loss_target}/{cfg.ood.score_norm}, {cfg.decoder.dec_layers} decoder layer(s)")

    counts = _wrappers(lsap=True)
    run = None
    for micro in (8, 4, 2):
        out = root / f"out_micro{micro}"
        for fn in counts.values():
            fn.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        store: list = []
        try:
            with _recorded_assignments(store):
                t0 = time.perf_counter()
                state = train_net.main(_train_args(root, weights, out, micro, TRAIN_WARMUP + TRAIN_TIMED))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            log(f"train: a per-step batch of {micro} does not fit ({str(e).splitlines()[0][:120]}); trying the next")
            state = None
            gc.collect()
            continue
        launches = {k: fn.launches for k, fn in counts.items()}
        run = dict(micro=micro, grad_accum=TRAIN_BATCH // micro, wall_s=wall_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches, out=out)
        break
    if run is None:
        raise RuntimeError("train: no per-step batch of 8, 4 or 2 fits on the card")
    lines = [json.loads(line) for line in open(run["out"] / "metrics.jsonl")]
    timed = lines[TRAIN_WARMUP:]
    ms_step = [TRAIN_BATCH * 1e3 / m["imgs_per_sec"] for m in timed]
    pasted = sum(m.get("ood_images", 0) for m in lines)
    finite = all(math.isfinite(v) for m in lines for k, v in m.items() if k not in ("step",))
    expected_e = len(lines) * run["grad_accum"] * _supervised_layers(cfg)
    log(f"train: per-step batch {run['micro']} x --grad-accum {run['grad_accum']} = global batch {TRAIN_BATCH}; "
        f"{len(lines)} steps in {run['wall_s']:.1f} s (model load and mapper start included); timed steps "
        f"{statistics.median(ms_step):.1f} ms/step median ({[round(v, 1) for v in ms_step]}), "
        f"{TRAIN_BATCH * 1e3 / statistics.median(ms_step):.2f} images/s; peak memory {run['peak_gib']:.2f} GiB; "
        f"seed {TRAIN_SEED}: {pasted} of {len(lines) * TRAIN_BATCH} images with a pasted object; launches "
        f"{run['launches']} (Kernel E expected {expected_e}: steps x micro-batches x supervised layers)")
    log(f"train: step 1 {json.dumps({k: round(v, 4) for k, v in lines[0].items()})}")
    log(f"train: step {len(lines)} {json.dumps({k: round(v, 4) for k, v in lines[-1].items()})}")
    serving = {k: v for k, v in run["launches"].items() if k != "lsap" and v}
    if not finite or "outlier_loss" not in lines[0] or pasted < 1 or run["launches"]["lsap"] != expected_e \
            or serving or len(lines) != TRAIN_WARMUP + TRAIN_TIMED:
        raise RuntimeError(f"train: finite {finite}, outlier_loss {'outlier_loss' in lines[0]}, pasted {pasted}, "
                           f"launches {run['launches']} (Kernel E expected {expected_e}, serving kernels {serving})")

    # Kernel E on a step's real costs: against the plain version and scipy, and timed
    cost, got = store[0]
    real = lsap_check("train step costs", cost, got)
    real["ms"] = cuda_ms(lambda: batched_linear_sum_assignment(cost))
    log(f"train: Kernel E on one step's real costs {tuple(cost.shape)}: equal to the plain version and optimal | "
        f"kernel {real['ms']:.4f} ms per launch, plain {real['plain_ms']:.2f} ms, scipy with the copy "
        f"{real['scipy_ms']:.3f} ms; latency bound {real['latency_bound_ms']:.4f} ms ({real['steps_max']} steps)")

    # one profiled step of the same run's configuration, on a batch mapped in this thread
    args = train_net.parse_args(_train_args(root, weights, run["out"], run["micro"], 1))
    batch, mapper_ms = _mapped_batch(cfg, args)
    log(f"train: mapper host time {mapper_ms:.1f} ms per image (one thread, {cfg.input.dataset_mapper_name})")
    step_fn = make_train_step(cfg, grad_accum=run["grad_accum"])
    step_fn(state, batch)  # the profiler's own warm-up
    _, in_memory_ms = _timed(step_fn, state, batch)  # the batch already read and mapped
    prof = _profile("train step", lambda: step_fn(state, batch), top=10)
    prof["idle_share_unprofiled"] = 1 - prof["busy_ms"] / in_memory_ms if prof["busy_ms"] else None
    log(f"train: one step with its batch in host memory {in_memory_ms:.1f} ms (profiler off); device busy "
        + (f"{prof['busy_ms']:.1f} ms of it (profiled), idle share {prof['idle_share_unprofiled']:.3f}"
           if prof["busy_ms"] else "not measured"))

    # fp32: a step through Kernel E and a step through the plain LSAP, from the same weights and draws
    fp32 = _fp32_kernel_vs_plain(cfg, state.model, batch)
    log(f"train: fp32, 2 images: losses with Kernel E {fp32['kernel']['total']:.6f}, with the plain LSAP "
        f"{fp32['plain']['total']:.6f}; largest difference over all {len(fp32['kernel'])} metrics "
        f"{fp32['max_diff']:.3e}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # the written checkpoint serves a path-1 request
    ckpt = run["out"] / "checkpoints" / f"step_{TRAIN_WARMUP + TRAIN_TIMED}"
    model = load_checkpoint_params(str(ckpt), cfg)
    maskformer_infer_rba(model, cfg, image)  # warm-up
    counts = _zero_counts()
    rba, ms = _timed(maskformer_infer_rba, model, cfg, image)
    served = counts()
    ok = bool(torch.isfinite(rba).all()) and tuple(rba.shape) == (1, *IMAGE_HW)
    log(f"train: the trained checkpoint {ckpt.name} served one path-1 request in {ms:.2f} ms, launches {served}, "
        f"finite and of the frame's shape: {ok}")
    if not ok or served["window_attention"] != sum(cfg.swin.depths) or served["fused_rba_score"] != 1:
        raise RuntimeError(f"train: the trained checkpoint's request: ok {ok}, launches {served}")
    del model
    return dict(micro=run["micro"], grad_accum=run["grad_accum"], ms_per_step=statistics.median(ms_step),
                ms_per_step_all=ms_step, images_per_s=TRAIN_BATCH * 1e3 / statistics.median(ms_step),
                peak_gib=run["peak_gib"], wall_s=run["wall_s"], launches=run["launches"], pasted_images=pasted,
                images=len(lines) * TRAIN_BATCH, first=lines[0], last=lines[-1], profile=prof,
                mapper_ms_per_image=mapper_ms, step_in_memory_ms=in_memory_ms, lsap_real=real, fp32=fp32, serve_ms=ms,
                serve_launches=served, write_trees_s=write_s)


# ---------------------------------------------------------------------------
# Closed-set evaluation: Cityscapes mIoU through eval_semseg, COCO open-panoptic PQ,
# mIoU and mask AP on the three-level Swin-B, and the trainer's evaluation
# ---------------------------------------------------------------------------

SEMSEG_FRAMES = 8  # synthetic 1024x2048 Cityscapes val frames
COCO_CONFIG = Path("configs/coco/open-panoptic-segmentation/swin/maskformer2_swin_base_IN21k_384_bs16_50ep.yaml")
PANOPTIC_FRAMES = 4  # synthetic COCO-format panoptic frames of COCO_HW
PANOPTIC_CHECKED = 2  # of them, held on the card against the CPU function
MAP_SHARE = 0.9999  # least share of equal pixels: argmax and threshold ties may fall the other way
PQ_TOL = 1e-3
MIOU_TOL = 1e-3


@contextlib.contextmanager
def _xla_attention_calls():
    """Count the calls of Swin's ``"xla"`` window-attention chain (rba_tpu's default
    chain in plain torch), which no evaluation on path 1 should make."""
    from rba_tpu_torch.models import swin

    real, calls = swin.xla_attention, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    swin.xla_attention = counted
    try:
        yield calls
    finally:
        swin.xla_attention = real


@contextlib.contextmanager
def _bytes_to_host():
    """Count the bytes that ``Tensor.cpu()`` brings from the card to the host: the
    evaluators fetch through it."""
    real, moved = torch.Tensor.cpu, [0]

    def counted(self, *args, **kw):
        if self.is_cuda:
            moved[0] += self.numel() * self.element_size()
        return real(self, *args, **kw)

    torch.Tensor.cpu = counted
    try:
        yield moved
    finally:
        torch.Tensor.cpu = real


def semseg_phase(model_dir: Path):
    """``python -m rba_tpu_torch.evalx.eval_semseg``'s ``main`` on the swin_b_1dl model
    directory of the d2 phase (its default precision, fast) over SEMSEG_FRAMES synthetic
    1024x2048 Cityscapes val frames on disk.  Gates: Kernel A 24 times per image and the
    "xla" chain never; every image's device confusion counts equal to numpy's bincount of
    the same argmax; at fp32 the kernels and their plain versions give the argmax on
    >= MAP_SHARE of the pixels and mIoU within MIOU_TOL.  Reports ms/image, images/s, the
    busy time and idle share of one profiled image and the peak memory."""
    from rba_tpu_torch.config import load_d2_config
    from rba_tpu_torch.data.ood_datasets import CityscapesSemSeg
    from rba_tpu_torch.evalx import eval_semseg
    from rba_tpu_torch.evalx.seg_evaluators import SemSegEvaluator, confusion_counts
    from rba_tpu_torch.evalx.sweep import load_model

    root = SCRATCH / "semseg"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    _write_cityscapes_split(root / "cityscapes", "val", SEMSEG_FRAMES, np.random.RandomState(1))
    write_s = time.perf_counter() - t0
    blocks = sum(load_d2_config(str(model_dir / "config.yaml")).swin.depths)
    with _xla_attention_calls() as xla_calls:
        counts = _zero_counts()
        res, cli_ms = _timed(eval_semseg.main, ["--model-dir", str(model_dir), "--data-root",
                                                str(root / "cityscapes"), "--out", str(root / "metrics.json")])
        launches = counts()
    log(f"semseg: eval_semseg over {SEMSEG_FRAMES} frames (written in {write_s:.1f} s) in {cli_ms / 1e3:.2f} s "
        f"(model load and PNG decode included): mIoU {res['mIoU']:.6f}, fwIoU {res['fwIoU']:.6f}, pACC "
        f"{res['pACC']:.6f}; launches {launches}, calls of the xla chain {xla_calls[0]}")
    if not (math.isfinite(res["mIoU"]) and launches["window_attention"] == blocks * SEMSEG_FRAMES
            and xla_calls[0] == 0 and launches["fused_rba_score"] == 0):
        raise RuntimeError(f"semseg: mIoU {res['mIoU']}, launches {launches} (Kernel A expected "
                           f"{blocks * SEMSEG_FRAMES}), xla chain calls {xla_calls[0]}")

    cfg, model = load_model(str(model_dir))  # as the CLI: fast_serving
    ds = CityscapesSemSeg(str(root / "cityscapes"), "val")
    samples = [ds[i] for i in range(len(ds))]
    k = cfg.num_classes
    ev = SemSegEvaluator(cfg, model)
    counts_equal = True
    for s in samples:
        pred = ev.predict(s.image)
        dev = confusion_counts(pred, torch.from_numpy(s.label), k).cpu().numpy()
        ev.add(pred, s.label)
        p, lab = pred.cpu().numpy().astype(np.int64), s.label.astype(np.int64)
        valid = lab < k
        counts_equal &= np.array_equal(dev, np.bincount(lab[valid] * k + p[valid], minlength=k * k).reshape(k, k))
    log(f"semseg: device confusion counts equal to numpy's bincount of the same argmax on every image: {counts_equal}")
    if not counts_equal:
        raise RuntimeError("semseg: the device confusion counts differ from numpy's")

    timed_ev = SemSegEvaluator(cfg, model)
    timed_ev.process(samples[0].image, samples[0].label)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed_ev = SemSegEvaluator(cfg, model)
    _, loop_ms = _timed(lambda: [timed_ev.process(s.image, s.label) for s in samples])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not np.array_equal(timed_ev.conf, ev.conf):
        raise RuntimeError("semseg: a second evaluation of the same frames counts otherwise")
    prof = _profile("semseg one image", lambda: timed_ev.process(samples[1].image, samples[1].label))
    ms_image = loop_ms / len(samples)
    log(f"semseg: SemSegEvaluator over the {len(samples)} frames in memory {ms_image:.2f} ms/image, "
        f"{1e3 / ms_image:.2f} images/s (upload, forward, argmax, counts); peak memory {peak_gib:.2f} GiB")

    # fp32: the kernels against their plain versions, on the same weights
    cfg32 = dataclasses.replace(load_d2_config(str(model_dir / "config.yaml")), compute_dtype="float32")
    evs = {plain: SemSegEvaluator(cfg32, model) for plain in (False, True)}
    same = total = 0
    for s in samples[:2]:
        preds = {}
        for plain, e in evs.items():
            with _plain(plain):
                preds[plain] = e.predict(s.image)
        same += int((preds[False] == preds[True]).sum())
        total += preds[False].numel()
        for plain, e in evs.items():
            e.add(preds[plain], s.label)
    share = same / total
    miou = {plain: e.evaluate()["mIoU"] for plain, e in evs.items()}
    log(f"semseg fp32, 2 frames: argmax of the kernels equal to the plain versions' on {share:.6f} of the pixels "
        f"(least {MAP_SHARE}); mIoU {miou[False]:.6f} vs {miou[True]:.6f} (bound {MIOU_TOL})")
    if not (share >= MAP_SHARE and abs(miou[False] - miou[True]) <= MIOU_TOL):
        raise RuntimeError(f"semseg: at fp32 the kernels' argmax share {share}, mIoU {miou}")
    del model, ev, timed_ev, evs
    return dict(frames=SEMSEG_FRAMES, cli_s=cli_ms / 1e3, metrics={k2: v for k2, v in res.items()
                                                                  if k2 != "IoU_per_class"},
                launches=launches, xla_calls=xla_calls[0], counts_equal=counts_equal, ms_per_image=ms_image,
                images_per_s=1e3 / ms_image, peak_gib=peak_gib, profile=prof, fp32_argmax_share=share,
                fp32_miou=miou[False], fp32_miou_plain=miou[True])


def _write_coco_panoptic(root: Path, frames: int, seed: int = 0, split: str = "val"):
    """``frames`` COCO-format panoptic frames of COCO_HW under ``root/coco`` (<split>2017/*.png
    images, panoptic_<split>2017/*.png RGB id maps, annotations/panoptic_<split>2017.json) in
    raw COCO category ids: a grid of 4x6 segments, each of a random class of the 133 (so
    some of the open protocol's unknown things), a few crowds, and void seams."""
    from PIL import Image

    from rba_tpu_torch.data.categories import COCO_PANOPTIC_CATEGORIES

    rs = np.random.RandomState(seed)
    h, w = COCO_HW
    img_dir, pan_dir, ann_dir = (root / "coco" / d for d in (f"{split}2017", f"panoptic_{split}2017", "annotations"))
    for d in (img_dir, pan_dir, ann_dir):
        d.mkdir(parents=True, exist_ok=True)
    palette = rs.randint(0, 256, (len(COCO_PANOPTIC_CATEGORIES), 3))
    images, anns = [], []
    for i in range(frames):
        ids = np.zeros((h, w), np.int64)
        img = np.zeros((h, w, 3), np.int64)
        segs = []
        for r in range(4):
            for c in range(6):
                cat = rs.randint(len(COCO_PANOPTIC_CATEGORIES))
                y0, y1, x0, x1 = r * h // 4, (r + 1) * h // 4 - 4, c * w // 6, (c + 1) * w // 6 - 4
                sid = 1 + r * 6 + c + 256 * (i + 1)
                ids[y0:y1, x0:x1] = sid
                img[y0:y1, x0:x1] = palette[cat]
                segs.append({"id": sid, "category_id": COCO_PANOPTIC_CATEGORIES[cat][0],
                             "iscrowd": int(rs.rand() < 0.1), "area": (y1 - y0) * (x1 - x0)})
        img = np.clip(img + rs.randint(-20, 21, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(img_dir / f"{i:012d}.png", compress_level=1)
        rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)
        Image.fromarray(rgb).save(pan_dir / f"{i:012d}.png", compress_level=1)
        images.append({"id": i, "file_name": f"{i:012d}.png", "height": h, "width": w})
        anns.append({"image_id": i, "file_name": f"{i:012d}.png", "segments_info": segs})
    (ann_dir / f"panoptic_{split}2017.json").write_text(json.dumps({"images": images, "annotations": anns}))


@contextlib.contextmanager
def _sampling_inputs(store: list):
    """Record the inputs of the pixel decoder's first deformable sampling call."""
    from rba_tpu_torch.models import pixel_decoder

    real = pixel_decoder.ms_deform_attn_core

    def recorded(value, shapes, loc, attn, *args, **kw):
        if not store:
            store.append((value.clone(), list(shapes), loc.clone(), attn.clone()))
        return real(value, shapes, loc, attn, *args, **kw)

    pixel_decoder.ms_deform_attn_core = recorded
    try:
        yield store
    finally:
        pixel_decoder.ms_deform_attn_core = real


def _onehot_fp32(value, shapes, loc, attn, queries: int):
    """The one-hot form of the sampling at fp32 for the first ``queries`` queries: each
    level's dense (Lq, HW) row matrix of the corners' weights (``ops/deform_sampling.py``
    ``_corner_rows`` / ``_build_rows``) times the values, summed over the levels."""
    from rba_tpu_torch.ops.deform_sampling import _build_rows, _corner_rows

    n, _, m, d = value.shape
    out, start = 0, 0
    for lid, (h, w) in enumerate(shapes):
        v = value[:, start : start + h * w].float().permute(0, 2, 1, 3)  # (N, M, HW, D)
        idx, wgt = _corner_rows(h, w, loc[:, :queries, :, lid].float(), attn[:, :queries, :, lid].float())
        out = out + torch.matmul(_build_rows(idx, wgt, h * w), v)
        start += h * w
    return out.permute(0, 2, 1, 3).reshape(n, queries, m * d)


def panoptic_phase():
    """The COCO open-panoptic Swin-B config (three deformable levels, 9 decoder layers, 117
    classes) read by ``load_config``; a seeded full-width Detectron2 ``model_final.pth`` of
    it converted onto the card; PANOPTIC_FRAMES synthetic COCO-format panoptic frames of
    800x1067 served through the trainer's panoptic evaluation (``run_val_eval`` on
    ``coco_2017_val_panoptic_open``: PQ with the Unknown split, mIoU through
    ``SemSegFromPanoptic``, mask AP through ``InstanceEvaluator``).  Seeded random weights
    give nearly uniform class probabilities, so the phase lowers the object-mask and
    overlap thresholds to 0 (every query that predicts a class and wins a pixel makes a
    segment).  Gates: every parameter equal to the CPU conversion; Kernel A and B launches
    as counted; Kernel B's map equal to its plain version within 1e-3; on the same
    logits the card's panoptic map equal to the CPU function's on >= MAP_SHARE of the
    pixels and PQ within PQ_TOL; the fp32 one-hot sampling over the three levels equal
    to the gather within 1e-3.  Reports the sampling form per level at parity and
    fast_serving, ms/image split into forward, panoptic bookkeeping and PQ, busy time,
    peak memory and bytes brought back per image."""
    from rba_tpu_torch.config import fast_serving, load_config
    from rba_tpu_torch.convert import jax_params_to_state, load_checkpoint_params
    from rba_tpu_torch.convert.d2_mapping import convert_d2_state_dict
    from rba_tpu_torch.data import catalog
    from rba_tpu_torch.evalx.panoptic import pq_compute
    from rba_tpu_torch.evalx.seg_evaluators import OpenPanopticEvaluator
    from rba_tpu_torch.kernels.fused_rba import fused_rba_score_reference
    from rba_tpu_torch.models.inference import panoptic_inference
    from rba_tpu_torch.ops.deform_sampling import ms_deform_attn_core, sampling_methods
    from rba_tpu_torch.train import train_net

    cfg = load_config(str(COCO_CONFIG))
    ecfg = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, semantic_on=True, instance_on=True, object_mask_threshold=0.0, overlap_threshold=0.0))
    root = SCRATCH / "panoptic"
    shutil.rmtree(root, ignore_errors=True)
    model_dir = root / "model"
    model_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    sd = write_d2_checkpoint(cfg, model_dir / "model_final.pth")
    _write_coco_panoptic(root, PANOPTIC_FRAMES)
    write_s = time.perf_counter() - t0
    want = {k: torch.from_numpy(v) for k, v in jax_params_to_state(convert_d2_state_dict(sd, cfg)).items()}
    model, load_ms = _timed(load_checkpoint_params, str(model_dir), cfg)
    wrong = [n for n, p in model.named_parameters() if not (p.is_cuda and torch.equal(p.detach().cpu(), want[n]))]
    log(f"panoptic: {COCO_CONFIG.name}: levels {cfg.pixel_decoder.transformer_in_features}, "
        f"{cfg.decoder.dec_layers} decoder layers, {cfg.num_classes} classes, panoptic_on {cfg.test.panoptic_on}; "
        f"model_final.pth ({sum(v.numel() for v in want.values()) / 1e6:.2f} M parameters) and "
        f"{PANOPTIC_FRAMES} frames written in {write_s:.1f} s, converted onto the card in {load_ms / 1e3:.2f} s; "
        f"parameters not equal to the CPU conversion: {len(wrong)}")
    if wrong or sorted(n for n, _ in model.named_parameters()) != sorted(want):
        raise RuntimeError(f"panoptic: parameters differ from the CPU conversion: {wrong[:5]}")
    del sd, want

    hp, wp = (-(-s // cfg.input.size_divisibility) * cfg.input.size_divisibility for s in COCO_HW)
    shapes = [(hp // 2 ** int(f[3:]), wp // 2 ** int(f[3:]))  # resN at stride 2**N
              for f in cfg.pixel_decoder.transformer_in_features]
    forms = {}
    for name, c in (("parity", cfg), ("fast_serving", fast_serving(cfg))):
        pd = c.pixel_decoder
        methods = sampling_methods(1, pd.transformer_nheads, sum(h * w for h, w in shapes), shapes,
                                   pd.sampling_method, pd.sampling_onehot_cap)
        forms[name] = {f"{h}x{w}": ("onehot" if m == "onehot" and pd.sampling_dtype == "bfloat16" else "gather")
                       for (h, w), m in zip(shapes, methods)}
    log(f"panoptic: deformable sampling form per level at {hp}x{wp}: parity {forms['parity']}, fast_serving "
        f"{forms['fast_serving']}")

    # the trainer's route for a panoptic DATASETS.TEST, counted
    data_root = root / "cityscapes"  # absent: the catalog reads coco/ under its parent
    catalog.register_standard_datasets(str(root))
    thing_ids = tuple(sorted(v for v in set(catalog.metadata("coco_2017_val_panoptic_open")[
        "thing_dataset_id_to_contiguous_id"].values()) if v != 255))
    train_net.run_val_eval(ecfg, model, str(data_root), 1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    res, route_ms = _timed(train_net.run_val_eval, ecfg, model, str(data_root))
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    blocks = sum(cfg.swin.depths)
    expect = {"window_attention": 3 * PANOPTIC_FRAMES * blocks, "fused_rba_score": PANOPTIC_FRAMES}
    log(f"panoptic: run_val_eval on coco_2017_val_panoptic_open, {res['eval_images']} frames, {route_ms / 1e3:.2f} s: "
        f"PQ {res['All_pq']:.6f} (Known {res.get('Known_pq', float('nan')):.6f}, Unknown "
        f"{res.get('Unknown_pq', float('nan')):.6f}), mIoU {res['mIoU']:.6f}, mask AP {res['instance_AP']:.6f}; "
        f"launches {launches} (expected {expect}: PQ, mIoU and AP passes, Kernel B in the PQ pass); peak memory "
        f"{peak_gib:.2f} GiB")
    finite = all(math.isfinite(res[k2]) for k2 in ("All_pq", "mIoU"))
    if any(launches[k2] != v for k2, v in expect.items()) or "Unknown_pq" not in res or not finite:
        raise RuntimeError(f"panoptic: launches {launches} (expected {expect}), result {res}")

    # each image's time split: forward (with Kernel B's map), panoptic bookkeeping, then PQ
    ds = catalog.get("coco_2017_val_panoptic_open")
    frames = [ds[i] for i in range(len(ds))]
    ev = OpenPanopticEvaluator(ecfg, model, thing_ids=thing_ids)
    fwd_ms, book_ms, moved = [], [], []
    for image, pan_gt, segs_gt in frames:
        (mask_cls, low, mask_pred), ms_f = _timed(ev.raw_outputs, image)
        rba_map, ms_b = _timed(ev.rba_map, mask_cls, low, image.shape[:2])
        with _bytes_to_host() as nbytes:
            pred, ms_p = _timed(panoptic_inference, ecfg, mask_cls, mask_pred, thing_ids=thing_ids,
                                open_panoptic=True, rba_map=rba_map)
        fwd_ms.append(ms_f + ms_b)
        book_ms.append(ms_p)
        moved.append(nbytes[0])
        ev.pairs.append((*pred, pan_gt, segs_gt))
    pq, pq_ms = _timed(ev.evaluate)
    prof = _profile("panoptic one frame (forward, Kernel B, bookkeeping)", lambda: ev.predict(frames[0][0]))
    log(f"panoptic: per frame forward + Kernel B {statistics.median(fwd_ms):.2f} ms, panoptic bookkeeping "
        f"{statistics.median(book_ms):.2f} ms (medians of {len(frames)}), PQ over {len(frames)} frames "
        f"{pq_ms:.2f} ms; brought back to the host {statistics.median(moved) / 2**20:.3f} MiB per frame "
        f"(the (Q, H, W) fp32 mask logits would be {ecfg.decoder.num_queries * COCO_HW[0] * COCO_HW[1] * 4 / 2**20:.1f} MiB)")
    if pq["All"]["pq"] != res["All_pq"]:
        raise RuntimeError(f"panoptic: the timed pass's PQ {pq['All']} differs from the route's {res['All_pq']}")

    # on the same logits: Kernel B against its plain version, the card's map against the CPU's
    card_pairs, cpu_pairs, rba_err, share = [], [], 0.0, 1.0
    for image, pan_gt, segs_gt in frames[:PANOPTIC_CHECKED]:
        mask_cls, low, mask_pred = ev.raw_outputs(image)
        rba_k = ev.rba_map(mask_cls, low, image.shape[:2])
        rba_p = fused_rba_score_reference(mask_cls[None], low[None])[0, : image.shape[0], : image.shape[1]]
        rba_err = max(rba_err, max_abs(rba_k, rba_p))
        thr = float(torch.quantile(rba_k.flatten()[::101].float(), 0.7))  # so that unknown regions appear
        card = panoptic_inference(ecfg, mask_cls, mask_pred, thing_ids=thing_ids, open_panoptic=True,
                                  ood_threshold=thr, rba_map=rba_k)
        cpu = panoptic_inference(ecfg, mask_cls.cpu(), mask_pred.cpu(), thing_ids=thing_ids, open_panoptic=True,
                                 ood_threshold=thr)
        share = min(share, float((card[0] == cpu[0]).mean()))
        card_pairs.append((*card, pan_gt, segs_gt))
        cpu_pairs.append((*cpu, pan_gt, segs_gt))
    pq_card, pq_cpu = pq_compute(card_pairs)["All"]["pq"], pq_compute(cpu_pairs)["All"]["pq"]
    unknown = sum(s["category_id"] == 255 for p in card_pairs for s in p[1])
    log(f"panoptic: Kernel B's map vs its plain version max diff {rba_err:.3e} (bound 1e-3); on the same logits "
        f"of {PANOPTIC_CHECKED} frames the card's panoptic map equals the CPU function's on {share:.6f} of the "
        f"pixels (least {MAP_SHARE}), {sum(len(p[1]) for p in card_pairs)} segments ({unknown} unknown); PQ "
        f"{pq_card:.6f} vs {pq_cpu:.6f} (bound {PQ_TOL})")
    if not (rba_err <= 1e-3 and share >= MAP_SHARE and abs(pq_card - pq_cpu) <= PQ_TOL):
        raise RuntimeError(f"panoptic: Kernel B err {rba_err}, map share {share}, PQ {pq_card} vs {pq_cpu}")

    # the three-level sampling at fp32: one-hot against the gather, on the model's own inputs
    store: list = []
    fcfg = fast_serving(cfg)
    with _sampling_inputs(store):
        _, fast_ms = _timed(ev.raw_outputs, frames[0][0])
    value, lv_shapes, loc, attn = store[0]
    gather = ms_deform_attn_core(value, lv_shapes, loc, attn, method="gather")
    queries = min(2048, loc.shape[1])
    onehot32 = _onehot_fp32(value, lv_shapes, loc, attn, queries)
    err32 = max_abs(onehot32, gather[:, :queries])
    pd = fcfg.pixel_decoder
    fast = ms_deform_attn_core(value, lv_shapes, loc, attn, method=pd.sampling_method, sampling_dtype="bfloat16",
                               onehot_cap=pd.sampling_onehot_cap)
    log(f"panoptic: three-level sampling on the model's inputs (levels {lv_shapes}, {loc.shape[1]} queries): fp32 "
        f"one-hot vs gather on {queries} queries max diff {err32:.3e} (bound 1e-3); fast_serving's form vs the fp32 "
        f"gather {max_abs(fast, gather):.3e} (reported)")
    if not err32 <= 1e-3:
        raise RuntimeError(f"panoptic: the fp32 one-hot sampling differs from the gather by {err32}")
    ev_fast = OpenPanopticEvaluator(fcfg, model, thing_ids=thing_ids)
    ev_fast.raw_outputs(frames[0][0])  # warm-up
    _, fast_ms = _timed(ev_fast.predict, frames[0][0])
    log(f"panoptic fast_serving: one frame through the open-panoptic evaluator {fast_ms:.2f} ms")
    del model, ev, ev_fast
    return dict(config=str(COCO_CONFIG), frames=PANOPTIC_FRAMES, load_convert_s=load_ms / 1e3, sampling_forms=forms,
                result=res, route_s=route_ms / 1e3, launches=launches, peak_gib=peak_gib,
                forward_ms=statistics.median(fwd_ms), bookkeeping_ms=statistics.median(book_ms), pq_ms=pq_ms,
                ms_per_image=statistics.median(fwd_ms) + statistics.median(book_ms) + pq_ms / len(frames),
                bytes_to_host_per_image=statistics.median(moved), profile=prof, rba_map_max_abs_err=rba_err,
                map_share=share, pq_card=pq_card, pq_cpu=pq_cpu, sampling_fp32_max_diff=err32,
                fast_serving_frame_ms=fast_ms)


def train_eval_phase():
    """The trainer on the train phase's trees and checkpoint: 4 steps at per-step batch 8
    with ``--eval-period 2 --eval-max-images 2`` over a 2-frame val split, then
    ``--eval-only`` from the checkpoint that run wrote.  Gates: both runs end (no gradient
    error), their three evaluations are in metrics.jsonl with finite mIoU, and Kernel A ran
    24 times per evaluated image.  Reports the seconds of each evaluation."""
    from rba_tpu_torch.config import load_d2_config
    from rba_tpu_torch.train import train_net

    root = SCRATCH / "train"
    shutil.rmtree(root / "cityscapes" / "leftImg8bit" / "val", ignore_errors=True)
    shutil.rmtree(root / "cityscapes" / "gtFine" / "val", ignore_errors=True)
    _write_cityscapes_split(root / "cityscapes", "val", 2, np.random.RandomState(2))
    out = root / "out_eval"
    shutil.rmtree(out, ignore_errors=True)
    blocks = sum(load_d2_config(str(OOD_CONFIG)).swin.depths)
    counts = _wrappers(lsap=True)
    real, eval_s = train_net.run_val_eval, []

    def timed_eval(*args, **kw):
        res, ms = _timed(real, *args, **kw)
        eval_s.append(ms / 1e3)
        return res

    train_net.run_val_eval = timed_eval
    launches = {}
    try:
        for name, extra, max_iter in (("train", ["--eval-period", "2", "--eval-max-images", "2"], 4),
                                      ("eval_only", ["--eval-only", "--eval-max-images", "2"], 4)):
            for fn in counts.values():
                fn.launches = 0
            t0 = time.perf_counter()
            train_net.main(_train_args(root, root / "weights", out, TRAIN_BATCH, max_iter) + extra)
            torch.cuda.synchronize()
            launches[name] = {k: fn.launches for k, fn in counts.items()}
            log(f"train_eval: {name} run {time.perf_counter() - t0:.1f} s, launches {launches[name]}")
    finally:
        train_net.run_val_eval = real
    lines = [json.loads(line) for line in open(out / "metrics.jsonl")]
    evals = [m for m in lines if "mIoU" in m]
    log(f"train_eval: evaluations {[(m['step'], round(m['mIoU'], 6), m['eval_images']) for m in evals]} in "
        f"metrics.jsonl; seconds per evaluation {[round(s, 3) for s in eval_s]}")
    ok = (len(evals) == 3 and [m["step"] for m in evals] == [2, 4, 4] and len(eval_s) == 3
          and all(math.isfinite(m["mIoU"]) and m["eval_images"] == 2 for m in evals)
          and launches["train"]["window_attention"] == 2 * 2 * blocks
          and launches["eval_only"]["window_attention"] == 2 * blocks and launches["eval_only"]["lsap"] == 0)
    if not ok:
        raise RuntimeError(f"train_eval: evaluations {evals}, launches {launches}, seconds {eval_s}")
    return dict(evaluations=evals, eval_s=eval_s, launches=launches)


# ---------------------------------------------------------------------------
# The non-Swin backbones: six shipped configs at full width and depth, served through
# maskformer_infer_rba; the R50 Detectron2 checkpoint and the sweep through the normal
# entry points
# ---------------------------------------------------------------------------

SEMSEG_CONFIGS = Path("configs/cityscapes/semantic-segmentation")
BACKBONE_CONFIGS = {  # one config of each family
    "R50": "maskformer2_R50_bs16_90k.yaml",
    "R101_1dl": "maskformer2_R101_bs16_90k_1dl.yaml",
    "mit_b5_1dl": "mix_transformer/maskformer_2_mit_b5_in21k_1dl.yaml",
    "mvit_in21k_1dl": "mvit/maskformer_2_mvit_in21k_bs16_90k_1dl.yaml",
    "vit": "vit/maskformer_2_vit_imagenet_bs16_90k.yaml",
    "wrn38_1dl": "wideresnet/maskformer_2_wideresnet38_imagenet_bs16_90k_1dl.yaml",
}
# the Detectron2 YAML of the R50 model, as the release's config.yaml names its keys
R50_D2_YAML = """MODEL:
  BACKBONE: {NAME: build_resnet_backbone}
  RESNETS: {DEPTH: 50, STRIDE_IN_1X1: false, OUT_FEATURES: [res2, res3, res4, res5]}
  SEM_SEG_HEAD: {NAME: MaskFormerHead, NUM_CLASSES: 19,
                 DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES: [res3, res4, res5]}
  MASK_FORMER: {DEC_LAYERS: 10}
"""


def backbones_phase(images):
    """Each config of ``BACKBONE_CONFIGS`` from its YAML at full width and depth, seeded
    weights, ``N_REQUESTS`` 1024x2048 requests through ``maskformer_infer_rba`` at the
    config's precision and at ``fast_serving`` (median ms/image), peak memory, one
    profiled request (busy, idle share, busy per layer span) and the launches of every
    kernel.  Gates: finite (1, 1024, 2048) maps; Kernel B once per request where the mask
    features are at stride 4 and never elsewhere, Kernel F once per encoder layer where
    ``_deform_per_request`` says so (and not the plain gather's kernel), Kernel G once per
    MiT block where ``_sr_per_request`` says so (and nothing else inside the
    ``sr_attention`` spans), Kernel H once per MViT and ViT block where
    ``_rel_per_request`` says so (inside its ``rel_pos_attention`` span), no other
    kernel; one ``rel_pos_attention`` span per MViT and ViT block and one ``qkv_pool`` span per MViT block; MiT's stretches between its
    cores, and MViT's spans and the stretches around them, replayed as CUDA graphs where
    ``_replays_per_request`` says so, captured at most once; at fp32 the entry equals its plain version and
    ``maskformer_infer(...)["rba"]`` within 1e-3."""
    from rba_tpu_torch.config import fast_serving, load_config
    from rba_tpu_torch.models.cuda_graphs import piecewise, spanwise
    from rba_tpu_torch.models.maskformer import build_model, maskformer_infer, maskformer_infer_rba

    out = {}
    for name, rel in BACKBONE_CONFIGS.items():
        t_cfg = time.perf_counter()
        cfg = load_config(str(SEMSEG_CONFIGS / rel))
        model = build_model(cfg, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        stride = model.mask_stride(cfg)
        per_image = {"fused_rba_score": 1} if stride == 4 else {}
        row = dict(config=str(SEMSEG_CONFIGS / rel), backbone=cfg.backbone_name, parameters=n_params,
                   mask_stride=stride, compute_dtype=cfg.compute_dtype)
        for label, c in (("parity", cfg), ("fast", fast_serving(cfg))):
            maskformer_infer_rba(model, c, images[0])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts = _zero_counts(deform=True)
            piecewise.captures = piecewise.replays = spanwise.captures = spanwise.replays = 0
            maps, times = [], []
            for i in range(1, N_REQUESTS + 1):
                rba, ms = _timed(maskformer_infer_rba, model, c, images[i])
                maps.append(rba)
                times.append(ms)
            launches = counts()
            graphs = dict(captures=piecewise.captures + spanwise.captures,
                          replays=piecewise.replays + spanwise.replays)
            bad = [tuple(r.shape) for r in maps if tuple(r.shape) != (1, *IMAGE_HW) or not bool(torch.isfinite(r).all())]
            want = dict(per_image, ms_deform_attn=_deform_per_request(c, model), sr_attention=_sr_per_request(c, model))
            want = {k: want.get(k, 0) * N_REQUESTS for k in launches}
            replays = _replays_per_request(c, model)
            # Kernel H launches in an eager request and at a capture, where its span's graph
            # takes it; a replayed request launches none
            want["rel_pos_attention"] = _rel_per_request(c, model) * (graphs["captures"] if replays else N_REQUESTS)
            # the warm-up ran eagerly; the first request after it captures where none is yet
            if (bad or launches != want or graphs["replays"] != replays * N_REQUESTS
                    or graphs["captures"] > (1 if replays else 0)):
                raise RuntimeError(f"backbones {name} {label}: maps {bad} not finite (1, 1024, 2048), launches "
                                   f"{launches}, expected {want}; graphs {graphs}, expected {replays} replays a "
                                   "request and at most one capture")
            row[label] = dict(ms_per_image=statistics.median(times), ms_all=times, launches=launches, graphs=graphs,
                              peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        redesigned = {"fused_rba_mma_kernel": "fused_rba_kernel"} if per_image else {}
        if _deform_per_request(cfg, model):
            redesigned.update(KERNEL_F)
        row["profile"] = profile_phase(f"backbones {name}", cfg, model, images[1], "fused", redesigned, top=6)
        cores, blocks = row["profile"].get("sr_attention"), _sr_per_request(cfg, model)
        if blocks and cores is not None and not (cores["spans"] == blocks == sum(k["calls"] for k in cores["kernels"])
                           and all("sr_attention_kernel" in k["kernel"] for k in cores["kernels"])):
            raise RuntimeError(f"backbones {name}: the attention cores ran {cores}, expected Kernel G alone, once "
                               "per block")
        want_spans = _rel_pos_spans_per_request(model)
        if row["profile"]["layers"] is not None:
            spans = {sp: row["profile"][sp]["spans"] for sp in want_spans}
            if spans != want_spans:
                raise RuntimeError(f"backbones {name}: a request opened {spans} spans, expected {want_spans}")
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        counts = _zero_counts()
        r32 = maskformer_infer_rba(model, cfg32, images[1])
        fused32 = counts()["fused_rba_score"]
        with _plain():
            plain32 = maskformer_infer_rba(model, cfg32, images[1])
        infer32 = maskformer_infer(model, cfg32, images[1])["rba"]
        row["fp32"] = dict(vs_plain=max_abs(r32, plain32), vs_maskformer_infer=max_abs(r32, infer32),
                           kernel_b_launches=fused32, bound=E2E_FP32_TOL)
        if not (row["fp32"]["vs_plain"] <= E2E_FP32_TOL and row["fp32"]["vs_maskformer_infer"] <= E2E_FP32_TOL
                and fused32 == per_image.get("fused_rba_score", 0)):
            raise RuntimeError(f"backbones {name}: fp32 {row['fp32']}")
        row["s"] = time.perf_counter() - t_cfg
        prof = row["profile"]
        log(f"backbones {name} ({cfg.backbone_name}, {n_params / 1e6:.2f} M parameters, mask stride {stride}): "
            f"ms/image {row['parity']['ms_per_image']:.2f} at {cfg.compute_dtype} "
            f"(all {[round(t, 2) for t in row['parity']['ms_all']]}), {row['fast']['ms_per_image']:.2f} at "
            f"fast_serving; peak {row['parity']['peak_gib']:.2f} / {row['fast']['peak_gib']:.2f} GiB; busy "
            f"{prof['busy_ms']} ms, idle share {prof['idle_share']}; Kernel B launches {row['parity']['launches']}"
            f"; fp32 vs plain {row['fp32']['vs_plain']:.3e}, vs maskformer_infer "
            f"{row['fp32']['vs_maskformer_infer']:.3e} (bound {E2E_FP32_TOL:.0e}); {row['s']:.1f} s")
        out[name] = row
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _resnet_d2_name(name: str) -> str:
    """The Detectron2 name of a port ResNet parameter: ``stem.norm1.mean`` →
    ``stem.conv1.norm.running_mean``, ``res3.0.norm2.weight`` → ``res3.0.conv2.norm.weight``,
    ``res3.0.shortcut_norm.var`` → ``res3.0.shortcut.norm.running_var``."""
    import re

    name = re.sub(r"^stem\.norm1\.", "stem.conv1.norm.", name)
    name = re.sub(r"\.norm(\d)\.", r".conv\1.norm.", name)
    name = name.replace(".shortcut_norm.", ".shortcut.norm.")
    return re.sub(r"\.mean$", ".running_mean", re.sub(r"\.var$", ".running_var", name))


def r50_d2_state_dict(cfg, seed: int = 0) -> dict:
    """A seeded Detectron2 state dict of the R50 model: the backbone under the released
    ResNet names (convs ~ N(0, 1/fan_in), batch-norm scales ~ 1, running variances above
    1), and ``tests/d2_synthetic.py``'s heads at the ResNet's widths."""
    import types

    from rba_tpu_torch.models.resnet import ResNet
    from tests.d2_synthetic import d2_state_dict

    with torch.device("meta"):
        backbone = ResNet(cfg.resnet)
    swin = types.SimpleNamespace(embed_dim=8, patch_size=4, window_size=1, num_layers=0, out_features=(),
                                 out_channels=backbone.out_channels, depths=(), num_heads=(), mlp_ratio=4.0)
    sd = {k: v for k, v in d2_state_dict(types.SimpleNamespace(swin=swin, pixel_decoder=cfg.pixel_decoder,
                                                               decoder=cfg.decoder, num_classes=cfg.num_classes),
                                         seed).items() if not k.startswith("backbone.")}
    rng = np.random.default_rng(seed + 1)
    for name, p in backbone.named_parameters():
        shape, leaf = tuple(p.shape), name.rpartition(".")[2]
        if len(shape) == 4:
            w = rng.standard_normal(shape, dtype=np.float32) / np.float32(math.sqrt(np.prod(shape[1:])))
        elif leaf in ("weight", "var"):
            w = 1 + np.abs(0.1 * rng.standard_normal(shape, dtype=np.float32))
        else:
            w = 0.1 * rng.standard_normal(shape, dtype=np.float32)
        sd["backbone." + _resnet_d2_name(name)] = w
    return sd


def r50_d2_phase(image):
    """R50 through the normal entry points: a D2-format ``config.yaml`` and a seeded
    full-width ``model_final.pth`` under ``build/``, loaded onto the card with
    ``load_checkpoint_params`` (every parameter bit-equal to the CPU conversion of the same
    dict; the config equal to the native YAML's), one request from it (Kernel B once), and
    ``python -m rba_tpu_torch.evalx.sweep``'s ``main`` over that model directory on its 4
    synthetic images (finite metrics, the ``params.npz`` cache)."""
    from rba_tpu_torch.config import load_config, load_d2_config
    from rba_tpu_torch.convert import jax_params_to_state, load_checkpoint_params
    from rba_tpu_torch.convert.d2_mapping import convert_d2_state_dict
    from rba_tpu_torch.evalx import sweep
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    zoo = SCRATCH / "zoo_r50"
    model_dir = zoo / "r50"
    shutil.rmtree(zoo, ignore_errors=True)
    model_dir.mkdir(parents=True)
    (model_dir / "config.yaml").write_text(R50_D2_YAML)
    cfg = load_d2_config(str(model_dir / "config.yaml"))
    native = load_config(str(SEMSEG_CONFIGS / BACKBONE_CONFIGS["R50"]))
    fields = ("backbone_name", "resnet", "pixel_decoder", "num_classes", "compute_dtype")
    if any(getattr(cfg, f) != getattr(native, f) for f in fields) or \
            dataclasses.replace(cfg.decoder, transformer_in_feature="") != \
            dataclasses.replace(native.decoder, transformer_in_feature=""):
        raise RuntimeError(f"r50_d2: the D2 YAML does not load as {BACKBONE_CONFIGS['R50']}: {cfg}")
    t0 = time.perf_counter()
    sd = r50_d2_state_dict(cfg)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "iteration": 89999},
               model_dir / "model_final.pth")
    write_s = time.perf_counter() - t0
    want = {k: torch.from_numpy(v) for k, v in jax_params_to_state(convert_d2_state_dict(sd, cfg)).items()}
    t0 = time.perf_counter()
    model = load_checkpoint_params(str(model_dir), cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    wrong = [n for n, p in params.items() if not (p.is_cuda and torch.equal(p.detach().cpu(), want[n]))]
    if wrong or sorted(params) != sorted(want) or not (model_dir / "params.npz").exists():
        raise RuntimeError(f"r50_d2: parameters differ from the CPU conversion: {wrong[:5]}")
    maskformer_infer_rba(model, cfg, image)
    counts = _zero_counts()
    rba, ms = _timed(maskformer_infer_rba, model, cfg, image)
    launches = counts()
    if launches["fused_rba_score"] != 1 or not bool(torch.isfinite(rba).all()) or tuple(rba.shape) != (1, *IMAGE_HW):
        raise RuntimeError(f"r50_d2: request launches {launches}, shape {tuple(rba.shape)}")
    del model
    (model_dir / "params.npz").unlink()  # the sweep converts model_final.pth itself
    res_dir = SCRATCH / "sweep_out_r50"
    shutil.rmtree(res_dir, ignore_errors=True)
    counts = _zero_counts()
    _, sweep_ms = _timed(sweep.main, ["--models_folder", str(zoo), "--datasets_folder", str(SCRATCH / "no_datasets"),
                                      "--dataset_mode", "synthetic", "--out_path", str(res_dir)])
    sweep_launches = counts()
    metrics = json.loads((res_dir / "r50" / "results.json").read_text())["synthetic"]
    cached = (model_dir / "params.npz").exists()
    log(f"r50_d2: model_final.pth of {len(sd)} arrays ({sum(v.numel() for v in want.values()) / 1e6:.2f} M "
        f"parameters) written in {write_s:.2f} s; load_checkpoint_params onto the card {load_s:.2f} s, every "
        f"parameter equal to the CPU conversion; one request {ms:.2f} ms, launches {launches}; sweep "
        f"{sweep_ms / 1e3:.2f} s, results {metrics}, launches {sweep_launches}, params.npz cached {cached}")
    if sorted(metrics) != ["aupr", "auroc", "fpr95"] or not all(math.isfinite(v) for v in metrics.values()) \
            or not cached or sweep_launches["fused_rba_score"] < 1:
        raise RuntimeError(f"r50_d2 sweep: results {metrics}, cached {cached}, launches {sweep_launches}")
    return dict(parameters=len(want), write_s=write_s, load_convert_s=load_s, request_ms=ms, launches=launches,
                sweep_s=sweep_ms / 1e3, sweep_metrics=metrics, sweep_launches=sweep_launches)

# ---------------------------------------------------------------------------
# Training the non-Swin backbones: the four RbA outlier fine-tunes and the 90k R50 and ViT
# ---------------------------------------------------------------------------

TRAIN_BACKBONE_CONFIGS = {  # frozen backbone and pixel decoder on the coco-mix recipes, unfrozen on R50 and ViT
    "R101_1dl_coco_mix": "maskformer2_R101_bs16_90k_1dl_coco_mix.yaml",
    "mit_b5_1dl_coco_mix": "mix_transformer/maskformer_2_mit_b5_in21k_1dl_coco_mix.yaml",
    "mvit_in21k_1dl_coco_mix": "mvit/maskformer_2_mvit_in21k_bs16_90k_1dl_coco_mix.yaml",
    "wrn38_1dl_coco_mix": "wideresnet/maskformer_2_wideresnet38_imagenet_bs16_90k_1dl_coco_mix.yaml",
    "R50": "maskformer2_R50_bs16_90k.yaml",
    "vit": "vit/maskformer_2_vit_imagenet_bs16_90k.yaml",
}
TRAIN_BB_WARMUP, TRAIN_BB_TIMED = 1, 3  # steps of each config
CLI_CONFIG = "R101_1dl_coco_mix"  # the config that the trainer CLI also runs
CLI_STEPS = 2
FROZEN = ("backbone.", "sem_seg_head.pixel_decoder.")


def _changed(model, before, prefixes):
    """(changed, all) counts of the parameters under ``prefixes`` against ``before``."""
    names = [n for n in before if n.startswith(prefixes)]
    params = dict(model.named_parameters())
    return sum(not torch.equal(params[n].detach(), before[n]) for n in names), len(names)


def _train_steps(cfg, model, batch, counts):
    """Steps of ``make_train_step`` on ``batch`` at the global batch of 8, per step the
    largest of 8 / 4 / 2 images that fits and the rest by ``grad_accum``: one warm-up and
    ``TRAIN_BB_TIMED`` timed (host clock to a synchronize).  Returns the state, the step
    function and what was measured."""
    from rba_tpu_torch.train.train_step import make_train_state, make_train_step

    for micro in (8, 4, 2):
        for fn in counts.values():
            fn.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = make_train_state(cfg, model=model, seed=TRAIN_SEED)
        step_fn = make_train_step(cfg, grad_accum=TRAIN_BATCH // micro)
        try:
            metrics, times = [], []
            for i in range(TRAIN_BB_WARMUP + TRAIN_BB_TIMED):
                m, ms = _timed(step_fn, state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
                times.append(ms)
        except torch.cuda.OutOfMemoryError as e:
            log(f"train_backbones: a per-step batch of {micro} does not fit ({str(e).splitlines()[0][:100]})")
            model.zero_grad(set_to_none=True)
            del state, step_fn
            gc.collect()
            continue
        return state, step_fn, dict(micro=micro, grad_accum=TRAIN_BATCH // micro, metrics=metrics,
                                    ms_all=times[TRAIN_BB_WARMUP:], launches={k: fn.launches for k, fn in counts.items()},
                                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    raise RuntimeError("train_backbones: no per-step batch of 8, 4 or 2 fits on the card")


def _fp32_kernel_vs_plain(cfg, model, batch):
    """At fp32 on 2 images from the model's current weights: a step through Kernel E and
    a step through the plain LSAP (same weights, same draws) give equal metrics; the
    model keeps the plain step's update."""
    from rba_tpu_torch.train.train_step import make_train_state, make_train_step

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    small = {k: v[:2] for k, v in batch.items()}
    out = {}
    for plain in (False, True):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(weights[n])
        st = make_train_state(cfg32, model=model, seed=TRAIN_SEED)
        with _plain(plain):
            out["plain" if plain else "kernel"] = {k: float(v) for k, v in make_train_step(cfg32)(st, small).items()}
    # each metric within 1e-6 of its own size: the losses come from the same matching, and
    # grad_norm differs in its last bits between any two runs of one step (the backward's
    # atomic adds sum in no fixed order)
    diff = max(abs(out["kernel"][k] - out["plain"][k]) for k in out["kernel"])
    if sorted(out["kernel"]) != sorted(out["plain"]) or any(
            abs(out["kernel"][k] - v) > 1e-6 * max(1.0, abs(v)) for k, v in out["plain"].items()):
        raise RuntimeError(f"fp32 metrics differ between Kernel E and the plain LSAP: {out}")
    return dict(kernel=out["kernel"], plain=out["plain"], max_diff=diff)


def _trainer_cli(rel: str, image, micro: int):
    """``train_net.main`` on the recipe for ``CLI_STEPS`` steps from seeded weights over the
    train phase's trees, then its last checkpoint loaded and served one request through
    ``maskformer_infer_rba`` (Kernel B once, at mask stride 4)."""
    from rba_tpu_torch.config import load_config
    from rba_tpu_torch.convert import load_checkpoint_params
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba
    from rba_tpu_torch.train import train_net

    root, out = SCRATCH / "train", SCRATCH / "train_backbones_cli"
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config(str(SEMSEG_CONFIGS / rel))
    counts = _zero_counts(lsap=True)
    argv = ["--config-file", str(SEMSEG_CONFIGS / rel), "--data-root", str(root / "cityscapes"), "--coco-root",
            str(root / "coco"), "--output-dir", str(out), "--max-iter", str(CLI_STEPS), "--batch-size",
            str(TRAIN_BATCH), "--grad-accum", str(TRAIN_BATCH // micro), "--log-period", "1",
            "--checkpoint-period", "0", "--seed", str(TRAIN_SEED), "--workers", str(min(8, os.cpu_count() or 1))]
    state, wall_ms = _timed(train_net.main, argv)
    del state
    gc.collect()
    train_launches = counts()
    lines = [json.loads(line) for line in open(out / "metrics.jsonl")]
    expected_e = CLI_STEPS * (TRAIN_BATCH // micro) * (1 + cfg.decoder.dec_layers)
    finite = all(math.isfinite(v) for m in lines for v in m.values())
    model = load_checkpoint_params(str(out / "checkpoints" / f"step_{CLI_STEPS}"), cfg)
    maskformer_infer_rba(model, cfg, image)  # warm-up
    counts = _zero_counts()
    rba, serve_ms = _timed(maskformer_infer_rba, model, cfg, image)
    served = counts()
    ok = bool(torch.isfinite(rba).all()) and tuple(rba.shape) == (1, *IMAGE_HW)
    row = dict(steps=len(lines), wall_s=wall_ms / 1e3, first=lines[0], last=lines[-1], launches=train_launches,
               expected_lsap=expected_e, serve_ms=serve_ms, serve_launches=served, serve_ok=ok)
    log(f"train_backbones {rel}: train_net.main ran {len(lines)} steps in {wall_ms / 1e3:.1f} s (model build, "
        f"mapper threads and checkpoint included), launches {train_launches} (Kernel E expected {expected_e}); its "
        f"checkpoint served one request in {serve_ms:.2f} ms, launches {served}, finite and of the frame's shape: {ok}")
    serving = {k: v for k, v in train_launches.items() if k != "lsap" and v}
    if len(lines) != CLI_STEPS or not finite or "outlier_loss" not in lines[0] or serving \
            or train_launches["lsap"] != expected_e or not ok or served != dict(dict.fromkeys(served, 0),
                                                                                fused_rba_score=1):
        raise RuntimeError(f"train_backbones trainer CLI: {row}")
    del model
    return row


def train_backbones_phase(image):
    """Each config of ``TRAIN_BACKBONE_CONFIGS`` from its YAML at full width and depth,
    seeded weights, TF32 off: ``TRAIN_BB_WARMUP`` + ``TRAIN_BB_TIMED`` steps of
    ``make_train_step`` at the global batch of 8 on the first 8 frames of the train phase's
    synthetic trees, mapped by the config's own mapper at its 512x1024 crop; ms/step,
    images/s, peak memory, one profiled step (busy, idle share, top kernels, the
    deformable sampling's forward and backward spans).  Gates, each of which fails the
    run: finite losses and grad_norm, outlier_loss on the coco-mix recipes; Kernel E
    launched steps x micro-batches x (1 + decoder layers) times, and no A, B, C or D; on
    the frozen recipes every backbone and pixel-decoder parameter bit for bit unchanged and
    every decoder parameter changed; on R50 and ViT every backbone parameter changed.  On
    ``CLI_CONFIG`` also the fp32 step through Kernel E against the plain LSAP and the
    trainer CLI with its checkpoint served (``_trainer_cli``)."""
    from rba_tpu_torch.config import load_config
    from rba_tpu_torch.models.maskformer import build_model
    from rba_tpu_torch.ops.deform_sampling import BACKWARD_SPAN, SPAN
    from rba_tpu_torch.train import train_net

    root = SCRATCH / "train"
    counts = _wrappers(lsap=True)
    out, lsap_total = {}, 0
    for name, rel in TRAIN_BACKBONE_CONFIGS.items():
        t_cfg = time.perf_counter()
        cfg = load_config(str(SEMSEG_CONFIGS / rel))
        args = train_net.parse_args(["--config-file", str(SEMSEG_CONFIGS / rel), "--data-root",
                                     str(root / "cityscapes"), "--coco-root", str(root / "coco"), "--seed",
                                     str(TRAIN_SEED)])
        batch, mapper_ms = _mapped_batch(cfg, args)
        model = build_model(cfg, seed=0)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        frozen = cfg.solver.freeze_backbone and cfg.solver.freeze_pixel_decoder
        coco_mix = cfg.input.dataset_mapper_name == "mask_former_semantic_coco_mix"
        state, step_fn, run = _train_steps(cfg, model, batch, counts)
        steps = TRAIN_BB_WARMUP + TRAIN_BB_TIMED
        expected_e = steps * run["grad_accum"] * (1 + cfg.decoder.dec_layers)
        lsap_total += run["launches"]["lsap"]
        finite = all(math.isfinite(v) for m in run["metrics"] for v in m.values())
        other = {k: v for k, v in run["launches"].items() if k != "lsap" and v}
        frozen_moved = _changed(model, before, FROZEN) if frozen else None
        decoder_moved = _changed(model, before, ("sem_seg_head.predictor.",))
        backbone_moved = _changed(model, before, ("backbone.",))
        ms = statistics.median(run["ms_all"])
        prof = _profile(f"train_backbones {name} step", lambda: step_fn(state, batch), top=8, spans=(SPAN, BACKWARD_SPAN))
        row = dict(config=str(SEMSEG_CONFIGS / rel), backbone=cfg.backbone_name,
                   parameters=sum(p.numel() for p in model.parameters()), frozen=frozen, coco_mix=coco_mix,
                   dec_layers=cfg.decoder.dec_layers, mask_stride=model.mask_stride(cfg), micro=run["micro"],
                   grad_accum=run["grad_accum"], ms_per_step=ms, ms_all=run["ms_all"], images_per_s=TRAIN_BATCH * 1e3 / ms,
                   peak_gib=run["peak_gib"], launches=run["launches"], expected_lsap=expected_e,
                   first=run["metrics"][0], last=run["metrics"][-1], mapper_ms_per_image=mapper_ms, profile=prof,
                   frozen_changed=frozen_moved, decoder_changed=decoder_moved, backbone_changed=backbone_moved)
        spans = prof.get("spans", {})
        log(f"train_backbones {name} ({cfg.backbone_name}, {row['parameters'] / 1e6:.2f} M parameters, "
            f"{'frozen backbone and pixel decoder' if frozen else 'unfrozen'}, {cfg.decoder.dec_layers} decoder "
            f"layer(s), mask stride {row['mask_stride']}): per-step batch {run['micro']} x {run['grad_accum']}; "
            f"{ms:.1f} ms/step median of {[round(t, 1) for t in run['ms_all']]}, {row['images_per_s']:.2f} images/s, "
            f"peak {run['peak_gib']:.2f} GiB; busy {prof['busy_ms']} ms of one profiled step, idle share "
            f"{prof['idle_share']}; deformable sampling forward / backward busy "
            + " / ".join(f"{spans.get(sp, {}).get('busy_ms', float('nan')):.2f} ms ({spans.get(sp, {}).get('count')} "
                         f"spans)" for sp in (SPAN, BACKWARD_SPAN))
            + f"; launches {run['launches']} (Kernel E expected {expected_e}); changed parameters: backbone "
            f"{backbone_moved}, decoder {decoder_moved}, frozen {frozen_moved}; step 1 total "
            f"{run['metrics'][0]['total']:.4f}, grad_norm {run['metrics'][0]['grad_norm']:.4f}")
        bad = []
        if not finite:
            bad.append("a loss or grad_norm is not finite")
        if coco_mix and "outlier_loss" not in run["metrics"][0]:
            bad.append("no outlier_loss")
        if run["launches"]["lsap"] != expected_e or other:
            bad.append(f"launches {run['launches']}, Kernel E expected {expected_e}")
        if frozen and (frozen_moved[0] or decoder_moved[0] != decoder_moved[1]):
            bad.append(f"frozen parameters changed {frozen_moved}, decoder parameters changed {decoder_moved}")
        if not frozen and backbone_moved[0] != backbone_moved[1]:
            bad.append(f"backbone parameters changed {backbone_moved}")
        if bad:
            raise RuntimeError(f"train_backbones {name}: " + "; ".join(bad))
        if name == CLI_CONFIG:
            row["fp32"] = _fp32_kernel_vs_plain(cfg, model, batch)
            log(f"train_backbones {name}: fp32, 2 images: total with Kernel E {row['fp32']['kernel']['total']:.6f}, "
                f"with the plain LSAP {row['fp32']['plain']['total']:.6f}; largest difference {row['fp32']['max_diff']:.3e}")
        del state, step_fn, model, before
        gc.collect()
        torch.cuda.empty_cache()
        if name == CLI_CONFIG:
            row["cli"] = _trainer_cli(rel, image, run["micro"])
        row["s"] = time.perf_counter() - t_cfg
        log(f"train_backbones {name}: {row['s']:.1f} s")
        out[name] = row
        gc.collect()
        torch.cuda.empty_cache()
    out["lsap_launches"] = lsap_total
    return out


# ---------------------------------------------------------------------------
# Swin-L on the card: a seeded Detectron2 checkpoint served on both paths, and the OOD
# evaluation of StreetHazards frames through path 1
# ---------------------------------------------------------------------------

STREET_HAZARDS_FRAMES = 4  # synthetic StreetHazards test frames


def _write_street_hazards(root: Path, frames: int, seed: int = 0):
    """``frames`` StreetHazards test frames of STREET_HAZARDS_HW under ``root/street_hazards``
    (images/test/t5/*.png and annotations/test/t5/*.png, the 1-based class ids 1-13 in
    blocks and the anomaly id 14 on an ellipse)."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    h, w = STREET_HAZARDS_HW
    img_dir, ann_dir = (root / "street_hazards" / d / "test" / "t5" for d in ("images", "annotations"))
    for d in (img_dir, ann_dir):
        d.mkdir(parents=True, exist_ok=True)
    palette = rs.randint(0, 256, (15, 3))
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(frames):
        lab = (rs.randint(1, 14, (9, 16)).repeat(h // 9, 0).repeat(w // 16, 1)).astype(np.uint8)
        cy, cx, ry, rx = rs.randint(h // 3, 2 * h // 3), rs.randint(w // 4, 3 * w // 4), rs.randint(30, 90), rs.randint(40, 140)
        lab[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 14
        img = np.clip(palette[lab] + rs.randint(-25, 26, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(img_dir / f"{i:06d}.png", compress_level=1)
        Image.fromarray(lab).save(ann_dir / f"{i:06d}.png", compress_level=1)


def swin_l_phase(images):
    """``swin_l_1dl()`` at full width and depth: a seeded Detectron2 ``model_final.pth``
    (``write_d2_checkpoint``) loaded onto the card with ``load_checkpoint_params``, every
    parameter bit-equal to the CPU conversion of the same dict; ``N_REQUESTS`` 1024x2048
    requests on path 1 (A 24, B 1 each) and on path 2 (C 24, D 0: Swin-L's widths take no
    fused MLP, B 1), each path's fp32 entry against its plain kernels within 1e-3 and
    path 2's fp32 maps against path 1's; ms/image, peak memory and one profiled request
    of each (busy, idle share, busy per layer).  Then StreetHazards: STREET_HAZARDS_FRAMES
    720x1280 frames read through ``catalog.get("street_hazards_test")`` and evaluated by
    ``OODEvaluator`` through path 1 (A 24 and B 1 per frame), metrics finite.  Returns the
    measurements and the model directory."""
    from rba_tpu_torch.config import swin_l_1dl
    from rba_tpu_torch.convert import jax_params_to_state, load_checkpoint_params
    from rba_tpu_torch.convert.d2_mapping import convert_d2_state_dict
    from rba_tpu_torch.data import catalog
    from rba_tpu_torch.evalx.evaluator import OODEvaluator
    from rba_tpu_torch.kernels.fused_mlp import beneficial as fused_mlp_beneficial

    cfg = swin_l_1dl()
    cfg2 = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, mlp_impl="fused"))
    model_dir = SCRATCH / "swin_l" / "swin_l_1dl"
    shutil.rmtree(model_dir, ignore_errors=True)
    model_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    sd = write_d2_checkpoint(cfg, model_dir / "model_final.pth")
    write_s = time.perf_counter() - t0
    want = {k: torch.from_numpy(v) for k, v in jax_params_to_state(convert_d2_state_dict(sd, cfg)).items()}
    t0 = time.perf_counter()
    model = load_checkpoint_params(str(model_dir), cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    wrong = [n for n, p in params.items() if not (p.is_cuda and torch.equal(p.detach().cpu(), want[n]))]
    n_params = sum(p.numel() for p in params.values())
    log(f"swin_l: model_final.pth of {len(sd)} arrays ({n_params / 1e6:.2f} M parameters) written in {write_s:.2f} s, "
        f"converted onto the card in {load_s:.2f} s; parameters not equal to the CPU conversion: {len(wrong)}")
    if wrong or sorted(params) != sorted(want):
        raise RuntimeError(f"swin_l: parameters differ from the CPU conversion: {wrong[:5]}")
    del sd, want, params
    n_blocks = sum(cfg.swin.depths)
    if any(fused_mlp_beneficial(1024, cfg.swin.stage_dim(i)) for i in range(cfg.swin.num_layers)):
        raise RuntimeError("swin_l: the fused-MLP dispatch would take Kernel D at a Swin-L width")
    paths = [("path1", cfg, "fused", {"window_attention": n_blocks, "fused_rba_score": 1},
              {"window_attention_mma_kernel": "window_attention_kernel", "fused_rba_mma_kernel": "fused_rba_kernel",
               **KERNEL_F}),
             ("path2", cfg2, "fused_softmax", {"masked_softmax": n_blocks, "fused_rba_score": 1},
              {"masked_softmax_walk_kernel": "masked_softmax_kernel", "fused_rba_mma_kernel": "fused_rba_kernel",
               **KERNEL_F})]
    out = dict(parameters=n_params, write_s=write_s, load_convert_s=load_s)
    scores32 = {}
    for name, pcfg, attention, per_image, redesigned in paths:
        out[name], _, scores32[name] = serve_phase(f"swin_l {name}", pcfg, model, images, attention, per_image)
        out[name]["profile"] = profile_phase(f"swin_l {name}", pcfg, model, images[1], attention, redesigned)
    cross32 = max(max_abs(a, b) for a, b in zip(scores32["path1"], scores32["path2"]))
    out["paths_fp32_max_diff"] = cross32
    log(f"swin_l: score map, path 2 vs path 1: fp32 max diff {cross32:.3e} (bound {E2E_FP32_TOL:.0e}, gated)")
    if not cross32 <= E2E_FP32_TOL:
        raise RuntimeError(f"swin_l: fp32 score maps of path 2 and path 1 differ by {cross32} > {E2E_FP32_TOL}")
    del scores32

    # StreetHazards through the catalog and the OOD evaluator, path 1
    root = SCRATCH / "train"
    _write_street_hazards(root, STREET_HAZARDS_FRAMES)
    catalog.register_standard_datasets(str(root))
    ds = catalog.get("street_hazards_test")
    samples = [ds[i] for i in range(len(ds))]
    ev = OODEvaluator(cfg, model)
    ev.score_fn(samples[0].image[None])  # warm-up at the frame's size
    counts = _zero_counts()
    metrics, secs, fell_back = _eval_timed(ev.evaluate_dataset, samples, cohort=1)
    launches = counts()
    passes = 2 if fell_back else 1  # a fall-back scores every frame again on the exact path
    want_launches = dict(window_attention=n_blocks * len(samples) * passes, fused_rba_score=len(samples) * passes,
                         masked_softmax=0, fused_mlp_residual=0)
    anomaly_share = float(np.mean([(smp.label == 1).mean() for smp in samples]))
    out["street_hazards"] = dict(frames=len(samples), hw=list(samples[0].image.shape[:2]), metrics=metrics, s=secs,
                                 fell_back=fell_back, launches=launches, anomaly_pixel_share=anomaly_share)
    log(f"swin_l: StreetHazards, {len(samples)} frames of {samples[0].image.shape[:2]} through catalog "
        f"'street_hazards_test' (anomaly share {anomaly_share:.4f}), OODEvaluator path 1: {secs:.2f} s, "
        f"{'fell back to the exact path' if fell_back else 'certified streaming result'}; metrics {metrics}; "
        f"launches {launches}")
    if len(samples) != STREET_HAZARDS_FRAMES or launches != want_launches or not all(
            math.isfinite(v) for v in metrics.values() if isinstance(v, float)):
        raise RuntimeError(f"swin_l: StreetHazards: {out['street_hazards']}, launches expected {want_launches}")
    del model, ev
    return out, model_dir


# ---------------------------------------------------------------------------
# The recipes that train on other datasets than Cityscapes, through the trainer CLI
# ---------------------------------------------------------------------------

MAPILLARY_CONFIGS = Path("configs/mapillary-vistas/semantic-segmentation")
# name: (config, whether the recipe starts from the swin_l phase's checkpoint, the per-step
# batches to try, largest first).  The 1024x1024 recipes start at 4: a per-step batch of 8 ran
# out of the card's 80 GB on both (PERF.md, the train_datasets cell).
TRAIN_DATASET_RECIPES = {
    "swin_l_1dl_coco_mix": (MAPILLARY_CONFIGS / "finetuning_with_cityscapes" / "maskformer2_swin_large_1dl_coco_mix.yaml",
                            True, (8, 4, 2)),
    "coco_open_panoptic_swin_b": (COCO_CONFIG, False, (4, 2)),
    "mapillary_R50_65": (MAPILLARY_CONFIGS / "maskformer2_R50_bs16_300k.yaml", False, (4, 2)),
}
MAPILLARY_TRAIN_FRAMES = 8  # synthetic BIG_FRAME_HW Mapillary training frames
MAPILLARY_VAL_FRAMES = 2  # of MAPILLARY_EVAL_HW
COCO_TRAIN_FRAMES = 8
TRAIN_DS_WARMUP, TRAIN_DS_TIMED = 1, 3


def _write_mapillary(root: Path, split: str, frames: int, hw, seed: int):
    """``frames`` Mapillary Vistas frames of ``hw`` under ``root/mapillary_vistas/<split>``
    (images/*.jpg, labels/*.png of the 66 ids, 65 the void, in blocks)."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    h, w = hw
    img_dir, lab_dir = (root / "mapillary_vistas" / split / d for d in ("images", "labels"))
    for d in (img_dir, lab_dir):
        d.mkdir(parents=True, exist_ok=True)
    palette = rs.randint(0, 256, (66, 3)).astype(np.int16)
    blk = h // 8
    shade = ((np.arange(w)[None] + np.arange(h)[:, None]) % 64 - 32).astype(np.int16)[..., None]
    for i in range(frames):
        lab = rs.randint(0, 66, (8, -(-w // blk))).repeat(blk, 0).repeat(blk, 1)[:h, :w].astype(np.uint8)
        img = np.clip(palette[lab] + shade, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(img_dir / f"synth_{i:06d}.jpg", quality=90)
        Image.fromarray(lab).save(lab_dir / f"synth_{i:06d}.png", compress_level=1)


def _write_train_dataset_trees(root: Path):
    """Beside the train phase's Cityscapes and COCO-proxy trees: Mapillary Vistas training
    frames of BIG_FRAME_HW and validation frames of MAPILLARY_EVAL_HW, a COCO panoptic
    train2017 split and the open protocol's ``unknown/unknown_K20.txt``.  Returns the
    seconds it took."""
    from rba_tpu_torch.data.categories import OPEN_PANOPTIC_UNKNOWN_CLASSES

    t0 = time.perf_counter()
    shutil.rmtree(root / "mapillary_vistas", ignore_errors=True)
    _write_mapillary(root, "training", MAPILLARY_TRAIN_FRAMES, BIG_FRAME_HW, seed=5)
    _write_mapillary(root, "validation", MAPILLARY_VAL_FRAMES, MAPILLARY_EVAL_HW, seed=6)
    shutil.rmtree(root / "coco" / "panoptic_train2017", ignore_errors=True)
    _write_coco_panoptic(root, COCO_TRAIN_FRAMES, seed=7, split="train")
    (root / "unknown").mkdir(exist_ok=True)
    (root / "unknown" / "unknown_K20.txt").write_text("\n".join(OPEN_PANOPTIC_UNKNOWN_CLASSES) + "\n")
    return time.perf_counter() - t0


@contextlib.contextmanager
def _concat_draws():
    """Record which part of a ``ConcatDataset`` each sample read comes from."""
    from rba_tpu_torch.data.ood_datasets import ConcatDataset

    real, parts = ConcatDataset.__getitem__, []

    def recorded(self, i):
        parts.append(int(np.searchsorted(self._offsets, i, side="right")) - 1)
        return real(self, i)

    ConcatDataset.__getitem__ = recorded
    try:
        yield parts
    finally:
        ConcatDataset.__getitem__ = real


def _recipe_argv(config: Path, out: Path, micro: int, max_iter: int, weights=None):
    root = SCRATCH / "train"
    return (["--config-file", str(config), "--data-root", str(root / "cityscapes"), "--coco-root", str(root / "coco"),
             "--output-dir", str(out), "--max-iter", str(max_iter), "--batch-size", str(TRAIN_BATCH), "--grad-accum",
             str(TRAIN_BATCH // micro), "--log-period", "1", "--checkpoint-period", "0", "--seed", str(TRAIN_SEED),
             "--workers", str(min(8, os.cpu_count() or 1))] + (["--weights", str(weights)] if weights else []))


def _train_recipe(name: str, config: Path, weights, micros):
    """``train_net.main`` on one recipe for TRAIN_DS_WARMUP + TRAIN_DS_TIMED steps at the
    global batch of 8, per step the largest of ``micros`` images that fits; then one
    profiled step of the same configuration on a batch from the trainer's own iterator.
    Gates: finite metrics, the steps all logged, Kernel E launched steps x micro-batches x
    (1 + decoder layers) times and no serving kernel."""
    from rba_tpu_torch.config import load_config
    from rba_tpu_torch.ops.deform_sampling import BACKWARD_SPAN, SPAN
    from rba_tpu_torch.train import train_net
    from rba_tpu_torch.train.train_step import make_train_step

    cfg = load_config(str(config))
    counts = _wrappers(lsap=True)
    steps = TRAIN_DS_WARMUP + TRAIN_DS_TIMED
    run = None
    for micro in micros:
        out = SCRATCH / "train_datasets" / name
        shutil.rmtree(out, ignore_errors=True)
        for fn in counts.values():
            fn.launches = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            with _concat_draws() as draws:
                t0 = time.perf_counter()
                state = train_net.main(_recipe_argv(config, out, micro, steps, weights))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            log(f"train_datasets {name}: a per-step batch of {micro} does not fit ({str(e).splitlines()[0][:100]})")
            state = None
            continue
        run = dict(micro=micro, grad_accum=TRAIN_BATCH // micro, wall_s=wall_s, out=out,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches={k: fn.launches for k, fn in counts.items()}, concat_draws=list(draws))
        break
    if run is None:
        raise RuntimeError(f"train_datasets {name}: no per-step batch of {micros} fits on the card")
    lines = [json.loads(line) for line in open(run["out"] / "metrics.jsonl")]
    ms_step = [TRAIN_BATCH * 1e3 / m["imgs_per_sec"] for m in lines[TRAIN_DS_WARMUP:]]
    expected_e = len(lines) * run["grad_accum"] * _supervised_layers(cfg)
    finite = all(math.isfinite(v) for m in lines for v in m.values())
    serving = {k: v for k, v in run["launches"].items() if k != "lsap" and v}
    bad = []
    if len(lines) != steps or not finite:
        bad.append(f"{len(lines)} steps logged, finite {finite}")
    if run["launches"]["lsap"] != expected_e or serving:
        bad.append(f"launches {run['launches']}, Kernel E expected {expected_e}")
    # one profiled step on a batch of the trainer's own iterator (its mapper threads)
    args = train_net.parse_args(_recipe_argv(config, run["out"], run["micro"], 1, weights))
    t0 = time.perf_counter()
    it = train_net.data_iterator(cfg, args, TRAIN_BATCH)
    batch = next(it)
    it.close()
    first_batch_s = time.perf_counter() - t0
    step_fn = make_train_step(cfg, grad_accum=run["grad_accum"])
    step_fn(state, batch)  # the profiler's own warm-up
    _, in_memory_ms = _timed(step_fn, state, batch)
    prof = _profile(f"train_datasets {name} step", lambda: step_fn(state, batch), top=8, spans=(SPAN, BACKWARD_SPAN))
    ms = statistics.median(ms_step)
    row = dict(config=str(config), backbone=cfg.backbone_name, mapper=cfg.input.dataset_mapper_name,
               datasets_train=list(cfg.datasets_train), num_classes=cfg.num_classes, dec_layers=cfg.decoder.dec_layers,
               crop=list(cfg.input.crop_size), parameters=sum(p.numel() for p in state.model.parameters()),
               micro=run["micro"], grad_accum=run["grad_accum"], ms_per_step=ms, ms_all=ms_step,
               images_per_s=TRAIN_BATCH * 1e3 / ms, wall_s=run["wall_s"], peak_gib=run["peak_gib"],
               launches=run["launches"], expected_lsap=expected_e, first=lines[0], last=lines[-1],
               first_batch_s=first_batch_s, step_in_memory_ms=in_memory_ms, profile=prof,
               idle_share_loop=1 - prof["busy_ms"] / ms if prof["busy_ms"] else None,
               idle_share_in_memory=1 - prof["busy_ms"] / in_memory_ms if prof["busy_ms"] else None)
    spans = prof.get("spans", {})
    log(f"train_datasets {name} ({cfg.backbone_name}, {row['parameters'] / 1e6:.2f} M parameters, "
        f"{cfg.input.dataset_mapper_name} on {list(cfg.datasets_train)}, {cfg.num_classes} classes, "
        f"{cfg.decoder.dec_layers} decoder layer(s)): per-step batch {run['micro']} x {run['grad_accum']}; "
        f"{ms:.1f} ms/step median of {[round(t, 1) for t in ms_step]} in the trainer's loop, "
        f"{row['images_per_s']:.2f} images/s, peak {run['peak_gib']:.2f} GiB; one step with its batch in memory "
        f"{in_memory_ms:.1f} ms; busy {prof['busy_ms']} ms of one profiled step, idle share "
        f"{row['idle_share_in_memory']} in memory and {row['idle_share_loop']} of the loop's step; deformable "
        "sampling forward / backward busy "
        + " / ".join(f"{spans.get(sp, {}).get('busy_ms', float('nan')):.2f} ms ({spans.get(sp, {}).get('count')} spans)"
                     for sp in (SPAN, BACKWARD_SPAN))
        + f"; launches {run['launches']} (Kernel E expected {expected_e}); first batch from the trainer's iterator "
        f"{first_batch_s:.1f} s; {run['wall_s']:.1f} s for the {steps} steps (model build and mapper start included)")
    if bad:
        raise RuntimeError(f"train_datasets {name}: " + "; ".join(bad))
    return row, state, batch, run["concat_draws"]


def _eval_only(name: str, config: Path, weights, out: Path, blocks: int):
    """``train_net.main --eval-only`` from the recipe's last checkpoint on 2 val frames:
    mIoU finite, Kernel A ``blocks`` times per frame and Kernel E never."""
    from rba_tpu_torch.train import train_net

    counts = _wrappers(lsap=True)
    for fn in counts.values():
        fn.launches = 0
    argv = _recipe_argv(config, out, TRAIN_BATCH, TRAIN_DS_WARMUP + TRAIN_DS_TIMED, weights)
    res, ms = _timed(train_net.main, argv + ["--eval-only", "--eval-max-images", str(MAPILLARY_VAL_FRAMES)])
    launches = {k: fn.launches for k, fn in counts.items()}
    log(f"train_datasets {name} --eval-only: {ms / 1e3:.1f} s, mIoU {res.get('mIoU')} over "
        f"{res.get('eval_images')} frames of {MAPILLARY_EVAL_HW} (step {res.get('step')}), launches {launches}")
    want = dict(dict.fromkeys(launches, 0), window_attention=blocks * MAPILLARY_VAL_FRAMES)
    if not (math.isfinite(res.get("mIoU", float("nan"))) and res.get("eval_images") == MAPILLARY_VAL_FRAMES
            and res.get("step") == TRAIN_DS_WARMUP + TRAIN_DS_TIMED and launches == want):
        raise RuntimeError(f"train_datasets {name} --eval-only: {res}, launches {launches}, expected {want}")
    return dict(s=ms / 1e3, result=res, launches=launches)


def train_datasets_phase(swin_l_dir: Path):
    """The three recipe kinds that train on other datasets than Cityscapes, through
    ``train_net.main`` at full width and depth, TRAIN_DS_WARMUP + TRAIN_DS_TIMED steps at the
    global batch of 8 each (``_train_recipe``), over synthetic trees written beside the
    train phase's (``_write_train_dataset_trees``):

    - the Swin-L RbA fine-tune on Mapillary Vistas with Cityscapes (a ``ConcatDataset`` of
      both, COCO-mix mapper, frozen backbone and pixel decoder) from the swin_l phase's
      checkpoint: the dataset's length is the sum of its parts' and the steps draw from
      both; the frozen parameters bit for bit unchanged; Kernel E 2 per micro-batch; then
      ``--eval-only`` on ``mapillary_cityscapes_sem_seg_val`` (Kernel A 24 per frame);
    - the COCO open-panoptic Swin-B recipe (``coco_panoptic_lsj``, 1024x1024 canvas,
      ``DATASETS.UNSEEN_LABEL_SET``): no unknown class a target; Kernel E 10 per
      micro-batch; the sampling's forward and backward spans;
    - Mapillary Vistas' 65 classes on R50 (``SemSegFolder``, 1024x1024 crops from frames
      resized to a shortest edge of 1024-4096): Kernel E 10 per micro-batch; then
      ``--eval-only`` on ``mapillary_vistas_sem_seg_val``, a 65-class mIoU."""
    from rba_tpu_torch.config import load_config
    from rba_tpu_torch.convert import jax_params_to_state, load_params
    from rba_tpu_torch.data.categories import COCO_PANOPTIC_CATEGORIES, OPEN_PANOPTIC_UNKNOWN_CLASSES
    from rba_tpu_torch.train import train_net

    root = SCRATCH / "train"
    write_s = _write_train_dataset_trees(root)
    log(f"train_datasets: {MAPILLARY_TRAIN_FRAMES} Mapillary training frames of {BIG_FRAME_HW}, "
        f"{MAPILLARY_VAL_FRAMES} validation frames of {MAPILLARY_EVAL_HW} and {COCO_TRAIN_FRAMES} COCO panoptic "
        f"train frames of {COCO_HW} written in {write_s:.1f} s")
    out = dict(write_trees_s=write_s)
    lsap_total = 0
    for name, (config, from_swin_l, micros) in TRAIN_DATASET_RECIPES.items():
        t_recipe = time.perf_counter()
        weights = swin_l_dir if from_swin_l else None
        cfg = load_config(str(config))
        # the recipe's reader, as the trainer builds it (the output directory is not read)
        ds = train_net.train_dataset(cfg, train_net.parse_args(_recipe_argv(config, root, TRAIN_BATCH, 1, weights)))
        row, state, batch, draws = _train_recipe(name, config, weights, micros)
        lsap_total += row["launches"]["lsap"]
        bad = []
        if name == "swin_l_1dl_coco_mix":
            sizes = [len(p) for p in ds.parts]
            by_part = [draws.count(j) for j in range(len(sizes))]
            row.update(concat_parts=[type(p).__name__ for p in ds.parts], concat_sizes=sizes, concat_len=len(ds),
                       draws_by_part=by_part)
            start = jax_params_to_state(load_params(str(weights / "params.npz")))
            frozen = {n: p for n, p in state.model.named_parameters() if n.startswith(FROZEN)}
            moved = [n for n, p in frozen.items() if not np.array_equal(p.detach().cpu().numpy(), start[n])]
            row["frozen_changed"] = [len(moved), len(frozen)]
            log(f"train_datasets {name}: ConcatDataset {row['concat_parts']} of {sizes} samples, length {len(ds)}; "
                f"the steps' samples by part {by_part}; frozen parameters changed after the 4 steps of the CLI: "
                f"{len(moved)} of {len(frozen)}; ood_images {[m.get('ood_images') for m in [row['first'], row['last']]]}")
            if len(ds) != sum(sizes) or sizes != [MAPILLARY_TRAIN_FRAMES, TRAIN_FRAMES] or min(by_part) < 1 \
                    or sum(by_part) < (TRAIN_DS_WARMUP + TRAIN_DS_TIMED) * TRAIN_BATCH or moved or not frozen:
                bad.append(f"concat {sizes} / {len(ds)}, draws {by_part}, frozen changed {len(moved)} of {len(frozen)}")
        if name == "coco_open_panoptic_swin_b":
            unknown = {i for i, _, n, _ in COCO_PANOPTIC_CATEGORIES if n in OPEN_PANOPTIC_UNKNOWN_CLASSES}
            raw = [s for i in range(len(ds)) for s in ds.entries[i][2]]
            targets = batch["gt_labels"][batch["gt_valid"] > 0]
            row.update(unknown_segments=sum(s["category_id"] in unknown for s in raw), segments=len(raw),
                       batch_targets=int(len(targets)), batch_target_labels=sorted({int(x) for x in targets}))
            log(f"train_datasets {name}: {row['unknown_segments']} of {len(raw)} segments in the split are of the 16 "
                f"unknown classes (255 in the open metadata); the profiled batch has {len(targets)} targets, labels "
                f"{row['batch_target_labels'][:12]}..., none of them 255: {255 not in targets}")
            if 255 in targets or row["unknown_segments"] < 1 or len(targets) < 1 or targets.max() >= cfg.num_classes:
                bad.append(f"unknown classes among the targets: {row['batch_target_labels']}")
        if bad:
            raise RuntimeError(f"train_datasets {name}: " + "; ".join(bad))
        del state, batch
        gc.collect()
        torch.cuda.empty_cache()
        if name != "coco_open_panoptic_swin_b":
            blocks = sum(cfg.swin.depths) if cfg.backbone_name == "swin" else 0
            row["eval_only"] = _eval_only(name, config, weights, SCRATCH / "train_datasets" / name, blocks)
            gc.collect()
            torch.cuda.empty_cache()
        row["s"] = time.perf_counter() - t_recipe
        log(f"train_datasets {name}: {row['s']:.1f} s")
        out[name] = row
    out["lsap_launches"] = lsap_total
    return out


# ---------------------------------------------------------------------------
# The other heads (MaskFormer v1, the per-pixel baselines) and HF checkpoints
# ---------------------------------------------------------------------------

def v1_cfg(encoder_layers: int = 0):
    """MaskFormer v1 on ``swin_b_1dl()``'s backbone, at the head widths of MaskFormer's
    ``configs/ade20k-150/swin/maskformer_swin_base_IN21k_384_bs16_160k_res640.yaml``:
    ``BasePixelDecoder`` (conv_dim 256, mask_dim 256) and ``StandardTransformerDecoder``
    (hidden 256, 8 heads, FFN 2048, 6 decoder layers, 100 queries, no encoder layers, on
    res5), 19 classes.  With ``encoder_layers`` the ``TransformerEncoderPixelDecoder``
    variant: that many DETR encoder layers on res5, the decoder on their output."""
    from rba_tpu_torch.config import swin_b_1dl

    base = swin_b_1dl()
    enc = encoder_layers > 0
    return dataclasses.replace(
        base,
        pixel_decoder=dataclasses.replace(base.pixel_decoder, name="TransformerEncoderPixelDecoder" if enc else
                                          "BasePixelDecoder", conv_dim=256, mask_dim=256,
                                          transformer_enc_layers=encoder_layers),
        decoder=dataclasses.replace(base.decoder, name="StandardTransformerDecoder", hidden_dim=256, nheads=8,
                                    dim_feedforward=2048, dec_layers_total=6, enc_layers=0, num_queries=100,
                                    transformer_in_feature="transformer_encoder" if enc else "res5"))


def per_pixel_cfg(plus: bool):
    """A per-pixel baseline on ``swin_b_1dl()``'s backbone, at the head widths of MaskFormer's
    ``configs/ade20k-150/per_pixel_baseline_R50_bs16_160k.yaml`` (``PerPixelBaselineHead``,
    ``BasePixelDecoder``, conv_dim 256, mask_dim 256) and
    ``per_pixel_baseline_plus_R50_bs16_160k.yaml`` (``PerPixelBaselinePlusHead`` on the
    ``TransformerEncoderPixelDecoder``, 6 encoder and 6 decoder layers, hidden 256, FFN 2048,
    one query per class, on the encoder's output), 19 classes."""
    from rba_tpu_torch.config import swin_b_1dl

    base = swin_b_1dl()
    pd = dataclasses.replace(base.pixel_decoder, name="TransformerEncoderPixelDecoder" if plus else "BasePixelDecoder",
                             conv_dim=256, mask_dim=256, transformer_enc_layers=6)
    dec = dataclasses.replace(base.decoder, name="StandardTransformerDecoder", hidden_dim=256, nheads=8,
                              dim_feedforward=2048, dec_layers_total=6, enc_layers=0, num_queries=base.num_classes,
                              transformer_in_feature="transformer_encoder")
    return dataclasses.replace(base, sem_seg_head_name="PerPixelBaselinePlusHead" if plus else "PerPixelBaselineHead",
                               pixel_decoder=pd, decoder=dec)


def _supervised_layers(cfg) -> int:
    """The layers that the criterion matches, each once per micro-batch (Kernel E once per
    layer): none for a per-pixel head, the last output alone for the simple decoder or
    without deep supervision, else each of the v1 decoder's layers, or the masked
    decoder's layers and its queries before the first."""
    if cfg.sem_seg_head_name != "MaskFormerHead":
        return 0
    if cfg.decoder.name in ("SimpleDecoder", "SimpleTransformerDecoder") or not cfg.loss.deep_supervision:
        return 1
    if cfg.decoder.name == "StandardTransformerDecoder":
        return cfg.decoder.dec_layers_total
    return 1 + cfg.decoder.dec_layers


def _head_model(name: str, cfg, seed: int = 0):
    """A seeded full-width Detectron2 ``model_final.pth`` of ``cfg`` under ``SCRATCH/heads``
    loaded onto the card with ``load_checkpoint_params``: every parameter bit-equal to the
    same dict converted on the CPU (which the CPU tests hold against rba_tpu's conversion)."""
    from rba_tpu_torch.convert import jax_params_to_state, load_checkpoint_params
    from rba_tpu_torch.convert.d2_mapping import convert_d2_state_dict

    model_dir = SCRATCH / "heads" / name
    shutil.rmtree(model_dir, ignore_errors=True)
    model_dir.mkdir(parents=True)
    sd = write_d2_checkpoint(cfg, model_dir / "model_final.pth", seed=seed)
    want = {k: torch.from_numpy(v) for k, v in jax_params_to_state(convert_d2_state_dict(sd, cfg)).items()}
    t0 = time.perf_counter()
    model = load_checkpoint_params(str(model_dir), cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    wrong = [n for n, p in params.items() if not (p.is_cuda and torch.equal(p.detach().cpu(), want[n]))]
    log(f"heads {name}: model_final.pth of {len(sd)} arrays, {sum(v.numel() for v in want.values()) / 1e6:.2f} M "
        f"parameters, converted onto the card in {load_s:.2f} s; parameters not equal to the CPU conversion: "
        f"{len(wrong)}")
    if wrong or sorted(params) != sorted(want):
        raise RuntimeError(f"heads {name}: parameters differ from the CPU conversion: {wrong[:5]}")
    return model, model_dir


def _fp32_against_infer(name, cfg, model, image, attention):
    """At fp32 the entry (kernels) against its plain version and against
    ``maskformer_infer(...)["rba"]``, within E2E_FP32_TOL."""
    from rba_tpu_torch.models.maskformer import maskformer_infer, maskformer_infer_rba

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    got = maskformer_infer_rba(model, cfg32, image, attention=attention)
    with _plain():
        plain = maskformer_infer_rba(model, cfg32, image, attention=attention)
        full = maskformer_infer(model, cfg32, image, attention=attention)["rba"]
    errs = dict(vs_plain=max_abs(got, plain), vs_maskformer_infer=max_abs(got, full))
    log(f"heads {name} at fp32: the entry vs its plain version {errs['vs_plain']:.3e}, vs maskformer_infer "
        f"{errs['vs_maskformer_infer']:.3e} (bound {E2E_FP32_TOL:.0e}, gated)")
    if not max(errs.values()) <= E2E_FP32_TOL:
        raise RuntimeError(f"heads {name}: fp32 score maps differ: {errs}")
    return errs


def _train_head(name: str, cfg, model_dir: Path):
    """``train_net.main`` on ``cfg`` (a native YAML under SCRATCH) from the head's seeded
    checkpoint over the train phase's Cityscapes trees (``_train_recipe``); every
    parameter with a learning rate changed."""
    from rba_tpu_torch.config import save_config
    from rba_tpu_torch.convert import load_checkpoint_params

    path = SCRATCH / "heads" / f"{name}.yaml"
    save_config(str(path), cfg)
    row, state, _, _ = _train_recipe(f"heads_{name}", path, model_dir, micros=(8, 4, 2))
    start = dict(load_checkpoint_params(str(model_dir), cfg).named_parameters())
    changed, total = _changed(state.model, {n: p.detach() for n, p in start.items()}, ("",))
    row.update(parameters_changed=changed, parameters_total=total)
    finite = all(math.isfinite(v) for v in row["last"].values())
    log(f"heads {name} training: {changed} of {total} parameters changed; last losses finite: {finite}")
    if changed != total or not finite:
        raise RuntimeError(f"heads {name}: {changed} of {total} parameters changed, finite {finite}")
    del state, start
    gc.collect()
    torch.cuda.empty_cache()
    return row


def heads_phase(images):
    """The other heads on ``swin_b_1dl()``'s backbone at full width and depth, 1024x2048
    requests: MaskFormer v1 (``v1_cfg``) from a seeded Detectron2 checkpoint on path 1
    (A 24, B 1 per request) and path 2 (C 24, D 4, B 1), at fp32 against the plain
    versions, against ``maskformer_infer(...)["rba"]`` and path 2 against path 1; the
    ``TransformerEncoderPixelDecoder`` variant (6 encoder layers on res5) for one request;
    ``PerPixelBaselineHead`` and ``PerPixelBaselinePlusHead`` (``per_pixel_cfg``) through
    ``maskformer_infer_rba`` (A 24, B 0); one profiled request of each.  Then
    ``train_net.main`` on the v1 model (Kernel E in the matcher) and on the Plus head (no
    matcher): 512x1024 crops at batch 8, 1 + 3 steps."""
    from rba_tpu_torch.config import load_d2_config

    n_blocks = 24
    path1 = {"window_attention_mma_kernel": "window_attention_kernel", "fused_rba_mma_kernel": "fused_rba_kernel"}
    out = {}
    cfg = v1_cfg()
    cfg2 = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, mlp_impl="fused"))
    model, v1_dir = _head_model("v1", cfg)
    scores32 = {}
    for name, pcfg, attention, per_image, redesigned in (
            ("path1", cfg, "fused", {"window_attention": n_blocks, "fused_rba_score": 1}, path1),
            ("path2", cfg2, "fused_softmax", {"masked_softmax": n_blocks, "fused_mlp_residual": 4, "fused_rba_score": 1},
             {"fused_mlp_mma_kernel": "fused_mlp_kernel", "masked_softmax_walk_kernel": "masked_softmax_kernel",
              "fused_rba_mma_kernel": "fused_rba_kernel"})):
        row, _, scores32[name] = serve_phase(f"heads v1 {name}", pcfg, model, images, attention, per_image)
        row["profile"] = profile_phase(f"heads v1 {name}", pcfg, model, images[1], attention, redesigned)
        row["fp32"] = _fp32_against_infer(f"v1 {name}", pcfg, model, images[1], attention)
        out[f"v1_{name}"] = row
    cross32 = max(max_abs(a, b) for a, b in zip(scores32["path1"], scores32["path2"]))
    out["v1_paths_fp32_max_diff"] = cross32
    log(f"heads v1: score map, path 2 vs path 1: fp32 max diff {cross32:.3e} (bound {E2E_FP32_TOL:.0e}, gated)")
    if not cross32 <= E2E_FP32_TOL:
        raise RuntimeError(f"heads v1: fp32 score maps of path 2 and path 1 differ by {cross32}")
    del model, scores32
    gc.collect()

    # the encoder variant: one request, its launches, fp32 against the plain version
    from rba_tpu_torch.models.maskformer import build_model, maskformer_infer_rba

    ecfg = v1_cfg(encoder_layers=6)
    model = build_model(ecfg, seed=0)
    maskformer_infer_rba(model, ecfg, images[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts(lsap=True)
    rba, ms = _timed(maskformer_infer_rba, model, ecfg, images[1])
    launches = counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ok = bool(torch.isfinite(rba).all()) and tuple(rba.shape) == (1, *IMAGE_HW)
    row = dict(launches=launches, ms=ms, peak_gib=peak_gib, ok=ok, profile=profile_phase("heads v1 encoder", ecfg, model, images[1],
                                                                       "fused", path1))
    row["fp32"] = _fp32_against_infer("v1 encoder", ecfg, model, images[1], "fused")
    log(f"heads v1 with the TransformerEncoderPixelDecoder (6 encoder layers): one request {ms:.2f} ms, launches "
        f"{launches}, peak memory {peak_gib:.2f} GiB, finite and of the frame's shape: {ok}")
    if not ok or launches != dict(dict.fromkeys(launches, 0), window_attention=n_blocks, fused_rba_score=1):
        raise RuntimeError(f"heads v1 encoder: {row}")
    out["v1_encoder"] = row
    del model
    gc.collect()

    pp_dirs = {}
    for name, plus in (("per_pixel", False), ("per_pixel_plus", True)):
        pcfg = per_pixel_cfg(plus)
        model, pp_dirs[name] = _head_model(name, pcfg)
        row, _, _ = serve_phase(f"heads {name}", pcfg, model, images, "fused", {"window_attention": n_blocks})
        row["profile"] = profile_phase(f"heads {name}", pcfg, model, images[1], "fused",
                                       {"window_attention_mma_kernel": "window_attention_kernel"})
        row["fp32"] = _fp32_against_infer(name, pcfg, model, images[1], "fused")
        out[name] = row
        del model
        gc.collect()
    torch.cuda.empty_cache()

    # training: the train phase's Cityscapes trees, the released config's solver and mapper
    base = load_d2_config(str(D2_CONFIG))
    for name, hcfg, model_dir in (("v1", cfg, v1_dir), ("per_pixel_plus", per_pixel_cfg(True), pp_dirs["per_pixel_plus"])):
        tcfg = dataclasses.replace(base, sem_seg_head_name=hcfg.sem_seg_head_name, pixel_decoder=hcfg.pixel_decoder,
                                   decoder=hcfg.decoder)
        out[f"train_{name}"] = _train_head(name, tcfg, model_dir)
    if not out["train_v1"]["launches"]["lsap"] or out["train_per_pixel_plus"]["launches"]["lsap"]:
        raise RuntimeError("heads: Kernel E must run in the v1 step and not in the Plus step")
    return out


def hf_phase(images):
    """A full-width HF-named state dict of ``facebook/mask2former-swin-base-IN21k-cityscapes-semantic``'s
    architecture (``tests/d2_synthetic.py``'s ``hf_cityscapes_cfg``: Swin-B, three
    deformable levels, 9 decoder layers, 19 classes): a seeded Detectron2 dict renamed to
    HF's names (its ``d2_to_hf_names``, held on the CPU against HF's own model),
    converted by ``convert_hf_checkpoint(sd, cfg)`` onto the card: every parameter equal
    to the same dict loaded under Detectron2 names; 4 + 1 requests on path 1 (A 24, B 1),
    fp32 against the plain versions, and every score map equal to the Detectron2-loaded
    model's."""
    from rba_tpu_torch.convert import jax_params_to_state, load_jax_params
    from rba_tpu_torch.convert.d2_mapping import convert_d2_state_dict
    from rba_tpu_torch.convert.hf_mapping import convert_hf_checkpoint
    from rba_tpu_torch.config import swin_b_1dl
    from rba_tpu_torch.models.maskformer import build_model, maskformer_infer_rba
    from tests.d2_synthetic import d2_state_dict, d2_to_hf_names, hf_cityscapes_cfg

    cfg = hf_cityscapes_cfg(swin_b_1dl())
    sd = d2_state_dict(cfg, 5, pre_rename=False)
    hf_sd = {k: torch.from_numpy(v) for k, v in d2_to_hf_names(sd).items()}
    t0 = time.perf_counter()
    params, _ = convert_hf_checkpoint(hf_sd, cfg)
    model = load_jax_params(build_model(cfg, seed=1), params)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    via_d2 = load_jax_params(build_model(cfg, seed=2), convert_d2_state_dict(sd, cfg))
    want = jax_params_to_state(convert_d2_state_dict(sd, cfg))
    d2_params = dict(via_d2.named_parameters())
    wrong = [n for n, p in model.named_parameters() if not torch.equal(p, d2_params[n])]
    log(f"hf: {len(hf_sd)} HF-named arrays ({sum(v.numel() for v in hf_sd.values()) / 1e6:.2f} M values) converted "
        f"by convert_hf_checkpoint onto the card in {convert_s:.2f} s; parameters not equal to the same weights "
        f"loaded under Detectron2 names: {len(wrong)} of {len(d2_params)}")
    if wrong or sorted(d2_params) != sorted(want):
        raise RuntimeError(f"hf: parameters differ from the Detectron2-loaded model's: {wrong[:5]}")
    row, scores, _ = serve_phase("hf path1", cfg, model, images, "fused", {"window_attention": 24, "fused_rba_score": 1})
    row["profile"] = profile_phase("hf path1", cfg, model, images[1], "fused",
                                   {"window_attention_mma_kernel": "window_attention_kernel",
                                    "fused_rba_mma_kernel": "fused_rba_kernel"})
    same = [torch.equal(s, maskformer_infer_rba(via_d2, cfg, images[i + 1])) for i, s in enumerate(scores)]
    row.update(hf_arrays=len(hf_sd), convert_s=convert_s, equal_to_d2_model=same)
    log(f"hf: score maps equal to the Detectron2-loaded model's: {same}")
    if not all(same):
        raise RuntimeError("hf: the HF-ingested model's score maps differ from the Detectron2-loaded model's")
    del model, via_d2
    gc.collect()
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# The last slice: several GPUs (data parallelism on an NCCL group, the sharded
# evaluation), int8 weights, and the tools
# ---------------------------------------------------------------------------

PARALLEL_WARMUP, PARALLEL_TIMED = 1, 3  # steps of the data-parallel fine-tune
LOSS_EQ_TOL = 1e-6  # the 1-rank step's losses against the single-process step's, relative


def _loss_reductions(cfg, micro: int) -> int:
    """The criterion's batch all-reduces of one step: per micro-batch one for num_masks
    and one per loss term of each supervised layer (labels, masks, and each OOD term that
    the config turns on), and one per extra whole-output loss."""
    terms = 2 + cfg.ood.outlier_supervision + cfg.ood.smoothness_loss + cfg.ood.sparsity_loss
    extra = cfg.ood.gambler_loss + cfg.ood.densehybrid_loss * 2
    return micro * (1 + _supervised_layers(cfg) * terms + extra)


def parallel_phase(train: dict):
    """Data parallelism on an NCCL group that this process forms through
    ``parallel/mesh.py`` (``init_distributed``: one rank per card, here the card count),
    then, in that group, ``train_net.main`` on the train phase's recipe and trees (the
    Swin-B 1dl COCO outlier fine-tune from the seeded Detectron2 checkpoint, global batch
    8, 1 + 3 steps at the train phase's per-step batch) and ``evaluate_dataset_sharded``
    over the eval phase's 8 scenes.  Gates: the group is NCCL at the card count; the
    port's counts of its loss and gradient all-reduces per step; Kernel E 2 per
    micro-batch; the first step's losses equal the single-process step's (train phase,
    same batch) within 1e-6; the sharded histograms equal the evaluator's, with A 24 and
    B 1 per image.  Reported: ms/step, busy, idle share, peak memory, NCCL kernels' time."""
    import torch.distributed as dist

    from rba_tpu_torch.config import load_d2_config, swin_b_1dl
    from rba_tpu_torch.evalx.evaluator import make_score_fn
    from rba_tpu_torch.evalx.metrics import StreamingOODMetrics, metrics_from_histograms
    from rba_tpu_torch.models.maskformer import build_model
    from rba_tpu_torch.parallel import mesh as pmesh
    from rba_tpu_torch.parallel.sharded_eval import sharded_histograms
    from rba_tpu_torch.train import train_net
    from rba_tpu_torch.train.train_step import grad_buckets, make_train_step

    root = SCRATCH / "train"
    weights = root / "weights"
    cfg = load_d2_config(str(OOD_CONFIG))
    t0 = time.perf_counter()
    pmesh.init_distributed("cuda")
    group = dict(backend=dist.get_backend(), world=dist.get_world_size(), cards=torch.cuda.device_count(),
                 form_s=time.perf_counter() - t0)
    log(f"parallel: process group formed in {group['form_s']:.2f} s: backend {group['backend']}, world size "
        f"{group['world']}, cards {group['cards']}")
    if group["backend"] != "nccl" or group["world"] != group["cards"]:
        raise RuntimeError(f"parallel: the group is {group}, not NCCL at the card count")
    try:
        micro = train["micro"]
        accum = TRAIN_BATCH // micro
        out = root / "out_parallel"
        shutil.rmtree(out, ignore_errors=True)
        counts = _wrappers(lsap=True)
        for fn in counts.values():
            fn.launches = 0
        pmesh.reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        steps = PARALLEL_WARMUP + PARALLEL_TIMED
        state, wall_ms = _timed(train_net.main, _train_args(root, weights, out, micro, steps))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches = {k: fn.launches for k, fn in counts.items()}
        reduces = dict(pmesh.COUNTS)
        lines = [json.loads(line) for line in open(out / "metrics.jsonl")]
        buckets = len(grad_buckets(list(state.model.parameters())))
        want_reduces = {"loss": steps * _loss_reductions(cfg, accum), "grad": steps * buckets, "model": 0}
        want_e = steps * accum * _supervised_layers(cfg)
        first, single = lines[0], train["first"]
        loss_keys = [k for k in single if k not in ("step", "imgs_per_sec", "grad_norm", "ood_images")]
        loss_err = max(abs(first[k] - single[k]) / max(1.0, abs(single[k])) for k in loss_keys)
        ms_step = [TRAIN_BATCH * 1e3 / m["imgs_per_sec"] for m in lines[PARALLEL_WARMUP:]]
        log(f"parallel: train_net on the group: {len(lines)} steps at per-step batch {micro} x --grad-accum {accum} "
            f"in {wall_ms / 1e3:.1f} s (model load and mapper start included); timed steps "
            f"{statistics.median(ms_step):.1f} ms/step median ({[round(v, 1) for v in ms_step]}); peak memory "
            f"{peak_gib:.2f} GiB; all-reduces {reduces} (expected {want_reduces}: {buckets} gradient buckets); "
            f"launches {launches} (Kernel E expected {want_e}); first step's losses vs the single-process step's: "
            f"largest relative difference {loss_err:.3e} over {len(loss_keys)} losses (bound {LOSS_EQ_TOL:.0e})")
        serving = {k: v for k, v in launches.items() if k != "lsap" and v}
        if (reduces != want_reduces or launches["lsap"] != want_e or serving or not loss_err <= LOSS_EQ_TOL
                or len(lines) != steps or not all(math.isfinite(v) for m in lines for v in m.values())):
            raise RuntimeError(f"parallel: all-reduces {reduces} (expected {want_reduces}), launches {launches} "
                               f"(Kernel E {want_e}), loss difference {loss_err}, {len(lines)} steps")

        # one profiled data-parallel step on a batch mapped in this thread, as the train phase profiles its step
        mesh = pmesh.make_mesh()
        args = train_net.parse_args(_train_args(root, weights, out, micro, 1))
        batch, _ = _mapped_batch(cfg, args)
        step_fn = make_train_step(cfg, grad_accum=accum, mesh=mesh)
        step_fn(state, batch)
        _, step_ms = _timed(step_fn, state, batch)
        prof = _profile("parallel train step", lambda: step_fn(state, batch), top=10)
        nccl_ms = prof["nccl_ms"]
        prof["idle_share_unprofiled"] = 1 - prof["busy_ms"] / step_ms if prof["busy_ms"] else None
        log(f"parallel: one step with its batch in host memory {step_ms:.1f} ms (profiler off), device busy "
            f"{prof['busy_ms']} ms, idle share {prof['idle_share_unprofiled']}; NCCL kernels {nccl_ms:.3f} ms")
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # the sharded evaluation against the evaluator's histograms
        scfg = swin_b_1dl()
        model = build_model(scfg, seed=0)
        samples, _ = make_scenes()
        score = make_score_fn(scfg, model)
        ref = StreamingOODMetrics()
        for s in samples:
            ref.update(score(s.image[None])[0], s.label.astype(np.uint8))
        ref_pos, ref_neg = ref._host_counts()
        zero = _zero_counts()
        (pos, neg), eval_ms = _timed(sharded_histograms, scfg, model, samples, mesh)
        eval_launches = zero()
        equal = bool(np.array_equal(pos, ref_pos) and np.array_equal(neg, ref_neg))
        m = metrics_from_histograms(pos, neg)
        want_eval = {"window_attention": EVAL_IMAGES * sum(scfg.swin.depths), "fused_rba_score": EVAL_IMAGES}
        log(f"parallel: evaluate_dataset_sharded's histograms over {EVAL_IMAGES} scenes on {mesh.data_size} data "
            f"rank(s) in {eval_ms:.1f} ms: equal to the evaluator's {equal} ({int(pos.sum())} + {int(neg.sum())} "
            f"pixels); AUROC {m['AUROC']:.6f}, AUPRC {m['AUPRC']:.6f}, FPR95 {m['FPR@95TPR']:.6f}; launches "
            f"{eval_launches}")
        if not equal or any(eval_launches[k] != v for k, v in want_eval.items()):
            raise RuntimeError(f"parallel: sharded histograms equal {equal}, launches {eval_launches} "
                               f"(expected {want_eval})")
        del model
    finally:
        dist.destroy_process_group()
    return dict(group=group, micro=micro, grad_accum=accum, steps=len(lines), wall_s=wall_ms / 1e3,
                ms_per_step=statistics.median(ms_step), ms_per_step_all=ms_step, peak_gib=peak_gib,
                all_reduces=reduces, all_reduces_expected=want_reduces, grad_buckets=buckets, launches=launches,
                first=first, first_loss_max_rel_diff=loss_err, step_in_memory_ms=step_ms, profile=prof,
                nccl_ms=nccl_ms, eval=dict(ms=eval_ms, launches=eval_launches, equal=equal,
                                           metrics={k: m[k] for k in ("AUROC", "AUPRC", "FPR@95TPR")}))


def int8_phase(images):
    """``swin_b_1dl()`` with int8 weights (``quantize_params_int8`` by each path's
    config): 4 + 1 requests at 1024x2048 on path 1 (A 24 + B 1) and path 2 (C 24 + D 4 +
    B 1, D on the fp fc1 / fc2 that the fused MLP's skip rule keeps), each kernel against
    its plain version at fp32 within 1e-3 (``serve_phase``), and path 2 against path 1 on
    one int8 model at fp32 within 1e-3.  Reported: ``count_quantized``, busy, peak
    memory, the weights' bytes against the fp model's, the score map's largest
    difference from the fp weights' map."""
    from rba_tpu_torch.config import swin_b_1dl
    from rba_tpu_torch.models.maskformer import build_model, maskformer_infer_rba
    from rba_tpu_torch.ops.quant import count_quantized, quantize_params_int8, weight_bytes

    cfg = dataclasses.replace(swin_b_1dl(), weight_quant="int8")
    cfg2 = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, mlp_impl="fused"))
    fp = build_model(cfg, seed=0)
    n_blocks = sum(cfg.swin.depths)
    d_blocks = sum(d for i, d in enumerate(cfg.swin.depths) if cfg.swin.stage_dim(i) <= 256)
    out = dict(fp_bytes=weight_bytes(fp))
    q = {}
    enc_layers = cfg.pixel_decoder.transformer_enc_layers
    for name, pcfg, attention, per_image, redesigned in (
            ("path1", cfg, "fused", {"window_attention": n_blocks, "fused_rba_score": 1, "ms_deform_attn": enc_layers},
             {"window_attention_mma_kernel": "window_attention_kernel", "fused_rba_mma_kernel": "fused_rba_kernel",
              **KERNEL_F}),
            ("path2", cfg2, "fused_softmax",
             {"masked_softmax": n_blocks, "fused_mlp_residual": d_blocks, "fused_rba_score": 1,
              "ms_deform_attn": enc_layers},
             {"fused_mlp_mma_kernel": "fused_mlp_kernel", "masked_softmax_walk_kernel": "masked_softmax_kernel",
              "fused_rba_mma_kernel": "fused_rba_kernel", **KERNEL_F})):
        q[name] = quantize_params_int8(fp, cfg=pcfg)
        stats = count_quantized(q[name])
        serve, scores, _ = serve_phase(f"int8 {name}", pcfg, q[name], images, attention, per_image)
        prof = profile_phase(f"int8 {name}", pcfg, q[name], images[1], attention, redesigned)
        with torch.inference_mode():
            fp_map = maskformer_infer_rba(fp, pcfg, images[1], attention=attention)
        diff = max_abs(scores[0], fp_map)
        out[name] = dict(count_quantized=stats, weight_bytes=weight_bytes(q[name]), serve=serve, profile=prof,
                         max_diff_from_fp_weights=diff, launches=serve["launches"])
        log(f"int8 {name}: count_quantized {stats}; weights {out[name]['weight_bytes'] / 2**20:.1f} MiB against the "
            f"fp model's {out['fp_bytes'] / 2**20:.1f} MiB; device busy {prof['busy_ms']} ms per request, peak "
            f"memory {serve['peak_gib']:.2f} GiB; score map vs the fp weights' map: max diff {diff:.4e}")
    # path 2 against path 1 on one int8 model (path 2's: fc1 and fc2 fp in both) at fp32
    cfg32, cfg2_32 = (dataclasses.replace(c, compute_dtype="float32") for c in (cfg, cfg2))
    with torch.inference_mode():
        cross = max(max_abs(maskformer_infer_rba(q["path2"], cfg32, images[i], attention="fused"),
                            maskformer_infer_rba(q["path2"], cfg2_32, images[i], attention="fused_softmax"))
                    for i in range(1, N_REQUESTS + 1))
    out["paths_fp32_max_diff"] = cross
    log(f"int8: path 2 vs path 1 on one int8 model at fp32: max diff {cross:.3e} (bound {E2E_FP32_TOL:.0e}, gated)")
    if not cross <= E2E_FP32_TOL:
        raise RuntimeError(f"int8: path 2 and path 1 differ by {cross} > {E2E_FP32_TOL}")
    del fp, q
    return out


def tools_phase(images, pth: Path):
    """The tools on the card: ``analyze_model`` on swin_b_1dl at 1024x2048 (its parameter
    count equal to the d2 phase's Detectron2-loaded model's), ``selfcheck`` at the full
    swin_b_1dl architecture at 128x256 with the port on the card (max score delta <=
    1e-3), ``ablation`` on 2 images for parity, fast and fast_int8 (the torch reference
    on the CPU, as the selfcheck's), and ``device_trace`` of one path-1 request."""
    from rba_tpu_torch.config import load_d2_config
    from rba_tpu_torch.convert import load_checkpoint_params
    from rba_tpu_torch.models.maskformer import build_model, maskformer_infer_rba
    from rba_tpu_torch.tools import ablation, analyze_model, selfcheck
    from rba_tpu_torch.utils.profiling import device_trace

    work = SCRATCH / "tools"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg_path = pth.parent / "config.yaml"
    cfg = load_d2_config(str(cfg_path))
    d2_params = sum(p.numel() for p in load_checkpoint_params(str(pth.parent), cfg).parameters())
    zero = _zero_counts()
    analysis, analyze_ms = _timed(analyze_model.main, ["--config-file", str(cfg_path), "--tasks", "parameter", "flop",
                                                       "activation", "memory", "--height", str(IMAGE_HW[0]),
                                                       "--width", str(IMAGE_HW[1])])
    total = analysis["parameter"][""]
    log(f"tools: analyze_model on {cfg_path.name} at {IMAGE_HW[0]}x{IMAGE_HW[1]} in {analyze_ms / 1e3:.1f} s: "
        f"{total / 1e6:.2f} M parameters (the d2 phase's model: {d2_params / 1e6:.2f} M), dot + conv FLOPs "
        f"{ {k: round(v / 1e9, 2) for k, v in analysis['flop'].items()} } G on the \"xla\" branch, activations "
        f"{analysis['activation']:.1f} M, memory {analysis['memory']} MB; launches {zero()}")
    if total != d2_params:
        raise RuntimeError(f"tools: analyze_model counts {total} parameters, the d2 phase's model {d2_params}")

    check, check_ms = _timed(selfcheck.run_selfcheck, str(work / "selfcheck"), "swin_b_1dl", 2, SELFCHECK_HW)
    log(f"tools: selfcheck at the swin_b_1dl architecture, 2 images of {SELFCHECK_HW[0]}x{SELFCHECK_HW[1]}, the port "
        f"on {check['device']}: max "
        f"score delta {check['max_score_delta']:.3e} (bound {check['tolerance']:.0e}) in {check_ms / 1e3:.1f} s")
    if not (check["pass"] and check["max_score_delta"] <= E2E_FP32_TOL and check["device"].startswith("cuda")):
        raise RuntimeError(f"tools: selfcheck {check}")

    abl, abl_ms = _timed(ablation.main, ["--images", "2", "--hw", "x".join(map(str, ABLATION_HW)), "--modes",
                                         "parity,fast,fast_int8", "--workdir", str(work / "ablation")])
    log(f"tools: ablation (2 images of {ABLATION_HW[0]}x{ABLATION_HW[1]}, parity / fast / fast_int8; the fp32 torch "
        f"model on the CPU) in {abl_ms / 1e3:.1f} s: " + "; ".join(
        f"{k} AUROC {v['exact']['auroc']:.4f} score delta max {v['score_map_max_abs_delta']:.4f} mean "
        f"{v['score_map_mean_abs_delta']:.2e}" for k, v in abl["results"].items() if k != "reference_torch_fp32")
        + f" (bounds {ABLATION_SCORE_TOL}, gated)")
    if set(abl["results"]) != {"reference_torch_fp32", "parity", "fast", "fast_int8"}:
        raise RuntimeError(f"tools: ablation modes {sorted(abl['results'])}")
    for k, v in abl["results"].items():
        if k != "reference_torch_fp32" and not (v["score_map_max_abs_delta"] <= ABLATION_SCORE_TOL[0]
                                                and v["score_map_mean_abs_delta"] <= ABLATION_SCORE_TOL[1]):
            raise RuntimeError(f"tools: ablation {k}'s scores are off the fp32 torch model's: {v}")

    model = build_model(cfg, seed=0)
    maskformer_infer_rba(model, cfg, images[1])
    with device_trace(str(work / "trace")) as prof:
        maskformer_infer_rba(model, cfg, images[1])
    trace = work / "trace" / "trace.json"
    device_ms = sum(r[1] for r in _device_kernels(prof))
    log(f"tools: device_trace of one path-1 request: {trace.stat().st_size / 2**20:.1f} MiB of trace, device time "
        f"{device_ms:.2f} ms")
    if not trace.exists() or not device_ms > 0:
        raise RuntimeError("tools: device_trace wrote no trace with device time")
    del model
    return dict(parameters=total, d2_parameters=d2_params, flops=analysis["flop"],
                activations_m=analysis["activation"], memory_mb=analysis["memory"], selfcheck=check,
                ablation=abl["results"], trace_mib=trace.stat().st_size / 2**20, trace_device_ms=device_ms)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, help="directory for chip_smoke.json, the run's measurements")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    smi = _smi("name,power.limit")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from rba_tpu_torch.config import swin_b_1dl, swin_l_1dl
    from rba_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s (nvcc, in parallel)")

    cfg = swin_b_1dl()
    cfg2 = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, mlp_impl="fused"))
    cfg_l = swin_l_1dl()
    gen = torch.Generator(device="cuda").manual_seed(0)
    wa_rows, wa, wa_err, wa_checked, wa_l = window_attention_phase(cfg, gen, cfg_l)
    rba_row = fused_rba_phase(cfg, gen)
    ms_rows, ms, ms_err = masked_softmax_phase(cfg, gen)
    ms_rows_l, ms_l, ms_err_l = masked_softmax_phase(cfg_l, gen)
    mlp_rows, mlp, mlp_err = fused_mlp_phase(gen)
    lsap_rows = lsap_phase(gen)
    mda_rows = ms_deform_attn_phase(gen)
    sr_rows = sr_attention_phase(gen)
    rel_rows = rel_pos_attention_phase(gen)

    from rba_tpu_torch.models.maskformer import build_model

    images = torch.randint(0, 256, (N_REQUESTS + 1, 1, *IMAGE_HW, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    serve, prof = {}, {}
    scores, scores32 = {}, {}
    n_blocks = sum(cfg.swin.depths)
    fused_mlp_blocks = sum(d for i, d in enumerate(cfg.swin.depths) if cfg.swin.stage_dim(i) <= 256)
    enc_layers = cfg.pixel_decoder.transformer_enc_layers
    paths = [
        ("path1", cfg, "fused", {"window_attention": n_blocks, "fused_rba_score": 1, "ms_deform_attn": enc_layers},
         {"window_attention_mma_kernel": "window_attention_kernel", "fused_rba_mma_kernel": "fused_rba_kernel",
          **KERNEL_F}),
        ("path2", cfg2, "fused_softmax",
         {"masked_softmax": n_blocks, "fused_mlp_residual": fused_mlp_blocks, "fused_rba_score": 1,
          "ms_deform_attn": enc_layers},
         {"fused_mlp_mma_kernel": "fused_mlp_kernel", "masked_softmax_walk_kernel": "masked_softmax_kernel",
          "fused_rba_mma_kernel": "fused_rba_kernel", **KERNEL_F}),
    ]
    for name, pcfg, attention, per_image, redesigned in paths:
        t0 = time.perf_counter()
        model = build_model(pcfg, seed=0)
        torch.cuda.synchronize()
        log(f"build_model(swin_b_1dl, mlp_impl={pcfg.swin.mlp_impl!r}) on the card: {time.perf_counter() - t0:.2f} s")
        serve[name], scores[name], scores32[name] = serve_phase(name, pcfg, model, images, attention, per_image)
        prof[name] = profile_phase(name, pcfg, model, images[1], attention, redesigned)
        del model

    # the two paths compute one function on the same seeded weights
    cross32 = max(max_abs(a, b) for a, b in zip(scores32["path1"], scores32["path2"]))
    cross16 = max(max_abs(a, b) for a, b in zip(scores["path1"], scores["path2"]))
    log(f"score map, path 2 vs path 1: fp32 max diff {cross32:.3e} (bound {E2E_FP32_TOL:.0e}, gated); "
        f"bf16 backbone max diff {cross16:.3e} (reported, not gated)")
    if not cross32 <= E2E_FP32_TOL:
        raise RuntimeError(f"fp32 score maps of path 2 and path 1 differ by {cross32} > {E2E_FP32_TOL}")

    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    fast = fast_phase(cfg, model, images)
    xla = xla_phase(cfg, model, images)
    log(f"path 1 / fast / xla at parity / xla at fast_serving, device busy of one request (ms): "
        f"{prof['path1']['busy_ms']} / {fast['profile']['busy_ms']} / {xla['parity']['profile']['busy_ms']} / "
        f"{xla['fast']['profile']['busy_ms']}; ms/image {serve['path1']['ms_per_image']:.2f} / "
        f"{fast['serve']['ms_per_image']:.2f} / {xla['parity']['ms_per_image']:.2f} / "
        f"{xla['fast']['ms_per_image']:.2f} ({time.perf_counter() - t0:.1f} s for the fast and xla phases)")
    samples, gen_s = make_scenes()
    t0 = time.perf_counter()
    evaluation = eval_phase(cfg, prof["path1"]["busy_ms"], model, samples, gen_s)
    evaluation["fast_serving"] = fast_eval_phase(cfg, model, samples)
    eval_launches = evaluation["cohort1"]["launches"]
    log(f"eval phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with window_attention_shapes() as wa_seen:
        d2, pth = d2_phase(images[1])
        tta = tta_phase(cfg, model, images[1])
        sliding = sliding_phase(cfg, model, images[1], gen)
        del model
        dense_hybrid = dense_hybrid_phase(images[1])
        sweep_cli = sweep_cli_phase(pth)
    log(f"d2, tta, sliding, dense_hybrid and sweep_cli phases: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    with window_attention_shapes() as wa_seen_eval:
        t0 = time.perf_counter()
        semseg = semseg_phase(pth.parent)
        log(f"semseg phase: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        panoptic = panoptic_phase()
        log(f"panoptic phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = train_phase(pth, images[1])
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    with window_attention_shapes() as wa_seen_parallel:
        t0 = time.perf_counter()
        parallel = parallel_phase(train)
        log(f"parallel phase: {time.perf_counter() - t0:.1f} s")
    wa_seen |= wa_seen_parallel
    gc.collect()
    torch.cuda.empty_cache()
    with window_attention_shapes() as wa_seen_train_eval:
        t0 = time.perf_counter()
        train_eval = train_eval_phase()
        log(f"train_eval phase: {time.perf_counter() - t0:.1f} s")
    wa_seen |= wa_seen_eval | wa_seen_train_eval
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    backbones = backbones_phase(images)
    r50_d2 = r50_d2_phase(images[1])
    log(f"backbones and r50_d2 phases: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_backbones = train_backbones_phase(images[1])
    log(f"train_backbones phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    with window_attention_shapes() as wa_seen_l:
        t0 = time.perf_counter()
        swin_l, swin_l_dir = swin_l_phase(images)
        log(f"swin_l phase: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train_datasets = train_datasets_phase(swin_l_dir)
        log(f"train_datasets phase: {time.perf_counter() - t0:.1f} s")
    wa_seen |= wa_seen_l
    gc.collect()
    torch.cuda.empty_cache()
    with window_attention_shapes() as wa_seen_heads:
        t0 = time.perf_counter()
        heads = heads_phase(images)
        log(f"heads phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        hf = hf_phase(images)
        log(f"hf phase: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        int8 = int8_phase(images)
        log(f"int8 phase: {time.perf_counter() - t0:.1f} s")
    wa_seen |= wa_seen_heads
    gc.collect()
    torch.cuda.empty_cache()
    with window_attention_shapes() as wa_seen_tools:
        t0 = time.perf_counter()
        tools = tools_phase(images, pth)
        log(f"tools phase: {time.perf_counter() - t0:.1f} s")
    wa_seen |= wa_seen_tools
    unchecked = sorted(wa_seen - wa_checked)
    log(f"Kernel A in these phases: {len(wa_seen)} distinct launch shapes (windows, heads, head dim, masked), "
        f"each held against its plain version at bf16 and fp32 in the kernel phase: {not unchecked} "
        f"({len(wa_checked)} shapes held there)")
    if unchecked:
        raise RuntimeError(f"Kernel A ran at shapes that the kernel phase did not hold: {unchecked}")
    variant_launches = {f"launches_{k}": v for k, v in (
        ("d2", d2["launches"]), ("tta", tta["fast"]["launches"]), ("sliding", sliding["1024x2048"]["launches"]),
        ("sliding_3072x4096", sliding["3072x4096"]["launches"]), ("dense_hybrid", dense_hybrid["launches"]),
        ("sweep_cli_plain", sweep_cli["plain"]["launches"]), ("sweep_cli_tta", sweep_cli["tta"]["launches"]),
        ("sweep_cli_sliding", sweep_cli["sliding"]["launches"]), ("semseg", semseg["launches"]),
        ("panoptic", panoptic["launches"]), ("train_eval", train_eval["launches"]["train"]),
        ("eval_only", train_eval["launches"]["eval_only"]),
        *((f"backbones_{k}", v["parity"]["launches"]) for k, v in backbones.items()),
        ("r50_d2_sweep", r50_d2["sweep_launches"]), ("swin_l_path1", swin_l["path1"]["launches"]),
        ("swin_l_path2", swin_l["path2"]["launches"]), ("swin_l_street_hazards", swin_l["street_hazards"]["launches"]),
        *((f"heads_{k}", heads[k]["launches"]) for k in ("v1_path1", "v1_path2", "v1_encoder", "per_pixel",
                                                         "per_pixel_plus")),
        *((f"heads_train_{k}", {w: v for w, v in heads[f"train_{k}"]["launches"].items() if w != "lsap"})
          for k in ("v1", "per_pixel_plus")), ("hf", hf["launches"]), ("parallel_eval", parallel["eval"]["launches"]),
        ("int8_path1", int8["path1"]["launches"]), ("int8_path2", int8["path2"]["launches"]))}
    swin_l_launches = {k: v for k, v in variant_launches.items() if k.startswith("launches_swin_l_")}
    eval_launches_ds = {f"launches_train_datasets_eval_{k}": v["eval_only"]["launches"]["window_attention"]
                        for k, v in train_datasets.items() if isinstance(v, dict) and "eval_only" in v}

    kernels = [
        dict(name="window_attention", route="cuda", source="rba_tpu_torch/csrc/window_attention.cu",
             replaces="rba_tpu/ops/pallas/window_attention.py:169",
             launches=serve["path1"]["launches"]["window_attention"], max_abs_err=wa_err, ms=wa["ms"],
             plain_ms=wa["plain_ms"], bound_ms=wa["bound_ms"], bound_by="bytes", library_ms=wa["library_ms"],
             ms_batches=wa["ms_batches"], launches_eval=eval_launches["window_attention"],
             launches_fast=fast["serve"]["launches"]["window_attention"],
             **{k: v["window_attention"] for k, v in variant_launches.items()}, **eval_launches_ds,
             **{f"{k}_swin_l": wa_l[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}),
        dict(name="fused_rba_score", route="cuda", source="rba_tpu_torch/csrc/fused_rba.cu",
             replaces="rba_tpu/ops/pallas/fused_rba.py:111",
             launches=serve["path2"]["launches"]["fused_rba_score"], max_abs_err=rba_row["max_abs_err"],
             ms=rba_row["ms"], plain_ms=rba_row["plain_ms"], bound_ms=rba_row["bound_ms"],
             bound_by=rba_row["bound_by"], library_ms=None, ms_batches=rba_row["ms_batches"],
             bound_built_ms=rba_row["bound_built_ms"], bound_built_by=rba_row["bound_built_by"],
             launches_eval=eval_launches["fused_rba_score"], launches_fast=fast["serve"]["launches"]["fused_rba_score"],
             **{k: v["fused_rba_score"] for k, v in variant_launches.items()},
             **{f"{k}_coco": rba_row["coco"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}),
        dict(name="masked_softmax", route="cuda", source="rba_tpu_torch/csrc/masked_softmax.cu",
             replaces="rba_tpu/ops/pallas/masked_softmax.py:77",
             launches=serve["path2"]["launches"]["masked_softmax"], max_abs_err=ms_err, ms=ms["ms"],
             plain_ms=ms["plain_ms"], bound_ms=ms["bound_ms"], bound_by="bytes", library_ms=None,
             ms_batches=ms["ms_batches"], cast_ms=ms["cast_ms"],
             **{k: v["masked_softmax"] for k, v in swin_l_launches.items()},
             **{f"{k}_swin_l": ms_l[k] for k in ("ms", "plain_ms", "bound_ms", "cast_ms")},
             max_abs_err_swin_l=ms_err_l, **{k: v["masked_softmax"] for k, v in variant_launches.items()
                                             if k.startswith(("launches_heads", "launches_hf", "launches_int8"))}),
        dict(name="fused_mlp_residual", route="cuda", source="rba_tpu_torch/csrc/fused_mlp.cu",
             replaces="rba_tpu/ops/pallas/fused_mlp.py:166",
             launches=serve["path2"]["launches"]["fused_mlp_residual"], max_abs_err=mlp_err, ms=mlp["ms"],
             plain_ms=mlp["plain_ms"], bound_ms=mlp["bound_ms"], bound_by="operations", library_ms=None,
             ms_batches=mlp["ms_batches"], **{k: v["fused_mlp_residual"] for k, v in swin_l_launches.items()},
             **{k: v["fused_mlp_residual"] for k, v in variant_launches.items()
                if k.startswith(("launches_heads", "launches_hf", "launches_int8"))}),
        dict(name="lsap", route="cuda", source="rba_tpu_torch/csrc/lsap.cu", replaces="rba_tpu/ops/lsap.py:93",
             launches=train["launches"]["lsap"],
             max_abs_err=max(r["max_abs_err"] for r in (*lsap_rows.values(), train["lsap_real"])),
             ms=train["lsap_real"]["ms"], plain_ms=train["lsap_real"]["plain_ms"],
             bound_ms=train["lsap_real"]["bound_ms"], bound_by=train["lsap_real"]["bound_by"], library_ms=None,
             scipy_ms=train["lsap_real"]["scipy_ms"], latency_bound_ms=train["lsap_real"]["latency_bound_ms"],
             shape=train["lsap_real"]["shape"], launches_per_step=train["launches"]["lsap"] // (
                 TRAIN_WARMUP + TRAIN_TIMED), ms_B8x32x100=lsap_rows["B8x32x100"]["ms"],
             launches_train_eval=train_eval["launches"]["train"]["lsap"],
             launches_train_backbones=train_backbones["lsap_launches"],
             launches_train_datasets=train_datasets["lsap_launches"],
             launches_heads_train_v1=heads["train_v1"]["launches"]["lsap"],
             launches_heads_train_per_pixel_plus=heads["train_per_pixel_plus"]["launches"]["lsap"],
             launches_parallel_train=parallel["launches"]["lsap"],
             **{k: v["lsap"] for k, v in variant_launches.items() if "lsap" in v
                and k.startswith(("launches_heads", "launches_hf"))}),
        dict(name="ms_deform_attn", route="cuda", source="rba_tpu_torch/csrc/ms_deform_attn.cu",
             replaces="none (rba_tpu/ops/deform_sampling.py samples with a jnp gather)",
             launches=serve["path1"]["launches"]["ms_deform_attn"],
             max_rel_err=max(r["max_rel_err"] for k, r in mda_rows.items() if k != "l1_bytes_per_s"),
             launches_per_call_r50_B1=mda_rows["r50_B1"]["launches"],
             **{k: v["ms_deform_attn"] for k, v in variant_launches.items() if "ms_deform_attn" in v},
             ms=mda_rows["r50_B1"]["ms"], plain_ms=mda_rows["r50_B1"]["plain_ms"],
             bound_ms=mda_rows["r50_B1"]["bound_ms"], bound_by=mda_rows["r50_B1"]["bound_by"], library_ms=None,
             gather_floor_ms=mda_rows["r50_B1"]["gather_floor_ms"], ms_batches=mda_rows["r50_B1"]["ms_batches"],
             **{f"{k2}_{k}": r[k2] for k, r in mda_rows.items() if k.startswith("swin_b")
                for k2 in ("ms", "plain_ms", "bound_ms", "gather_floor_ms")}),
        dict(name="sr_attention", route="cuda", source="rba_tpu_torch/csrc/sr_attention.cu",
             replaces="none (rba_tpu/models/mix_transformer.py computes the core in plain jnp)",
             launches=backbones["mit_b5_1dl"]["parity"]["launches"]["sr_attention"],
             launches_per_image=sr_rows["per_image"]["launches"],
             bit_equal_share=min(r["bit_equal_share"] for k, r in sr_rows.items() if k != "per_image"),
             max_ulps=max(r["max_ulps"] for k, r in sr_rows.items() if k != "per_image"),
             **{k: sr_rows["per_image"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by="operations"),
        dict(name="rel_pos_attention", route="cuda", source="rba_tpu_torch/csrc/rel_pos_attention.cu",
             replaces="none (rba_tpu/models/vit.py computes the core in plain jnp)",
             launches=backbones["mvit_in21k_1dl"]["parity"]["launches"]["rel_pos_attention"],
             launches_per_image=rel_rows["per_image"]["launches"],
             bit_equal_share=min(r["bit_equal_share"] for k, r in rel_rows.items() if k != "per_image"),
             max_ulps=max(r["max_ulps"] for k, r in rel_rows.items() if k != "per_image"),
             **{k: rel_rows["per_image"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by="bytes"),
    ]
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(
            dict(card=smi, torch=torch.__version__, build_s=built, window_attention=wa_rows, fused_rba=rba_row,
                 masked_softmax=ms_rows, fused_mlp=mlp_rows, serve=serve, paths_fp32_max_diff=cross32,
                 paths_bf16_max_diff_not_gated=cross16, profile=prof, fast=fast, xla=xla, eval=evaluation, d2=d2,
                 tta=tta, sliding=sliding, dense_hybrid=dense_hybrid, sweep_cli=sweep_cli, lsap=lsap_rows,
                 ms_deform_attn=mda_rows, sr_attention=sr_rows, rel_pos_attention=rel_rows,
                 train=train, semseg=semseg, panoptic=panoptic, train_eval=train_eval, backbones=backbones,
                 r50_d2=r50_d2, train_backbones=train_backbones, masked_softmax_swin_l=ms_rows_l, swin_l=swin_l,
                 train_datasets=train_datasets, heads=heads, hf=hf, parallel=parallel, int8=int8, tools=tools,
                 elapsed_s=time.perf_counter() - T_START, kernels=kernels), indent=1))
    log("(window_attention, masked_softmax and fused_mlp_residual times are per image: each call of one "
        "1024x2048 request, summed; ms is the mean of the first batch of 20 calls, ms_batches the means of "
        f"three batches one after the other; launches count the {N_REQUESTS} requests of a serving path, "
        f"launches_eval the eval phase's evaluate_dataset over {EVAL_IMAGES} images, launches_fast the fast cell's "
        f"{N_REQUESTS} requests, launches_d2 one request of the D2-loaded model, launches_tta one TTA frame at "
        "fast_serving, launches_sliding one 1024x2048 frame and launches_sliding_3072x4096 one 3072x4096 frame in "
        "1024x1024 tiles, launches_dense_hybrid one DenseHybrid request, launches_sweep_cli_* each sweep run over "
        f"the synthetic dataset, launches_semseg eval_semseg over {SEMSEG_FRAMES} frames, launches_panoptic the "
        f"panoptic run_val_eval over {PANOPTIC_FRAMES} COCO frames (PQ, mIoU and AP passes), launches_train_eval "
        "the 4-step run with its two evaluations and launches_eval_only the --eval-only run, launches_backbones_* "
        f"the {N_REQUESTS} requests of each non-Swin config at its precision, launches_r50_d2_sweep the sweep over "
        f"the R50 checkpoint, launches_swin_l_path1 / _path2 the {N_REQUESTS} Swin-L requests of each path, "
        f"launches_swin_l_street_hazards the StreetHazards evaluation of {STREET_HAZARDS_FRAMES} frames, "
        "launches_train_datasets_eval_* each --eval-only of the train_datasets phase, launches_heads_v1_path1 / "
        f"_v1_path2 / _per_pixel / _per_pixel_plus the {N_REQUESTS} requests of each head, launches_heads_v1_encoder "
        "one request of the encoder variant, launches_heads_train_* each head's training run, launches_hf the "
        f"{N_REQUESTS} requests of the HF-ingested model, launches_parallel_eval the sharded evaluation of "
        f"{EVAL_IMAGES} scenes and launches_parallel_train the data-parallel fine-tune's "
        f"{PARALLEL_WARMUP + PARALLEL_TIMED} steps, launches_int8_path1 / _path2 the {N_REQUESTS} int8 requests of "
        "each path; *_swin_l times per Swin-L "
        "1024x2048 image; fused_rba_score's "
        "*_coco at Q=100, K=117, 200x272; lsap's launches count the train phase's "
        f"{TRAIN_WARMUP + TRAIN_TIMED} steps, launches_train_backbones the train_backbones phase's "
        f"{TRAIN_BB_WARMUP + TRAIN_BB_TIMED} steps of each config, launches_train_datasets the train_datasets "
        f"phase's {TRAIN_DS_WARMUP + TRAIN_DS_TIMED} steps of each recipe, its ms, "
        "plain_ms and bound are per launch on one step's real costs, scipy_ms scipy's host time on them with the "
        f"copy; ms_deform_attn's times are per call at R50's three levels (one encoder layer of one 1024x2048 "
        "frame), *_swin_b_B1 / _B4 at Swin-B's one level, batch 1 and 4; sr_attention's times are per MiT-B5 "
        "1024x2048 image (its 52 calls), its launches count the mit_b5_1dl backbones requests; "
        f"{time.perf_counter() - T_START:.1f} s in all)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
