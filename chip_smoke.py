#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold each
against its plain PyTorch version at the serving paths' shapes, serve Swin-B RbA
requests at 1024x2048 through both serving paths and check the score maps.

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

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py [--out DIR]

It exits non-zero when there is no GPU, when a kernel fails to build or launch or
disagrees with its plain version, or when an end-to-end check fails.  Its last two
lines are a JSON object with every kernel's launches, error and times, and
``{"ok": true, "device": {...}}``.  With ``--out`` every measurement also goes to
DIR/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
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
N_REQUESTS = 4  # distinct images served after one warm-up request
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
    images, each whole, in its TTA variants and in its sliding-window tiles, and the
    3072x4096 frame's tiles."""
    from rba_tpu_torch.data.ood_datasets import SyntheticAnomaly
    from rba_tpu_torch.models.sliding_window import tile_grid
    from rba_tpu_torch.models.tta import tta_variants

    sizes = []
    for hw in (IMAGE_HW, SyntheticAnomaly().hw):
        sizes += [hw, *((h, w) for h, w, _ in tta_variants(cfg, *hw)), tile_grid(*hw)[:2]]
    sizes.append(tile_grid(*BIG_FRAME_HW)[:2])
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
# Kernel A: window attention at the Swin-B 1024x2048 stage shapes (timed) and at every
# other shape that the driven phases give it
# ---------------------------------------------------------------------------

def window_attention_phase(cfg, gen):
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
    # correctness alone at every other window-attention shape that the driven phases
    # give the kernel (served_sizes: TTA variants up to 1792x3584, 1024x1024 tiles, the
    # sweep's synthetic images), at bf16 and fp32; main() gates that these cover every
    # shape the kernel was launched at
    checked = {(nw, nh, c // nh, masked) for _, masked, nw, nh, c, _, _, _ in stage_shapes(cfg)}
    for hw in served_sizes(cfg)[1:]:
        first = len(rows)
        for s, masked, nw, nh, c, hp, wp, _ in stage_shapes(cfg, hw):
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
            rows.append(dict(image_hw=list(hw), stage=s, masked=masked, nW=nw, nh=nh, max_abs_err_bf16=err,
                             tol_bf16=tol, bf16_ulp_share=share, max_abs_err_fp32=err32, tol_fp32=1e-4))
            if not (err <= tol and share >= BF16_SHARE and err32 <= 1e-4):
                raise RuntimeError(f"window_attention disagrees with its plain version at {hw}: {rows[-1]}")
            worst = max(worst, err)
        new = rows[first:]
        if new:
            log(f"window_attention at {hw[0]}x{hw[1]}, {len(new)} new shapes (nW "
                f"{sorted({r['nW'] for r in new}, reverse=True)}): worst bf16 err / tol "
                f"{max(r['max_abs_err_bf16'] / r['tol_bf16'] for r in new):.3f}, least share within 1 ulp "
                f"{min(r['bf16_ulp_share'] for r in new):.6f} (tol {BF16_SHARE}), worst fp32 err "
                f"{max(r['max_abs_err_fp32'] for r in new):.3e} (tol 1e-4)")
    return rows, totals, worst, checked


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
    # second pass of 24 classes, on masks whose width is not a whole tile of patches
    for b, k2, h2, w2 in ((2, k, 64, 200), (2, 40, 64, 200)):
        cls2 = torch.randn(b, q, k2 + 1, generator=gen, device="cuda")
        masks2 = torch.randn(b, h2, w2, q, generator=gen, device="cuda") * 2
        got2 = fused_rba_score(cls2, masks2, masks_layout="bhwq")
        torch.cuda.synchronize()
        err2 = max_abs(got2, fused_rba_score_reference(cls2, masks2, masks_layout="bhwq"))
        row[f"max_abs_err_B{b}_K{k2}"] = err2
        log(f"fused_rba_score B={b} Q={q} K={k2} {h2}x{w2}: err {err2:.3e} (tol {tol:.0e})")
        if not err2 <= tol:
            raise RuntimeError(f"fused_rba_score disagrees with its plain version at B={b}, K={k2}: {err2}")
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


def _wrappers():
    """Every kernel wrapper of the port by name; each counts its launches."""
    from rba_tpu_torch.kernels.fused_mlp import fused_mlp_residual
    from rba_tpu_torch.kernels.fused_rba import fused_rba_score
    from rba_tpu_torch.kernels.masked_softmax import masked_softmax
    from rba_tpu_torch.kernels.window_attention import window_attention

    return {"window_attention": window_attention, "fused_rba_score": fused_rba_score,
            "masked_softmax": masked_softmax, "fused_mlp_residual": fused_mlp_residual}


def serve_phase(name, cfg, model, images, attention, per_image):
    """Serve each image as one request through one path's kernels (the main path,
    counted: ``per_image`` launches of each kernel per request) and, in turns, through
    the plain versions; check the score maps.  Returns the measurements and the fp32
    score maps of the kernels, for the comparison between paths."""
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    wrappers = _wrappers()
    infer = functools.partial(maskformer_infer_rba, model, attention=attention)
    infer(cfg, images[0])  # warm-up requests, one per path
    infer(cfg, images[0], plain=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    scores, plain_scores, times, t_plain = [], [], [], []
    for i in range(1, N_REQUESTS + 1):  # kernel, plain, plain, kernel, ...
        for plain in ((False, True) if i % 2 else (True, False)):
            rba, ms = _timed(infer, cfg, images[i], plain=plain)
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
        plain32 = infer(cfg32, images[i], plain=True)
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
    """The names of the port's record_function spans: the layers of a request
    (``maskformer.LAYERS``) and each deformable-sampling call."""
    from rba_tpu_torch.models.maskformer import LAYERS
    from rba_tpu_torch.ops.deform_sampling import SPAN

    return (*LAYERS, SPAN)


def _device_kernels(prof):
    """(name, device ms, calls) of a profile's device events, the longest first, less the
    annotation spans that mirror each record_function of ``_annotations()``."""
    from torch.autograd import DeviceType

    spans = _annotations()
    return sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in spans), key=lambda r: -r[1])


def _sampling_busy(device, layer_busy_ms):
    """Device busy ms of the kernels that start inside the deformable-sampling spans
    (one per encoder layer), those kernels by name, and their share of the pixel
    decoder's busy time."""
    from rba_tpu_torch.ops.deform_sampling import SPAN

    spans = [e.time_range for e in device if e.name == SPAN]
    spans_all = _annotations()
    inside = [e for e in device if e.name not in spans_all
              and any(sp.start <= e.time_range.start < sp.end for sp in spans)]
    by_name = {}
    for e in inside:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy = sum(ms for ms, _ in by_name.values())
    return dict(spans=len(spans), busy_ms=busy,
                share_of_pixel_decoder=busy / layer_busy_ms if layer_busy_ms else None,
                kernels=[dict(kernel=k[:120], ms=ms, calls=c)
                         for k, (ms, c) in sorted(by_name.items(), key=lambda r: -r[1][0])])


def profile_phase(path, cfg, model, image, attention, redesigned, top: int = 10):
    """torch.profiler over one request through ``maskformer_infer_rba``: each layer's
    host span, device span and device busy time (read from the entry's own
    ``record_function`` spans), the card's idle share of the request's wall time, and
    the kernels that take the most device time.  ``redesigned`` maps the name of each
    kernel the path must run to the name of the kernel it superseded (or the fp32
    CUDA-core counterpart that a bf16 request must not take): fails unless the first
    ran and the second did not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rba_tpu_torch.models.maskformer import LAYERS, maskformer_infer_rba

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
    hand = []
    for new, old in redesigned.items():
        ran = [r for r in kernels if new in r[0]]
        stale = [r[0] for r in kernels if old in r[0]]
        if not ran or stale:
            raise RuntimeError(f"{path}: the request ran {[r[0] for r in ran]} and {stale}; expected {new} "
                               f"and no {old}")
        hand += ran
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
    sampling = _sampling_busy(device, layers["pixel_decoder"]["device_busy_ms"])
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms, layers=layers,
               top=[dict(kernel=k[:120], ms=t, calls=c) for k, t, c in kernels[:top]],
               hand_kernels=[dict(kernel=k[:120], ms=t, calls=c) for k, t, c in hand], sampling=sampling)
    log(f"{path} profile of one request (profiler on): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {out['idle_share']:.3f}; by layer, host span / device span / device busy ms: "
        + "; ".join(f"{k} {v['host_ms']:.2f} / {v['device_span_ms']:.2f} / {v['device_busy_ms']:.2f}"
                    for k, v in layers.items()))
    share = sampling["share_of_pixel_decoder"]
    log(f"{path} deformable sampling ({sampling['spans']} calls): device busy {sampling['busy_ms']:.3f} ms, "
        + (f"{share:.3f} of the pixel decoder's busy time" if share is not None else "pixel decoder not measured"))
    for title, rows in ((f"{path} top kernels by device time:", out["top"]),
                        (f"{path} its hand kernels:", out["hand_kernels"]),
                        (f"{path} the deformable sampling's kernels:", sampling["kernels"])):
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


def _profile(name, fn, top: int = 8):
    """torch.profiler over one call of ``fn``: wall, device busy time, idle share and the
    kernels that take the most device time."""
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
               top=[dict(kernel=k[:120], ms=t, calls=c) for k, t, c in kernels[:top]])
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
        ev32 = OODEvaluator(cfg32, model, score=lambda x, plain=plain: maskformer_infer_rba(
            model, cfg32, to_device(x, "cuda"), plain=plain))
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


def _zero_counts():
    wrappers = _wrappers()
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
    if cfg != swin_b_1dl():
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
    err16 = max_abs(tta_inference(model, fcfg, img), tta_inference(model, fcfg, img, plain=True))
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    counts = _zero_counts()
    k = tta_inference(model, c32, img)
    launches32 = counts()
    p = tta_inference(model, c32, img, plain=True)
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
    err = max_abs(k, sliding_window_sem_seg(model, c32, image[0], plain=True))
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
    o = maskformer_infer(model, c32, image.float(), plain=True)
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

    from rba_tpu_torch.config import swin_b_1dl
    from rba_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s (nvcc, in parallel)")

    cfg = swin_b_1dl()
    cfg2 = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, mlp_impl="fused"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    wa_rows, wa, wa_err, wa_checked = window_attention_phase(cfg, gen)
    rba_row = fused_rba_phase(cfg, gen)
    ms_rows, ms, ms_err = masked_softmax_phase(cfg, gen)
    mlp_rows, mlp, mlp_err = fused_mlp_phase(gen)

    from rba_tpu_torch.models.maskformer import build_model

    images = torch.randint(0, 256, (N_REQUESTS + 1, 1, *IMAGE_HW, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    serve, prof = {}, {}
    scores, scores32 = {}, {}
    n_blocks = sum(cfg.swin.depths)
    fused_mlp_blocks = sum(d for i, d in enumerate(cfg.swin.depths) if cfg.swin.stage_dim(i) <= 256)
    paths = [
        ("path1", cfg, "fused", {"window_attention": n_blocks, "fused_rba_score": 1},
         {"window_attention_mma_kernel": "window_attention_kernel", "fused_rba_mma_kernel": "fused_rba_kernel"}),
        ("path2", cfg2, "fused_softmax",
         {"masked_softmax": n_blocks, "fused_mlp_residual": fused_mlp_blocks, "fused_rba_score": 1},
         {"fused_mlp_mma_kernel": "fused_mlp_kernel", "masked_softmax_walk_kernel": "masked_softmax_kernel",
          "fused_rba_mma_kernel": "fused_rba_kernel"}),
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
        ("sweep_cli_sliding", sweep_cli["sliding"]["launches"]))}

    kernels = [
        dict(name="window_attention", route="cuda", source="rba_tpu_torch/csrc/window_attention.cu",
             replaces="rba_tpu/ops/pallas/window_attention.py:169",
             launches=serve["path1"]["launches"]["window_attention"], max_abs_err=wa_err, ms=wa["ms"],
             plain_ms=wa["plain_ms"], bound_ms=wa["bound_ms"], bound_by="bytes", library_ms=wa["library_ms"],
             ms_batches=wa["ms_batches"], launches_eval=eval_launches["window_attention"],
             launches_fast=fast["serve"]["launches"]["window_attention"],
             **{k: v["window_attention"] for k, v in variant_launches.items()}),
        dict(name="fused_rba_score", route="cuda", source="rba_tpu_torch/csrc/fused_rba.cu",
             replaces="rba_tpu/ops/pallas/fused_rba.py:111",
             launches=serve["path2"]["launches"]["fused_rba_score"], max_abs_err=rba_row["max_abs_err"],
             ms=rba_row["ms"], plain_ms=rba_row["plain_ms"], bound_ms=rba_row["bound_ms"],
             bound_by=rba_row["bound_by"], library_ms=None, ms_batches=rba_row["ms_batches"],
             bound_built_ms=rba_row["bound_built_ms"], bound_built_by=rba_row["bound_built_by"],
             launches_eval=eval_launches["fused_rba_score"], launches_fast=fast["serve"]["launches"]["fused_rba_score"],
             **{k: v["fused_rba_score"] for k, v in variant_launches.items()}),
        dict(name="masked_softmax", route="cuda", source="rba_tpu_torch/csrc/masked_softmax.cu",
             replaces="rba_tpu/ops/pallas/masked_softmax.py:77",
             launches=serve["path2"]["launches"]["masked_softmax"], max_abs_err=ms_err, ms=ms["ms"],
             plain_ms=ms["plain_ms"], bound_ms=ms["bound_ms"], bound_by="bytes", library_ms=None,
             ms_batches=ms["ms_batches"], cast_ms=ms["cast_ms"]),
        dict(name="fused_mlp_residual", route="cuda", source="rba_tpu_torch/csrc/fused_mlp.cu",
             replaces="rba_tpu/ops/pallas/fused_mlp.py:166",
             launches=serve["path2"]["launches"]["fused_mlp_residual"], max_abs_err=mlp_err, ms=mlp["ms"],
             plain_ms=mlp["plain_ms"], bound_ms=mlp["bound_ms"], bound_by="operations", library_ms=None,
             ms_batches=mlp["ms_batches"]),
    ]
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(
            dict(card=smi, torch=torch.__version__, build_s=built, window_attention=wa_rows, fused_rba=rba_row,
                 masked_softmax=ms_rows, fused_mlp=mlp_rows, serve=serve, paths_fp32_max_diff=cross32,
                 paths_bf16_max_diff_not_gated=cross16, profile=prof, fast=fast, xla=xla, eval=evaluation, d2=d2,
                 tta=tta, sliding=sliding, dense_hybrid=dense_hybrid, sweep_cli=sweep_cli,
                 elapsed_s=time.perf_counter() - T_START, kernels=kernels), indent=1))
    log("(window_attention, masked_softmax and fused_mlp_residual times are per image: each call of one "
        "1024x2048 request, summed; ms is the mean of the first batch of 20 calls, ms_batches the means of "
        f"three batches one after the other; launches count the {N_REQUESTS} requests of a serving path, "
        f"launches_eval the eval phase's evaluate_dataset over {EVAL_IMAGES} images, launches_fast the fast cell's "
        f"{N_REQUESTS} requests, launches_d2 one request of the D2-loaded model, launches_tta one TTA frame at "
        "fast_serving, launches_sliding one 1024x2048 frame and launches_sliding_3072x4096 one 3072x4096 frame in "
        "1024x1024 tiles, launches_dense_hybrid one DenseHybrid request, launches_sweep_cli_* each sweep run over "
        f"the synthetic dataset; {time.perf_counter() - T_START:.1f} s in all)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
