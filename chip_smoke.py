#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build its CUDA kernels, hold each
against its plain PyTorch version at the serving path's shapes, serve Swin-B RbA
requests at 1024x2048 and check the score maps.

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
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# Published H100 SXM peaks (dense): HBM bytes/s and fp32 CUDA-core / bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

IMAGE_HW = (1024, 2048)
N_REQUESTS = 4  # distinct images served after one warm-up request
E2E_FP32_TOL = 1e-3  # score-map bound of rba_tpu's selfcheck


def log(msg: str) -> None:
    print(msg, flush=True)


def _smi(query: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<query>`` for card 0."""
    return subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# Kernel A: window attention at the Swin-B 1024x2048 stage shapes
# ---------------------------------------------------------------------------

def window_attention_phase(cfg, gen):
    from rba_tpu_torch.kernels.window_attention import window_attention, window_attention_reference
    from rba_tpu_torch.models.swin import shifted_window_mask

    sw = cfg.swin
    ws, n = sw.window_size, sw.window_size**2
    h, w = IMAGE_HW[0] // sw.patch_size, IMAGE_HW[1] // sw.patch_size
    rows, totals = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    worst = 0.0
    for s in range(sw.num_layers):
        hs, wsz = -(-h // 2**s), -(-w // 2**s)
        hp, wp = -(-hs // ws) * ws, -(-wsz // ws) * ws
        nw, nh, c = (hp // ws) * (wp // ws), sw.num_heads[s], sw.stage_dim(s)
        hd = c // nh
        scale = hd**-0.5
        qkv = torch.randn(nw, n, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
        bias = torch.randn(nh, n, n, generator=gen, device="cuda")
        q, k, v = (x.contiguous() for x in qkv.reshape(nw, n, 3, nh, hd).permute(2, 0, 3, 1, 4))
        for masked in (False, True):
            mask = torch.as_tensor(shifted_window_mask(hp, wp, ws, ws // 2), device="cuda") if masked else None
            count = sw.depths[s] // 2 if masked else (sw.depths[s] + 1) // 2  # odd blocks are shifted
            # correctness: bf16 (the serving dtype) and fp32
            got = window_attention(qkv, bias, mask, nh, scale)
            want = window_attention_reference(qkv, bias, mask, nh, scale)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            tol = 2.0**-7 * float(want.float().abs().max())  # one bf16 ulp of the largest output
            q32 = qkv.float()
            err32 = max_abs(window_attention(q32, bias, mask, nh, scale),
                            window_attention_reference(q32, bias, mask, nh, scale))
            tol32 = 1e-4
            ok = err <= tol and err32 <= tol32
            worst = max(worst, err)
            # times
            am = (bias[None] + mask[:, None] if masked else bias[None]).to(torch.bfloat16)
            t_k = cuda_ms(lambda: window_attention(qkv, bias, mask, nh, scale))
            t_p = cuda_ms(lambda: window_attention_reference(qkv, bias, mask, nh, scale))
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale))
            nbytes = qkv.numel() * 2 + nw * n * c * 2 + bias.numel() * 4 + (mask.numel() * 4 if masked else 0)
            flops = 4.0 * nw * nh * n * n * hd
            b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
            row = dict(stage=s, masked=masked, nW=nw, nh=nh, N=n, hd=hd, blocks_per_image=count,
                       max_abs_err_bf16=err, tol_bf16=tol, max_abs_err_fp32=err32, tol_fp32=tol32,
                       ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
            rows.append(row)
            log(f"window_attention stage {s} {'shifted' if masked else 'plain   '} nW={nw:4d} nh={nh:2d}: "
                f"err bf16 {err:.3e} (tol {tol:.3e}) fp32 {err32:.3e} (tol {tol32:.0e}) | "
                f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            if not ok:
                raise RuntimeError(f"window_attention disagrees with its plain version: {row}")
            for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms)):
                totals[key] += count * t
    return rows, totals, worst


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
    t_k = cuda_ms(lambda: fused_rba_score(mask_cls, masks, masks_layout="bhwq"))
    t_p = cuda_ms(lambda: fused_rba_score_reference(mask_cls, masks, masks_layout="bhwq"), iters=5)
    nbytes = masks.numel() * 4 + mask_cls.numel() * 4 + got.numel() * 4
    flops = 2.0 * q * k * got.numel()  # the class contraction alone
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    row = dict(Q=q, K=k, h=h, w=w, max_abs_err=err, tol=tol, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, flops=flops)
    log(f"fused_rba_score Q={q} K={k} {h}x{w}: err {err:.3e} (tol {tol:.0e}) | kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if err > tol:
        raise RuntimeError(f"fused_rba_score disagrees with its plain version: {row}")
    return row


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


def serve_phase(cfg, model, images):
    """Serve each image as one request through the kernels (the main path, counted) and,
    in turns, through the plain versions; check the score maps."""
    from rba_tpu_torch.kernels.fused_rba import fused_rba_score
    from rba_tpu_torch.kernels.window_attention import window_attention
    from rba_tpu_torch.models.maskformer import maskformer_infer_rba

    maskformer_infer_rba(model, cfg, images[0])  # warm-up requests, one per path
    maskformer_infer_rba(model, cfg, images[0], plain=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window_attention.launches = 0
    fused_rba_score.launches = 0
    scores, plain_scores, times, t_plain = [], [], [], []
    for i in range(1, N_REQUESTS + 1):  # kernel, plain, plain, kernel, ...
        for plain in ((False, True) if i % 2 else (True, False)):
            rba, ms = _timed(maskformer_infer_rba, model, cfg, images[i], plain=plain)
            (plain_scores if plain else scores).append(rba)
            (t_plain if plain else times).append(ms)
    launches = {"window_attention": window_attention.launches, "fused_rba_score": fused_rba_score.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    clocks = _smi("clocks.sm,power.draw,temperature.gpu")

    n_blocks = sum(cfg.swin.depths)
    for rba in scores:
        if tuple(rba.shape) != (1, *IMAGE_HW) or not bool(torch.isfinite(rba).all()):
            raise RuntimeError(f"bad score map: shape {tuple(rba.shape)}, finite {bool(torch.isfinite(rba).all())}")
    if launches != {"window_attention": n_blocks * N_REQUESTS, "fused_rba_score": N_REQUESTS}:
        raise RuntimeError(f"launches {launches}, expected {n_blocks} and 1 per request")
    log(f"served {N_REQUESTS} requests: launches {launches} ({n_blocks} + 1 per image); "
        f"ms/image {statistics.median(times):.2f} (median; all {[round(t, 2) for t in times]}), "
        f"plain versions {statistics.median(t_plain):.2f} (all {[round(t, 2) for t in t_plain]}), "
        f"peak memory {peak_gib:.2f} GiB; right after: SM clock, power draw, temperature {clocks}")

    # fp32: kernels vs plain versions, gated at the selfcheck bound.  bf16 backbone:
    # reported, not gated.  Kernel and plain version sum the same fp32 math in other
    # orders, so their bf16 outputs differ by one ulp where a value sits near a rounding
    # edge; with random weights those flips grow through 24 blocks into differences far
    # above rounding.  The plain version's own bf16-vs-fp32 difference is printed for scale.
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    err32 = err16 = spread16 = 0.0
    for i in range(1, N_REQUESTS + 1):
        plain32 = maskformer_infer_rba(model, cfg32, images[i], plain=True)
        err32 = max(err32, max_abs(maskformer_infer_rba(model, cfg32, images[i]), plain32))
        err16 = max(err16, max_abs(scores[i - 1], plain_scores[i - 1]))
        spread16 = max(spread16, max_abs(plain_scores[i - 1], plain32))
    log(f"score map, kernels vs plain versions: fp32 max diff {err32:.3e} (bound {E2E_FP32_TOL:.0e}, gated); "
        f"bf16 backbone max diff {err16:.3e} (reported, not gated; the plain version's own bf16-vs-fp32 "
        f"diff is {spread16:.3e})")
    if not err32 <= E2E_FP32_TOL:
        raise RuntimeError(f"fp32 score maps differ by {err32} > {E2E_FP32_TOL}")
    return dict(launches=launches, ms_per_image=statistics.median(times), ms_all=times,
                plain_ms_per_image=statistics.median(t_plain), plain_ms_all=t_plain, peak_gib=peak_gib, clocks=clocks,
                fp32_max_diff=err32, fp32_bound=E2E_FP32_TOL, bf16_max_diff_not_gated=err16,
                bf16_plain_vs_fp32_diff=spread16)


def profile_phase(cfg, model, image, top: int = 10):
    """torch.profiler over one request through ``maskformer_infer_rba``: each layer's
    host span, device span and device busy time (read from the entry's own
    ``record_function`` spans), the card's idle share of the request's wall time, and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rba_tpu_torch.models.maskformer import LAYERS, maskformer_infer_rba

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        maskformer_infer_rba(model, cfg, image)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events, less the annotation spans that mirror each record_function
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.key not in LAYERS), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    if busy_ms == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return dict(wall_ms=wall_ms, busy_ms=None, idle_share=None, layers=None, top=[])
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
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
                    if e.name not in LAYERS and span.start <= e.time_range.start < span.end) / 1e3 if span else 0.0)
        layers[name] = dict(host_ms=host_spans[name].elapsed_us() / 1e3,
                            device_span_ms=span.elapsed_us() / 1e3 if span else 0.0, device_busy_ms=busy)
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms, layers=layers,
               top=[dict(kernel=k[:120], ms=t, calls=c) for k, t, c in kernels[:top]])
    log(f"profile of one request (profiler on): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {out['idle_share']:.3f}; by layer, host span / device span / device busy ms: "
        + "; ".join(f"{k} {v['host_ms']:.2f} / {v['device_span_ms']:.2f} / {v['device_busy_ms']:.2f}"
                    for k, v in layers.items()))
    log("top kernels by device time:")
    for r in out["top"]:
        log(f"  {r['ms']:8.3f} ms  x{r['calls']:<4d} {r['kernel']}")
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    wa_rows, wa, wa_err = window_attention_phase(cfg, gen)
    rba_row = fused_rba_phase(cfg, gen)

    from rba_tpu_torch.models.maskformer import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"build_model(swin_b_1dl) on the card: {time.perf_counter() - t0:.2f} s")
    images = torch.randint(0, 256, (N_REQUESTS + 1, 1, *IMAGE_HW, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    e2e = serve_phase(cfg, model, images)
    prof = profile_phase(cfg, model, images[1])

    kernels = [
        dict(name="window_attention", route="cuda", source="rba_tpu_torch/csrc/window_attention.cu",
             replaces="rba_tpu/ops/pallas/window_attention.py:169",
             launches=e2e["launches"]["window_attention"], max_abs_err=wa_err, ms=wa["ms"],
             plain_ms=wa["plain_ms"], bound_ms=wa["bound_ms"], bound_by="bytes", library_ms=wa["library_ms"]),
        dict(name="fused_rba_score", route="cuda", source="rba_tpu_torch/csrc/fused_rba.cu",
             replaces="rba_tpu/ops/pallas/fused_rba.py:111",
             launches=e2e["launches"]["fused_rba_score"], max_abs_err=rba_row["max_abs_err"], ms=rba_row["ms"],
             plain_ms=rba_row["plain_ms"], bound_ms=rba_row["bound_ms"], bound_by=rba_row["bound_by"],
             library_ms=None),
    ]
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(
            dict(card=smi, torch=torch.__version__, build_s=built, window_attention=wa_rows, fused_rba=rba_row,
                 serve=e2e, profile=prof, kernels=kernels), indent=1))
    log("(window_attention times are per image: every Swin-B block's call at 1024x2048, summed)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
