"""Model analysis: parameter counts, FLOPs, activations, memory, structure (counterpart of
``rba_tpu/tools/analyze_model.py``, after the reference's fvcore tasks in
``tools/analyze_model.py``).

- ``parameter``: counts per path prefix of the parameter tree, up to depth 3, the paths
  of ``rba_tpu``'s tree (``convert/params.py`` names them), so the two packages' counts
  are comparable key by key;
- ``flop``: the dot and conv FLOPs of one ``maskformer_infer_rba`` call, from
  ``torch.utils.flop_counter.FlopCounterMode``, bucketed as ``rba_tpu``'s ``flop_table``
  buckets its jaxpr (``dot_general``: every matmul-like op; ``conv``: every convolution).
  ``rba_tpu`` also reports XLA's whole-program ``flop_count`` of the compiled program;
  torch has no compiled whole program, so that number has no counterpart here;
- ``activation``: the elements of the outputs of the same dot and conv ops (millions), as
  ``rba_tpu``'s ``activation_count`` counts its jaxpr's;
- ``memory``: on the card, the peak of ``torch.cuda.max_memory_allocated`` over the call
  beside the model's own bytes (``rba_tpu`` reads XLA's memory analysis);
- ``structure``: the parameter tree as ``rba_tpu`` prints its pytree.

The counters see the ops that PyTorch dispatches, so the FLOPs are counted on the
``"xla"`` attention branch by default: a hand-written kernel's work (Kernels A-D) is not
an op that the counter knows.

Usage:
    python -m rba_tpu_torch.tools.analyze_model --config-file configs/cityscapes/swin_b_1dl_ood_coco.yaml \\
        --tasks parameter flop structure [--height 1024 --width 2048] [--device cpu]
"""
from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np
import torch

# the forward ops that FlopCounterMode counts
_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm", "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_efficient_attention", "_scaled_dot_product_cudnn_attention")
_CONV_OPS = ("convolution", "_convolution")


def _bucket(op_name: str):
    name = op_name.split(".")[-1] if "." in op_name else op_name
    if name in _DOT_OPS:
        return "dot_general"
    if name in _CONV_OPS:
        return "conv"
    return None


def _tree_paths(model):
    """(path parts in rba_tpu's tree, element count) of every leaf: the parameters and an
    int8 layer's buffers."""
    from ..convert.params import jax_path

    for name, p in model.named_parameters():
        yield jax_path(name, p.dim()).split("/"), p.numel()
    for name, b in model.named_buffers():
        if name.endswith((".kernel_q", ".kscale")):
            yield name.split("."), b.numel()


def parameter_count(model, max_depth: int = 3):
    counts = defaultdict(int)
    for keys, n in _tree_paths(model):
        counts[""] += n
        for d in range(1, min(len(keys), max_depth) + 1):
            counts[".".join(keys[:d])] += n
    return dict(counts)


def _counted(fn, *args):
    """(FLOPs by op, output elements of the counted ops) of one no-grad call of ``fn``."""
    from torch.utils.flop_counter import FlopCounterMode

    class Counter(FlopCounterMode):
        activations = 0

        def _count_flops(self, func_packet, out, args, kwargs):
            if func_packet in self.flop_registry:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                self.activations += sum(o.numel() for o in outs if isinstance(o, torch.Tensor))
            return super()._count_flops(func_packet, out, args, kwargs)

    with torch.no_grad(), Counter(display=False) as counter:
        fn(*args)
    return counter.get_flop_counts().get("Global", {}), counter.activations


def flop_table(fn, *args) -> dict:
    """{"dot_general": FLOPs, "conv": FLOPs} of ``fn(*args)`` by ``FlopCounterMode``."""
    counts: dict = defaultdict(float)
    for op, flops in _counted(fn, *args)[0].items():
        bucket = _bucket(str(op))
        if bucket is None:
            raise ValueError(f"FlopCounterMode counted {op}, which is neither a dot nor a conv")
        counts[bucket] += float(flops)
    return dict(counts)


def activation_count(fn, *args) -> float:
    """Elements of the outputs of the ops that ``flop_table`` counts, in millions."""
    return _counted(fn, *args)[1] / 1e6


def memory_analysis(fn, *args) -> dict:
    """On the card, in MB: what was allocated before one call (the model, its inputs), and
    the call's peak over that."""
    if not torch.cuda.is_available():
        return {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    return {"argument_mb": base / 1e6, "temp_mb": (torch.cuda.max_memory_allocated() - base) / 1e6}


def structure_string(params, depth: int = 4) -> str:
    """The lines of ``rba_tpu``'s ``structure_string`` for a pytree (``model_to_jax_params``)."""
    lines = []

    def rec(node, name, level):
        if level >= depth and not hasattr(node, "shape"):
            lines.append(f"{name}: <subtree>")
            return
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{name}.{k}" if name else k, level + 1)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{name}[{i}]", level + 1)
        else:
            lines.append(f"{name}: {tuple(np.shape(node))} {np.asarray(node).dtype}")

    rec(params, "", 0)
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--tasks", nargs="+", default=["parameter"],
                   choices=["parameter", "flop", "activation", "structure", "memory"])
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--attention", default="xla", help="Swin's window-attention branch of the counted call")
    p.add_argument("--device", default=None, help="torch device (default: the GPU; 'cpu' asks for the CPU)")
    args = p.parse_args(argv)

    from ..config import load_config
    from ..convert.params import model_to_jax_params
    from ..models.maskformer import build_model, maskformer_infer_rba, resolve_device

    cfg = load_config(args.config_file)
    device = resolve_device(args.device, "analyze_model")
    model = build_model(cfg, device=device, seed=0)
    img = torch.zeros((1, args.height, args.width, 3), device=device)

    def call(x):
        return maskformer_infer_rba(model, cfg, x, attention=args.attention)

    out = {}
    for task in args.tasks:
        if task == "parameter":
            counts = out["parameter"] = parameter_count(model)
            print(f"total parameters: {counts[''] / 1e6:.2f}M")
            for k in sorted(counts):
                if k and k.count(".") <= 1:
                    print(f"  {k}: {counts[k] / 1e6:.2f}M")
        elif task == "flop":
            table = out["flop"] = flop_table(call, img)
            print(f"inference dot + conv FLOPs @{args.height}x{args.width}: {sum(table.values()) / 1e9:.1f} GFLOPs")
            for k, v in sorted(table.items()):
                print(f"  {k}: {v / 1e9:.1f} GFLOPs")
        elif task == "activation":
            acts = out["activation"] = activation_count(call, img)
            print(f"(Million) activations @{args.height}x{args.width}: {acts:.1f}")
        elif task == "memory":
            mem = out["memory"] = memory_analysis(call, img)
            for k, v in mem.items():
                print(f"  {k}: {v:.1f}")
        elif task == "structure":
            print(out.setdefault("structure", structure_string(model_to_jax_params(model))))
    return out


if __name__ == "__main__":
    main()
