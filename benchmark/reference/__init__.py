"""The benchmark's plain reference: the served models (``model``) and the exact OOD
metrics (``ood_metrics``).  Imports torch and nothing of the program under test.

A backbone file.  ``model`` holds the Swin and ResNet backbones; a configuration of
another backbone brings its own in a file of its own.  The configuration file names it
under the top-level key ``reference_backbone``, as a path relative to the benchmark's
folder (``reference/<family>.py``, or in a subfolder of ``reference/``), and the harness
then takes the backbone's maps and its operation count from it, in the check, in the
control and in ``mfu.*``.  The file is plain torch: it imports ``torch`` and, relatively
(``from .model import _conv, _linear``), the reference's own helpers, and nothing else.
It is loaded as a module of the benchmark's package.  It exports:

``features(P, model, x, q) -> {name: map}``
    The backbone's maps of ``x``, the (1, H, W, 3) normalised and padded fp32 image, from
    the weights ``P`` (a dict of tensors keyed by the port's parameter names) and the
    configuration's ``model`` object: one NCHW fp32 map under each name in
    ``model["pixel_decoder"]["in_features"]``, as ``model.swin`` and ``model.resnet``
    return them.  TF32 is the caller's to set.  Every matmul and convolution operand
    goes through ``q``, as there, so that the control's fp8 operands reach it.
``flops(model, h, w) -> (int, {name: (channels, hw)})``
    The backbone's operations on an (h, w) padded image, two per multiply-add of every
    matmul, convolution and attention product, as ``FlopCounterMode`` counts them on
    ``features``; and each map's channels and number of positions, as
    ``workcount.swin_flops`` and ``workcount.resnet_flops`` give them.
"""
