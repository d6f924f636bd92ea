"""FP8 gradient compression with error feedback (port of
``repro/distributed/grad_compress.py``).

Gradients cross the interconnect in fp8 (4x fewer bytes than an f32
all-reduce) while an error-feedback buffer re-injects the quantization
residual into the next step, keeping the accumulated bias negligible.

* :func:`compress_decompress` — value-level compress (+ error feedback),
  for tests and for wrapping grads before the optimizer;
* :func:`compress_tree` — the same over every leaf of a grad tree;
* :func:`compressed_psum` — the collective form; it waits for the port's
  mesh (ROADMAP item A9b) and raises until then.
"""
from __future__ import annotations

import torch

from repro_torch.nn.spec import sorted_leaves, tree_from_flat
from repro_torch.quant import qtensor

__all__ = ["compress_decompress", "compressed_psum", "compress_tree"]


def compress_decompress(g: torch.Tensor, err: torch.Tensor,
                        fmt_name: str = "fp8_e4m3") -> tuple:
    """Returns (g_compressed_roundtrip, new_err): ``g + err`` is quantized
    (per-tensor amax scale); the residual becomes the next step's error
    feedback."""
    target = g + err
    q = qtensor.fake_quant(target.float(), fmt_name)
    new_err = target - q
    return q.to(g.dtype), new_err.to(err.dtype)


def compress_tree(grads: dict, err_tree: dict,
                  fmt_name: str = "fp8_e4m3") -> tuple:
    """:func:`compress_decompress` on every leaf; returns (grads, errors)
    as trees of the shape of ``grads``, the leaves of ``err_tree`` taken in
    the same order."""
    outs, errs = {}, {}
    for (path, g), (_, e) in zip(sorted_leaves(grads),
                                 sorted_leaves(err_tree)):
        outs[path], errs[path] = compress_decompress(g, e, fmt_name)
    return tree_from_flat(outs), tree_from_flat(errs)


def compressed_psum(x: torch.Tensor, axis_name: str,
                    fmt_name: str = "fp8_e4m3") -> torch.Tensor:
    """All-reduce with an fp8 wire format: needs the port's mesh."""
    raise NotImplementedError(
        "compressed_psum is the sharded trainer's all-reduce, which lands "
        "with the training half of ROADMAP item A9b; compress_decompress / "
        "compress_tree work on one device")
