"""FP8 gradient compression with error feedback (port of
``repro/distributed/grad_compress.py``).

Gradients cross the interconnect in fp8 (4x fewer bytes than an f32
all-reduce) while an error-feedback buffer re-injects the quantization
residual into the next step, keeping the accumulated bias negligible.

* :func:`compress_decompress` — value-level compress (+ error feedback),
  for tests and for wrapping grads before the optimizer;
* :func:`compress_tree` — the same over every leaf of a grad tree;
* :func:`compressed_psum` — the collective form, over an axis of the
  current mesh layout: quantize with a scale shared over the axis, sum the
  fp8 codes in f32, dequantize.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (current_serving_layout,
                                              record_collective)
from repro_torch.nn.spec import sorted_leaves, tree_from_flat
from repro_torch.quant import qtensor
from repro_torch.quant.formats import cast_to, get_format, true_div

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
    """All-reduce with an fp8 wire format over ``axis_name`` (``data`` or
    ``model``) of the current mesh layout (``sharding.serving_layout_scope``;
    one rank without a layout), as the reference's inside ``shard_map``:
    the amax maxed over the axis, every shard cast to the format with the
    shared scale (``formats.cast_to``, not PyTorch's saturating cast), the
    codes summed in f32 and divided by the scale (``true_div``). No trainer
    calls it: the gradients' all-reduce is an f32 sum, as the reference
    trainer's."""
    fmt = get_format(fmt_name)
    layout = current_serving_layout()
    if layout is not None and axis_name not in layout.sizes:
        raise ValueError(f"no mesh axis {axis_name!r} in the current layout "
                         f"({sorted(layout.sizes)})")
    group = None if layout is None else layout.group(axis_name)
    xf = x.float()
    amax = xf.abs().amax()
    if group is not None:
        amax = amax.clone()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        record_collective("all-reduce", amax)
    scale = true_div(fmt.max_value, torch.clamp_min(amax, 1e-12))
    s = cast_to(xf * scale, fmt.dtype).float()
    if group is not None:
        dist.all_reduce(s, group=group)
        record_collective("all-reduce", s)
    return true_div(s, scale).to(x.dtype)
