"""Stage partitioning and shape tracing (twin of
``mpi4dl_tpu/parallel/partition.py``).

A model is a flat cell sequence. :func:`stage_bounds` and
:func:`split_cells` cut it into ``split_size`` contiguous stages (an even
split with the remainder in the last stage, or a user ``balance``), as the
reference's ``get_start_end_layer_index`` does (``mp_pipeline.py:41-69``).
The reference finds each stage's output shape by a dry run on the GPU; the
JAX package uses ``jax.eval_shape``; here the cells run on the meta device
(:func:`eval_stage_shapes`), which touches no memory and launches nothing.
Shapes are NHWC, as the JAX package reports them; a tuple state
(AmoebaNet's ``(concat, skip)``) gives a tuple of shapes.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch


def stage_bounds(num_layers: int, split_size: int,
                 balance: Sequence[int] | None = None) -> list[tuple[int, int]]:
    """Per-stage ``(start, end)`` cell indices (``partition.py:21-52``)."""
    if split_size < 1:
        raise ValueError("split_size must be >= 1")
    if balance is not None:
        if len(balance) != split_size:
            raise ValueError("balance list length must equal split_size")
        if sum(balance) != num_layers:
            raise ValueError(
                f"balance {tuple(balance)} sums to {sum(balance)}, "
                f"model has {num_layers} layers"
            )
        bounds, start = [], 0
        for b in balance:
            bounds.append((start, start + b))
            start += b
        return bounds
    if split_size > num_layers:
        raise ValueError(f"cannot split {num_layers} layers into {split_size} stages")
    per = num_layers // split_size
    bounds = [(i * per, (i + 1) * per) for i in range(split_size)]
    bounds[-1] = (bounds[-1][0], num_layers)
    return bounds


def split_cells(cells: Sequence[Any], split_size: int,
                balance: Sequence[int] | None = None) -> list[list[Any]]:
    """Slice a flat cell list into per-stage cell lists
    (``partition.py:55-62``)."""
    cells = list(cells)
    return [cells[s:e] for s, e in stage_bounds(len(cells), split_size, balance)]


def _nhwc(t: torch.Tensor) -> tuple:
    return (t.shape[0], *t.shape[2:], t.shape[1]) if t.dim() == 4 else tuple(t.shape)


def _shapes(h):
    if isinstance(h, (tuple, list)):
        return tuple(_nhwc(t) for t in h)
    return _nhwc(h)


def meta_input(shape: Sequence[int], dtype=torch.float32):
    """A meta tensor of NHWC ``shape`` in the port's NCHW layout (a tuple of
    shapes gives a tuple state)."""
    if shape and isinstance(shape[0], (tuple, list)):
        return tuple(meta_input(s, dtype) for s in shape)
    b, h, w, c = shape
    return torch.empty((b, c, h, w), dtype=dtype, device="meta")


def eval_stage_shapes(cells: Sequence[Any], x):
    """One pass of ``cells`` over the meta state ``x`` (a meta tensor, NCHW,
    or a tuple of them). Returns ``(out, shapes)``: the meta output and its
    NHWC shape (a tuple of shapes for a tuple state)
    (``partition.py:88-111``)."""
    from mpi4dl_tpu_torch.ops.layers import bn_stats_mode
    from mpi4dl_tpu_torch.train import meta_cell

    h = x
    for cell in cells:
        with bn_stats_mode(cell, "batch"):
            h = meta_cell(cell, h)
    return h, _shapes(h)


def trace_shapes(cells: Sequence[Any], split_size: int, input_shape: Sequence[int],
                 balance: Sequence[int] | None = None, dtype=torch.float32) -> list[Any]:
    """Per-stage NHWC output shapes of ``cells`` cut into ``split_size``
    stages, for an NHWC input of ``input_shape`` (``partition.py:114-135``)."""
    x = meta_input(input_shape, dtype)
    shapes: list[Any] = []
    for stage in split_cells(cells, split_size, balance):
        x, stage_shapes = eval_stage_shapes(stage, x)
        shapes.append(stage_shapes)
    return shapes


def spatial_shape(shape: Sequence[int], tile_shape: tuple[int, int]) -> tuple[int, ...]:
    """Per-tile shape of a spatially partitioned NHWC activation
    (``partition.py:138-144``)."""
    b, h, w, c = shape
    th, tw = tile_shape
    if h % th or w % tw:
        raise ValueError(f"activation {shape} not divisible by tile grid {tile_shape}")
    return (b, h // th, w // tw, c)


def joined_state(h, tile_shape: tuple[int, int], batch: int | None = None):
    """The meta state ``h`` (NCHW, a tensor or a tuple of them) of one tile
    as the SP -> plain join gives it: H and W times the grid
    (``train.py:361-374``), and ``batch`` rows when given (LOCAL_DP_LP's
    slice, ``pipeline.py:334-343``)."""
    th, tw = tile_shape
    out = [torch.empty((t.shape[0] if batch is None else batch, t.shape[1],
                        t.shape[2] * th, t.shape[3] * tw), dtype=t.dtype, device="meta")
           for t in (h if isinstance(h, (tuple, list)) else (h,))]
    return tuple(out) if isinstance(h, (tuple, list)) else out[0]
