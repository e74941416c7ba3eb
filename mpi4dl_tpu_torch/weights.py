"""Weights for the port: random init, and loading the JAX package's params.

Parameter names follow the Flax modules, so the map is mechanical:

- conv ``kernel``: Flax HWIO ↔ torch OIHW;
- Dense ``fc.kernel [in, out]`` ↔ ``nn.Linear`` ``fc.weight [out, in]``;
- everything else (BN ``scale``/``bias``, biases) carries over as is.

:func:`flax_state` and :func:`load_flax_state` carry a whole training state
(params, SGD momentum buffers, step) to and from the state dict of the JAX
package's ``TrainState`` (``mpi4dl_tpu/train.py:188-191``): per cell
``{"params": ...}``, the optax ``sgd(lr, momentum)`` state ``({"trace":
params-shaped}, EmptyState())`` as ``{"0": {"trace": ...}, "1": {}}``, and
an int32 step. Arrays are numpy, in their logical C order whatever the
tensors' memory format.

The JAX ``PipelineTrainer`` keeps its params as one flat row per device
(``stack_pipeline``, ``unstack_pipeline``, ``from_jax_pipeline_params``);
:func:`pipeline_flax_state` and :func:`load_pipeline_flax_state` carry a
pipeline trainer's state in that layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from mpi4dl_tpu_torch.models.amoebanet import Classify
from mpi4dl_tpu_torch.ops.fastconv import FastConv
from mpi4dl_tpu_torch.ops.layers import Dense, TrainBatchNorm

_OWN_INIT = (FastConv, TrainBatchNorm, Dense, Classify)


def init(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Flax's initializers, drawn from ``generator`` in module order:
    lecun-normal conv and dense kernels, zero biases, BN scale 1 / bias 0."""
    for m in model.modules():
        if isinstance(m, _OWN_INIT):
            m.reset_parameters(generator)
    return model


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if hasattr(v, "items"):  # dict or FrozenDict
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def _to_torch(name: str, a: np.ndarray) -> tuple[str, np.ndarray]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel" and a.ndim == 4:
        return name, a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and a.ndim == 2:
        return name[: -len("kernel")] + "weight", a.T  # [in,out] -> [out,in]
    return name, a


def _to_flax(name: str, a: np.ndarray) -> tuple[str, np.ndarray]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel" and a.ndim == 4:
        return name, a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if leaf == "weight" and a.ndim == 2:
        return name[: -len("weight")] + "kernel", a.T
    return name, a


def _torch_named(params) -> dict[str, np.ndarray]:
    """A Flax params tree as ``{torch parameter name: array}`` in the
    torch layouts."""
    return dict(_to_torch(name, a) for name, a in _flatten(params))


def load_cell(variables, module: nn.Module) -> None:
    """Copy one cell's Flax variables (numpy leaves; the ``params``
    collection or the dict holding it) into ``module``'s parameters. Every
    parameter on both sides must be matched."""
    own = dict(module.named_parameters())
    given = _torch_named(variables.get("params", variables))
    for tname, ta in given.items():
        if tname not in own:
            raise KeyError(f"no parameter {tname!r} (from Flax) in {type(module).__name__}")
        p = own[tname]
        if tuple(p.shape) != ta.shape:
            raise ValueError(f"{tname}: shape {tuple(p.shape)} != {ta.shape}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(ta)))
    missing = set(own) - set(given)
    if missing:
        raise KeyError(f"parameters without a Flax value: {sorted(missing)}")


def from_jax_params(cell_params, model: nn.Module) -> nn.Module:
    """Load the JAX package's per-cell variable dicts (numpy arrays) into
    the port's cells, cell ``i`` into ``model[i]``."""
    cells = list(model.children())
    if len(cells) != len(cell_params):
        raise ValueError(f"{len(cell_params)} Flax cells for {len(cells)} torch cells")
    for variables, cell in zip(cell_params, cells):
        load_cell(variables, cell)
    return model


def flax_arrays(module: nn.Module, grads: bool = False) -> dict[str, np.ndarray]:
    """``module``'s parameters (or their ``.grad``) as numpy arrays under
    their Flax names and layouts (f32)."""
    out = {}
    for name, p in module.named_parameters():
        t = p.grad if grads else p
        fname, a = _to_flax(name, t.detach().float().cpu().numpy())
        out[fname] = np.array(a)  # a copy: CPU tensors share numpy memory
    return out


def _nest(flat: dict) -> dict:
    """``{"a.b.c": v}`` -> ``{"a": {"b": {"c": v}}}``."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def flax_tree(named: dict) -> dict:
    """One cell's ``{torch parameter name: tensor}`` (parameters, or their
    momentum buffers) as its Flax variables ``{"params": nested numpy}``
    (``{}`` for a cell without parameters, as Flax's ``init`` gives)."""
    if not named:
        return {}
    return {"params": _nest(dict(
        _to_flax(name, t.detach().cpu().numpy()) for name, t in named.items()))}


def flax_state(trainer) -> dict:
    """The trainer's (params, momentum buffers, step) as the state dict of
    a JAX ``TrainState`` (see the module docstring). A pipeline trainer's
    is :func:`pipeline_flax_state`'s (collective; None off rank 0)."""
    if getattr(trainer, "is_pipeline", False):
        return pipeline_flax_state(trainer)
    params, momentum, step = trainer.state_tensors()
    return {
        "params": {str(i): flax_tree(p) for i, p in enumerate(params)},
        "opt_state": {"0": {"trace": {str(i): flax_tree(m) for i, m in enumerate(momentum)}},
                      "1": {}},
        "step": np.asarray(step, np.int32),
    }


def load_flax_state(state: dict, trainer) -> None:
    """Load a JAX ``TrainState`` state dict (as :func:`flax_state` writes
    it, or a JAX checkpoint's ``state.msgpack``), matched by name, into the
    trainer's params, momentum buffers and step (a pipeline trainer's:
    :func:`load_pipeline_flax_state`)."""
    if getattr(trainer, "is_pipeline", False):
        return load_pipeline_flax_state(state, trainer)
    n = len(trainer.model)
    trace = state["opt_state"]["0"]["trace"]
    if len(state["params"]) != n or len(trace) != n:
        raise ValueError(f"{len(state['params'])} cells of params and {len(trace)} of momentum "
                         f"for {n} cells")
    params = [_torch_named(state["params"][str(i)].get("params", {})) for i in range(n)]
    momentum = [_torch_named(trace[str(i)].get("params", {})) for i in range(n)]
    trainer.load_state_tensors(params, momentum, int(np.asarray(state["step"])))


# -- the JAX pipeline's flat parameter layout ---------------------------------
#
# The JAX ``PipelineTrainer`` holds its params as ``(front_flat, stacked)``
# (``pipeline.py:362-413``): each virtual stage's per-cell variables
# flattened in ``jax.tree.flatten`` order (``_TreeMeta``, ``:96-133``: dict
# keys sorted at every level, Flax layouts, f32) and concatenated; row ``d``
# of ``stacked [S, MAXP]`` is the concatenation of the stages device ``d``
# hosts (``_stages_of_device``), zero-padded to the longest row. No spatial
# front here, so ``front_flat`` is empty.

def _flax_name(name: str, ndim: int) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and ndim == 2:
        return name[: -len("weight")] + "kernel"
    return name


def _flax_layout(t: torch.Tensor) -> torch.Tensor:
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    if t.dim() == 2:
        return t.t()  # [out, in] -> [in, out]
    return t


def _torch_layout(flat: torch.Tensor, shape) -> torch.Tensor:
    if len(shape) == 4:
        o, i, h, w = shape
        return flat.view(h, w, i, o).permute(3, 2, 0, 1)
    if len(shape) == 2:
        return flat.view(shape[1], shape[0]).t()
    return flat.view(shape)


def leaf_order(cell: nn.Module) -> list[tuple[str, torch.nn.Parameter]]:
    """``cell``'s ``(torch name, parameter)`` pairs in the order
    ``jax.tree.flatten`` gives its Flax params (sorted Flax paths)."""
    named = [(tuple(_flax_name(n, p.dim()).split(".")), n, p)
             for n, p in cell.named_parameters()]
    return [(n, p) for _, n, p in sorted(named, key=lambda e: e[0])]


def cells_size(cells) -> int:
    return sum(p.numel() for cell in cells for p in cell.parameters())


def flatten_cells(cells, values=None) -> torch.Tensor:
    """The parameters of ``cells`` (or ``values``: per cell, ``{torch name:
    tensor}`` of the parameters' shapes, such as momentum buffers) as one
    1-D f32 tensor in the JAX flatten order and Flax layouts, on the
    tensors' device."""
    parts = []
    for i, cell in enumerate(cells):
        for name, p in leaf_order(cell):
            t = p if values is None else values[i][name]
            parts.append(_flax_layout(torch.as_tensor(t).detach()).reshape(-1).float())
    if not parts:
        return torch.zeros(0)
    return torch.cat(parts)


def unflatten_cells(flat: torch.Tensor, cells) -> list[dict]:
    """Inverse of :func:`flatten_cells`: per cell, ``{torch name: tensor}``
    (views of ``flat`` in the torch layouts)."""
    out, off = [], 0
    for cell in cells:
        named = {}
        for name, p in leaf_order(cell):
            n = p.numel()
            named[name] = _torch_layout(flat[off:off + n], tuple(p.shape))
            off += n
        out.append(named)
    if off != flat.numel():
        raise ValueError(f"{flat.numel()} values for {off} parameters")
    return out


def pipeline_layout(model: nn.Module, stages, placement):
    """``(offsets, max_p)`` of the stacked layout: ``offsets[d]`` lists
    ``(virtual stage, offset, size)`` of each stage device ``d`` hosts,
    in its row (``pipeline.py:397-407``); ``stages`` lists each virtual
    stage's cell indices, ``placement[d]`` the stages of device ``d``."""
    cells = list(model)
    sizes = [cells_size(cells[i] for i in st) for st in stages]
    offsets, rows = [], []
    for hosted in placement:
        off, row = 0, []
        for k in hosted:
            row.append((k, off, sizes[k]))
            off += sizes[k]
        offsets.append(row)
        rows.append(off)
    return offsets, max(rows)


def unstack_pipeline(stacked, model: nn.Module, stages, placement) -> list[dict]:
    """The stacked ``[S, MAXP]`` array (params or momentum of the JAX
    pipeline's layout) as per cell ``{torch name: tensor}``, for every cell
    of ``model``, in the torch layouts (``PipelineTrainer.unstack_params``,
    ``pipeline.py:415-432``)."""
    stacked = torch.from_numpy(np.array(stacked, np.float32))
    cells = list(model)
    offsets, max_p = pipeline_layout(model, stages, placement)
    if tuple(stacked.shape) != (len(placement), max_p):
        raise ValueError(f"stacked {tuple(stacked.shape)} for the layout [{len(placement)}, "
                         f"{max_p}]")
    out: list = [None] * len(cells)
    for d, row in enumerate(offsets):
        for k, off, size in row:
            ids = stages[k]
            for i, named in zip(ids, unflatten_cells(stacked[d, off:off + size],
                                                     [cells[i] for i in ids])):
                out[i] = named
    return out


def stack_pipeline(values, model: nn.Module, stages, placement) -> np.ndarray:
    """Per cell ``{torch name: tensor}`` (``values``; None: the parameters)
    as the stacked ``[S, MAXP]`` f32 array of the JAX pipeline's layout."""
    cells = list(model)
    offsets, max_p = pipeline_layout(model, stages, placement)
    out = np.zeros((len(placement), max_p), np.float32)
    for d, row in enumerate(offsets):
        for k, off, size in row:
            ids = stages[k]
            vals = None if values is None else [values[i] for i in ids]
            out[d, off:off + size] = flatten_cells([cells[i] for i in ids], vals).cpu().numpy()
    return out


def from_jax_pipeline_params(params, model: nn.Module, stages, placement) -> nn.Module:
    """Load the JAX ``PipelineTrainer``'s params ``(front_flat, stacked)``
    (numpy) into ``model``'s cells."""
    front, stacked = params
    if np.asarray(front).size:
        raise NotImplementedError("a spatial front's params come with the SP+LP slice "
                                  "(ROADMAP queue 1 item 5)")
    with torch.no_grad():
        for cell, named in zip(model, unstack_pipeline(stacked, model, stages, placement)):
            own = dict(cell.named_parameters())
            for name, v in named.items():
                own[name].copy_(v)
    return model


def pipeline_flax_state(trainer) -> dict | None:
    """The pipeline trainer's (params, momentum, step) as the state dict of
    the JAX ``PipelineTrainer``'s ``TrainState`` (``params = (front_flat,
    stacked)``, the optax trace of the same layout, the step). Collective:
    every rank sends its row to rank 0, which returns the dict; the other
    ranks return None."""
    params, momentum = trainer.stacked_rows("params"), trainer.stacked_rows("momentum")
    if params is None:
        return None
    front = np.zeros((0,), np.float32)
    return {
        "params": {"0": front, "1": params},
        "opt_state": {"0": {"trace": {"0": front.copy(), "1": momentum}}, "1": {}},
        "step": np.asarray(trainer.step, np.int32),
    }


def load_pipeline_flax_state(state: dict, trainer) -> None:
    """Load a JAX pipeline ``TrainState`` state dict (as
    :func:`pipeline_flax_state` writes it, or a JAX checkpoint's) into this
    rank's stages."""
    trace = state["opt_state"]["0"]["trace"]
    for front in (state["params"]["0"], trace["0"]):
        if np.asarray(front).size:
            raise NotImplementedError("a spatial front's state comes with the SP+LP slice "
                                      "(ROADMAP queue 1 item 5)")
    trainer.load_rows(np.asarray(state["params"]["1"]), np.asarray(trace["1"]),
                      int(np.asarray(state["step"])))
