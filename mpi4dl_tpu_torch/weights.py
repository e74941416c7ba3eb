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
    a JAX ``TrainState`` (see the module docstring)."""
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
    trainer's params, momentum buffers and step."""
    n = len(trainer.model)
    trace = state["opt_state"]["0"]["trace"]
    if len(state["params"]) != n or len(trace) != n:
        raise ValueError(f"{len(state['params'])} cells of params and {len(trace)} of momentum "
                         f"for {n} cells")
    params = [_torch_named(state["params"][str(i)].get("params", {})) for i in range(n)]
    momentum = [_torch_named(trace[str(i)].get("params", {})) for i in range(n)]
    trainer.load_state_tensors(params, momentum, int(np.asarray(state["step"])))
