"""Weights for the port: random init, and loading the JAX package's params.

Parameter names follow the Flax modules, so the map is mechanical:

- conv ``kernel``: Flax HWIO ↔ torch OIHW;
- Dense ``fc.kernel [in, out]`` ↔ ``nn.Linear`` ``fc.weight [out, in]``;
- everything else (BN ``scale``/``bias``, biases) carries over as is.
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


def load_cell(variables, module: nn.Module) -> None:
    """Copy one cell's Flax variables (numpy leaves; the ``params``
    collection or the dict holding it) into ``module``'s parameters. Every
    parameter on both sides must be matched."""
    params = variables.get("params", variables)
    own = dict(module.named_parameters())
    seen = set()
    for name, a in _flatten(params):
        tname, ta = _to_torch(name, a)
        if tname not in own:
            raise KeyError(f"no parameter {tname!r} (from Flax {name!r}) in {type(module).__name__}")
        p = own[tname]
        if tuple(p.shape) != ta.shape:
            raise ValueError(f"{tname}: shape {tuple(p.shape)} != {ta.shape}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(ta)))
        seen.add(tname)
    missing = set(own) - seen
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
