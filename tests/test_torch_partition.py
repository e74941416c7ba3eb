"""Stage partitioning and shape tracing of the port
(``mpi4dl_tpu_torch.parallel.partition``) against the JAX package's
(``mpi4dl_tpu.parallel.partition``), CPU.

- ``stage_bounds`` and ``split_cells`` over a grid of (cells, split,
  balance): the same bounds, or the same refusal (``ValueError``).
- The per-stage output shapes of a forward on the meta device
  (``trace_shapes``) against JAX's ``jax.eval_shape`` ones, NHWC, on
  ResNet-v1 depth 8 and AmoebaNet-D 3L/32F @64 (whose stage boundaries are
  ``(concat, skip)`` tuples), over several splits and a balance.
- ``spatial_shape`` and the config's pipeline fields (``lp_stages``,
  ``num_devices``) as JAX's.
"""

import pytest
import torch

from mpi4dl_tpu import config as jax_config
from mpi4dl_tpu.models.amoebanet import amoebanetd as jax_amoebanetd
from mpi4dl_tpu.models.resnet import get_resnet_v1 as jax_resnet_v1
from mpi4dl_tpu.parallel import partition as jax_partition
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.models.resnet import get_resnet_v1
from mpi4dl_tpu_torch.parallel import partition

torch.set_num_threads(1)

GRID = [(n, split, balance) for n in (1, 2, 5, 9, 10) for split in (0, 1, 2, 3, 4, 11)
        for balance in (None, "even", "front", "short", "long")]


def _balance(n, split, kind):
    if kind is None or split < 1:
        return None
    if kind == "even":
        return [n // split] * (split - 1) + [n - (n // split) * (split - 1)]
    if kind == "front":
        return [n - (split - 1)] + [1] * (split - 1)
    if kind == "short":
        return [1] * (split - 1)  # one entry too few
    return [1] * split + [0]  # "long": one entry too many


def _jax_or_error(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return ValueError


@pytest.mark.parametrize("n,split,kind", GRID)
def test_stage_bounds_and_split_match_jax(n, split, kind):
    balance = _balance(n, split, kind)
    want = _jax_or_error(jax_partition.stage_bounds, n, split, balance)
    if want is ValueError:
        with pytest.raises(ValueError):
            partition.stage_bounds(n, split, balance)
        with pytest.raises(ValueError):
            partition.split_cells(list(range(n)), split, balance)
        return
    assert partition.stage_bounds(n, split, balance) == want
    cells = [f"c{i}" for i in range(n)]
    assert partition.split_cells(cells, split, balance) == jax_partition.split_cells(
        cells, split, balance)


def _nested(shapes):
    """A JAX shape tree (tuples of ints, or tuples of them) as tuples."""
    if isinstance(shapes, (tuple, list)) and shapes and isinstance(shapes[0], (tuple, list)):
        return tuple(tuple(s) for s in shapes)
    return tuple(shapes)


MODELS = {
    "resnet_v1_d8": (lambda: jax_resnet_v1(depth=8, num_classes=10),
                     lambda: get_resnet_v1(8, 10), 32),
    "amoebanet_3l32f": (lambda: jax_amoebanetd(num_classes=10, num_layers=3, num_filters=32),
                        lambda: amoebanetd(10, 3, 32), 64),
}


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("split,balance", [(2, None), (3, None), (4, "front")])
def test_meta_traced_stage_shapes_match_eval_shape(name, split, balance):
    jax_build, build, size = MODELS[name]
    jcells, cells = jax_build(), build()
    n = len(cells)
    assert n == len(jcells)
    bal = _balance(n, split, balance)
    want = jax_partition.trace_shapes(jcells, split, (2, size, size, 3), bal)
    got = partition.trace_shapes(cells, split, (2, size, size, 3), bal)
    assert [_nested(s) for s in got] == [_nested(s) for s in want]


def test_bf16_model_boundaries_are_bf16():
    """A bf16 model's stage boundaries carry bf16 from an f32 input, as the
    JAX pipeline's wires do (``pipeline.py:336-356``)."""
    cells = list(amoebanetd(10, 3, 32, dtype=torch.bfloat16))
    out, shapes = partition.eval_stage_shapes(cells[:3], partition.meta_input((2, 64, 64, 3)))
    assert isinstance(out, tuple) and len(shapes) == 2
    assert all(t.dtype == torch.bfloat16 for t in out)


def test_eval_stage_shapes_is_a_meta_walk():
    """No parameter moves and nothing runs on real memory: the cells stay
    where they are and the output is on the meta device."""
    cells = list(get_resnet_v1(8, 10))
    before = [p.data_ptr() for c in cells for p in c.parameters()]
    out, shapes = partition.eval_stage_shapes(cells, partition.meta_input((4, 32, 32, 3)))
    assert out.is_meta and shapes == (4, 10)
    assert [p.data_ptr() for c in cells for p in c.parameters()] == before


def test_spatial_shape_matches_jax():
    for shape, tiles in [((2, 32, 32, 3), (2, 2)), ((2, 32, 32, 3), (1, 4)),
                         ((1, 64, 16, 8), (4, 1))]:
        assert partition.spatial_shape(shape, tiles) == jax_partition.spatial_shape(shape, tiles)
    with pytest.raises(ValueError):
        partition.spatial_shape((2, 30, 32, 3), (4, 1))


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=4, parts=2, split_size=2), dict(batch_size=8, parts=4, split_size=4),
    dict(batch_size=4, parts=1, split_size=1), dict(batch_size=4, split_size=1, spatial_size=1),
    dict(batch_size=4, parts=2, split_size=3, balance=(2, 1, 5)),
])
def test_config_pipeline_fields_match_jax(kwargs):
    want = jax_config.ParallelConfig(image_size=32, **kwargs)
    got = ParallelConfig(image_size=32, **kwargs)
    assert (got.lp_stages, got.num_devices, got.micro_batch_size()) == (
        want.lp_stages, want.num_devices, want.micro_batch_size())
    assert got.balance == (tuple(want.balance) if want.balance is not None else None)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(batch_size=4, parts=3, split_size=2), ValueError),
    (dict(batch_size=4, parts=0, split_size=2), ValueError),
    (dict(batch_size=4, split_size=0), ValueError),
    (dict(batch_size=4, parts=2, split_size=2, balance=(1, 2, 3)), ValueError),
    # What stays refused since the SP+LP slice lifted the front, DP and
    # local DP, and the GEMS slice ``times > 1``: local DP without a front
    # or off the tile count, an increasing skewed list, and ``times < 1``.
    (dict(batch_size=4, split_size=2, spatial_size=1, num_spatial_parts=(2, 4)), ValueError),
    (dict(batch_size=4, split_size=2, spatial_size=1, local_dp=2), ValueError),
    (dict(batch_size=4, split_size=2, local_dp=4), ValueError),
    pytest.param(dict(batch_size=4, split_size=2, times=0), ValueError, id="times_below_one"),
    (dict(batch_size=4, split_size=2, precision="fp16"), ValueError),
])
def test_config_refusals(kwargs, exc):
    with pytest.raises(exc):
        ParallelConfig(image_size=32, **kwargs)
