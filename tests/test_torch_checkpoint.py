"""Checkpoints of the port (``mpi4dl_tpu_torch.checkpoint``) against the JAX
package's (``mpi4dl_tpu.checkpoint``), CPU.

- The msgpack codec (``mpi4dl_tpu_torch.serialization``): its bytes equal
  ``msgpack.packb(..., use_bin_type=True)`` with flax's ext hook (and
  ``flax.serialization.msgpack_serialize``) on generated trees: every int
  width, floats, nil, bool, str and bin lengths across their length codes,
  nested maps of 0-70000 entries, f32 / bf16 / int32 arrays with 0-d ones
  and numpy scalars, torch tensors (channels_last ones too), and a chunked
  array with ``MAX_CHUNK_SIZE`` patched small in both packages. Decoding
  gives back every value (bf16 as ``torch.bfloat16``, bit for bit).
- Port -> JAX: a port trainer (JAX init, two SGD-momentum steps) saved by
  the port restores through JAX's ``restore_checkpoint`` into a JAX
  ``TrainState``; params, momentum trace and step exactly equal after the
  layout map (ResNet-v2 depth 11 @32, AmoebaNet-D 3L/32F @64, bs2).
- JAX -> port: a JAX checkpoint with ``model_metadata`` and calibrated
  ``batch_stats`` rebuilds through the port's ``rebuild_from_checkpoint``;
  the port's ``make_predict`` logits match JAX's ``make_predict`` within
  1e-4 of max |logit| (f32, the same seeded batch).
- Resume is exact on the CPU: k steps, save, restore into a fresh trainer
  (other weights), continue: losses, params and momentum bit-equal to the
  uninterrupted run, also from a step-0 checkpoint (zero momentum).
- Pruning, ``latest_checkpoint``, the refusal without a ``model`` block and
  the metadata's dtype names behave as in JAX.
"""

import copy
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from mpi4dl_tpu import checkpoint as jax_ckpt
from mpi4dl_tpu import evaluate as jax_eval
from mpi4dl_tpu.models.amoebanet import amoebanetd as jax_amoebanetd
from mpi4dl_tpu.models.resnet import get_resnet_v2 as jax_resnet_v2
from mpi4dl_tpu.parallel.partition import init_cells
from mpi4dl_tpu.train import TrainState, make_optimizer
from mpi4dl_tpu_torch import checkpoint, evaluate, serialization
from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.models.resnet import get_resnet_v1, get_resnet_v2
from mpi4dl_tpu_torch.train import Trainer
from mpi4dl_tpu_torch.weights import _to_flax, flax_arrays, from_jax_params, init

torch.set_num_threads(1)

LOGIT_TOL = 1e-4  # of max |logit|, f32 both sides
# (name, JAX builder, port builder, image size, model_metadata spec)
MODELS = {
    "resnet_v2_d11": (lambda: jax_resnet_v2(11, 10, pool_kernel=8),
                      lambda: get_resnet_v2(11, 10, pool_kernel=8), 32,
                      ("resnet_v2", dict(depth=11, num_classes=10, pool_kernel=8))),
    "amoebanet_3l32f": (lambda: jax_amoebanetd(10, 3, 32), lambda: amoebanetd(10, 3, 32), 64,
                        ("amoebanet", dict(num_classes=10, num_layers=3, num_filters=32))),
}


def _flax_pack(tree) -> bytes:
    return msgpack.packb(tree, use_bin_type=True, default=flax_ser._msgpack_ext_pack,
                         strict_types=True)


def _assert_tree_equal(got, want, bf16=torch.Tensor):
    """Decoded trees: same keys, values and bits (bf16 arrays as ``bf16``:
    torch tensors from the port, numpy arrays from flax)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k], bf16)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w, bf16)
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        if w.dtype == ml_dtypes.bfloat16:
            assert isinstance(got, bf16) and tuple(got.shape) == w.shape
            bits = (got.view(torch.int16).numpy() if bf16 is torch.Tensor
                    else np.asarray(got).view(np.int16))
            np.testing.assert_array_equal(bits, w.view(np.int16))
        else:
            g = np.asarray(got)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
            assert isinstance(got, np.ndarray) == isinstance(want, np.ndarray)
    else:
        assert type(got) is type(want) and got == want


def _tree(kind):
    rng = np.random.default_rng(3)
    if kind == "scalars":
        ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**64 - 1,
                -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
        return {"ints": {str(i): v for i, v in enumerate(ints)}, "f": 1.25, "neg": -3e300,
                "t": True, "no": False, "nil": None, "s0": "", "s31": "a" * 31, "s32": "b" * 32,
                "s300": "c" * 300, "s70k": "d" * 70000, "utf": "héllo ✓", "bin": b"q" * 300,
                "bin70k": b"r" * 70000, "lst": [1, "x", None, 2.5] * 5}
    if kind == "arrays":
        return {"f32": rng.standard_normal((3, 4, 5)).astype(np.float32),
                "bf16": rng.standard_normal((7, 2)).astype(ml_dtypes.bfloat16),
                "i32": rng.integers(-9, 9, size=(2, 3)).astype(np.int32),
                "f32_0d": np.asarray(1.5, np.float32), "bf16_0d": np.asarray(2.0, ml_dtypes.bfloat16),
                "i32_0d": np.asarray(-7, np.int32), "np_f32": np.float32(3.5),
                "np_i64": np.int64(-5), "np_bool": np.bool_(True), "empty": np.zeros((0, 3), np.float32),
                "u8_70k": rng.integers(0, 255, size=(70000,)).astype(np.uint8)}
    assert kind == "nested"
    return {"a": {str(i): {"w": rng.standard_normal((i + 1,)).astype(np.float32)} for i in range(16)},
            "empty": {}, "wide": {str(i): i for i in range(70000)},
            "deep": {"x": {"y": {"z": {"params": {"kernel": np.ones((3, 3, 2, 4), np.float32)}}}}}}


@pytest.mark.parametrize("kind", ["scalars", "arrays", "nested"])
def test_codec_bytes_equal_msgpack_and_flax(kind):
    tree = _tree(kind)
    got = serialization.packb(tree)
    assert got == _flax_pack(tree)
    assert serialization.msgpack_serialize(tree) == flax_ser.msgpack_serialize(
        copy.deepcopy(tree), in_place=True)
    _assert_tree_equal(serialization.unpackb(bytearray(got)), tree)
    _assert_tree_equal(serialization.msgpack_restore(got), tree)  # read-only bytes too
    _assert_tree_equal(flax_ser.msgpack_restore(got), tree, bf16=np.ndarray)


def test_codec_torch_tensors_in_logical_order():
    """Tensors are written in their logical C order: a channels_last and a
    transposed tensor give the bytes of their numpy twins."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    b = rng.standard_normal((6, 3)).astype(ml_dtypes.bfloat16)
    i = rng.integers(0, 100, size=(4,)).astype(np.int32)
    tensors = {"cl": torch.from_numpy(a).contiguous(memory_format=torch.channels_last),
               "t": torch.from_numpy(np.ascontiguousarray(a[0].transpose(2, 1, 0))).permute(2, 1, 0),
               "bf16": torch.from_numpy(b.view(np.int16)).view(torch.bfloat16),
               "i32": torch.from_numpy(i)}
    assert not tensors["cl"].is_contiguous() and not tensors["t"].is_contiguous()
    want = {"cl": a, "t": a[0], "bf16": b, "i32": i}
    assert serialization.packb(tensors) == _flax_pack(want)


def test_codec_chunked_arrays(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes (patched to 64 in both packages)
    split into flax's chunk maps, at the root and inside maps."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(5)
    tree = {"x": rng.standard_normal((7, 9)).astype(np.float32),
            "y": {"z": np.arange(40, dtype=np.int32), "small": np.ones((3,), np.float32)},
            "bf": rng.standard_normal((50,)).astype(ml_dtypes.bfloat16)}
    got = serialization.msgpack_serialize(tree)
    assert got == flax_ser.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    assert serialization.CHUNKED.encode() in got
    _assert_tree_equal(serialization.msgpack_restore(got), tree)
    _assert_tree_equal(flax_ser.msgpack_restore(got), tree, bf16=np.ndarray)
    root = rng.standard_normal((33,)).astype(np.float32)
    assert serialization.msgpack_serialize(root) == flax_ser.msgpack_serialize(root.copy())
    np.testing.assert_array_equal(serialization.msgpack_restore(
        serialization.msgpack_serialize(root)), root)


def test_codec_refuses_malformed_input():
    data = serialization.packb({"a": np.ones((4,), np.float32)})
    with pytest.raises(ValueError):
        serialization.unpackb(data[:-3])
    with pytest.raises(ValueError):
        serialization.unpackb(data + b"\x00")
    with pytest.raises(TypeError):
        serialization.packb({1: 2})
    with pytest.raises(ValueError, match="ext code 2"):  # flax's complex scalar
        serialization.unpackb(msgpack.packb(msgpack.ExtType(2, b"\x92\x01\x02")))


# -- checkpoints between the packages -----------------------------------------

def _jax_params(name):
    jax_build, _, size, _ = MODELS[name]
    cells = jax_build()
    params = jax.jit(lambda k, x: init_cells(cells, k, x))(
        jax.random.PRNGKey(0), jnp.zeros((2, size, size, 3), jnp.float32))
    return cells, jax.tree.map(np.asarray, params)


def _batches(size, n=2, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, size, size, 3)).astype(np.float32),
             rng.integers(0, 10, size=(batch,)).astype(np.int32)) for _ in range(n)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_checkpoint_restores_in_jax(name, tmp_path):
    cells, params = _jax_params(name)
    _, build, size, _ = MODELS[name]
    trainer = Trainer(from_jax_params(params, build()), ParallelConfig(batch_size=2, image_size=size),
                      learning_rate=0.01, device="cpu")
    for x, y in _batches(size):
        trainer.train_step(x, y)
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), trainer)
    assert path.endswith("step_00000002")

    target = TrainState(params=params, opt_state=make_optimizer().init(params),
                        step=jnp.zeros((), jnp.int32))
    restored = jax_ckpt.restore_checkpoint(str(tmp_path / "ckpt"), target)
    assert int(restored.step) == 2
    trace = restored.opt_state[0].trace
    for i, cell in enumerate(trainer.model):
        got = _flat(restored.params[i])
        assert got.keys() == {f"params.{k}" for k in flax_arrays(cell)}
        for k, v in flax_arrays(cell).items():
            np.testing.assert_array_equal(got[f"params.{k}"], v)
        bufs = {}
        for pname, p in cell.named_parameters():
            fname, a = _to_flax(pname, trainer.opt.state[p]["momentum_buffer"].numpy())
            bufs[f"params.{fname}"] = a
        got = _flat(trace[i])
        assert got.keys() == bufs.keys()
        for k in bufs:
            np.testing.assert_array_equal(got[k], bufs[k])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_checkpoint_rebuilds_in_port(name, tmp_path):
    cells, params = _jax_params(name)
    _, _, size, (family, spec) = MODELS[name]
    batches = _batches(size, seed=1)
    stats = jax_eval.collect_batch_stats(cells, params, [jnp.asarray(x) for x, _ in batches])
    state = TrainState(params=params, opt_state=make_optimizer().init(params),
                       step=jnp.asarray(7, jnp.int32))
    jax_ckpt.save_checkpoint(str(tmp_path / "ckpt"), state, batch_stats=stats,
                             metadata=jax_ckpt.model_metadata(family, image_size=size,
                                                              dtype=jnp.float32, **spec))
    model, trainer, port_stats, meta = checkpoint.rebuild_from_checkpoint(
        str(tmp_path / "ckpt"), device="cpu")
    assert meta["model"]["family"] == family and trainer.step == 7
    assert len(model) == len(cells) and len(port_stats) == len(cells)
    x = _batches(size, n=1, seed=2)[0][0]
    want = np.asarray(jax_eval.make_predict(cells)(params, stats, jnp.asarray(x)))
    got = evaluate.make_predict(trainer)(port_stats, x).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale)


# -- resume, pruning, metadata ------------------------------------------------

def _small_trainer(seed=0, **kwargs):
    model = init(get_resnet_v1(8, 10, pool_kernel=4), torch.Generator().manual_seed(seed))
    return Trainer(model, ParallelConfig(batch_size=2, image_size=16), learning_rate=0.05,
                   device="cpu", **kwargs)


def _state(trainer):
    params, momentum, step = trainer.state_tensors()
    return ([{k: v.detach().clone() for k, v in p.items()} for p in params],
            [{k: v.clone() for k, v in m.items()} for m in momentum], step)


def _assert_state_equal(a, b):
    assert a[2] == b[2]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_resume_is_exact(grad_accum, tmp_path):
    batches = _batches(16, n=4, seed=3)
    full = _small_trainer(grad_accum=grad_accum)
    want = [float(full.train_step(x, y)["loss"]) for x, y in batches]
    first = _small_trainer(grad_accum=grad_accum)
    got = [float(first.train_step(x, y)["loss"]) for x, y in batches[:2]]
    checkpoint.save_checkpoint(str(tmp_path), first)
    resumed = _small_trainer(seed=9, grad_accum=grad_accum)  # other weights, no momentum
    checkpoint.restore_checkpoint(str(tmp_path), resumed)
    assert resumed.step == 2
    _assert_state_equal(_state(resumed), _state(first))
    got += [float(resumed.train_step(x, y)["loss"]) for x, y in batches[2:]]
    assert got == want
    _assert_state_equal(_state(resumed), _state(full))


def test_restore_at_step_zero_gives_the_first_update(tmp_path):
    """A step-0 checkpoint holds zero momentum (optax's trace at init);
    loaded, it gives the update that no buffer gives."""
    x, y = _batches(16, n=1, seed=4)[0]
    fresh = _small_trainer()
    path = checkpoint.save_checkpoint(str(tmp_path), fresh)
    assert path.endswith("step_00000000")
    assert all(torch.count_nonzero(v) == 0 for m in _state(fresh)[1] for v in m.values())
    restored = checkpoint.restore_checkpoint(str(tmp_path), _small_trainer(seed=5))
    fresh.train_step(x, y)
    restored.train_step(x, y)
    _assert_state_equal(_state(restored), _state(fresh))


def test_checkpoint_pruning_and_latest(tmp_path):
    trainer = _small_trainer()
    for s in range(5):
        checkpoint.save_checkpoint(str(tmp_path), trainer, step=s, keep=2)
    assert [s for s, _ in checkpoint.all_checkpoints(str(tmp_path))] == [3, 4]
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("step_00000004")
    assert checkpoint.resolve_checkpoint(str(tmp_path / "step_00000003")).endswith("3")
    with pytest.raises(FileNotFoundError):
        checkpoint.resolve_checkpoint(str(tmp_path / "nothing"))


def test_rebuild_without_model_metadata_refuses(tmp_path):
    trainer = _small_trainer()
    checkpoint.save_checkpoint(str(tmp_path), trainer, metadata={"note": "train-only"})
    assert checkpoint.restore_batch_stats(str(tmp_path)) is None
    assert checkpoint.checkpoint_metadata(checkpoint.latest_checkpoint(str(tmp_path))) == {
        "step": 0, "note": "train-only"}
    with pytest.raises(ValueError, match="model"):
        checkpoint.rebuild_from_checkpoint(str(tmp_path), device="cpu")


def test_spatial_rebuild_needs_stored_spatial_cells():
    meta = checkpoint.model_metadata("resnet_v2", 32, depth=11, num_classes=10, pool_kernel=8)
    with pytest.raises(ValueError, match="spatial_cells"):
        checkpoint.rebuild_spatial_twin(meta, grid=None)
    with pytest.raises(ValueError, match="spatial_cells"):
        jax_ckpt.rebuild_spatial_twin(jax_ckpt.model_metadata(
            "resnet_v2", 32, depth=11, num_classes=10, pool_kernel=8))


def test_model_metadata_matches_jax_and_rebuilds_dtype():
    spec = dict(num_classes=10, num_layers=3, num_filters=32, spatial_cells=4)
    port = checkpoint.model_metadata("amoebanet", 64, dtype=torch.bfloat16, **spec)
    assert port == jax_ckpt.model_metadata("amoebanet", 64, dtype=jnp.bfloat16, **spec)
    model = checkpoint.rebuild_cells(port)
    assert model[0].conv.conv.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="family"):
        checkpoint.model_metadata("vgg", 32)


def test_rebuild_round_trip_with_batch_stats(tmp_path):
    """Train, calibrate, save with metadata and statistics, rebuild from the
    path alone: the same params, statistics and logits, bit for bit."""
    model = init(get_resnet_v2(11, 10, pool_kernel=4), torch.Generator().manual_seed(1))
    trainer = Trainer(model, ParallelConfig(batch_size=2, image_size=16), device="cpu")
    (x, y), = _batches(16, n=1, seed=6)
    trainer.train_step(x, y)
    stats = evaluate.collect_batch_stats(trainer, [x])
    checkpoint.save_checkpoint(str(tmp_path), trainer, batch_stats=stats, metadata=
                               checkpoint.model_metadata("resnet_v2", 16, depth=11, pool_kernel=4))
    model2, trainer2, stats2, meta = checkpoint.rebuild_from_checkpoint(str(tmp_path), device="cpu")
    assert meta["step"] == 1 and trainer2.step == 1
    _assert_state_equal(_state(trainer2), _state(trainer))
    assert len(stats2) == len(stats)
    for a, b in zip(_flat_stats(stats2), _flat_stats(stats)):
        np.testing.assert_array_equal(a, b)
    want = evaluate.make_predict(trainer)(stats, x)
    assert torch.equal(evaluate.make_predict(model2)(stats2, x), want)


def _flat_stats(stats):
    out = []
    for s in stats:
        out += [np.asarray(v) for _, v in sorted(_flat(s).items())]
    return out
