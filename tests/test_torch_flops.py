"""FLOP accounting parity: the port's ``flops`` vs ``mpi4dl_tpu.flops``, CPU.

``forward_flops`` counts the same linears analytically (convs and dense
layers, on the meta device) that the JAX package counts in the forward's
jaxpr: the two counts are integers and must be equal exactly, for
AmoebaNet-D (3, 32) @64, ResNet-v1 depth 8 @32 and ResNet-v2 depth 11 @32.
Without a card, the peak and the MFU are None.
"""

import pytest
import torch

from mpi4dl_tpu import flops as jax_flops
from mpi4dl_tpu.models import amoebanet as jax_amoebanet, resnet as jax_resnet
from mpi4dl_tpu_torch import flops
from mpi4dl_tpu_torch.models import amoebanet, resnet

torch.set_num_threads(1)

# name: (JAX builder, port builder, NHWC input shape)
MODELS = {
    "amoebanet_3_32": (lambda: jax_amoebanet.amoebanetd(10, 3, 32),
                       lambda: amoebanet.amoebanetd(10, 3, 32), (2, 64, 64, 3)),
    "resnet_v1_8": (lambda: jax_resnet.get_resnet_v1(8, 10, pool_kernel=8),
                    lambda: resnet.get_resnet_v1(8, 10, pool_kernel=8), (2, 32, 32, 3)),
    "resnet_v2_11": (lambda: jax_resnet.get_resnet_v2(11, 10, pool_kernel=8),
                     lambda: resnet.get_resnet_v2(11, 10, pool_kernel=8), (2, 32, 32, 3)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_flops_match_jax(name):
    build_jax, build, shape = MODELS[name]
    want = jax_flops.forward_flops(build_jax(), shape)
    got = flops.forward_flops(build(), shape)
    assert isinstance(got, int) and got == want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_flops_are_three_forwards(name):
    _, build, shape = MODELS[name]
    model = build()
    assert flops.train_flops_per_image(model, shape[1]) == 3 * flops.forward_flops(
        model, (1,) + shape[1:])


def test_forward_flops_leave_the_model_alone():
    model = amoebanet.amoebanetd(10, 3, 32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    flops.forward_flops(model, (1, 64, 64, 3))
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_peak_and_mfu_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flops.peak_flops() is None
    assert flops.mfu(10.0, 1e12) is None


@pytest.mark.parametrize("name, peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                        ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_by_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert flops.peak_flops() == peak
    if peak:
        assert flops.mfu(2.0, 989e12, n_devices=4) == pytest.approx(0.5)
