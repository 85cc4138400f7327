"""The port's model API against the JAX package's: the input normalization
constants and the model's feature width, crop and scale sizes, for all four
tiers. The values are read on the JAX side here; the port keeps its own
copy and imports nothing of the JAX package."""

import pytest
import torch

import rubiksnet_torch.models as port_models
from rubiksnet_torch.models import create_rubiksnet
from rubiksnet_tpu import models as jax_models
from rubiksnet_tpu.nn.backbone import RubiksNetBackbone as JaxBackbone

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["INPUT_MEAN", "INPUT_STD", "INPUT_SIZE"])
def test_input_constants_equal_the_jax_package(name):
    assert getattr(port_models, name) == getattr(jax_models, name)
    assert name in port_models.__all__


@pytest.mark.parametrize("tier", sorted(jax_models.TIERS))
def test_model_sizes_equal_the_jax_package(tier):
    ref = jax_models.RubiksNet(tier=tier, num_classes=5)
    width, repeats, use_se = jax_models.TIERS[tier]
    ref_backbone = JaxBackbone(width=width, repeats=repeats, use_se=use_se)
    # The sizes depend on the tier alone: a CPU model of 2 frames will do.
    model = create_rubiksnet(tier, 5, 2, device="cpu")
    assert (model.feature_dim, model.crop_size, model.scale_size) == (
        ref.feature_dim, ref.crop_size, ref.scale_size)
    assert (model.crop_size, model.scale_size) == (224, 256)
    assert model.backbone.feature_dim == ref_backbone.feature_dim
    assert model.new_fc.weight.shape[1] == model.feature_dim
    video = torch.randn((1, 2, 32, 32, 3))
    with torch.no_grad():
        feats = model.backbone(video, plain=True)
    assert feats.shape == (1, 2, model.backbone.feature_dim)
