"""The plain reference against the port at a tiny size on the CPU (both
in float32, the port on its plain versions): the same weights give the
same logits and the same train steps; and the reference's names and
shapes are the port's at the benchmark's configurations."""

import json

import pytest
import torch

from portbench import spec
from portbench.reference import Reference, make_weights, param_spec
from rubiksnet_torch.models.fused_infer import FusedExecutor
from rubiksnet_torch.models.rubiksnet import RubiksNet
from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

from .tiny import config


def port(cfg, weights):
    model = RubiksNet(cfg["tier"], cfg["num_classes"], cfg["num_frames"],
                      cfg["variant"], cfg["quantize"], cfg["max_shift"],
                      torch.float32)
    model.load_state_dict(weights, strict=True)
    return model


def inputs(cfg, n, seed=3):
    gen = torch.Generator().manual_seed(seed)
    weights = make_weights(cfg, gen, "cpu")
    s = cfg["input_size"]
    video = torch.randn((n, cfg["num_frames"], s, s, 3), generator=gen)
    return weights, video


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("variant", ["rubiks3d", "rubiks3d-aq"])
def test_logits_match_the_port(variant):
    cfg = config(variant=variant)
    weights, video = inputs(cfg, 2)
    want = Reference(cfg, weights).logits(video)
    model = port(cfg, weights).eval()
    with torch.no_grad():
        assert rel(model(video, plain=True), want) < 1e-5
        assert rel(FusedExecutor(model)(video), want) < 1e-5


def test_train_steps_match_the_port():
    cfg = config()
    weights, video = inputs(cfg, 4)
    labels = torch.tensor([1, 7, 3, 3])
    batches = [(video, labels), (video.flip(0), labels.flip(0))]
    model = port(cfg, weights)
    step = make_train_step(model, sgd_with_shift_mult(model, 1e-2, 0.1))
    losses = [float(step(v, y)["loss"]) for v, y in batches]
    r_losses, _, r_params = Reference(cfg, weights).train_steps(
        batches, 1e-2, 0.1, 0.9, 1e-4)
    assert losses == pytest.approx(r_losses, rel=1e-5)
    for name, p in model.named_parameters():
        change = p.detach() - weights[name]
        want = r_params[name] - weights[name]
        assert float((change - want).norm()) <= 1e-3 * float(
            want.norm()) + 1e-9, name


@pytest.mark.parametrize("name", ["large", "large_aq"])
def test_names_and_shapes_are_the_ports(name):
    with open(spec.ROOT / "portbench" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    model = RubiksNet(cfg["tier"], cfg["num_classes"], cfg["num_frames"],
                      cfg["variant"], cfg["quantize"], cfg["max_shift"])
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in param_spec(cfg)} == want


def test_weights_follow_the_seed():
    cfg = config()
    a = make_weights(cfg, torch.Generator().manual_seed(2**31 + 7), "cpu")
    b = make_weights(cfg, torch.Generator().manual_seed(2**31 + 7), "cpu")
    c = make_weights(cfg, torch.Generator().manual_seed(2**31 + 8), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(NotImplementedError):
        Reference(config(variant="rubiks3d-aq"), a).train_steps(
            [], 1e-3, 0.1, 0.9, 1e-4)
    assert not torch.equal(a["new_fc.weight"], c["new_fc.weight"])
    shifts = [v for k, v in a.items() if k.endswith(".shift")]
    assert all(float(s.abs().max()) < 1 for s in shifts)
