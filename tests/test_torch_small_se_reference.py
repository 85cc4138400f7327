"""RubiksNet-Small, the SE tier, against the benchmark's plain reference
(``portbench/reference_se.py``) at a small size on the CPU, in float32:
tier ``small`` at its own widths (72 to 576, every block gated), 4 frames,
32 px, 10 classes, on the seed's weights.

* The port's module path and its fused executor (the kernels' plain
  versions) agree with the reference within 1e-5 logit rel-L2: both are
  float32 and differ only in the order of their sums.
* The reference's names and shapes are the port's at the benchmark's
  ``configs/small.json`` (a strict ``load_state_dict``), its weights follow
  the seed, and at a configuration without SE it is ``reference.py``
  itself, weights and logits alike.
* Planted faults: a gate left out (g = 1) and a gate applied after the
  block's last 1x1 conv each move the logits by more than the limit of the
  cell ``small.serve.b64``; the harness's check, run on the executor with
  the gate left out, says not correct. A gate pooled over the whole clip
  instead of each frame moves them by about 0.5% here, under any limit the
  program's bfloat16 readings leave room for: on seeded weights and noise
  clips each frame's spatial means lie close to the clip's. The logits
  cannot show that fault; the gate itself does, and the port's plain gate
  is held per frame against the reference's here (the kernels' gate
  against the plain one: ``tests/test_torch_se_gate_plan.py`` and
  ``chip_smoke.py``).
"""

import copy
import json

import pytest
import torch

from portbench import reference, reference_se, run, spec
from portbench.compare import worst_clip_rel_l2
from rubiksnet_torch.models.fused_infer import FusedExecutor
from rubiksnet_torch.models.rubiksnet import RubiksNet
from rubiksnet_torch.ops import fused_block, fused_entry

torch.set_num_threads(1)

SMALL = {"tier": "small", "variant": "rubiks3d", "width": 72,
         "repeats": [3, 4, 6, 3], "use_se": True, "num_classes": 10,
         "num_frames": 4, "input_size": 32, "quantize": False,
         "max_shift": 1, "dtype": "float32"}
TOL = 1e-5
SEED = 2**31 + 11


def config(**overrides):
    cfg = copy.deepcopy(SMALL)
    cfg.update(overrides)
    return cfg


def load_json(*parts):
    with open(spec.ROOT.joinpath("portbench", *parts)) as f:
        return json.load(f)


def limit():
    return load_json("limits", "small.serve.b64.json")["logits_rel_l2"]


def port(cfg, weights):
    model = RubiksNet(cfg["tier"], cfg["num_classes"], cfg["num_frames"],
                      cfg["variant"], cfg["quantize"], cfg["max_shift"],
                      torch.float32)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def inputs(cfg, n, seed=SEED):
    gen = torch.Generator().manual_seed(seed)
    weights = reference_se.make_weights(cfg, gen, "cpu")
    s = cfg["input_size"]
    video = torch.randn((n, cfg["num_frames"], s, s, 3), generator=gen)
    return weights, video


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def small():
    """The seed's weights, two clips and the reference's logits."""
    cfg = config()
    weights, video = inputs(cfg, 2)
    return cfg, weights, video, reference_se.Reference(cfg, weights).logits(
        video)


@pytest.mark.parametrize("path", ["module", "executor"])
def test_port_matches_the_reference(small, path):
    cfg, weights, video, want = small
    model = port(cfg, weights)
    assert all(b.se is not None for _, b in model.backbone.named_blocks())
    with torch.no_grad():
        got = (model(video, plain=True) if path == "module"
               else FusedExecutor(model)(video))
    assert rel(got, want) < TOL


def test_names_and_shapes_are_the_ports():
    cfg = load_json("configs", "small.json")
    assert (cfg["tier"], cfg["use_se"], cfg["width"], cfg["repeats"]) == (
        "small", True, 72, [3, 4, 6, 3])
    model = RubiksNet(cfg["tier"], cfg["num_classes"], cfg["num_frames"],
                      cfg["variant"], cfg["quantize"], cfg["max_shift"])
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in reference_se.param_spec(cfg)} == want
    se = [n for n, _, _ in reference_se.se_spec(cfg)]
    assert len(se) == 2 * 17
    model.load_state_dict(reference_se.make_weights(
        cfg, torch.Generator().manual_seed(SEED), "cpu"), strict=True)


def test_weights_follow_the_seed():
    cfg = config()
    a = reference_se.make_weights(cfg, torch.Generator().manual_seed(SEED),
                                  "cpu")
    b = reference_se.make_weights(cfg, torch.Generator().manual_seed(SEED),
                                  "cpu")
    c = reference_se.make_weights(
        cfg, torch.Generator().manual_seed(SEED + 1), "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    fc = "backbone.layer3.2.se.fc.0.weight"
    assert not torch.equal(a[fc], c[fc])
    # N(0, SE_GAIN**2 / fan_in): fc.0 of a 288-wide block reads 288
    # channels
    assert float(a[fc].std()) == pytest.approx(
        reference_se.SE_GAIN * 288 ** -0.5, rel=0.1)
    plain = reference.make_weights(cfg, torch.Generator().manual_seed(SEED),
                                   "cpu")
    assert all(torch.equal(plain[k], a[k]) for k in plain)


@pytest.mark.parametrize("variant", ["rubiks3d", "rubiks3d-aq"])
def test_without_se_it_is_the_plain_reference(variant):
    cfg = config(tier="tiny", width=54, use_se=False, variant=variant)
    assert reference_se.param_spec(cfg) == reference.param_spec(cfg)
    gen = torch.Generator().manual_seed(SEED)
    weights = reference_se.make_weights(cfg, gen, "cpu")
    plain = reference.make_weights(cfg, torch.Generator().manual_seed(SEED),
                                   "cpu")
    assert weights.keys() == plain.keys()
    assert all(torch.equal(weights[k], plain[k]) for k in plain)
    video = torch.randn((2, 4, 32, 32, 3), generator=gen)
    assert torch.equal(reference_se.Reference(cfg, weights).logits(video),
                       reference.Reference(cfg, weights).logits(video))


class NoGate(reference_se.Reference):
    """The gate left out: g = 1."""

    def gate(self, v, prefix):
        return torch.ones_like(v[:, :, 0, 0])


class ClipGate(reference_se.Reference):
    """The gate pooled over T, H and W, one gate a clip."""

    def gate(self, v, prefix):
        g = super().gate(v.mean(dim=1, keepdim=True), prefix)
        return g.expand(-1, v.shape[1], -1)


class GateAfterW3(reference_se.Reference):
    """The gate of v applied to W3 . v instead of to v."""

    def _mm(self, x, w):
        out = super()._mm(x, w)
        late = getattr(self, "_late", None)
        if late is not None and w is self.p[f"{late[0]}.conv3.weight"]:
            out = out * late[1][:, :, None, None, :]
        return out

    def gate(self, v, prefix):
        self._late = (prefix, super().gate(v, prefix))
        return torch.ones_like(self._late[1])


@pytest.mark.parametrize("fault", [NoGate, GateAfterW3])
def test_planted_faults_exceed_the_limit(small, fault):
    cfg, weights, video, want = small
    got = fault(cfg, weights).logits(video)
    assert worst_clip_rel_l2(got, want) > limit()


def test_the_gate_is_per_frame(small):
    """The port's plain gate (K2's and K3's plain versions) equals the
    reference's on an activation whose frames differ, and the gate pooled
    over the clip does not."""
    cfg, weights, _, _ = small
    prefix = "backbone.layer3.2"
    model = port(cfg, weights)
    stacked = fused_block.stack_se_params([model.backbone.layer3[2]])[0]
    gen = torch.Generator().manual_seed(SEED)
    v = torch.rand((2, 4, 5, 5, 288), generator=gen) * torch.arange(
        1.0, 5.0).view(1, 4, 1, 1, 1)
    want = reference_se.Reference(cfg, weights).gate(v, prefix)
    assert rel(fused_block.se_gate(v, stacked), want) < TOL
    assert rel(ClipGate(cfg, weights).gate(v, prefix), want) > 100 * TOL


def run_tiny(seed=2**31 + 5):
    cfg = config()
    traffic = dict(load_json("traffic", "serve_se.b64.json"), batch=2,
                   pool=2, warmup_calls=1, trace_calls=2,
                   reference_rows=2)
    cell = {"name": "small_tiny.serve", "root": None, "config": cfg,
            "traffic": traffic,
            "limits": load_json("limits", "small.serve.b64.json"),
            "end_to_end": [{"name": "setup_s", "unit": "s"}],
            "per_layer": []}
    return run.run_cell(cell, seed, 0.2, False, torch.device("cpu"))


def test_harness_check_passes_the_executor():
    result = run_tiny()
    assert result["correct"], result["checks"]
    assert result["checks"]["logits_rel_l2"]["value"] < TOL


def test_harness_check_fails_the_executor_without_its_gate(monkeypatch):
    def ones(v, se):
        return torch.ones_like(v[:, :, 0, 0])

    monkeypatch.setattr(fused_block, "se_gate", ones)
    monkeypatch.setattr(fused_entry, "se_gate", ones)
    result = run_tiny()
    assert not result["correct"], result["checks"]
