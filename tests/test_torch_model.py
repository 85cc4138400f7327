"""Port's model (rubiksnet_torch.models) vs the JAX package: weights
crossing over (state dicts and reference-format checkpoints), logits of the
module path and of the fused executor on the tiny tier, on the SE tier
(small) and on the rubiks3d-aq variant at a tiny size, full-width parameter
names and shapes, the fused routing, and that the port never imports JAX.

Tolerance: logits float32 rtol/atol 2e-4, the JAX package's fused-test
tolerance (tests/test_fused_block.py); weights cross over exactly."""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.models import (
    FusedExecutor,
    create_rubiksnet,
    fused_infer_apply,
    load_pretrained,
    max_int_shift,
    save_pretrained,
    state_dict_from_jax,
)
from rubiksnet_torch.nn import BN
from rubiksnet_torch.ops import launch_counters
from rubiksnet_tpu.models import RubiksNet as JaxRubiksNet
from rubiksnet_tpu.models import RubiksNetBundle
from rubiksnet_tpu.models import create_rubiksnet as jax_create
from rubiksnet_tpu.models import load_pretrained as jax_load_pretrained
from rubiksnet_tpu.models.fused_infer import fused_infer_apply as jax_fused
from rubiksnet_tpu.models.pretrained import _max_int_shift, export_torch_state_dict
from rubiksnet_tpu.nn.backbone import BN as jax_bn

torch.set_num_threads(1)

TOL = 2e-4
REPO = Path(__file__).resolve().parent.parent


def _randomize(tree, rng, lo, hi):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(lo, hi, a.shape).astype(np.float32)),
        tree)


def tiny_bundle(quantize=False, seed=0, dtype=jnp.float32, tier="tiny",
                variant="rubiks3d"):
    """JAX model of ``tier`` and ``variant`` (default tiny rubiks3d), 4
    frames, 32 px, with non-trivial BN: running mean U(-0.2, 0.2), var
    U(0.5, 2), BN weight U(0.5, 1.5), bias U(-0.3, 0.3). ``dtype`` is the
    compute dtype; parameters are float32."""
    bundle = jax_create(tier, num_classes=11, num_frames=4, input_size=32,
                        quantize=quantize, shift_max_shift=1, variant=variant,
                        rng=jax.random.PRNGKey(seed), dtype=dtype)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda a: a, dict(bundle.variables["params"]))
    stats = dict(bundle.variables["batch_stats"])

    def bn_params(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        if name == "bias" and "new_fc" not in str(path):
            return jnp.asarray(rng.uniform(-0.3, 0.3, leaf.shape).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(bn_params, params)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            (rng.uniform(-0.2, 0.2, a.shape) if path[-1].key == "mean"
             else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32)),
        stats)
    bundle.variables = {"params": params, "batch_stats": stats}
    return bundle


def test_state_dict_from_jax_matches_export():
    bundle = tiny_bundle()
    want = export_torch_state_dict(bundle)
    got = state_dict_from_jax(bundle.variables["params"],
                              bundle.variables["batch_stats"])
    assert set(got) == set(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == np.shape(value), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)


@pytest.mark.parametrize("quantize", [False, True])
def test_tiny_logits_match_jax(quantize):
    bundle = tiny_bundle(quantize, seed=1 + quantize)
    video = np.random.default_rng(3).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(bundle.model.apply(bundle.variables, jnp.asarray(video),
                                         train=False))

    model = create_rubiksnet("tiny", 11, 4, max_shift=1, quantize=quantize,
                             device="cpu")
    model.load_state_dict(state_dict_from_jax(
        bundle.variables["params"], bundle.variables["batch_stats"]))
    v = torch.from_numpy(video)
    with torch.no_grad():
        got_module = model(v).numpy()
        got_plain = model(v, plain=True).numpy()
    got_fused = fused_infer_apply(model, v).numpy()
    for got in (got_module, got_plain, got_fused):
        assert got.shape == (2, 11)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # On the CPU every op is the plain version: no kernel launched.
    assert all(c.count == 0 for c in launch_counters().values())


def test_large_parameters_match_jax():
    """Names and shapes of the port's Large state dict == the JAX Large
    init pushed through the export rules (eval_shape only, no forward)."""
    model = JaxRubiksNet(tier="large", num_classes=174, num_frames=8)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 32, 32, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    got = create_rubiksnet("large", 174, device="cpu").state_dict()
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
    assert got["backbone.layer3.12.as3.rubiks3d.shift"].shape == (3, 288)
    assert got["backbone.layer0.0.conv2.weight"].shape == (72, 72, 1, 1)


def test_large_fused_routing():
    """Every stride-1 block (layer0_0 at 112x112 included) goes to K2 and
    every stride-2 entry to K3: 47 and 4 blocks."""
    model = create_rubiksnet("large", 174, max_shift=1, device="cpu")
    steps = FusedExecutor(model).steps
    block_names = [n for kind, names, _ in steps if kind == "block"
                   for n in names]
    entry_names = [n for kind, names, _ in steps if kind == "entry"
                   for n in names]
    assert len(block_names) == 47 and block_names[0] == "layer0_0"
    assert entry_names == ["layer1_0", "layer2_0", "layer3_0", "layer4_0"]
    assert len(steps) == 9  # runs: stage 0, then entry + run per stage


def test_init_is_seeded_and_follows_jax_distributions():
    a = create_rubiksnet("tiny", 5, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    b = create_rubiksnet("tiny", 5, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    shifts = torch.cat([v.flatten() for k, v in sd.items()
                        if k.endswith(".shift")])
    assert float(shifts.abs().max()) <= 1.0
    w = sd["backbone.layer3.0.conv3.weight"]  # He fan-out: std sqrt(2/out)
    assert abs(float(w.std()) / np.sqrt(2.0 / w.shape[0]) - 1) < 0.05
    assert torch.equal(sd["backbone.bn_last.weight"],
                       torch.ones_like(sd["backbone.bn_last.weight"]))
    assert float(sd["new_fc.weight"].abs().max()) <= 2 * np.sqrt(
        1 / 432) / 0.87962566103423978 + 1e-6


def _port_of(bundle, tier, variant, quantize=False):
    model = create_rubiksnet(tier, 11, 4, variant, max_shift=1,
                             quantize=quantize, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        bundle.variables["params"], bundle.variables["batch_stats"]))
    return model


@pytest.mark.parametrize("tier,variant", [("small", "rubiks3d"),
                                          ("tiny", "rubiks3d-aq"),
                                          ("small", "rubiks3d-aq")])
def test_unported_configurations_raise(tier, variant):
    """The SE tier and the rubiks3d-aq variant, which earlier raised as not
    ported: they build, take the JAX package's weights, and their logits
    (module path, plain route and fused executor) equal the JAX model's
    eval logits and its fused executor's, float32 at TOL."""
    bundle = tiny_bundle(seed=5, tier=tier, variant=variant)
    video = np.random.default_rng(4).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(bundle.model.apply(bundle.variables, jnp.asarray(video),
                                         train=False))
    want_fused = np.asarray(jax_fused(bundle.model, bundle.variables,
                                      jnp.asarray(video)))
    np.testing.assert_allclose(want_fused, want, rtol=TOL, atol=TOL)
    model = _port_of(bundle, tier, variant)
    v = torch.from_numpy(video)
    with torch.no_grad():
        routes = {"module": model(v), "plain": model(v, plain=True),
                  "fused": fused_infer_apply(model, v)}
    for route, got in routes.items():
        assert got.shape == (2, 11), route
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=route)
        np.testing.assert_allclose(got.numpy(), want_fused, rtol=TOL,
                                   atol=TOL, err_msg=route)
    kinds = [kind for kind, _, _ in FusedExecutor(model).steps]
    assert kinds.count("module") == (4 if variant == "rubiks3d-aq" else 0)
    assert all(c.count == 0 for c in launch_counters().values())


def test_quantized_aq_logits_match_jax():
    """rubiks3d-aq with quantize: the 2D shift rounds half away from zero,
    which has no tap form, so the executor keeps every block on the module
    path; logits equal the JAX model's."""
    bundle = tiny_bundle(True, seed=6, variant="rubiks3d-aq")
    video = np.random.default_rng(5).standard_normal(
        (1, 4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(bundle.model.apply(bundle.variables, jnp.asarray(video),
                                         train=False))
    model = _port_of(bundle, "tiny", "rubiks3d-aq", quantize=True)
    executor = FusedExecutor(model)
    assert [kind for kind, _, _ in executor.steps] == ["module"] * 17
    with torch.no_grad():
        got = model(torch.from_numpy(video)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(executor(torch.from_numpy(video)).numpy(),
                               want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tier,variant", [("small", "rubiks3d"),
                                          ("tiny", "rubiks3d-aq"),
                                          ("small", "rubiks3d-aq")])
def test_state_dict_from_jax_matches_export_aq_se(tier, variant):
    """AQ's Sequential keys (conv2.0.weight, conv2.0.T, conv2.1.weight),
    the (2, C) as3.shift and the SE keys equal the JAX package's export."""
    bundle = tiny_bundle(seed=2, tier=tier, variant=variant)
    want = export_torch_state_dict(bundle)
    got = state_dict_from_jax(bundle.variables["params"],
                              bundle.variables["batch_stats"])
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)
    model = create_rubiksnet(tier, 11, 4, variant, device="cpu")
    assert set(model.state_dict()) == set(got)
    grads = state_dict_from_jax(bundle.variables["params"])
    assert set(grads) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("tier,variant", [("large", "rubiks3d-aq"),
                                          ("small", "rubiks3d")])
def test_full_width_parameters_match_jax(tier, variant):
    """Names and shapes of the port's full-width Large-AQ and Small state
    dicts == the JAX init pushed through export_torch_state_dict
    (eval_shape only, no forward)."""
    model = JaxRubiksNet(tier=tier, num_classes=174, num_frames=8,
                         variant=variant)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 32, 32, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = export_torch_state_dict(RubiksNetBundle(model=model,
                                                   variables=zeros))
    got = create_rubiksnet(tier, 174, variant=variant,
                           device="cpu").state_dict()
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == np.shape(want[key]), key
    if variant == "rubiks3d-aq":
        assert got["backbone.layer3.12.as3.shift"].shape == (2, 288)
        assert got["backbone.layer3.12.conv2.0.weight"].shape == (288, 3)
        assert got["backbone.layer3.0.conv2.1.weight"].shape == (288, 144, 1,
                                                                 1)
    else:
        assert got["backbone.layer2.1.se.fc.0.weight"].shape == (12, 144)
        assert got["backbone.layer2.1.se.fc.2.weight"].shape == (144, 12)


@pytest.mark.parametrize("tier,variant,blocks,entries,modules", [
    ("large", "rubiks3d-aq", 47, 0, 4),
    ("small", "rubiks3d", 13, 4, 0),
    ("small", "rubiks3d-aq", 13, 0, 4),
])
def test_fused_routing_of_aq_and_se(tier, variant, blocks, entries, modules):
    """rubiks3d-aq: stride-1 runs on K2 with the AQ taps, the four entries
    on the module path. SE tier: runs on K2 and entries on K3, each with
    its gate weights."""
    model = create_rubiksnet(tier, 174, variant=variant, max_shift=1,
                             device="cpu")
    executor = FusedExecutor(model)
    names = {kind: [n for k, ns, _ in executor.steps if k == kind for n in ns]
             for kind in ("block", "entry", "module")}
    assert (len(names["block"]), len(names["entry"]),
            len(names["module"])) == (blocks, entries, modules)
    strided = ["layer1_0", "layer2_0", "layer3_0", "layer4_0"]
    assert (names["module"] or names["entry"]) == strided
    se = tier == "small"
    for kind, _, params in executor.steps:
        if kind == "block":
            vt, _, sep = params
            rows = 4 + 3 * 3 + (3 if variant == "rubiks3d-aq" else 0)
            assert vt.shape[1] == rows and (sep is not None) == se
        elif kind == "entry":
            assert (params[1] is not None) == se
    model.variant = "rubiks2d"
    with pytest.raises(ValueError, match="unknown variant"):
        FusedExecutor(model)
    with pytest.raises(ValueError, match="unknown variant"):
        create_rubiksnet("tiny", 5, variant="rubiks3d_aq", device="cpu")


@pytest.mark.parametrize("tier,variant", [("tiny", "rubiks3d"),
                                          ("small", "rubiks3d-aq")])
def test_pretrained_round_trip(tier, variant, tmp_path):
    """Reference-format checkpoints cross both ways: the port saves and
    rubiksnet_tpu.models.load_pretrained loads; a checkpoint written from
    the JAX package's export loads into the port. Weights cross exactly and
    max_shift is sized from the shifts."""
    bundle = tiny_bundle(seed=7, tier=tier, variant=variant)
    sd = state_dict_from_jax(bundle.variables["params"],
                             bundle.variables["batch_stats"])
    sd["backbone.layer1.1.as3." + ("shift" if variant == "rubiks3d-aq"
                                   else "rubiks3d.shift")][1, 0] = -2.25
    model = create_rubiksnet(tier, 11, 4, variant, max_shift=3, device="cpu")
    model.load_state_dict(sd)
    path = tmp_path / "port.pth.tar"
    save_pretrained(model, path)
    loaded = jax_load_pretrained(str(path))
    assert (loaded.model.tier, loaded.model.variant, loaded.model.num_classes,
            loaded.model.num_frames) == (tier, variant, 11, 4)
    assert loaded.model.shift_max_shift == 3
    back = export_torch_state_dict(loaded)
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(np.asarray(back[key]), value.numpy(),
                                      err_msg=key)

    ref_path = tmp_path / "reference.pth.tar"
    torch.save({"tier": tier, "num_classes": 11, "num_frames": 4,
                "variant": variant,
                "model": {k: torch.from_numpy(np.array(v))
                          for k, v in back.items()}}, ref_path)
    port = load_pretrained(ref_path, device="cpu")
    assert (port.tier, port.variant, port.num_classes, port.num_frames,
            port.max_shift) == (tier, variant, 11, 4, 3)
    assert not port.training
    for key, value in port.state_dict().items():
        assert torch.equal(value, sd[key]), key
    broken = dict(torch.load(ref_path))
    broken["model"] = {k: v for k, v in broken["model"].items()
                       if not k.endswith("bn_last.bias")}
    torch.save(broken, ref_path)
    with pytest.raises(ValueError, match="does not fit"):
        load_pretrained(ref_path, device="cpu")


def test_replace_new_fc():
    """A fresh head of another width, seeded; the backbone keeps its
    weights."""
    model = create_rubiksnet("tiny", 5, 4, device="cpu")
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    out = model.replace_new_fc(9, generator=torch.Generator().manual_seed(3))
    assert out is model and model.num_classes == 9
    assert model.new_fc.weight.shape == (9, 432)
    assert torch.equal(model.new_fc.bias, torch.zeros(9))
    again = create_rubiksnet("tiny", 5, 4, device="cpu").replace_new_fc(
        9, generator=torch.Generator().manual_seed(3))
    assert torch.equal(model.new_fc.weight, again.new_fc.weight)
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, before[k]), k
    video = torch.zeros(1, 4, 32, 32, 3)
    with torch.no_grad():
        assert model(video).shape == (1, 9)


def test_default_device_is_the_card():
    """Without a device the entry points build on the CUDA card, and raise
    where there is none: the CPU is never a silent default."""
    if torch.cuda.is_available():
        model = create_rubiksnet("tiny", 5)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            create_rubiksnet("tiny", 5)
        with pytest.raises(RuntimeError, match="CUDA"):
            load_pretrained("missing.pth.tar")
    cpu = create_rubiksnet("tiny", 5, device="cpu")
    assert next(cpu.parameters()).device.type == "cpu"


def test_max_int_shift_matches_jax():
    bundle = tiny_bundle()
    sd = state_dict_from_jax(bundle.variables["params"],
                             bundle.variables["batch_stats"])
    assert max_int_shift(sd) == _max_int_shift(bundle.variables["params"])
    sd["backbone.layer2.1.as3.rubiks3d.shift"][0, 0] = -2.5
    assert max_int_shift(sd) == 3


def test_eval_mode_required():
    """The fused executor is inference only; the module path trains, with
    train-mode BN equal to flax's BatchNorm of the JAX package: batch
    statistics, and running statistics updated with momentum 0.9 and the
    biased batch variance (torch's batch_norm would use the unbiased one).
    Tolerance 1e-5 (float32, the same arithmetic in another order)."""
    model = create_rubiksnet("tiny", 5, device="cpu").train()
    with pytest.raises(ValueError, match="eval"):
        FusedExecutor(model)
    video = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 2, 16, 16, 3)).astype(np.float32))
    model(video).sum().backward()
    assert model.new_fc.weight.grad is not None

    rng = np.random.default_rng(6)
    c = 8
    x = (rng.standard_normal((2, 3, 4, 5, c)) * 2 + 0.5).astype(np.float32)
    scale, bias = (rng.uniform(0.5, 1.5, c).astype(np.float32),
                   rng.uniform(-0.3, 0.3, c).astype(np.float32))
    mean0, var0 = (rng.uniform(-0.2, 0.2, c).astype(np.float32),
                   rng.uniform(0.5, 2.0, c).astype(np.float32))
    want, upd = jax_bn(jnp.float32, None).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    bn = BN(c).train()
    bn.load_state_dict({
        "weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
        "running_mean": torch.from_numpy(mean0),
        "running_var": torch.from_numpy(var0),
        "num_batches_tracked": torch.tensor(0)})
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5, atol=1e-5)
    biased = x.reshape(-1, c).var(axis=0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0 + 0.1 *
                               biased, rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1


def test_port_imports_no_jax():
    code = ("import sys, rubiksnet_torch, rubiksnet_torch.models, "
            "rubiksnet_torch.nn, rubiksnet_torch.ops, rubiksnet_torch.train, "
            "rubiksnet_torch.utils; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'rubiksnet_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
