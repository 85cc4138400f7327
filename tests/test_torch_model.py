"""Port's model (rubiksnet_torch.models) vs the JAX package: weights
crossing over, logits of the module path and of the fused executor on the
tiny tier, Large's parameter names and shapes, the fused routing, and that
the port never imports JAX.

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
    max_int_shift,
    state_dict_from_jax,
)
from rubiksnet_torch.ops import launch_counters
from rubiksnet_tpu.models import RubiksNet as JaxRubiksNet
from rubiksnet_tpu.models import create_rubiksnet as jax_create
from rubiksnet_tpu.models.pretrained import _max_int_shift, export_torch_state_dict

torch.set_num_threads(1)

TOL = 2e-4
REPO = Path(__file__).resolve().parent.parent


def _randomize(tree, rng, lo, hi):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(lo, hi, a.shape).astype(np.float32)),
        tree)


def tiny_bundle(quantize=False, seed=0):
    """JAX tiny rubiks3d, 4 frames, 32 px, with non-trivial BN: running mean
    U(-0.2, 0.2), var U(0.5, 2), BN weight U(0.5, 1.5), bias U(-0.3, 0.3)."""
    bundle = jax_create("tiny", num_classes=11, num_frames=4, input_size=32,
                        quantize=quantize, shift_max_shift=1,
                        rng=jax.random.PRNGKey(seed))
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

    model = create_rubiksnet("tiny", 11, 4, max_shift=1, quantize=quantize)
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
    got = create_rubiksnet("large", 174).state_dict()
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
    assert got["backbone.layer3.12.as3.rubiks3d.shift"].shape == (3, 288)
    assert got["backbone.layer0.0.conv2.weight"].shape == (72, 72, 1, 1)


def test_large_fused_routing():
    """Every stride-1 block (layer0_0 at 112x112 included) goes to K2 and
    every stride-2 entry to K3: 47 and 4 blocks."""
    model = create_rubiksnet("large", 174, max_shift=1)
    steps = FusedExecutor(model).steps
    block_names = [n for kind, names, _ in steps if kind == "block"
                   for n in names]
    entry_names = [n for kind, names, _ in steps if kind == "entry"
                   for n in names]
    assert len(block_names) == 47 and block_names[0] == "layer0_0"
    assert entry_names == ["layer1_0", "layer2_0", "layer3_0", "layer4_0"]
    assert len(steps) == 9  # runs: stage 0, then entry + run per stage


def test_init_is_seeded_and_follows_jax_distributions():
    a = create_rubiksnet("tiny", 5, generator=torch.Generator().manual_seed(4))
    b = create_rubiksnet("tiny", 5, generator=torch.Generator().manual_seed(4))
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


@pytest.mark.parametrize("tier,variant", [("small", "rubiks3d"),
                                          ("tiny", "rubiks3d-aq")])
def test_unported_configurations_raise(tier, variant):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_rubiksnet(tier, 5, variant=variant)


def test_max_int_shift_matches_jax():
    bundle = tiny_bundle()
    sd = state_dict_from_jax(bundle.variables["params"],
                             bundle.variables["batch_stats"])
    assert max_int_shift(sd) == _max_int_shift(bundle.variables["params"])
    sd["backbone.layer2.1.as3.rubiks3d.shift"][0, 0] = -2.5
    assert max_int_shift(sd) == 3


def test_eval_mode_required():
    model = create_rubiksnet("tiny", 5).train()
    with pytest.raises(NotImplementedError, match="eval"):
        with torch.no_grad():
            model(torch.zeros(1, 2, 16, 16, 3))
    with pytest.raises(ValueError, match="eval"):
        FusedExecutor(model)


def test_port_imports_no_jax():
    code = ("import sys, rubiksnet_torch, rubiksnet_torch.models, "
            "rubiksnet_torch.nn, rubiksnet_torch.ops, rubiksnet_torch.utils; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'rubiksnet_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
