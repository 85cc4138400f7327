"""The fused executor's route per input shape (the port's
``models/fused_infer.py`` against the JAX executor's per-shape fallback,
``rubiksnet_tpu/models/fused_infer.py``).

The executor decides each step's route at the first call for each input
shape: a block the kernel declines at its activation's shape runs on the
module path. K3 declines odd H or W (48 px reaches a 3 x 3 entry, 56 px
and 112 px a 7 x 7 one) and an SE plan whose gate does not fit a block's
shared memory. On the tiny tier (T = 2, float32) at 48, 56 and 112 px the
executor equals the module path and JAX's ``fused_infer_apply`` (which
runs the Pallas kernels in interpret mode on the CPU) on the same weights.

Tolerance: logits relative L2 <= 1e-5 (float32; the executor's plain
versions and the module path sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
from rubiksnet_torch.models import fused_infer_apply, state_dict_from_jax
from rubiksnet_torch.ops import launch_counters
from rubiksnet_torch.ops import fused_block, fused_entry
from rubiksnet_torch.ops.fused_block import NoPlan, fused_block_supported
from rubiksnet_torch.ops.fused_entry import fused_entry_supported
from rubiksnet_tpu.models import create_rubiksnet as jax_create
from rubiksnet_tpu.models.fused_infer import fused_infer_apply as jax_fused

torch.set_num_threads(1)

T, CLASSES = 2, 5
TOL = 1e-5
ENTRIES = ["layer1_0", "layer2_0", "layer3_0", "layer4_0"]


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def models():
    """A JAX tiny model with non-trivial BN and the port's model of the same
    weights."""
    import jax

    bundle = jax_create("tiny", num_classes=CLASSES, num_frames=T,
                        input_size=32, shift_max_shift=1,
                        rng=jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)

    def randomized(path, leaf):
        name = getattr(path[-1], "key", "")
        lo, hi = {"scale": (0.5, 1.5), "mean": (-0.2, 0.2),
                  "var": (0.5, 2.0)}.get(name, (None, None))
        if name == "bias" and "new_fc" not in str(path):
            lo, hi = -0.3, 0.3
        if lo is None:
            return leaf
        return jnp.asarray(rng.uniform(lo, hi, leaf.shape).astype(np.float32))

    bundle.variables = jax.tree_util.tree_map_with_path(
        randomized, dict(bundle.variables))
    model = create_rubiksnet("tiny", CLASSES, T, max_shift=1, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        bundle.variables["params"], bundle.variables["batch_stats"]))
    return bundle, model


def fallbacks(executor, shape):
    """Names of the blocks the route for ``shape`` runs on the module path,
    and the route's step kinds."""
    steps = executor.route(shape)
    return ([n for kind, names, _ in steps if kind == "module"
             for n in names], [kind for kind, _, _ in steps])


@pytest.mark.parametrize("px,declined", [
    (48, ["layer4_0"]),    # entries at 24, 12, 6, 3
    (56, ["layer3_0"]),    # entries at 28, 14, 7, 4
    (112, ["layer4_0"]),   # entries at 56, 28, 14, 7
])
def test_executor_serves_odd_entries_as_jax_does(models, px, declined):
    """At 48, 56 and 112 px the executor falls back on exactly the entry
    that meets an odd extent and equals the module path and JAX's
    fused_infer_apply; its route is cached per shape."""
    bundle, model = models
    video = np.random.default_rng(px).standard_normal(
        (1, T, px, px, 3)).astype(np.float32)
    want_jax = np.asarray(jax_fused(bundle.model, bundle.variables,
                                    jnp.asarray(video)))
    executor = FusedExecutor(model)
    v = torch.from_numpy(video)
    with torch.no_grad():
        got = executor(v).numpy()
        module = model(v).numpy()
    assert rel_l2(got, module) <= TOL
    assert rel_l2(got, want_jax) <= TOL
    assert rel_l2(fused_infer_apply(model, v).numpy(), module) <= TOL
    names, kinds = fallbacks(executor, v.shape)
    assert names == declined
    assert executor.declined[(v.shape, 132)] == [("entry", tuple(declined))]
    assert kinds.count("entry") == 3 and kinds.count("block") == 5
    assert executor.route(v.shape) is executor.routes[(v.shape, 132)]
    assert all(c.count == 0 for c in launch_counters().values())


def test_route_per_shape(models):
    """At 64 px nothing falls back and the route is the structure's; one
    executor keeps a route for each shape it served."""
    _, model = models
    executor = FusedExecutor(model)
    assert fallbacks(executor, (2, T, 64, 64, 3))[0] == []
    assert executor.route((2, T, 64, 64, 3)) == executor.steps
    assert fallbacks(executor, (2, T, 56, 56, 3))[0] == ["layer3_0"]
    with torch.no_grad():
        for px in (64, 56):
            executor(torch.zeros((1, T, px, px, 3)))
    assert sorted(k[0][2] for k in executor.routes) == [56, 56, 64, 64]
    assert {k[0][0] for k in executor.routes} == {1, 2}


def test_large_routes_every_block_at_224():
    """Large at 224 px, bfloat16 on the card's 132 SMs: 47 blocks on K2 and
    4 entries on K3, nothing on the module path; at 112 px the last entry
    (7 x 7) takes the module path."""
    model = create_rubiksnet("large", 174, max_shift=1, device="cpu",
                             dtype=torch.bfloat16)
    executor = FusedExecutor(model)
    for batch in (1, 8, 32):
        steps = executor.route((batch, 8, 224, 224, 3))
        blocks = [n for k, ns, _ in steps if k == "block" for n in ns]
        entries = [n for k, ns, _ in steps if k == "entry" for n in ns]
        assert (len(blocks), entries) == (47, ENTRIES)
        assert not [k for k, _, _ in steps if k == "module"]
    names, _ = fallbacks(executor, (8, 8, 112, 112, 3))
    assert names == ["layer4_0"]


def test_supported_follows_the_kernels_limits():
    """The checks are pure Python: K3 declines odd H or W and another Cin;
    both decline more than 16 taps per axis and other dtypes."""
    f32, bf = torch.float32, torch.bfloat16
    assert fused_entry_supported((2, 4, 8, 8, 54), 54, 108, 1, f32)
    assert not fused_entry_supported((2, 4, 7, 8, 54), 54, 108, 1, f32)
    assert not fused_entry_supported((2, 4, 8, 7, 54), 54, 108, 1, f32)
    assert not fused_entry_supported((2, 4, 8, 8, 54), 72, 108, 1, f32)
    assert not fused_entry_supported((2, 4, 8, 8, 54), 54, 108, 8, f32)
    assert not fused_entry_supported((2, 4, 8, 8, 54), 54, 108, 1,
                                     torch.float16)
    assert fused_block_supported((2, 4, 7, 7, 54), 7, f32)
    assert fused_block_supported((2, 4, 7, 7, 54), 7, bf, quantize=True)
    assert not fused_block_supported((2, 4, 7, 7, 54), 8, f32)
    assert not fused_block_supported((2, 4, 7, 7, 54), 1, torch.float64)


# The largest max_shift whose SE gate fits beside K2's and K3's launch A
# plan, per batch, at Small's widths (14 x 14 x 288, K3 growing to 576).
# chip_smoke.py's phase 9 (e) holds the rule to the C side's own check on
# the card at K2's edge at batch 8 (5 runs, 6 is refused) and K3's at batch
# 2 (1 runs, 2 is refused).
SE_EDGE = {1: (7, 6), 2: (7, 1), 8: (5, 1), 32: (2, 1)}


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("max_shift", [1, 2, 4, 7])
def test_se_gate_shared_memory(batch, max_shift):
    """With SE on the tensor cores, K2 and K3 decline exactly the plans whose
    gate region does not fit a block's shared memory: every max_shift up to
    the edge of SE_EDGE fits, every one past it is declined. Without SE, and
    on the SIMT route (float32), which has no such region, both take the
    block. Small's widths at 14 x 14."""
    bf = torch.bfloat16
    k2_edge, k3_edge = SE_EDGE[batch]
    shape = (batch, 8, 14, 14, 288)
    assert fused_block_supported(shape, max_shift, bf, se=True) == (
        max_shift <= k2_edge)
    assert fused_block_supported(shape, max_shift, bf)
    assert fused_block_supported(shape, max_shift, torch.float32, se=True)
    assert fused_entry_supported(shape, 288, 576, max_shift, bf,
                                 se=True) == (max_shift <= k3_edge)
    assert fused_entry_supported(shape, 288, 576, max_shift, bf)
    assert fused_entry_supported(shape, 288, 576, max_shift, torch.float32,
                                 se=True)


def test_se_entry_that_does_not_fit_takes_the_module_path():
    """Small in bfloat16 with max_shift 2 at batch 2: K3-SE at 14 x 14 ->
    576 needs more shared memory than a block has, so that entry runs on
    the module path and the others on K3."""
    assert not fused_entry_supported((2, 8, 14, 14, 288), 288, 576, 2,
                                     torch.bfloat16, se=True)
    model = create_rubiksnet("small", 174, max_shift=2, device="cpu",
                             dtype=torch.bfloat16)
    executor = FusedExecutor(model)
    names, kinds = fallbacks(executor, (2, 8, 224, 224, 3))
    assert names == ["layer4_0"] and kinds.count("entry") == 3
    assert executor.declined[((2, 8, 224, 224, 3), 132)] == [
        ("entry", ("layer4_0",))]
    names, _ = fallbacks(executor, (1, 8, 224, 224, 3))
    assert names == []
    assert executor.declined[((1, 8, 224, 224, 3), 132)] == []


@pytest.mark.parametrize("batch,declined", [
    (1, []),
    (8, [("entry", ("layer4_0",))]),
    (32, [("block", tuple(f"layer3_{i}" for i in range(1, 6))),
          ("entry", ("layer4_0",))]),
])
def test_small_at_the_default_max_shift(batch, declined):
    """Small in bfloat16 at create_rubiksnet's default max_shift (4), 224
    px: one clip takes every SE step on its kernel; from batch 2 the last
    entry's gate does not fit K3's launch A, and at batch 32 neither does
    the 14 x 14 run's in K2. The executor records what it declined."""
    model = create_rubiksnet("small", 174, device="cpu", dtype=torch.bfloat16)
    executor = FusedExecutor(model)
    shape = (batch, 8, 224, 224, 3)
    steps = executor.route(shape)
    assert executor.declined[(shape, 132)] == declined
    modules = [n for k, ns, _ in steps if k == "module" for n in ns]
    assert modules == [n for _, names in declined for n in names]


@pytest.mark.parametrize("which", ["block", "entry"])
def test_supported_declines_only_where_no_plan_fits(monkeypatch, which):
    """A plan that reports NoPlan is a decline; any other error of the
    planner is a fault and propagates out of the check."""
    if which == "block":
        module, name = fused_block, "fused_block_plan"

        def check():
            return fused_block_supported((2, 4, 8, 8, 54), 1, torch.bfloat16)
    else:
        module, name = fused_entry, "fused_entry_plan"

        def check():
            return fused_entry_supported((2, 4, 8, 8, 54), 54, 108, 1,
                                         torch.bfloat16)

    assert check()

    def no_plan(*args, **kwargs):
        raise NoPlan("no plan fits")

    def broken(*args, **kwargs):
        raise ValueError("a fault in the planner")

    monkeypatch.setattr(module, name, no_plan)
    assert not check()
    monkeypatch.setattr(module, name, broken)
    with pytest.raises(ValueError, match="a fault in the planner"):
        check()
