"""The port's tensor parallelism (``rubiksnet_torch.parallel``'s model
group: ``create_mesh(data, model)``, ``param_partition_spec``,
``shard_params``, ``gather_params``, the column-parallel layers, the
``data x model`` train step, ``train.py --model-parallel``) on gloo ranks
on the CPU, against the JAX package's partition rule and (data, model)
mesh step and against the port's one-process runs.

Two module-scoped fixtures spawn the ranks once each and run every check
there (tests/test_torch_parallel_ranks.py::tensor_job): 2 ranks (a 1 x 2
mesh) and 4 (a 2 x 2 mesh, then a 1 x 4 one). The tests read their
results.

* ``param_partition_spec`` against JAX's on ``jax.eval_shape`` of the same
  model, name by name through ``state_dict_from_jax``'s mapping: Large,
  Small and tiny, both variants, at the default size and at 1 << 12, over
  2 and 4 ranks. The one divergence: ``new_fc`` at 174 classes over 4
  ranks stays replicated where JAX's ``device_put`` raises.
* ``shard_params`` then ``gather_params``: the state bit for bit.
* Two float64 steps (parameters too) on the 1 x 2 and 2 x 2 meshes, both
  variants (and the SE tier on 1 x 2), and on 1 x 4 at 174 classes,
  against the port's one-process step at the global batch, 1e-10: loss,
  every gradient (gathered), BN running statistics, parameters and
  momentum; the replicated parameters' gradients equal on every rank of a
  model group; the collectives counted.
* The 2 x 2 step against JAX's jitted step over a (data 2, model 2) mesh
  (tests/test_parallel.py::test_dp_tp_train_step_runs_and_matches's setup,
  ``min_size_for_tp=1 << 12``) at tests/test_torch_train_parity.py's
  tolerance, weights carried across by ``state_dict_from_jax``, then
  sharded.
* The eval step's logits under the model group against one process.
* ``train.py --data-parallel 1 --model-parallel 2 --synthetic`` (float64)
  against one process; its checkpoint loaded in one process; a
  one-process checkpoint resumed over the model group.
* A model group and a time group together raise; so do the fused executor
  on a sharded model or under a model group, and a sharded layer outside
  its group.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rubiksnet_torch.models import create_rubiksnet, state_dict_from_jax
from rubiksnet_torch.models.rubiksnet import RubiksNet
from rubiksnet_torch.parallel import Shard, param_partition_spec
from rubiksnet_torch.scripts.train import checkpoint_path, latest_checkpoint
from rubiksnet_torch.train import load_train_state, sgd_with_shift_mult
from rubiksnet_tpu.models.rubiksnet import RubiksNet as JaxRubiksNet
from rubiksnet_tpu.parallel import mesh as jax_mesh
from rubiksnet_tpu.train import create_train_state
from rubiksnet_tpu.train import make_train_step as jax_train_step
from rubiksnet_tpu.train import sgd_with_shift_mult as jax_sgd
from test_torch_model import tiny_bundle
from test_torch_parallel import TOL64, assert_close64, put, train_argv
from test_torch_parallel_ranks import (
    as_float64,
    run_ranks,
    tensor_job,
    tp_model,
    train_script_float64,
    train_steps,
)
from test_torch_train_parity import (
    LR,
    SHIFT_MULT,
    TOL,
    WEIGHT_DECAY,
    _clips,
    _momentum,
)

torch.set_num_threads(1)

CLASSES, FRAMES, WIDE_CLASSES = 11, 4, 174
# A head that shards over 2 ranks (11 classes stay replicated in the port;
# JAX's device_put refuses them): JAX's mesh step and the eval step.
EVEN_CLASSES = 12
# (variant, min_size_for_tp, tier) of the 1 x 2 steps: at 1 << 10 the stem,
# most 1x1 convs, the head and (Small) the SE dense layers shard.
STEPS_1X2 = (("rubiks3d", 1 << 10, "tiny"), ("rubiks3d-aq", 1 << 10, "tiny"),
             ("rubiks3d", 1 << 10, "small"))
STEPS_2X2 = (("rubiks3d", 1 << 12, "tiny"), ("rubiks3d-aq", 1 << 12, "tiny"))
SPEC_MODELS = [(t, v) for t in ("large", "small", "tiny")
               for v in ("rubiks3d", "rubiks3d-aq")]


# ------------------------------------------------------------ the partition


@functools.lru_cache(maxsize=None)
def jax_sharded(tier, variant, min_size):
    """The names (the port's, through ``state_dict_from_jax``) of the
    parameters JAX's ``param_partition_spec`` shards over ``model``."""
    model = JaxRubiksNet(tier=tier, num_classes=WIDE_CLASSES, num_frames=4,
                         variant=variant)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)),
        train=False))["params"]
    spec = jax_mesh.param_partition_spec(shapes, min_size)
    marks = jax.tree_util.tree_map(
        lambda leaf, s: np.full((1,) * len(leaf.shape), float(s != P()),
                                np.float32), shapes, spec)
    return frozenset(n for n, v in state_dict_from_jax(marks).items()
                     if v.flatten()[0] == 1)


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("min_size", [1 << 16, 1 << 12])
@pytest.mark.parametrize("tier,variant", SPEC_MODELS)
def test_partition_spec_matches_jax(tier, variant, min_size, model_size):
    want = jax_sharded(tier, variant, min_size)
    model = RubiksNet(tier, WIDE_CLASSES, 4, variant)  # shapes only
    params = dict(model.named_parameters())
    spec = param_partition_spec(model, model_size, min_size)
    assert spec.keys() == params.keys() and want <= spec.keys()
    got = {n for n, d in spec.items() if d == 0}
    indivisible = {n for n in want if params[n].shape[0] % model_size}
    assert indivisible == ({"new_fc.weight"} if model_size == 4 else set())
    assert got == want - indivisible
    assert set(spec.values()) <= {0, None}
    if (tier, variant, min_size) == ("large", "rubiks3d", 1 << 16):
        assert len(want) == 79  # 71 + 2 + 5 1x1 convs and new_fc
    if tier == "small" and min_size == 1 << 12:
        assert any(".se.fc." in n for n in got)


def test_shard_rows_split_as_tensor_split():
    for full, parts in ((174, 4), (12, 2), (7, 3)):
        rows = [torch.arange(full)[Shard(full, parts, i).rows]
                for i in range(parts)]
        for got, want in zip(rows, torch.tensor_split(torch.arange(full),
                                                      parts)):
            assert torch.equal(got, want)


# ------------------------------------------------------------ the ranks


def resume_from_step_2(src, dst):
    os.makedirs(dst)
    shutil.copy(checkpoint_path(str(src), 2), dst)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    rng = np.random.default_rng(7)
    bundle = tiny_bundle(seed=0, dtype=jnp.float64,
                         num_classes=EVEN_CLASSES)
    bundle.variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), dict(bundle.variables))
    eval_model = create_rubiksnet("tiny", EVEN_CLASSES, FRAMES, max_shift=1,
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(9))
    one = train_script_float64(train_argv(tmp / "run_one"))
    resume_from_step_2(tmp / "run_one", tmp / "resume_one")
    resume_from_step_2(tmp / "run_one", tmp / "resume_tp")
    out = dict(
        tmp=tmp, bundle=bundle, classes=CLASSES, frames=FRAMES,
        clips=[(rng.standard_normal((4, FRAMES, 32, 32, 3)).astype(
            np.float32), rng.integers(0, CLASSES, 4)) for _ in range(2)],
        steps_1x2=STEPS_1X2,
        eval_state=eval_model.state_dict(),
        eval_spec=param_partition_spec(eval_model, 2, 1 << 10),
        eval_video=rng.standard_normal((4, 1, FRAMES, 32, 32, 3)).astype(
            np.float32),
        eval_labels=np.array([3, 1, 10, 0]),
        jax_state=state_dict_from_jax(bundle.variables["params"],
                                      bundle.variables["batch_stats"]),
        even_classes=EVEN_CLASSES,
        jax_spec=param_partition_spec(eval_model, 2, 1 << 12),
        parity_clips=[_clips(i) for i in range(2)],
        parity_sgd=(LR, SHIFT_MULT),
        train_argv=train_argv(tmp / "run_tp", "--data-parallel", "1",
                              "--model-parallel", "2"),
        resume_argv=train_argv(tmp / "resume_tp", "--model-parallel", "2",
                               "--resume", "--steps", "2"),
        one_process=one,
        one_resumed=train_script_float64(train_argv(
            tmp / "resume_one", "--resume", "--steps", "2")))
    return out


def job_case(case):
    return {k: v for k, v in case.items()
            if k not in ("tmp", "bundle", "one_process", "one_resumed")}


@pytest.fixture(scope="module")
def ranks2(case):
    return run_ranks(tensor_job, 2, case["tmp"] / "ranks2", job_case(case))


@pytest.fixture(scope="module")
def ranks4(case):
    return run_ranks(tensor_job, 4, case["tmp"] / "ranks4", job_case(case))


def test_mesh_groups_are_row_major(ranks2, ranks4):
    """rank = d * M + m: a model group is the M consecutive ranks of a row,
    a data group the D ranks of a column (None where D is 1)."""
    for r in ranks2:
        assert r["groups"] == (None, [0, 1])
    for rank, r in enumerate(ranks4):
        d, m = divmod(rank, 2)
        assert r["groups"] == ([m, m + 2], [2 * d, 2 * d + 1])
        assert r["wide_groups"] == (None, [0, 1, 2, 3])


def test_shard_then_gather_is_the_state(case, ranks2):
    """Each rank keeps an exact slice of its sharded weights' output rows;
    gathered, the state is the full one bit for bit."""
    model = tp_model(case, "rubiks3d")
    spec = param_partition_spec(model, 2)
    assert sum(d == 0 for d in spec.values()) > 0
    params = dict(model.named_parameters())
    for rank, r in enumerate(ranks2):
        full, back = r["round_trip"]
        assert full.keys() == back.keys()
        for k, v in full.items():
            assert torch.equal(back[k], v), k
        for n, p in params.items():
            want = p.detach()
            if spec[n] == 0:
                want = want[Shard(p.shape[0], 2, rank).rows]
            assert torch.equal(r["shard_rows"][n], want), n


def one_process(case, variant, classes=None, tier="tiny"):
    model = tp_model(case, variant, classes, tier)
    return train_steps(model, sgd_with_shift_mult(model, 0.05, 0.1),
                       case["clips"])


def want_counts(case, variant, min_size, model_size, classes=None,
                tier="tiny"):
    """The model group's collectives of two steps: a gather a sharded
    layer a forward, an input-gradient all-reduce a sharded layer a
    backward but the stem's (the clip needs no gradient)."""
    spec = param_partition_spec(tp_model(case, variant, classes, tier),
                                model_size, min_size)
    n = sum(d == 0 for d in spec.values())
    stem = spec["backbone.conv1.weight"] == 0
    return {"gather_channels": 2 * n, "model_all_reduce": 2 * (n - stem)}


def assert_steps_equal(case, results, variant, min_size, model_size,
                       classes=None, tier="tiny"):
    losses, grads, state, momentum = one_process(case, variant, classes,
                                                 tier)
    want = want_counts(case, variant, min_size, model_size, classes, tier)
    for (got_losses, got_grads, got_state, got_momentum), counts, _ in (
            results):
        np.testing.assert_allclose(got_losses, losses, rtol=TOL64, atol=0)
        assert_close64(got_grads, grads, "gradient")
        assert_close64(got_state, state, "state")
        assert_close64(got_momentum, momentum, "momentum")
        assert counts == want


def assert_replicated_grads_alike(results, groups):
    for group in groups:
        first = results[group[0]][2]
        for r in group[1:]:
            got = results[r][2]
            assert got.keys() == first.keys()
            for n, g in first.items():
                assert torch.equal(got[n], g), n


@pytest.mark.parametrize("variant,min_size,tier", STEPS_1X2)
def test_1x2_step_equals_one_process(case, ranks2, variant, min_size, tier):
    """Two float64 steps, the model sharded over 2 ranks that both take
    the batch of 4, against one process: loss, every gradient gathered,
    BN running statistics, parameters, momentum; the replicated
    parameters' gradients bit-identical on both ranks."""
    results = [r[f"1x2 {variant} {min_size} {tier}"] for r in ranks2]
    assert_steps_equal(case, results, variant, min_size, 2, tier=tier)
    assert_replicated_grads_alike(results, [[0, 1]])


@pytest.mark.parametrize("variant,min_size,tier", STEPS_2X2)
def test_2x2_step_equals_one_process(case, ranks4, variant, min_size, tier):
    """The same on a 2 x 2 mesh: 2 rows of the batch a data rank, DDP over
    each data group, the weights sharded over each model group."""
    results = [r[f"2x2 {variant}"] for r in ranks4]
    assert_steps_equal(case, results, variant, min_size, 2, tier=tier)
    assert_replicated_grads_alike(results, [[0, 1], [2, 3]])


def test_1x4_step_at_174_classes_equals_one_process(case, ranks4):
    """Four model ranks at 174 classes: new_fc stays replicated (174 does
    not divide by 4), the rest of JAX's default partition shards."""
    spec = param_partition_spec(tp_model(case, "rubiks3d", WIDE_CLASSES), 4)
    assert spec["new_fc.weight"] is None
    assert sum(d == 0 for d in spec.values()) > 0
    results = [r["1x4 174"] for r in ranks4]
    assert_steps_equal(case, results, "rubiks3d", 1 << 16, 4,
                       classes=WIDE_CLASSES)
    assert_replicated_grads_alike(results, [[0, 1, 2, 3]])


def test_2x2_step_matches_the_jax_mesh(case, ranks4):
    """Two steps at a data rank's batch of 1 on the 2 x 2 mesh against
    JAX's jitted step over a (data 2, model 2) mesh of 4 virtual devices
    with its partition at 1 << 12, from the same state: the losses, the
    step-1 gradients (JAX's first momentum less the weight decay), and
    parameters, BN statistics and momentum after step 2."""
    bundle = case["bundle"]
    mesh = jax_mesh.create_mesh(data=2, model=2, devices=jax.devices()[:4])
    tx = jax_sgd(LR, SHIFT_MULT)
    state = create_train_state(bundle, tx)
    pspecs = jax_mesh.param_partition_spec(state.params,
                                           min_size_for_tp=1 << 12)
    state = state._replace(
        params=jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            state.params, pspecs),
        batch_stats=put(mesh, state.batch_stats, P()),
        opt_state=put(mesh, state.opt_state, P()),
        step=jax.device_put(state.step, NamedSharding(mesh, P())))
    p0 = state_dict_from_jax(bundle.variables["params"])
    step = jax.jit(jax_train_step(bundle.model, tx))
    losses, states = [], []
    with mesh:
        for video, labels in case["parity_clips"]:
            state, metrics = step(state,
                                  put(mesh, jnp.asarray(video), P("data")),
                                  put(mesh, jnp.asarray(labels), P("data")))
            losses.append(float(metrics["loss"]))
            states.append(state)
    trace = state_dict_from_jax(_momentum(states[0].opt_state))
    final = state_dict_from_jax(states[1].params, states[1].batch_stats)
    trace2 = state_dict_from_jax(_momentum(states[1].opt_state))
    model = create_rubiksnet("tiny", EVEN_CLASSES, FRAMES, max_shift=1,
                             device="cpu")
    groups = {id(p): g for g, ps in
              ((g["name"], g["params"]) for g in
               sgd_with_shift_mult(model, LR).param_groups) for p in ps}
    names = {n: groups[id(p)] for n, p in model.named_parameters()}
    assert case["jax_spec"]["new_fc.weight"] == 0
    for r in ranks4:
        got_losses, grads, got_state, momentum = r["2x2 vs jax"]
        np.testing.assert_allclose(got_losses, losses, rtol=TOL, atol=TOL)
        for name, g in grads.items():
            want = trace[name] - (WEIGHT_DECAY * p0[name]
                                  if names[name] == "weight" else 0)
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=TOL,
                                       atol=TOL, err_msg=name)
        for name, v in final.items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got_state[name].numpy(),
                                       np.asarray(v), rtol=TOL, atol=TOL,
                                       err_msg=name)
        for name, m in momentum.items():
            np.testing.assert_allclose(m.numpy(), np.asarray(trace2[name]),
                                       rtol=TOL, atol=TOL, err_msg=name)


def test_eval_step_under_the_model_group(case, ranks2):
    """The eval step's logits with the stem, the 1x1 convs and the head
    sharded over 2 ranks (the module path) against one process."""
    model = create_rubiksnet("tiny", EVEN_CLASSES, FRAMES, max_shift=1,
                             device="cpu")
    model.load_state_dict(case["eval_state"])
    assert case["eval_spec"]["backbone.conv1.weight"] == 0
    assert case["eval_spec"]["new_fc.weight"] == 0
    with torch.no_grad():
        want = model(torch.from_numpy(case["eval_video"][:, 0]))
    for r in ranks2:
        np.testing.assert_allclose(r["eval_logits"].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_refusals(ranks2):
    for r in ranks2:
        got = r["refusals"]
        assert "cannot be active together" in got["time_in_model"]
        assert "cannot be active together" in got["model_in_time"]
        assert "cannot be used together" in got["step_with_both"]
        assert "unsharded model" in got["executor_sharded"]
        assert "model group" in got["executor_under_model"]
        assert "inside model_parallel" in got["sharded_outside"]


def rank_rows(state, spec, rank, parts):
    """A full state cut to rank ``rank``'s rows of the sharded weights."""
    return {k: v[Shard(v.shape[0], parts, rank).rows] if spec.get(k) == 0
            else v for k, v in state.items()}


def test_train_script_model_parallel_equals_one_process(case, ranks2):
    """``train.py --data-parallel 1 --model-parallel 2 --synthetic``
    (float64) against the one-process run: losses, validations, each
    rank's rows of the final state; the checkpoint (the full state, rank
    0's) loads in one process and equals the one-process state, and so
    does ``model_final.pth.tar``."""
    losses, state, val = case["one_process"]
    spec = param_partition_spec(create_rubiksnet(
        "tiny", 5, 2, device="cpu"), 2)
    assert any(d == 0 for d in spec.values())
    for rank, r in enumerate(ranks2):
        got_losses, got_state, got_val = r["script"]
        assert len(got_losses) == len(losses) == 4
        np.testing.assert_allclose(got_losses, losses, rtol=TOL64, atol=0)
        assert got_val == pytest.approx(val, rel=TOL64)
        assert_close64(got_state, rank_rows(state, spec, rank, 2),
                       "final state")
    path = latest_checkpoint(str(case["tmp"] / "run_tp"))
    assert path and path.endswith("train_state_00000004.pt")
    model = as_float64(create_rubiksnet("tiny", 5, 2, device="cpu"))
    opt = sgd_with_shift_mult(model, 0.05)
    step, meta = load_train_state(path, model, opt)
    assert step == 4 and meta["tier"] == "tiny"
    assert_close64(model.state_dict(), state, "checkpoint")
    final = torch.load(case["tmp"] / "run_tp" / "model_final.pth.tar",
                       weights_only=True)["model"]
    assert_close64(final, state, "model_final")


def test_one_process_checkpoint_resumes_over_the_model_group(case, ranks2):
    """A one-process step-2 checkpoint resumed by ``train.py
    --model-parallel 2 --resume`` for 2 steps equals the one-process
    resume: losses, validations, each rank's rows of the final state."""
    losses, state, val = case["one_resumed"]
    spec = param_partition_spec(create_rubiksnet(
        "tiny", 5, 2, device="cpu"), 2)
    for rank, r in enumerate(ranks2):
        got_losses, got_state, got_val = r["script_resumed"]
        assert len(got_losses) == len(losses) == 2
        np.testing.assert_allclose(got_losses, losses, rtol=TOL64, atol=0)
        assert got_val == pytest.approx(val, rel=TOL64)
        assert_close64(got_state, rank_rows(state, spec, rank, 2),
                       "resumed state")
