"""The port's data parallelism (``rubiksnet_torch.parallel.mesh``, the
DDP train step, ``train.py --data-parallel``, the batch-sharded
evaluator) on 2 gloo ranks on the CPU, against the JAX package's data mesh
(2 of its 8 virtual CPU devices) and against the port's one-process runs.

One module-scoped fixture spawns the ranks once and runs every check there
(tests/test_torch_parallel_ranks.py::data_job); the tests read its results.

* The eval step with the batch sharded, logits gathered in order, against
  JAX's jitted eval step over a batch-sharded array (rtol 1e-4, atol 1e-5).
* The DDP train step at local batch 1 against JAX's step over a data mesh
  at batch 2: the setup and tolerance of tests/test_torch_train_parity.py
  (1e-5), with float64 parameters on both sides. With float32 parameters
  DDP averages float32 gradients, one rounding away from the one-process
  gradient, and the shift gradient's normalization magnifies that in a
  channel whose raw gradient nearly cancels (2.7e-5 in one entry of the
  step-2 momentum).
* The DDP train step in float64 (parameters too) against the port's
  one-process step at the global batch, 1e-10: loss, every gradient (the
  shifts' normalized over the global batch), BN running statistics,
  parameters and momentum, for both variants.
* ``train.py --data-parallel 2 --synthetic`` in float64 against one
  process, 1e-10, and its checkpoint loaded in one process.
* ``train.py``'s registry train batches on 2 ranks against one process,
  over two epochs with a dropped remainder: each rank decodes only its
  rows, and skips the others' clips with the same random draws.
* ``test_models`` on 2 ranks (the last batch's second half all padding):
  the one-process run's accuracies.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from PIL import Image

from rubiksnet_torch.data import batch_iterator
from rubiksnet_torch.models import (
    create_rubiksnet,
    save_pretrained,
    state_dict_from_jax,
)
from rubiksnet_torch.parallel import (
    choose_backend,
    create_mesh,
    initialize_distributed,
    shard_batch,
)
from rubiksnet_torch.scripts import eval_throughput, test_models
from rubiksnet_torch.scripts import train as port_train
from rubiksnet_torch.scripts.train import latest_checkpoint
from rubiksnet_torch.train import load_train_state, sgd_with_shift_mult
from rubiksnet_tpu.parallel import mesh as jax_mesh
from rubiksnet_tpu.train import create_train_state
from rubiksnet_tpu.train import make_eval_step as jax_eval_step
from rubiksnet_tpu.train import make_train_step as jax_train_step
from rubiksnet_tpu.train import sgd_with_shift_mult as jax_sgd
from test_torch_model import tiny_bundle
from test_torch_train_parity import (
    LR,
    SHIFT_MULT,
    TOL,
    WEIGHT_DECAY,
    _clips,
    _momentum,
)
from test_torch_parallel_ranks import (
    as_float64,
    data_job,
    registry_batches,
    run_ranks,
    train_script_float64,
    train_steps,
)

torch.set_num_threads(1)

RANKS, CLASSES = 2, 11
TOL64 = 1e-10
TMPL, VIDEOS, EVAL_CLASSES, EVAL_T, CROP, SCALE = "{:05d}.jpg", 5, 5, 4, 32, 36
REGISTRY_T = 2


# ------------------------------------------------------------ one process


def test_single_process_is_a_no_op(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(log=None) is False
    assert create_mesh() is None and create_mesh(1) is None


def test_backend_rule():
    assert choose_backend("cpu", 2) == "gloo"
    if torch.cuda.device_count() == 0:
        assert choose_backend("cuda", 1) == "gloo"


def test_mesh_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        create_mesh(model=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        create_mesh(2)


def test_shard_batch_without_a_group():
    batch = {"v": np.arange(8).reshape(4, 2), "l": torch.arange(4)}
    out = shard_batch(batch, None)
    np.testing.assert_array_equal(out["v"], batch["v"])
    assert torch.equal(out["l"], batch["l"])


@pytest.mark.parametrize("n,batch,world", [(7, 4, 2), (3, 4, 2), (8, 6, 3),
                                           (9, 4, 4)])
def test_rank_batches_partition_the_batches(n, batch, world):
    """Each rank's part of every batch, read by index: together, in rank
    order, the one-process batches (padding and valid marks included), and
    every rank yields as many batches."""
    data = [(np.full((4, 2, 2, 3), i, np.uint8), i % 3) for i in range(n)]
    want = list(batch_iterator(data, batch, 2, 2))
    parts = [list(batch_iterator(data, batch, 2, 2, rank=r, world=world))
             for r in range(world)]
    assert all(len(p) == len(want) for p in parts)
    for i, (video, labels, valid) in enumerate(want):
        np.testing.assert_array_equal(
            np.concatenate([p[i][0] for p in parts]), video)
        np.testing.assert_array_equal(
            np.concatenate([p[i][1] for p in parts]), labels)
        np.testing.assert_array_equal(
            np.concatenate([p[i][2] for p in parts]), valid)
    with pytest.raises(ValueError, match="does not divide"):
        next(batch_iterator(data, 5, 2, 2, rank=0, world=2))


# ------------------------------------------------------------ two ranks


def write_frames(root):
    rng = np.random.RandomState(0)
    lines = []
    for vi in range(VIDEOS):
        d = root / f"vid{vi}"
        d.mkdir()
        for f in range(1, 9 + vi + 1):
            Image.fromarray(rng.randint(0, 255, (40, 52, 3)).astype(
                np.uint8)).save(str(d / TMPL.format(f)), quality=95)
        lines.append(f"vid{vi} {9 + vi} {vi % EVAL_CLASSES}")
    (root / "val.txt").write_text("\n".join(lines) + "\n")


def train_argv(ckpt_dir, *extra):
    return ["--synthetic", "16", "--tier", "tiny", "--num-classes", "5",
            "--frames", "2", "--input-size", "16", "--batch-size", "4",
            "--lr", "0.05", "--lr-schedule", "cosine", "--warmup-steps", "1",
            "--total-steps", "4", "--save-every", "2", "--val-every", "2",
            "--val-size", "8", "--log-every", "1", "--prefetch-depth", "0",
            "--device", "cpu", "--seed", "3", "--checkpoint-dir",
            str(ckpt_dir), *extra]


def registry_argv(root, batch):
    return ["somethingv2", "--root", root, "--frames", str(REGISTRY_T),
            "--input-size", "16", "--batch-size", str(batch), "--seed", "5",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data_parallel")
    bundle = tiny_bundle(seed=0, dtype=jnp.float64)
    bundle.variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), dict(bundle.variables))
    rng = np.random.default_rng(5)
    frames = tmp / "frames"
    frames.mkdir()
    write_frames(frames)
    eval_model = create_rubiksnet("tiny", EVAL_CLASSES, EVAL_T, max_shift=1,
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(9))
    ckpt = tmp / "tiny.pth.tar"
    save_pretrained(eval_model, ckpt)
    registry = eval_throughput.generate_registry(str(tmp / "ssv2"), 5, 3, 3,
                                                 seed=1)
    clips = [(rng.standard_normal((4, 4, 32, 32, 3)).astype(np.float32),
              rng.integers(0, CLASSES, 4)) for _ in range(2)]
    return dict(
        tmp=tmp, bundle=bundle, classes=CLASSES,
        jax_state=state_dict_from_jax(bundle.variables["params"],
                                      bundle.variables["batch_stats"]),
        eval_video=rng.standard_normal((4, 1, 4, 32, 32, 3)).astype(
            np.float32),
        eval_labels=np.array([3, 1, 10, 0]),
        parity_clips=[_clips(i) for i in range(2)],
        parity_sgd=(LR, SHIFT_MULT),
        clips=clips,
        train_argv=train_argv(tmp / "run_dp", "--data-parallel", "2"),
        registry_argv=registry_argv(registry, 2),
        eval_argv=["-p", str(ckpt), "--val-list", str(frames / "val.txt"),
                   "--root-path", str(frames), "--image-tmpl", TMPL,
                   "--num-classes", str(EVAL_CLASSES), "--frames",
                   str(EVAL_T), "--batch-size", "4", "--loader", "pil",
                   "--device", "cpu"],
        crop=CROP, scale=SCALE)


@pytest.fixture(scope="module")
def ranks(case):
    job = {k: v for k, v in case.items() if k not in ("tmp", "bundle")}
    return run_ranks(data_job, RANKS, case["tmp"] / "ranks", job)


def jax_data_mesh():
    return jax_mesh.create_mesh(data=RANKS, devices=jax.devices()[:RANKS])


def put(mesh, tree, spec):
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, spec)), tree)


def test_replicated_broadcasts_the_first_rank(ranks):
    first = ranks[0]["replicated"]
    want = create_rubiksnet("tiny", 5, 2, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    for r in ranks:
        for k, v in want.state_dict().items():
            assert torch.equal(r["replicated"][k], v), k
            assert torch.equal(first[k], v), k


def test_data_parallel_eval_matches_jax(case, ranks):
    bundle, mesh = case["bundle"], jax_data_mesh()
    step = jax.jit(jax_eval_step(bundle.model, num_crops=1))
    out = step(put(mesh, dict(bundle.variables), P()),
               put(mesh, jnp.asarray(case["eval_video"]), P("data")),
               put(mesh, jnp.asarray(case["eval_labels"]), P("data")))
    want = np.asarray(out["logits"])
    for r in ranks:
        np.testing.assert_allclose(r["eval_logits"].numpy(), want,
                                   rtol=1e-4, atol=1e-5)


def test_ddp_step_matches_the_jax_data_mesh(case, ranks):
    """Two steps at local batch 1 on each rank against JAX's jitted step
    over a batch sharded on 2 devices, from the same state: the losses,
    the step-1 gradients (JAX's first momentum less the weight decay), and
    parameters, BN statistics and momentum after step 2."""
    bundle, mesh = case["bundle"], jax_data_mesh()
    tx = jax_sgd(LR, SHIFT_MULT)
    state = put(mesh, create_train_state(bundle, tx), P())
    p0 = state_dict_from_jax(bundle.variables["params"])
    step = jax.jit(jax_train_step(bundle.model, tx))
    losses, states = [], []
    for video, labels in case["parity_clips"]:
        state, metrics = step(state, put(mesh, jnp.asarray(video), P("data")),
                              put(mesh, jnp.asarray(labels), P("data")))
        losses.append(float(metrics["loss"]))
        states.append(state)
    trace = state_dict_from_jax(_momentum(states[0].opt_state))
    final = state_dict_from_jax(states[1].params, states[1].batch_stats)
    trace2 = state_dict_from_jax(_momentum(states[1].opt_state))
    model = create_rubiksnet("tiny", CLASSES, 4, max_shift=1, device="cpu")
    groups = {id(p): g for g, ps in
              ((g["name"], g["params"]) for g in
               sgd_with_shift_mult(model, LR).param_groups) for p in ps}
    names = {n: groups[id(p)] for n, p in model.named_parameters()}
    for r in ranks:
        got_losses, grads, got_state, momentum = r["ddp_vs_jax"]
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


def assert_close64(got, want, what):
    assert got.keys() == want.keys(), what
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=TOL64,
                                   atol=TOL64, err_msg=f"{what} {name}")


@pytest.mark.parametrize("variant", ["rubiks3d", "rubiks3d-aq"])
def test_ddp_step_equals_one_process(case, ranks, variant):
    """Two float64 steps on 2 ranks at local batch 2 against one process at
    batch 4: loss, every gradient (shifts normalized over the global
    batch: their raw gradients are averaged before normalization), BN
    running statistics over the global batch, parameters, momentum."""
    model = as_float64(create_rubiksnet(
        "tiny", CLASSES, 4, variant, max_shift=1, device="cpu",
        generator=torch.Generator().manual_seed(0)))
    losses, grads, state, momentum = train_steps(
        model, sgd_with_shift_mult(model, 0.05, 0.1), case["clips"])
    assert any(n.endswith("shift") for n in grads)
    for r in ranks:
        got_losses, got_grads, got_state, got_momentum = r[f"ddp_{variant}"]
        np.testing.assert_allclose(got_losses, losses, rtol=TOL64, atol=0)
        assert_close64(got_grads, grads, "gradient")
        assert_close64(got_state, state, "state")
        assert_close64(got_momentum, momentum, "momentum")


def test_train_script_data_parallel_equals_one_process(case, ranks):
    """``train.py --data-parallel 2 --synthetic`` (float64) against the
    one-process run: losses, validations and final state; rank 0's
    checkpoint (no ``module.`` prefix) loads in one process."""
    losses, state, val = train_script_float64(
        train_argv(case["tmp"] / "run_one"))
    for r in ranks:
        got_losses, got_state, got_val = r["train_script"]
        assert len(got_losses) == len(losses) == 4
        np.testing.assert_allclose(got_losses, losses, rtol=TOL64, atol=0)
        assert got_val == pytest.approx(val, rel=TOL64)
        assert_close64(got_state, state, "final state")
    path = latest_checkpoint(str(case["tmp"] / "run_dp"))
    assert path and path.endswith("train_state_00000004.pt")
    model = as_float64(create_rubiksnet("tiny", 5, 2, device="cpu"))
    opt = sgd_with_shift_mult(model, 0.05)
    step, meta = load_train_state(path, model, opt)
    assert step == 4 and meta["tier"] == "tiny"
    assert_close64(model.state_dict(), state, "checkpoint")
    assert os.path.exists(case["tmp"] / "run_dp" / "model_final.pth.tar")


def test_test_models_sharded_equals_one_process(case, ranks):
    """The evaluator on 2 ranks (each decodes and evaluates its rows of
    every batch of 4; the last batch holds one video) against one
    process: the same accuracies, per class too, and the logits in order."""
    want = test_models.evaluate(
        test_models.build_parser().parse_args(case["eval_argv"]), CROP,
        SCALE, log=lambda *a: None)
    assert len(want["labels"]) == VIDEOS
    for r in ranks:
        got = r["test_models"]
        assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
        np.testing.assert_array_equal(got["class_accuracy"],
                                      want["class_accuracy"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                                   atol=1e-6)


def assert_rank_rows(parts, want, local):
    """Each rank's batches, concatenated in rank order, are the one-process
    batches; each rank decoded the frames of its own rows only."""
    batches, ranks = want[0], [p[0] for p in parts]
    assert batches and all(len(p) == len(batches) for p in ranks)
    for i, one in enumerate(batches):
        for j, a in enumerate(one):
            np.testing.assert_array_equal(
                np.concatenate([p[i][j] for p in ranks]), a)
    for _, got in parts:
        assert len(got) == len(batches) * local * REGISTRY_T


def test_train_script_registry_batches_on_two_ranks(case, ranks):
    """``train.py``'s registry train batches on 2 ranks (5 videos, batch 2,
    two epochs, one clip dropped each) against one process: the same clips
    with the same sampler and crop draws, each rank decoding one clip a
    batch where one process decodes all five an epoch."""
    want = registry_batches(case["registry_argv"], None)
    assert len(want[0]) == 4 and len(want[1]) == 2 * 5 * REGISTRY_T
    assert_rank_rows([r["registry"] for r in ranks], want, 1)


@pytest.mark.parametrize("world,batch", [(2, 4), (4, 4)])
def test_registry_skip_keeps_the_draws(case, monkeypatch, world, batch):
    """``build_data``'s registry batches for each rank of ``world`` in one
    process (its rank read from a patched ``group_rank``): together the
    one-process batches, each rank decoding only its rows."""
    argv = registry_argv(str(case["tmp"] / "ssv2"), batch)
    want = registry_batches(argv, None)
    monkeypatch.setattr(port_train, "group_size", lambda g: world)
    parts = []
    for r in range(world):
        monkeypatch.setattr(port_train, "group_rank", lambda g, r=r: r)
        parts.append(registry_batches(argv, "group"))
    assert_rank_rows(parts, want, batch // world)
