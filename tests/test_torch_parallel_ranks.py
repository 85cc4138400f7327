"""Run a function on the ranks of a gloo process group on the CPU, for the
port's parallel tests (tests/test_torch_parallel.py,
tests/test_torch_temporal_parallel.py, and the collectives' own tests at
the end of this file).

The ranks are spawned (``torch.multiprocessing`` with the ``spawn`` start
method: the pytest process holds JAX's threads, so it must not fork), meet
through a ``file://`` store under the test's temporary directory (no TCP
port, so parallel test workers cannot collide), run one thread each, and
return what the function returns through ``torch.save``. This module
imports torch and the port only, so a rank starts without JAX.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rubiksnet_torch.parallel import initialize_distributed


def _quiet(*_args, **_kw):
    pass


def _entry(rank, world, store, out, fn, args):
    torch.set_num_threads(1)
    initialize_distributed(init_method=f"file://{store}", world_size=world,
                           rank=rank, backend="gloo", device="cpu",
                           log=_quiet)
    try:
        result = fn(rank, world, dist.group.WORLD, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, tmp_dir, *args):
    """``fn(rank, world, group, *args)`` on ``world`` spawned ranks; returns
    their results in rank order. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function of an importable module)."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    mp.start_processes(_entry, args=(world, store, tmp_dir, fn, args),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ------------------------------------------------------------ shared helpers


def as_float64(model):
    """``model`` with float64 parameters, buffers and compute dtype, so a
    comparison of two runs sees no float32 rounding of the updates."""
    model.double()
    model.dtype = torch.float64
    return model


def train_script_float64(argv, log=_quiet):
    """``rubiksnet_torch.scripts.train.train`` on ``argv`` with its model in
    float64 (:func:`as_float64`); -> (losses, final state dict,
    validations)."""
    from rubiksnet_torch.scripts import train as script

    build = script.build_model
    script.build_model = lambda *a: as_float64(build(*a))
    try:
        result = script.train(script.build_parser().parse_args(argv), log=log)
    finally:
        script.build_model = build
    return result["losses"], result["model"].state_dict(), result["val"]


def registry_batches(argv, group, epochs=2):
    """``train.py``'s registry train batches over ``epochs`` epochs (this
    rank's rows under ``group``), from ``random.seed`` of the run's seed,
    as ``build_data`` yields them; -> (batches, the clips whose frames were
    decoded, one name a frame)."""
    import random

    from rubiksnet_torch.data import RubiksDataset
    from rubiksnet_torch.scripts import train as script

    args = script.build_parser().parse_args(argv)
    decoded, load = [], RubiksDataset._load_image

    def counted(self, record, idx):
        decoded.append(record.path)
        return load(self, record, idx)

    RubiksDataset._load_image = counted
    try:
        random.seed(args.seed)
        _, _, train_iter, _ = script.build_data(args, group)
        batches = [b for epoch in range(epochs) for b in train_iter(epoch)]
    finally:
        RubiksDataset._load_image = load
    return batches, decoded


def loss_weights(shape, dtype=torch.float64):
    """cos(0), cos(1), ... over ``shape``: a loss that weights every output
    element differently."""
    n = 1
    for d in shape:
        n *= d
    return torch.cos(torch.arange(n, dtype=dtype)).reshape(shape)


def grads_and_state(model):
    return ({n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


# ------------------------------------------------------------ the jobs


def temporal_job(rank, world, group, case):
    """The time-group checks of tests/test_torch_temporal_parallel.py on
    one rank: ``case`` holds the clips, shifts, weights and model states
    (numpy arrays and state dicts) that the parent also runs unsharded."""
    from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
    from rubiksnet_torch.parallel import (
        halo_exchange_time, sequence_parallel_eval, temporal_attention_shift,
        temporal_rubiks_shift_3d, time_parallel, time_shard_clip,
    )
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    k = case["max_shift"]
    out = {}
    x = torch.from_numpy(case["x"])
    xl = time_shard_clip(x, group)
    shift = torch.from_numpy(case["shift"])
    out["halo"] = halo_exchange_time(xl, k, group)
    for stride in (1, 2):
        out[f"forward{stride}"] = temporal_rubiks_shift_3d(
            xl, shift, group, stride, max_shift=k)
    out["attention"] = temporal_attention_shift(
        xl, torch.from_numpy(case["attention_weight"]), group=group)
    for name, q in (("fractional", ""), ("quantize", "_quantize")):
        for normalize in (True, False):
            xq = torch.from_numpy(case["x" + q]).double()
            xg = time_shard_clip(xq, group).requires_grad_()
            sg = torch.from_numpy(case["shift" + q]).double()
            sg.requires_grad_()
            y = temporal_rubiks_shift_3d(
                xg, sg, group, 1, normalize_grad=normalize,
                quantize=bool(q), max_shift=k)
            w = loss_weights((xq.shape[0], xq.shape[1])
                             + tuple(y.shape[2:]))
            (y * time_shard_clip(w, group)).sum().backward()
            out[f"grads_{name}_{normalize}"] = (y.detach(), xg.grad, sg.grad)
    try:
        temporal_rubiks_shift_3d(xl, shift, group, max_shift=xl.shape[1])
        out["too_large"] = None
    except ValueError as e:
        out["too_large"] = str(e)

    video = torch.from_numpy(case["video"])
    vl = time_shard_clip(video, group)
    for variant, state in case["eval_states"].items():
        model = create_rubiksnet("tiny", case["classes"], video.shape[1],
                                 variant, max_shift=k, device="cpu")
        model.load_state_dict(state)
        out[f"eval_{variant}"] = sequence_parallel_eval(model, group)(vl)
        if variant == "rubiks3d":
            executor = FusedExecutor(model)
            try:
                with time_parallel(group, k):
                    executor(vl)
                out["fused_under_time"] = None
            except RuntimeError as e:
                out["fused_under_time"] = str(e)

    model = as_float64(create_rubiksnet(
        "tiny", case["classes"], video.shape[1], max_shift=k, device="cpu",
        generator=torch.Generator().manual_seed(rank)))
    step = make_train_step(model, sgd_with_shift_mult(model, 0.05, 0.1),
                           time_group=group)
    metrics = step(vl, torch.from_numpy(case["labels"]))
    out["train"] = (float(metrics["loss"]), *grads_and_state(model))
    return out


def train_steps(model, optimizer, clips, group=None):
    """``make_train_step`` over ``clips`` [(video, labels) numpy, global
    batches], on this rank's rows of each where ``group`` is given; ->
    (losses, step-1 gradients, final state dict, momentum by name)."""
    from rubiksnet_torch.parallel import shard_batch
    from rubiksnet_torch.train import make_train_step

    step = make_train_step(model, optimizer, data_group=group)
    losses, grads = [], None
    for video, labels in clips:
        batch = (torch.from_numpy(video), torch.from_numpy(labels).long())
        if group is not None:
            batch = shard_batch(batch, group)
        losses.append(float(step(*batch)["loss"]))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    momentum = {n: optimizer.state[p]["momentum_buffer"].clone()
                for n, p in model.named_parameters()}
    return losses, grads, model.state_dict(), momentum


def data_job(rank, world, group, case):
    """The data-group checks of tests/test_torch_parallel.py on one rank."""
    from rubiksnet_torch.models import create_rubiksnet
    from rubiksnet_torch.parallel import gather_rows, replicated, shard_batch
    from rubiksnet_torch.scripts import test_models
    from rubiksnet_torch.train import make_eval_step, sgd_with_shift_mult

    out = {}
    model = create_rubiksnet("tiny", 5, 2, device="cpu",
                             generator=torch.Generator().manual_seed(rank))
    out["replicated"] = replicated(model, group).state_dict()

    def jax_model():
        m = as_float64(create_rubiksnet("tiny", case["classes"], 4,
                                        max_shift=1, device="cpu"))
        m.load_state_dict(case["jax_state"])
        return m

    video, labels = shard_batch(
        (torch.from_numpy(case["eval_video"]),
         torch.from_numpy(case["eval_labels"])), group)
    logits = make_eval_step(jax_model())(video, labels)["logits"]
    out["eval_logits"] = gather_rows(logits, group)

    model = jax_model()
    out["ddp_vs_jax"] = train_steps(
        model, sgd_with_shift_mult(model, *case["parity_sgd"]),
        case["parity_clips"], group)
    for variant in ("rubiks3d", "rubiks3d-aq"):
        model = as_float64(create_rubiksnet(
            "tiny", case["classes"], 4, variant, max_shift=1, device="cpu",
            generator=torch.Generator().manual_seed(0)))
        out[f"ddp_{variant}"] = train_steps(
            model, sgd_with_shift_mult(model, 0.05, 0.1), case["clips"],
            group)
    out["train_script"] = train_script_float64(case["train_argv"])
    out["registry"] = registry_batches(case["registry_argv"], group)
    result = test_models.evaluate(
        test_models.build_parser().parse_args(case["eval_argv"]),
        case["crop"], case["scale"], log=_quiet)
    out["test_models"] = {k: result[k] for k in (
        "logits", "labels", "top1", "top5", "class_accuracy")}
    return out


# ------------------------------------------------------------ collectives


def collectives_job(rank, world, group):
    """The differentiable sums and the gathers of ``parallel/mesh.py`` and
    the halo exchange's backward, on values that name their rank."""
    from rubiksnet_torch.parallel import (
        all_reduce_sum, gather_rows, halo_exchange_time,
    )

    out = {}
    for replicated_use in (False, True):
        x = torch.full((3,), float(rank + 1), dtype=torch.float64,
                       requires_grad=True)
        y = all_reduce_sum(x * (rank + 1), group, replicated_use)
        (y * (rank + 10)).sum().backward()
        out[f"sum_{replicated_use}"] = (y.detach(), x.grad)
    out["gather"] = gather_rows(torch.full((2, 2), rank), group)
    x = (torch.arange(4, dtype=torch.float64) + 4 * rank).reshape(
        1, 4, 1, 1, 1).requires_grad_()
    h = halo_exchange_time(x, 1, group)
    (h * torch.arange(1.0, 7.0, dtype=torch.float64).reshape(
        1, 6, 1, 1, 1)).sum().backward()
    out["halo"] = (h.detach().flatten(), x.grad.flatten())
    return out


def test_collectives_on_two_ranks(tmp_path):
    """Rank r holds r + 1. The summing backward gathers every rank's
    cotangent ((10 + 11) * (r + 1)); the replicated one keeps its own
    ((10 + r) * (r + 1)). Rows gather in rank order. A halo frame's
    gradient returns to its owner: rank 0's last frame gets rank 1's left
    halo weight (1) on top of its own (5), rank 1's first frame rank 0's
    right halo weight (6) on top of its own (2)."""
    ranks = run_ranks(collectives_job, 2, tmp_path)
    for r, res in enumerate(ranks):
        y, g = res["sum_False"]
        assert torch.equal(y, torch.full((3,), 5.0, dtype=torch.float64))
        assert torch.equal(g, torch.full((3,), 21.0 * (r + 1),
                                         dtype=torch.float64))
        y, g = res["sum_True"]
        assert torch.equal(g, torch.full((3,), (10.0 + r) * (r + 1),
                                         dtype=torch.float64))
        assert res["gather"].tolist() == [[0, 0], [0, 0], [1, 1], [1, 1]]
    h0, g0 = ranks[0]["halo"]
    h1, g1 = ranks[1]["halo"]
    assert h0.tolist() == [0, 0, 1, 2, 3, 4] and h1.tolist() == [
        3, 4, 5, 6, 7, 0]
    assert g0.tolist() == [2, 3, 4, 5 + 1] and g1.tolist() == [2 + 6, 3, 4, 5]
