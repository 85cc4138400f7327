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


def gathered(model, group, tensors):
    """``tensors`` {parameter name: tensor of the parameter's shape} with
    each sharded weight's gathered over the model ``group`` (as it is
    without one)."""
    from rubiksnet_torch.parallel import gather_shard, sharded_modules

    shards = {f"{n}.weight": m.shard for n, m in sharded_modules(model)}
    return {n: gather_shard(t, shards[n], group) if n in shards else t
            for n, t in tensors.items()}


def train_steps(model, optimizer, clips, group=None, model_group=None):
    """``make_train_step`` over ``clips`` [(video, labels) numpy, global
    batches], on this rank's rows of each where ``group`` is given, the
    model sharded over ``model_group`` where given; -> (losses, step-1
    gradients, final state dict, momentum by name), whole (gathered)."""
    from rubiksnet_torch.parallel import gather_params, shard_batch
    from rubiksnet_torch.train import make_train_step

    step = make_train_step(model, optimizer, data_group=group,
                           model_group=model_group)
    losses, grads = [], None
    for video, labels in clips:
        batch = (torch.from_numpy(video), torch.from_numpy(labels).long())
        if group is not None:
            batch = shard_batch(batch, group)
        losses.append(float(step(*batch)["loss"]))
        if grads is None:
            grads = gathered(model, model_group, {
                n: p.grad.clone() for n, p in model.named_parameters()})
    momentum = gathered(model, model_group, {
        n: optimizer.state[p]["momentum_buffer"].clone()
        for n, p in model.named_parameters()})
    return (losses, grads, gather_params(model, model_group), momentum)


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


# ------------------------------------------------------------ tensor parallel


def tp_model(case, variant, classes=None, tier="tiny", seed=0):
    """The float64 model every rank of a tensor-parallel job builds alike
    (tests/test_torch_tensor_parallel.py builds the same one in one
    process)."""
    from rubiksnet_torch.models import create_rubiksnet

    return as_float64(create_rubiksnet(
        tier, classes or case["classes"], case["frames"], variant,
        max_shift=1, device="cpu",
        generator=torch.Generator().manual_seed(seed)))


def tp_steps(case, mesh, variant, min_size, classes=None, tier="tiny"):
    """Two float64 steps of ``tp_model`` sharded over ``mesh.model`` at
    ``min_size``, rows over ``mesh.data``; -> train_steps' result, the
    model group's collectives counted over both steps, and the last
    step's gradients of the replicated parameters as this rank holds
    them."""
    from rubiksnet_torch.parallel import (
        collective_counters, group_size, param_partition_spec, shard_params,
    )
    from rubiksnet_torch.train import sgd_with_shift_mult

    model = tp_model(case, variant, classes, tier)
    spec = param_partition_spec(model, group_size(mesh.model), min_size)
    shard_params(model, mesh.model, spec)
    counters = collective_counters()
    for c in counters.values():
        c.reset()
    result = train_steps(model, sgd_with_shift_mult(model, 0.05, 0.1),
                         case["clips"], mesh.data, mesh.model)
    counts = {k: c.count for k, c in counters.items()}
    replicated_grads = {n: p.grad.clone() for n, p in model.named_parameters()
                        if spec[n] is None}
    return result, counts, replicated_grads


def mesh_ranks(group):
    import torch.distributed as dist

    return dist.get_process_group_ranks(group)


def tensor_job(rank, world, group, case):
    """The tensor-parallel checks of tests/test_torch_tensor_parallel.py
    on one rank of ``world`` (2: a 1 x 2 mesh; 4: 2 x 2 and 1 x 4)."""
    from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
    from rubiksnet_torch.parallel import (
        create_mesh, gather_params, model_parallel, shard_batch,
        shard_params, time_parallel,
    )
    from rubiksnet_torch.train import (
        make_eval_step, make_train_step, sgd_with_shift_mult,
    )

    out = {}
    if world == 2:
        mesh = create_mesh(1, 2)
        out["groups"] = (mesh.data, mesh_ranks(mesh.model))
        model = tp_model(case, "rubiks3d")
        full = {k: v.clone() for k, v in model.state_dict().items()}
        shard_params(model, mesh.model)
        out["shard_rows"] = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
        out["round_trip"] = (full, gather_params(model, mesh.model))
        for variant, min_size, tier in case["steps_1x2"]:
            out[f"1x2 {variant} {min_size} {tier}"] = tp_steps(
                case, mesh, variant, min_size, tier=tier)
        model = create_rubiksnet("tiny", case["even_classes"],
                                 case["frames"], max_shift=1, device="cpu")
        model.load_state_dict(case["eval_state"])
        shard_params(model, mesh.model, case["eval_spec"])
        video = torch.from_numpy(case["eval_video"])
        labels = torch.from_numpy(case["eval_labels"])
        out["eval_logits"] = make_eval_step(
            model, model_group=mesh.model)(video, labels)["logits"]
        refusals = {}
        for what, fn in (
                ("time_in_model", lambda: _enter(
                    model_parallel(mesh.model), time_parallel(group, 1))),
                ("model_in_time", lambda: _enter(
                    time_parallel(group, 1), model_parallel(mesh.model))),
                ("step_with_both", lambda: make_train_step(
                    model, sgd_with_shift_mult(model, 0.1),
                    time_group=group, model_group=mesh.model)),
                ("executor_sharded", lambda: FusedExecutor(model)),
                ("executor_under_model", lambda: _under(
                    model_parallel(mesh.model), FusedExecutor(
                        unsharded(case)), video[:, 0])),
                ("sharded_outside", lambda: model(video[:, 0]))):
            try:
                fn()
                refusals[what] = None
            except (ValueError, RuntimeError) as e:
                refusals[what] = str(e)
        out["refusals"] = refusals
        out["script"] = train_script_float64(case["train_argv"])
        out["script_resumed"] = train_script_float64(case["resume_argv"])
    else:
        mesh = create_mesh(2, 2)
        out["groups"] = (mesh_ranks(mesh.data), mesh_ranks(mesh.model))
        for variant in ("rubiks3d", "rubiks3d-aq"):
            out[f"2x2 {variant}"] = tp_steps(case, mesh, variant, 1 << 12)
        model = as_float64(create_rubiksnet(
            "tiny", case["even_classes"], case["frames"], max_shift=1,
            device="cpu"))
        model.load_state_dict(case["jax_state"])
        shard_params(model, mesh.model, case["jax_spec"])
        out["2x2 vs jax"] = train_steps(
            model, sgd_with_shift_mult(model, *case["parity_sgd"]),
            case["parity_clips"], mesh.data, mesh.model)
        wide = create_mesh(1, 4)
        out["wide_groups"] = (wide.data, mesh_ranks(wide.model))
        out["1x4 174"] = tp_steps(case, wide, "rubiks3d", 1 << 16,
                                  classes=174)
    return out


def _enter(*contexts):
    import contextlib

    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)


def _under(context, fn, *args):
    with context:
        return fn(*args)


def unsharded(case):
    from rubiksnet_torch.models import create_rubiksnet

    return create_rubiksnet("tiny", case["classes"], case["frames"],
                            max_shift=1, device="cpu")


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
