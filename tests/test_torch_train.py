"""The port's train API (rubiksnet_torch.train) on the CPU: optimizer
groups, the SGD update against optax's, steps, bit-identical resume through
checkpoints, the eval step, and a synthetic overfit on the plain path.

Tolerances: the SGD update against optax at 1e-6 (float32, the same
arithmetic in another order); resume is bit-identical (torch.equal); the
eval step's logits equal the model's crop mean at 1e-6."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
from rubiksnet_torch.nn import BN
from rubiksnet_torch.nn.layers import RubiksShift3D
from rubiksnet_torch.train import (
    load_train_state,
    make_eval_step,
    make_train_step,
    param_groups,
    save_train_state,
    sgd_with_shift_mult,
)
from rubiksnet_torch.train import checkpoint
from rubiksnet_tpu.train import sgd_with_shift_mult as jax_sgd
from rubiksnet_tpu.train.optim import param_labels

torch.set_num_threads(1)


def _tiny(seed=0, classes=4, frames=4):
    return create_rubiksnet("tiny", classes, frames, max_shift=1, device="cpu",
                            generator=torch.Generator().manual_seed(seed))


def _clips(seed, n=2, frames=4, size=16, classes=4):
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((n, frames, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, classes, n)
    return torch.from_numpy(video), torch.from_numpy(labels)


def test_param_groups():
    """Every parameter in exactly one group, routed by module: BN weights
    and biases and the fc bias in ``bias``, shifts at lr * 0.1, weight decay
    on ``weight`` only."""
    model = _tiny()
    opt = sgd_with_shift_mult(model, 0.05, 0.1)
    by_id = {}
    for g in opt.param_groups:
        for p in g["params"]:
            assert id(p) not in by_id
            by_id[id(p)] = g
    assert set(by_id) == {id(p) for p in model.parameters()}
    assert [g["name"] for g in opt.param_groups] == ["weight", "bias",
                                                     "shift"]
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            g = by_id[id(p)]
            if isinstance(mod, RubiksShift3D):
                want = "shift"
            elif isinstance(mod, BN) or name == "bias":
                want = "bias"
            else:
                want = "weight"
            assert g["name"] == want, (type(mod).__name__, name)
    lr = {g["name"]: g["lr"] for g in opt.param_groups}
    decay = {g["name"]: g["weight_decay"] for g in opt.param_groups}
    assert lr == pytest.approx({"weight": 0.05, "bias": 0.05,
                                "shift": 0.005})
    assert decay == {"weight": 1e-4, "bias": 0.0, "shift": 0.0}
    assert all(g["momentum"] == 0.9 for g in opt.param_groups)
    groups = param_groups(model)
    assert sum(len(v) for v in groups.values()) == len(list(
        model.parameters()))
    with pytest.raises(TypeError, match="no optimizer group"):
        param_groups(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("tier,variant", [("tiny", "rubiks3d-aq"),
                                          ("small", "rubiks3d"),
                                          ("small", "rubiks3d-aq")])
def test_param_groups_of_aq_and_se_match_jax_labels(tier, variant):
    """The 2D shift goes to ``shift``; the attention weights and the SE
    dense weights to ``weight`` (decayed): the groups rubiksnet_tpu's
    param_labels gives the same parameters by leaf name."""
    model = create_rubiksnet(tier, 4, 4, variant, max_shift=1, device="cpu")
    group_of = {id(p): name for name, ps in param_groups(model).items()
                for p in ps}
    assert set(group_of) == {id(p) for p in model.parameters()}
    paths = _jax_tree(model)
    labels = param_labels(_nest(paths, lambda p: 0.0))
    for path, p in paths.items():
        assert group_of[id(p)] == _get(labels, path), path
    by_name = {n: group_of[id(p)] for n, p in model.named_parameters()}
    if variant == "rubiks3d-aq":
        assert by_name["backbone.layer2.1.as3.shift"] == "shift"
        assert by_name["backbone.layer2.1.conv2.0.weight"] == "weight"
        assert by_name["backbone.layer2.1.conv2.1.weight"] == "weight"
    if tier == "small":
        assert by_name["backbone.layer2.1.se.fc.0.weight"] == "weight"
        assert by_name["backbone.layer2.1.se.fc.2.weight"] == "weight"
    opt = sgd_with_shift_mult(model, 0.05, 0.1)
    step = make_train_step(model, opt)
    metrics = step(*_clips(3))
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.grad is not None for p in model.parameters())


def _jax_tree(model):
    """{path in the JAX package's naming: nested keys, BN weight as
    ``scale``} -> parameter, so rubiksnet_tpu's optimizer labels it."""
    paths = {}
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            leaf = "scale" if isinstance(mod, BN) and name == "weight" else (
                name)
            paths[tuple(mod_name.split(".")) + (leaf,)] = p
    return paths


def _nest(paths, value):
    tree = {}
    for path, p in paths.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value(p)
    return tree


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_sgd_update_matches_optax():
    """torch.optim.SGD with momentum and weight decay equals the JAX
    package's sgd_with_shift_mult (optax.add_decayed_weights ->
    optax.sgd(momentum) per group), over three steps of random gradients."""
    model = _tiny()
    opt = sgd_with_shift_mult(model, 0.05, 0.1)
    paths = _jax_tree(model)
    tree = _nest(paths, lambda p: jnp.array(p.detach().numpy(), copy=True))
    tx = jax_sgd(0.05, 0.1)
    state = tx.init(tree)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = {path: rng.standard_normal(tuple(p.shape)).astype(np.float32)
                 for path, p in paths.items()}
        for path, p in paths.items():
            p.grad = torch.from_numpy(grads[path])
        opt.step()
        g_tree = _nest(paths, lambda p: None)
        for path in paths:
            _get(g_tree, path[:-1])[path[-1]] = jnp.asarray(grads[path])
        updates, state = tx.update(g_tree, state, tree)
        tree = optax.apply_updates(tree, updates)
    for path, p in paths.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(_get(tree, path)), rtol=1e-6,
                                   atol=1e-6, err_msg=".".join(path))


def test_train_step_and_schedule():
    """A step returns float32 loss and accuracy, counts itself, updates the
    parameters and BN running statistics; a schedule scales every group."""
    model = _tiny()
    opt, sched = sgd_with_shift_mult(model, lambda s: 1.0 / (1 + s), 0.1)
    step = make_train_step(model, opt, sched)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    video, labels = _clips(1)
    metrics = step(video, labels)
    assert set(metrics) == {"loss", "accuracy"} and step.step == 1
    assert metrics["loss"].dtype == torch.float32
    assert bool(torch.isfinite(metrics["loss"]))
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    assert model.training
    after = model.state_dict()
    for k in before:
        if k.endswith("num_batches_tracked"):
            assert int(after[k]) == 1, k
        else:
            assert not torch.equal(before[k], after[k]), k
    lr = {g["name"]: g["lr"] for g in opt.param_groups}
    assert lr == pytest.approx({"weight": 0.5, "bias": 0.5, "shift": 0.05})


def _run(model, opt, n, first_seed, step=None):
    step = step or make_train_step(model, opt)
    losses = [step(*_clips(first_seed + i))["loss"] for i in range(n)]
    return step, losses


def test_resume_is_bit_identical(tmp_path):
    """2 steps, save, 2 steps; a fresh model and optimizer loaded from the
    checkpoint take the same 2 steps bit for bit."""
    model = _tiny()
    opt = sgd_with_shift_mult(model, 0.05)
    step, _ = _run(model, opt, 2, 10)
    path = tmp_path / "state.pt"
    save_train_state(path, model, opt, step.step, {"run": "a", "lr": 0.05})
    assert not (tmp_path / "state.pt.tmp").exists()
    _, losses = _run(model, opt, 2, 12, step)

    model2 = _tiny(seed=1)
    opt2 = sgd_with_shift_mult(model2, 0.05)
    at, meta = load_train_state(path, model2, opt2)
    assert at == 2 and meta == {"run": "a", "lr": 0.05}
    _, losses2 = _run(model2, opt2, 2, 12)
    assert all(torch.equal(a, b) for a, b in zip(losses, losses2))
    sd, sd2 = model.state_dict(), model2.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    for p, p2 in zip(model.parameters(), model2.parameters()):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           opt2.state[p2]["momentum_buffer"])


@pytest.mark.parametrize("change,match", [
    ({"format": "something-else"}, "not a train-state"),
    ({"version": checkpoint.VERSION + 1}, "newer version"),
])
def test_load_rejects_wrong_format_and_newer_version(tmp_path, change,
                                                     match):
    model = _tiny()
    opt = sgd_with_shift_mult(model, 0.05)
    path = tmp_path / "state.pt"
    save_train_state(path, model, opt, 0)
    payload = torch.load(path, weights_only=True)
    payload.update(change)
    torch.save(payload, path)
    with pytest.raises(ValueError, match=match):
        load_train_state(path, model, opt)


@pytest.mark.parametrize("fused", [False, True])
def test_eval_step(fused):
    """Crop-averaged logits of the module path (or the fused executor),
    with raw uint8 pixels normalized on the device; top-1 and top-5 hits."""
    model = _tiny(classes=7)
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 3, 4, 32, 32, 3),
                                        dtype=np.uint8))
    labels = torch.tensor([1, 6])
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    out = make_eval_step(model, num_crops=3, fused=fused,
                         normalize=(mean, std))(raw, labels)
    flat = ((raw.reshape(6, 4, 32, 32, 3).float() / 255.0
             - torch.tensor(mean)) / torch.tensor(std))
    with torch.no_grad():
        fwd = FusedExecutor(model) if fused else model
        want = fwd(flat).reshape(2, 3, -1).mean(1)
    np.testing.assert_allclose(out["logits"].numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(out["top1"], (want.argmax(-1) == labels).float())
    top5 = (want.topk(5, -1).indices == labels[:, None]).any(-1).float()
    assert torch.equal(out["top5"], top5)


def test_synthetic_overfit():
    """tests/test_overfit.py's recipe on the port's plain path: brightness
    encodes the label, one fixed batch of 8, 40 SGD steps at lr 0.05 (shift
    multiplier 0.1). The loss halves and accuracy reaches 0.75."""
    classes, batch, size, frames = 4, 8, 32, 4
    model = create_rubiksnet("tiny", classes, frames, device="cpu")
    opt = sgd_with_shift_mult(model, 0.05, 0.1)
    step = make_train_step(model, opt)
    rng = np.random.RandomState(0)
    labels = np.arange(batch) % classes
    video = (labels[:, None, None, None, None] / classes
             + 0.1 * rng.randn(batch, frames, size, size, 3))
    video = torch.from_numpy(video.astype(np.float32))
    labels = torch.from_numpy(labels)
    first = float(step(video, labels)["loss"])
    for _ in range(39):
        metrics = step(video, labels)
    last = float(metrics["loss"])
    assert np.isfinite(last)
    assert last < 0.5 * first, (first, last)
    assert float(metrics["accuracy"]) >= 0.75, metrics


def test_profile_probe_classifies_kernel_names():
    """utils/profile_step.py sorts device kernels into classes by name, the
    port's own kernels before the library's."""
    from rubiksnet_torch.utils import profile_step

    cases = {
        "void rubiks::shift3d_fwd_kernel<__nv_bfloat16>(...)": "K1 / K1-2D",
        "void rubiks::shift3d_inv_kernel<float>(...)": "K1-inverse",
        "void rubiks::se_partial_kernel<float>(...)": "SE gate",
        "void rubiks::gemm_kernel<float, rubiks::ShiftLoad<float>>": "K2 / K3",
        "sm90_xmma_gemm_bf16bf16_bf16f32": "library GEMMs",
        "void at::native::reduce_kernel<512, 1>": "reductions",
        "void at::native::vectorized_elementwise_kernel<4>": "elementwise",
        "something_else": "other",
    }
    for name, want in cases.items():
        assert profile_step.classify(name).startswith(want), name
    if not torch.cuda.is_available():  # no card: no measurement, no CPU run
        assert profile_step.main(["--tier", "tiny"]) == 1
