"""Port's train step (rubiksnet_torch.train) vs rubiksnet_tpu.train's on
the tiny tier, on tiny with the rubiks3d-aq variant (attention shift, 2D
shift and its gradient rule) and on the SE tier (small): 4 frames, 32 px,
batch 2, shift max 1, float32 parameters, SGD lr 0.05 with the shift
multiplier 0.1, from the same weights and BN statistics, two steps on the
same clips.

Both sides compute in float64 (parameters, gradients and updates stay
float32, as in both packages). In float32 the comparison is chaotic rather
than loose: a pre-activation within ~1e-5 of a ReLU kink flips its mask
between the two summation orders (seen at clip seed 100, layer4.2.bn1), and
the per-channel normalization of the shift gradient divides the rounding
error of channels whose raw gradient nearly cancels by their small norm.
Float64 computation leaves only the float32 parameter roundings:
rtol/atol 1e-5. The JAX step is compiled once for the module."""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rubiksnet_torch.models import create_rubiksnet, state_dict_from_jax
from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult
from rubiksnet_tpu.train import create_train_state
from rubiksnet_tpu.train import make_train_step as jax_train_step
from rubiksnet_tpu.train import sgd_with_shift_mult as jax_sgd
from test_torch_model import tiny_bundle

torch.set_num_threads(1)

TOL = 1e-5
LR, SHIFT_MULT, WEIGHT_DECAY = 0.05, 0.1, 1e-4


def _clips(step):
    rng = np.random.default_rng(100 + step)
    video = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    return video, np.array([step % 11, 7], np.int32)


def _momentum(opt_state):
    """The SGD momentum (trace) of every parameter, merged from the three
    groups of the JAX optimizer state into one params-shaped tree."""
    traces = [n.trace for n in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: isinstance(n, optax.TraceState))
        if isinstance(n, optax.TraceState)]

    def merge(trees):
        out = {}
        for tree in trees:
            for k, v in tree.items():
                if isinstance(v, Mapping):
                    out.setdefault(k, []).append(v)
                elif not isinstance(v, optax.MaskedNode):
                    out[k] = v
        return {k: merge(v) if isinstance(v, list) else v
                for k, v in out.items()}

    return merge(traces)


def _two_steps(tier, variant):
    """Two steps of each side from the same state."""
    bundle = tiny_bundle(seed=0, dtype=jnp.float64, tier=tier,
                         variant=variant)
    tx = jax_sgd(LR, SHIFT_MULT)
    state = create_train_state(bundle, tx)
    jstep = jax.jit(jax_train_step(bundle.model, tx))
    p0 = state.params
    jax_losses, jax_states = [], []
    for i in range(2):
        video, labels = _clips(i)
        state, metrics = jstep(state, jnp.asarray(video),
                               jnp.asarray(labels))
        jax_losses.append(float(metrics["loss"]))
        jax_states.append(state)

    model = create_rubiksnet(tier, 11, 4, variant, max_shift=1,
                             dtype=torch.float64, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        bundle.variables["params"], bundle.variables["batch_stats"]))
    opt = sgd_with_shift_mult(model, LR, SHIFT_MULT)
    step = make_train_step(model, opt)
    losses, grads = [], None
    for i in range(2):
        video, labels = _clips(i)
        metrics = step(torch.from_numpy(video), torch.from_numpy(labels))
        losses.append(float(metrics["loss"]))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return dict(p0=p0, jax_losses=jax_losses, jax_states=jax_states,
                model=model, opt=opt, step=step, losses=losses, grads=grads)


@pytest.fixture(scope="module")
def runs():
    return _two_steps("tiny", "rubiks3d")


@pytest.fixture(scope="module", params=[("tiny", "rubiks3d-aq"),
                                        ("small", "rubiks3d")],
                ids=["aq", "se"])
def option_runs(request):
    return _two_steps(*request.param)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL, err_msg=what)


def test_losses_match(runs):
    np.testing.assert_allclose(runs["losses"], runs["jax_losses"], rtol=TOL,
                               atol=TOL)
    assert runs["step"].step == 2


def test_step1_gradients_match(runs):
    """JAX's step-1 momentum is its gradient, plus the weight decay on the
    weight group: g = trace - 1e-4 * p0 there."""
    trace = state_dict_from_jax(_momentum(runs["jax_states"][0].opt_state))
    p0 = state_dict_from_jax(runs["p0"])
    groups = {id(p): g["name"] for g in runs["opt"].param_groups
              for p in g["params"]}
    params = dict(runs["model"].named_parameters())
    assert set(trace) == set(runs["grads"])
    for name, got in runs["grads"].items():
        want = trace[name]
        if groups[id(params[name])] == "weight":
            want = want - WEIGHT_DECAY * p0[name]
        _close(got, want, name)


def test_state_after_two_steps_matches(runs):
    """Parameters, BN running statistics and SGD momentum after step 2."""
    jstate = runs["jax_states"][1]
    want = state_dict_from_jax(jstate.params, jstate.batch_stats)
    got = runs["model"].state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            assert int(got[name]) == 2, name
            continue
        _close(got[name], value, name)
    trace = state_dict_from_jax(_momentum(jstate.opt_state))
    opt = runs["opt"]
    for name, p in runs["model"].named_parameters():
        _close(opt.state[p]["momentum_buffer"], trace[name], name)


def test_aq_and_se_losses_match(option_runs):
    test_losses_match(option_runs)


def test_aq_and_se_step1_gradients_match(option_runs):
    """Also holds the 2D shift's gradient rule, the attention weights'
    gradient and the SE weights' against JAX autodiff of the same ops."""
    test_step1_gradients_match(option_runs)
    names = set(option_runs["grads"])
    assert any(n.endswith(("as3.shift", "se.fc.0.weight")) for n in names)


def test_aq_and_se_state_after_two_steps_matches(option_runs):
    test_state_after_two_steps_matches(option_runs)
