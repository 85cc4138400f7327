"""The port's sequence parallelism (``rubiksnet_torch.parallel.temporal``)
on 4 gloo ranks on the CPU, against the JAX package on 4 of its 8 virtual
CPU devices and against the port's own unsharded ops.

One module-scoped fixture spawns the ranks once and runs every check there
(tests/test_torch_parallel_ranks.py::temporal_job); the tests read its results.
Shapes as tests/test_temporal_parallel.py: N, T, H, W, C = 2, 8, 6, 6, 8,
T split 4 ways (2 frames a shard), max_shift 1 (a halo of 2 frames); the
quantized shift's halo is 3 frames, so its clip has T = 12.

* Forward against JAX's shard_map ops (``halo_exchange_time``, the
  temporal shift at strides 1 and 2, ``temporal_attention_shift``) and
  ``sequence_parallel_eval``'s logits for both variants against JAX's, at
  rtol 1e-4, atol 1e-5 (tests/test_temporal_parallel.py:157-159). The
  fractional shifts lie in (-1, 1), inside the contract where JAX's
  one-frame halo is right.
* Gradients in float64 against the port's unsharded ``rubiks_shift_3d``
  within 1e-10, normalized and raw (the raw gradient would show a sum
  taken twice, which the normalization hides), fractional and quantized
  with T shifts in (K + 0.5, K + 1] (JAX's sharded op reads zeros there;
  the port follows the unsharded op). Never against JAX's sharded
  gradient (ROADMAP C, reference-side).
* A tiny float64 train step with T sharded against the unsharded step,
  1e-10: the consensus's backward must not multiply the gradient by the
  number of shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from rubiksnet_torch.models import create_rubiksnet, state_dict_from_jax
from rubiksnet_torch.ops.attention_shift import attention_shift
from rubiksnet_torch.ops.shift3d import rubiks_shift_3d
from rubiksnet_torch.parallel import halo_width
from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult
from rubiksnet_tpu.models import create_rubiksnet as jax_create
from rubiksnet_tpu.parallel import temporal as jax_temporal
from test_torch_parallel_ranks import (
    as_float64,
    grads_and_state,
    loss_weights,
    run_ranks,
    temporal_job,
)

torch.set_num_threads(1)

N, T, H, W, C = 2, 8, 6, 6, 8
K, SHARDS, CLASSES, SIZE = 1, 4, 7, 32
T_QUANTIZE = 12
TOL_FWD = dict(rtol=1e-4, atol=1e-5)
TOL_GRAD = 1e-10


def quantize_shift(rng):
    """T shifts in (K + 0.5, K + 1] and [-K - 1, -K - 0.5) (which round to
    +-(K + 1)), K + 1 itself among them, beside ordinary ones; H and W in
    (-1, 1)."""
    s = rng.uniform(-1, 1, (3, C))
    s[0, :3] = rng.uniform(K + 0.51, K + 1.0, 3)
    s[0, 3:6] = -rng.uniform(K + 0.51, K + 1.0, 3)
    s[0, 2], s[0, 5] = K + 1, -K - 1
    return s.astype(np.float32)


def eval_bundles():
    out = {}
    for i, variant in enumerate(("rubiks3d", "rubiks3d-aq")):
        out[variant] = jax_create(
            "tiny", num_classes=CLASSES, num_frames=T, input_size=SIZE,
            variant=variant, shift_backend="gather", shift_max_shift=K,
            rng=jax.random.PRNGKey(7 + i))
    return out


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    bundles = eval_bundles()
    return dict(
        max_shift=K, classes=CLASSES,
        x=rng.randn(N, T, H, W, C).astype(np.float32),
        x_quantize=rng.randn(N, T_QUANTIZE, H, W, C).astype(np.float32),
        shift=rng.uniform(-1, 1, (3, C)).astype(np.float32),
        shift_quantize=quantize_shift(rng),
        attention_weight=rng.randn(C, 3).astype(np.float32),
        video=rng.randn(2, T, SIZE, SIZE, 3).astype(np.float32),
        labels=np.array([1, 4]),
        bundles=bundles,
        eval_states={v: state_dict_from_jax(b.variables["params"],
                                            b.variables["batch_stats"])
                     for v, b in bundles.items()})


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    job = {k: v for k, v in case.items() if k != "bundles"}
    return run_ranks(temporal_job, SHARDS, tmp_path_factory.mktemp("time"),
                     job)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:SHARDS]), ("time",))


def gathered(ranks, key, part=None):
    """The ranks' (N, T_loc, ...) results (entry ``part`` of each) in frame
    order."""
    return torch.cat([r[key] if part is None else r[key][part]
                      for r in ranks], dim=1).numpy()


def jax_sharded(mesh, fn, *args, replicated=()):
    """``fn`` under a shard_map over the time axis: every argument sharded
    on axis 1 unless its index is in ``replicated``."""
    specs = tuple(P() if i in replicated else P(None, "time")
                  for i in range(len(args)))
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=specs,
                          out_specs=P(None, "time")))
    return np.asarray(f(*(jnp.asarray(a) for a in args)))


def test_halo_width_reaches_the_unsharded_contract():
    assert halo_width(1) == 2 and halo_width(4) == 5
    assert halo_width(1, quantize=True) == 3


def test_halo_exchange_matches_jax(case, ranks, mesh):
    """Zeros at both ends, each shard's own frames inside, its neighbours'
    boundary frames in its halos: JAX's exchange, frame for frame."""
    want = jax_sharded(
        mesh, lambda v: jax_temporal.halo_exchange_time(v, K, "time"),
        case["x"])
    got = gathered(ranks, "halo")
    np.testing.assert_array_equal(got, want)
    ext = got.reshape(N, SHARDS, T // SHARDS + 2 * K, H, W, C)
    assert not ext[:, 0, :K].any() and not ext[:, -1, -K:].any()
    xs = case["x"].reshape(N, SHARDS, T // SHARDS, H, W, C)
    np.testing.assert_array_equal(ext[:, 1, :K], xs[:, 0, -K:])
    np.testing.assert_array_equal(ext[:, 2, -K:], xs[:, 3, :K])


@pytest.mark.parametrize("stride", [1, 2])
def test_forward_matches_jax(case, ranks, mesh, stride):
    want = jax_sharded(
        mesh, lambda v, s: jax_temporal.temporal_rubiks_shift_3d(
            v, s, axis_name="time", stride=stride, max_shift=K,
            backend="gather"),
        case["x"], case["shift"], replicated=(1,))
    np.testing.assert_allclose(gathered(ranks, f"forward{stride}"), want,
                               **TOL_FWD)


def test_attention_shift_matches_jax(case, ranks, mesh):
    want = jax_sharded(
        mesh, lambda v, w: jax_temporal.temporal_attention_shift(
            v, w, axis_name="time"),
        case["x"], case["attention_weight"], replicated=(1,))
    np.testing.assert_allclose(gathered(ranks, "attention"), want,
                               **TOL_FWD)
    plain = attention_shift(torch.from_numpy(case["x"]),
                            torch.from_numpy(case["attention_weight"]))
    np.testing.assert_allclose(gathered(ranks, "attention"), plain.numpy(),
                               **TOL_FWD)


def unsharded_grads(case, kind, normalize):
    q = "_quantize" if kind == "quantize" else ""
    x = torch.from_numpy(case["x" + q]).double().requires_grad_()
    s = torch.from_numpy(case["shift" + q]).double().requires_grad_()
    y = rubiks_shift_3d(x, s, normalize_grad=normalize,
                        quantize=kind == "quantize")
    (y * loss_weights(y.shape)).sum().backward()
    return y.detach(), x.grad, s.grad


@pytest.mark.parametrize("normalize", [True, False],
                         ids=["normalized", "raw"])
@pytest.mark.parametrize("kind", ["fractional", "quantize"])
def test_gradients_match_unsharded(case, ranks, kind, normalize):
    """Forward, input gradient and shift gradient in float64 against the
    port's unsharded op; the shift gradient is the same on every rank."""
    y, gx, gs = unsharded_grads(case, kind, normalize)
    key = f"grads_{kind}_{normalize}"
    np.testing.assert_allclose(gathered(ranks, key, 0), y.numpy(),
                               rtol=0, atol=TOL_GRAD)
    np.testing.assert_allclose(gathered(ranks, key, 1), gx.numpy(), rtol=0,
                               atol=TOL_GRAD)
    for r in ranks:
        np.testing.assert_allclose(r[key][2].numpy(), gs.numpy(), rtol=0,
                                   atol=TOL_GRAD)
    if normalize:
        np.testing.assert_allclose(gs.norm(dim=0).numpy(), 1.0, atol=1e-12)


def test_quantize_reaches_the_next_tap(case, ranks):
    """The quantized T shifts in (K + 0.5, K + 1] round onto the tap K + 1
    away: the sharded output equals the unsharded op's there, and differs
    from what a one-frame halo (zeros in that tap) would give."""
    y, _, _ = unsharded_grads(case, "quantize", True)
    got = gathered(ranks, "grads_quantize_True", 0)
    np.testing.assert_array_equal(got, y.numpy())
    s = torch.from_numpy(case["shift_quantize"]).double()
    assert (s[0].abs() > K + 0.5).sum() >= 6


def test_halo_too_large_raises(ranks):
    for r in ranks:
        assert r["too_large"] and "cannot source a halo" in r["too_large"]


def test_fused_executor_refuses_a_time_group(ranks):
    for r in ranks:
        assert r["fused_under_time"] and "time-sharded" in (
            r["fused_under_time"])


@pytest.mark.parametrize("variant", ["rubiks3d", "rubiks3d-aq"])
def test_sequence_parallel_eval_matches_jax(case, ranks, mesh, variant):
    """Logits of the clip sharded 4 ways over T: replicated on every rank,
    equal to JAX's sequence_parallel_eval and to the port's unsharded
    forward."""
    bundle = case["bundles"][variant]
    video = jnp.asarray(case["video"])
    fn = jax_temporal.sequence_parallel_eval(bundle.model, bundle.variables,
                                             mesh)
    want = np.asarray(fn(jax_temporal.time_shard_clip(video, mesh)))
    model = create_rubiksnet("tiny", CLASSES, T, variant, max_shift=K,
                             device="cpu")
    model.load_state_dict(case["eval_states"][variant])
    with torch.no_grad():
        unsharded = model(torch.from_numpy(case["video"])).numpy()
    for r in ranks:
        got = r[f"eval_{variant}"].numpy()
        np.testing.assert_allclose(got, want, **TOL_FWD)
        np.testing.assert_allclose(got, unsharded, **TOL_FWD)


def test_time_sharded_train_step_matches_unsharded(case, ranks):
    """One float64 SGD step with T sharded 4 ways (every rank starts from
    rank 0's weights) against the unsharded step: loss, every gradient
    (the 1x1 convs, BN and new_fc summed over the shards; the shifts'
    normalized over the whole clip) and the state after the step (BN
    running statistics over the whole clip). A consensus whose backward
    summed the replicated cotangent would scale every gradient by 4."""
    model = as_float64(create_rubiksnet(
        "tiny", CLASSES, T, max_shift=K, device="cpu",
        generator=torch.Generator().manual_seed(0)))
    step = make_train_step(model, sgd_with_shift_mult(model, 0.05, 0.1))
    loss = float(step(torch.from_numpy(case["video"]),
                      torch.from_numpy(case["labels"]))["loss"])
    grads, state = grads_and_state(model)
    for r in ranks:
        got_loss, got_grads, got_state = r["train"]
        assert abs(got_loss - loss) <= TOL_GRAD * abs(loss)
        assert got_grads.keys() == grads.keys()
        for name, g in grads.items():
            np.testing.assert_allclose(got_grads[name].numpy(), g.numpy(),
                                       rtol=TOL_GRAD, atol=TOL_GRAD,
                                       err_msg=name)
        for name, v in state.items():
            np.testing.assert_allclose(got_state[name].numpy(), v.numpy(),
                                       rtol=TOL_GRAD, atol=TOL_GRAD,
                                       err_msg=name)
