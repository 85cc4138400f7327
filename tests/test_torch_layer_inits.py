"""The port's shift-init helpers (``rubiksnet_torch.nn``) against the JAX
package's (``rubiksnet_tpu.nn``), mirroring tests/test_layer_inits.py.

``init_shift1d_nfold`` and ``create_3d_from_2d`` (the reference's
rubiks3d/layer.py:25-40 and :110-154) and ``group_shift_init`` (its
rubiks2d/layer.py:6-15). The deterministic parts equal JAX exactly: the
+-1 folds, the ``tsm`` and ``none`` rows, the 2D rows carried over, the
grid of ``group_shift_init``, and the refusals (AssertionError for a shift
that is not one row, NotImplementedError for an unknown mode). The random
parts draw from a ``torch.Generator`` where JAX draws from a PRNG key, so
they are held to their folds and ranges, and to one seed giving one
result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.nn import (
    create_3d_from_2d,
    group_shift_init,
    init_shift1d_nfold,
)
from rubiksnet_tpu.nn import create_3d_from_2d as jax_create_3d_from_2d
from rubiksnet_tpu.nn import group_shift_init as jax_group_shift_init
from rubiksnet_tpu.nn import init_shift1d_nfold as jax_init_shift1d_nfold

torch.set_num_threads(1)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_init_shift1d_nfold_folds():
    c, nfold, noise = 32, 8, 1e-3
    out = init_shift1d_nfold(torch.zeros((1, c)), nfold, noise,
                             generator=gen())
    want = np.asarray(jax_init_shift1d_nfold(jnp.zeros((1, c)), nfold,
                                             noise))
    g = c // nfold
    assert out.shape == (1, c) and out.dtype == torch.float32
    np.testing.assert_array_equal(out[0, :2 * g].numpy(), want[0, :2 * g])
    tail = out[0, 2 * g:].numpy()
    assert np.all(np.abs(tail) <= noise)
    assert np.any(tail != 0)  # jittered, not zeroed
    assert torch.equal(out, init_shift1d_nfold(torch.zeros((1, c)), nfold,
                                               noise, generator=gen()))
    assert not torch.equal(out, init_shift1d_nfold(
        torch.zeros((1, c)), nfold, noise, generator=gen(1)))


def test_init_shift1d_nfold_rejects_2d():
    with pytest.raises(AssertionError):
        jax_init_shift1d_nfold(jnp.zeros((2, 16)))
    with pytest.raises(AssertionError, match="rubiks1d"):
        init_shift1d_nfold(torch.zeros((2, 16)))


@pytest.fixture
def shift2d():
    rs = np.random.RandomState(0)
    return rs.uniform(-1, 1, (2, 16)).astype(np.float32)


@pytest.mark.parametrize("mode", ["tsm", "none"])
def test_create_3d_from_2d_deterministic_modes_equal_jax(shift2d, mode):
    """tsm (folds of +1, -1, then 0) and none (a NaN row a checkpoint must
    overwrite) equal JAX's exactly; the 2D rows are carried over."""
    out = create_3d_from_2d(torch.from_numpy(shift2d), mode)
    want = np.asarray(jax_create_3d_from_2d(jnp.asarray(shift2d), mode))
    assert out.shape == (3, 16) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out[1:].numpy(), shift2d)


def test_create_3d_from_2d_tsm_gauss(shift2d):
    out = create_3d_from_2d(torch.from_numpy(shift2d), "tsm-g0.01",
                            generator=gen())
    t = out[0].numpy()
    fold = shift2d.shape[1] // 8
    # folds jittered around +-1 with stddev 0.01
    assert np.all(np.abs(t[:fold] - 1.0) < 0.1)
    assert np.all(np.abs(t[fold:2 * fold] + 1.0) < 0.1)
    assert np.all(np.abs(t[2 * fold:]) < 0.1) and np.std(t[2 * fold:]) > 0
    np.testing.assert_array_equal(out[1:].numpy(), shift2d)
    assert torch.equal(out, create_3d_from_2d(torch.from_numpy(shift2d),
                                              "tsm-g0.01", generator=gen()))


def test_create_3d_from_2d_uniform(shift2d):
    out = create_3d_from_2d(torch.from_numpy(shift2d), "uni0.5",
                            generator=gen())
    assert np.all(np.abs(out[0].numpy()) <= 0.5)
    assert np.std(out[0].numpy()) > 0
    np.testing.assert_array_equal(out[1:].numpy(), shift2d)
    assert torch.equal(out, create_3d_from_2d(torch.from_numpy(shift2d),
                                              "uni0.5", generator=gen()))
    with pytest.raises(AssertionError):
        jax_create_3d_from_2d(jnp.asarray(shift2d), "uni0")
    with pytest.raises(AssertionError):
        create_3d_from_2d(torch.from_numpy(shift2d), "uni0")


def test_create_3d_from_2d_unknown_mode(shift2d):
    with pytest.raises(NotImplementedError, match="bogus"):
        jax_create_3d_from_2d(jnp.asarray(shift2d), "bogus")
    with pytest.raises(NotImplementedError, match="bogus"):
        create_3d_from_2d(torch.from_numpy(shift2d), "bogus")


@pytest.mark.parametrize("k,c", [(3, 18), (3, 20), (5, 54)])
def test_group_shift_init_equals_jax(k, c):
    """The conv-like grid of a (2, C) shift, exported from the package as in
    JAX; the channels past the last whole group of k*k stay zero."""
    out = group_shift_init(torch.full((2, c), 7.0), k)
    want = np.asarray(jax_group_shift_init(k)(jax.random.PRNGKey(0),
                                              (2, c), jnp.float32))
    np.testing.assert_array_equal(out.numpy(), want)
