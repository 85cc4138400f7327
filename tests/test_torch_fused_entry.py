"""Port's fused stride-2 entry block (rubiksnet_torch.ops.fused_entry) vs the
JAX package: parameter stacking, the Pallas kernel in interpret mode, and
the unfused JAX block at stride 2. On the CPU the port runs the kernel's
plain version.

Tolerance: float32 rtol/atol 2e-4, as the JAX package's own entry tests
(tests/test_fused_entry.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.ops import fused_block as tfb
from rubiksnet_torch.ops import fused_entry as tfe
from rubiksnet_tpu.nn.backbone import RubiksShiftBlock as JaxBlock
from rubiksnet_tpu.ops.pallas import fused_block as jfb
from rubiksnet_tpu.ops.pallas import fused_entry as jfe
from test_torch_fused_block import COLD, HOT, make_block, torch_block

torch.set_num_threads(1)

TOL = 2e-4


def make_entry(seed, cin, mid, shift_scale, hot_cold=False):
    rng = np.random.default_rng(seed)
    p, s = make_block(rng, cin, mid, shift_scale, stride=2)
    if hot_cold:
        p["as3"]["rubiks3d"]["shift"] = jnp.asarray(np.stack(
            [np.resize(HOT, mid), np.resize(COLD, mid), np.resize(HOT, mid)]))
    return rng, p, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
def test_stack_entry_params_matches_jax(dtype, quantize):
    cin, mid, k = 8, 16, 1
    _, p, s = make_entry(1, cin, mid, 0.9, hot_cold=quantize)
    blk = torch_block(p, s, cin, mid, stride=2, quantize=quantize)
    got = tfe.stack_entry_params(blk, getattr(torch, dtype), k, quantize)
    want = jfe.stack_entry_params(p, s, getattr(jnp, dtype), k, quantize)
    for name, g, w in zip(("vt1", "vt2", "w2", "w3", "wsc"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("cin,mid,max_shift,quantize", [
    (128, 128, 1, False),  # shapes of test_fused_entry.py:66
    (8, 16, 2, False),
    (16, 16, 1, True),     # quantize, with the K+1 tap
])
def test_entry_matches_jax(cin, mid, max_shift, quantize):
    rng, p, s = make_entry(cin + mid, cin, mid, max_shift - 0.2,
                           hot_cold=quantize)
    x = rng.standard_normal((2, 3, 8, 10, cin)).astype(np.float32)
    blk = torch_block(p, s, cin, mid, stride=2, quantize=quantize)
    params = tfe.stack_entry_params(blk, torch.float32, max_shift, quantize)
    got = tfe.fused_entry_run(torch.from_numpy(x), params,
                              max_shift=max_shift).numpy()
    assert got.shape == (2, 3, 4, 5, mid)

    jparams = jfe.stack_entry_params(p, s, jnp.float32, max_shift, quantize)
    kernel = jfe.fused_entry_run(jnp.asarray(x), jparams,
                                 max_shift=max_shift, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=TOL, atol=TOL)

    jblock = JaxBlock(in_planes=cin, out_planes=mid, stride=2,
                      shift_backend="conv", shift_max_shift=max_shift,
                      quantize=quantize)
    unfused = jblock.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                           False)
    np.testing.assert_allclose(got, np.asarray(unfused), rtol=TOL, atol=TOL)

    with torch.no_grad():
        mod = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got, mod.numpy(), rtol=TOL, atol=TOL)


def test_entry_checks_arguments():
    _, p, s = make_entry(2, 8, 16, 0.5)
    blk = torch_block(p, s, 8, 16, stride=2)
    params = tfe.stack_entry_params(blk, torch.float32, 1)
    with pytest.raises(ValueError, match="even"):
        tfe.fused_entry_run(torch.randn(1, 2, 5, 6, 8), params, max_shift=1)
    with pytest.raises(ValueError, match="vt1 must be"):
        tfe.fused_entry_run(torch.randn(1, 2, 4, 6, 4), params, max_shift=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfe.fused_entry_kernel(torch.randn(1, 2, 4, 6, 8), params,
                               max_shift=1)
    assert tfe.LAUNCHES.count == 0


@pytest.mark.parametrize("cin,mid,max_shift,quantize", [
    (72, 144, 1, False),
    (24, 24, 2, False),
    (12, 24, 1, True),
])
def test_entry_with_se_matches_jax(cin, mid, max_shift, quantize):
    """The SE gate on the stride-2 decimated activation: the plain version
    against the Pallas kernel in interpret mode, the unfused JAX block and
    the port's own module path."""
    rng = np.random.default_rng(cin + mid + 1)
    p, s = make_block(rng, cin, mid, max_shift - 0.2, stride=2, se=True)
    if quantize:
        p["as3"]["rubiks3d"]["shift"] = jnp.asarray(np.stack(
            [np.resize(HOT, mid), np.resize(COLD, mid), np.resize(HOT, mid)]))
    x = rng.standard_normal((2, 3, 8, 10, cin)).astype(np.float32)
    blk = torch_block(p, s, cin, mid, stride=2, quantize=quantize)
    params = tfe.stack_entry_params(blk, torch.float32, max_shift, quantize)
    se = tfb.stack_se_params([blk])[0]
    got = tfe.fused_entry_run(torch.from_numpy(x), params, se,
                              max_shift=max_shift).numpy()
    assert got.shape == (2, 3, 4, 5, mid)

    jparams = jfe.stack_entry_params(p, s, jnp.float32, max_shift, quantize)
    jse = jfb.stack_se_params([p])[0]
    np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
    kernel = jfe.fused_entry_run(jnp.asarray(x), jparams, jse,
                                 max_shift=max_shift, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=TOL, atol=TOL)

    jblock = JaxBlock(in_planes=cin, out_planes=mid, stride=2, use_se=True,
                      shift_backend="conv", shift_max_shift=max_shift,
                      quantize=quantize)
    unfused = jblock.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                           False)
    np.testing.assert_allclose(got, np.asarray(unfused), rtol=TOL, atol=TOL)

    with torch.no_grad():
        mod = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got, mod.numpy(), rtol=TOL, atol=TOL)
    # The gate is not the identity: without it the result differs.
    bare = tfe.fused_entry_run(torch.from_numpy(x), params,
                               max_shift=max_shift).numpy()
    assert np.abs(bare - got).max() > 1e-2


def test_entry_se_checks_arguments():
    rng = np.random.default_rng(3)
    p, s = make_block(rng, 12, 24, 0.5, stride=2, se=True)
    blk = torch_block(p, s, 12, 24, stride=2)
    params = tfe.stack_entry_params(blk, torch.float32, 1)
    se = tfb.stack_se_params([blk])
    x = torch.randn(1, 2, 4, 6, 12)
    with pytest.raises(ValueError, match="se must be"):
        tfe.fused_entry_run(x, params, se, max_shift=1)  # (1, 2, C, Cr)
    with pytest.raises(ValueError, match="se must be"):
        tfe.fused_entry_run(x, params, se[0].double(), max_shift=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfe.fused_entry_kernel(x, params, se[0], max_shift=1)
    assert tfe.LAUNCHES.count == 0
