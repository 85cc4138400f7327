"""Train-mode BN with its ReLU (``ops/bn_relu.py``): the kernel pair's
decomposition, emulated here in plain PyTorch under its launch plan, against
the plain ops BN runs today and their autograd gradients; the plan; the
route by device, ``plain``, mode and active group.

The emulation follows ``csrc/bn_relu_train.cu`` step by step: each thread's
rows (a block's rows ``row_lanes`` apart), its count, mean and M2, the row
lanes merged in order by Chan's rule into a block's partials, the partials
merged FIN_SLICES side by side and then in order, the apply pass; backward,
the sums of g = dy [out > 0] and g (x - mean) by the same walk, dgamma and
dbeta, and dx. A thread's Welford update is replaced by the exact two-pass
statistics of the same rows, which it computes up to rounding.
"""

from __future__ import annotations

import re
import types

import pytest
import torch

from portbench import yardstick
from rubiksnet_torch.models.rubiksnet import create_rubiksnet
from rubiksnet_torch.nn import backbone
from rubiksnet_torch.nn.backbone import BN, kernel_route
from rubiksnet_torch.ops import _build, bn_relu, launch_counters
from rubiksnet_torch.ops.bn_relu import (
    FIN_SLICES,
    bn_relu_plan,
    bn_relu_train,
    bn_train_plain,
)
from rubiksnet_torch.parallel.mesh import data_parallel
from rubiksnet_torch.parallel.temporal import time_parallel
from rubiksnet_torch.utils import profile_step

EPS = 1e-5
SMS = 3  # a small card: few blocks, so the partials' merge has work
# Large's BN sites at 224 px: (H, C) of the tensors BN normalizes.
LARGE_SITES = ((112, 72), (56, 72), (56, 144), (28, 144), (28, 288),
               (14, 288), (14, 576), (7, 576))


def chan(a, b):
    """(n, mean, M2) of two disjoint sets merged, per channel."""
    na, ma, m2a = a
    nb, mb, m2b = b
    if nb == 0:
        return a
    n = na + nb
    d = mb - ma
    f = nb / n
    return n, ma + d * f, m2a + m2b + d * d * na * f


def walk(plan, rows):
    """Per block, per row lane, the rows the lane's threads walk."""
    for b in range(plan.blocks):
        r0 = b * plan.per_block
        r1 = min(rows, r0 + plan.per_block)
        yield [torch.arange(r0 + lane, r1, plan.row_lanes)
               for lane in range(plan.row_lanes)]


def merge_partials(parts, combine, empty):
    """The finalize order: slice s takes blocks s, s + FIN_SLICES, ...;
    then the slices in order."""
    slices = []
    for s in range(FIN_SLICES):
        acc = empty
        for p in parts[s::FIN_SLICES]:
            acc = combine(acc, p)
        slices.append(acc)
    acc = slices[0]
    for p in slices[1:]:
        acc = combine(acc, p)
    return acc


def emulate_forward(x2, weight, bias, plan, eps=EPS):
    """(out, mean, var, rstd) of the forward launches on x2 (rows, C)."""
    rows, c = x2.shape
    zero = torch.zeros(c, dtype=x2.dtype)
    empty = (0, zero, zero)
    parts = []
    for lanes in walk(plan, rows):
        acc = empty
        for idx in lanes:
            if len(idx):
                v = x2[idx]
                m = v.mean(0)
                acc = chan(acc, (len(idx), m, ((v - m) ** 2).sum(0)))
        parts.append(acc)
    n, mean, m2 = merge_partials(parts, chan, empty)
    assert n == rows
    var = m2 / rows
    rstd = torch.rsqrt(var + eps)
    out = torch.relu((x2 - mean) * (rstd * weight) + bias)
    return out, mean, var, rstd


def emulate_backward(dy2, x2, weight, bias, mean, rstd, plan):
    """(dx, dweight, dbias) of the backward launches."""
    rows, c = x2.shape
    t = x2 - mean
    g = torch.where(t * (rstd * weight) + bias > 0, dy2, 0.0)
    gt = g * t
    zero = torch.zeros(c, dtype=x2.dtype)

    def add(a, b):
        return a[0] + b[0], a[1] + b[1]

    parts = []
    for lanes in walk(plan, rows):
        acc = (zero, zero)
        for idx in lanes:
            acc = add(acc, (g[idx].sum(0), gt[idx].sum(0)))
        parts.append(acc)
    sg, sgt = merge_partials(parts, add, (zero, zero))
    dbias, dweight = sg, rstd * sgt
    dx = rstd * weight * (g - dbias / rows - t * (rstd * dweight / rows))
    return dx, dweight, dbias


def bn_params(c, dtype, seed, dead=()):
    """weight, bias, running mean and variance of one BN; the channels in
    ``dead`` get a bias that keeps them below zero (an all-zero mask)."""
    gen = torch.Generator().manual_seed(seed)
    weight = (0.5 + torch.rand(c, generator=gen)).to(dtype)
    bias = (0.5 * torch.randn(c, generator=gen)).to(dtype)
    for ch in dead:
        bias[ch] = -1e3
    return weight, bias, torch.randn(c, generator=gen).to(dtype), (
        0.5 + torch.rand(c, generator=gen)).to(dtype)


def plain_step(x, weight, bias, rm, rv, nbt):
    """Today's relu(BN(x)) in train mode and its gradients for dy."""
    x = x.detach().requires_grad_(True)
    w = weight.detach().requires_grad_(True)
    b = bias.detach().requires_grad_(True)
    out = torch.relu(bn_train_plain(x, w, b, rm, rv, nbt, EPS))
    return out, (x, w, b)


CASES = [  # (C, rows, plan's itemsize, dead channels)
    (72, 3 * 1000 + 7, 2, ()),
    (144, 2 * 1111 + 1, 4, (5,)),
    (576, 613, 2, (0, 575)),
    (72, 509, 4, (3,)),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("c,rows,itemsize,dead", CASES)
def test_emulated_kernels_match_the_plain_ops(c, rows, itemsize, dead,
                                              dtype):
    plan = bn_relu_plan(rows, c, itemsize, SMS)
    assert plan.per_block * (plan.blocks - 1) < rows <= (
        plan.per_block * plan.blocks)
    assert rows % plan.per_block or rows % plan.row_lanes  # ragged edges
    gen = torch.Generator().manual_seed(c + rows)
    x2 = (3.0 + 2.0 * torch.randn((rows, c), generator=gen)).to(dtype)
    dy2 = torch.randn((rows, c), generator=gen).to(dtype)
    weight, bias, rm, rv = bn_params(c, dtype, rows, dead)
    x = x2.reshape(1, rows, 1, c)  # any leading axes: BN reduces them all

    rm_p, rv_p, nbt = rm.clone(), rv.clone(), torch.tensor(4)
    out_p, leaves = plain_step(x, weight, bias, rm_p, rv_p, nbt)
    out_p.backward(dy2.reshape(x.shape))
    dx_p, dw_p, db_p = (v.grad for v in leaves)

    out, mean, var, rstd = emulate_forward(x2, weight, bias, plan)
    dx, dw, db = emulate_backward(dy2, x2, weight, bias, mean, rstd, plan)
    # The kernels' running update, in the finalize launch.
    rm_k, rv_k = 0.1 * mean + 0.9 * rm, 0.1 * var + 0.9 * rv

    tol = {torch.float64: 1e-12, torch.float32: 2e-5}[dtype]

    def close(got, want):
        scale = want.abs().max().clamp_min(1.0)
        assert (got - want).abs().max() <= tol * scale

    close(out, out_p.reshape(rows, c))
    close(dx, dx_p.reshape(rows, c))
    close(dw, dw_p)
    close(db, db_p)
    close(rm_k, rm_p)
    close(rv_k, rv_p)
    assert int(nbt) == 5
    for ch in dead:  # an all-zero mask: no gradient through the channel
        assert not out[:, ch].any() and not dx[:, ch].any()
        assert dw[ch] == 0 and db[ch] == 0


def test_statistics_do_not_cancel_over_many_rows():
    """A large mean over many rows: the merged M2 keeps the variance where
    float32's E[x^2] - E[x]^2 loses it."""
    rows, c = 400_003, 8
    plan = bn_relu_plan(rows, c, 2, SMS)
    gen = torch.Generator().manual_seed(0)
    x64 = 300.0 + 0.01 * torch.randn((rows, c), generator=gen,
                                     dtype=torch.float64)
    x32 = x64.float()
    want = x32.double().var(0, correction=0)
    ones, zeros = torch.ones(c), torch.zeros(c)
    var = emulate_forward(x32, ones, zeros, plan)[2].double()
    assert ((var - want).abs() / want).max() < 1e-3
    naive = (x32 * x32).mean(0) - x32.mean(0) ** 2
    assert ((naive.double() - want).abs() / want).max() > 1e-1


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("h,c", LARGE_SITES)
def test_plan_at_large_shapes(h, c, batch):
    rows = batch * 8 * h * h
    for itemsize in (2, 4):
        plan = bn_relu_plan(rows, c, itemsize, 132)
        assert plan.vec * itemsize == 16  # one 16-byte load a thread
        assert plan.lanes * plan.vec == c
        assert 0 < plan.threads <= bn_relu.MAX_THREADS
        assert plan.smem_bytes(c) <= bn_relu.SMEM_LIMIT
        assert plan.blocks <= 2 * 132
        assert plan.per_block * (plan.blocks - 1) < rows <= (
            plan.per_block * plan.blocks)


@pytest.mark.parametrize("c,itemsize,align,vec", [
    (54, 2, 16, 2), (54, 4, 16, 2), (3, 2, 16, 1), (72, 2, 4, 2),
    (72, 4, 8, 2), (72, 2, 2, 1), (4096, 2, 16, 8)])
def test_plan_narrows_the_load_to_the_row_and_alignment(c, itemsize, align,
                                                        vec):
    plan = bn_relu_plan(1000, c, itemsize, 4, align)
    assert plan.vec == vec and plan.lanes * vec == c
    assert plan.threads <= bn_relu.MAX_THREADS


def test_plan_refuses_a_row_wider_than_a_block():
    with pytest.raises(ValueError, match="at most"):
        bn_relu_plan(10, 8193, 2, 4)
    with pytest.raises(ValueError, match="rows and channels"):
        bn_relu_plan(0, 72, 2, 4)


# ------------------------------------------------------------ the route


CUDA_X = types.SimpleNamespace(device=torch.device("cuda", 0))


def test_route_takes_the_kernels_only_where_it_should():
    assert kernel_route(CUDA_X, True, False)
    assert not kernel_route(CUDA_X, True, True)  # plain=True
    assert not kernel_route(CUDA_X, False, False)  # eval mode
    assert not kernel_route(torch.zeros(2, 3), True, False)  # the CPU
    with data_parallel(object()):
        assert not kernel_route(CUDA_X, True, False)
    with time_parallel(object(), 1):
        assert not kernel_route(CUDA_X, True, False)


@pytest.mark.parametrize("plain", [False, True])
def test_cpu_and_plain_run_the_plain_ops(monkeypatch, plain):
    def refuse(*args):
        raise AssertionError("the kernel pair was called")

    monkeypatch.setattr(backbone, "bn_relu_train", refuse)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 4, 4, 6), generator=gen)
    bn, ref = BN(6).train(), BN(6).train()
    got = bn.relu(x, plain)
    want = torch.relu(ref(x))
    assert torch.equal(got, want)
    for a, b in ((bn.running_mean, ref.running_mean),
                 (bn.running_var, ref.running_var),
                 (bn.num_batches_tracked, ref.num_batches_tracked)):
        assert torch.equal(a, b)
    assert all(c.count == 0 for c in launch_counters().values())


def test_a_dtype_the_kernels_do_not_take_raises(monkeypatch):
    """No fallback: on the kernels' route a float64 or float16 x raises."""
    monkeypatch.setattr(backbone, "kernel_route", lambda *a: True)
    bn = BN(4).train()
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            bn.relu(torch.zeros((3, 4), dtype=dtype))
    with pytest.raises(ValueError, match="CUDA"):
        bn_relu_train(torch.zeros((3, 4)), bn.weight, bn.bias,
                      bn.running_mean, bn.running_var,
                      bn.num_batches_tracked, bn.eps)


@pytest.mark.parametrize("tier,variant,sites", [
    ("large", "rubiks3d", 103), ("large", "rubiks3d-aq", 103),
    ("small", "rubiks3d", 35)])
def test_a_train_forward_sends_every_bn_relu_through_the_op(
        monkeypatch, tier, variant, sites):
    """With the route open, each block's bn1 and bn2 and bn_last take the
    fused op: 103 sites a Large step, 35 a Small one; none in eval mode."""
    calls = []

    def counting(x, weight, *rest):
        calls.append(tuple(x.shape))
        return torch.relu(bn_train_plain(x, weight, *rest))

    monkeypatch.setattr(backbone, "kernel_route",
                        lambda x, training, plain: training and not plain)
    monkeypatch.setattr(backbone, "bn_relu_train", counting)
    model = create_rubiksnet(tier, 5, 2, variant, max_shift=1, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    video = torch.randn((1, 2, 32, 32, 3),
                        generator=torch.Generator().manual_seed(1))
    model.train()(video)
    assert len(calls) == sites
    calls.clear()
    model.train()(video, plain=True)
    with torch.no_grad():
        model.eval()(video)
    assert not calls


def kernel_names():
    """The pair's kernels as the profiler names an instance."""
    text = (_build.CSRC / "bn_relu_train.cu").read_text()
    names = re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text)
    namespace = re.search(r"^namespace (\w+) \{", text, re.M).group(1)
    return [f"void {namespace}::{n}<__nv_bfloat16, 8>(__nv_bfloat16 const*, "
            f"float const*, float*, long, int, int, long)" for n in names]


def test_the_pairs_kernels_sort_out_of_the_plain_classes():
    """Six launches, each in the port's BN class and, by the benchmark's
    frozen table, in no class of plain ops and under no other metric's
    name, so their time leaves plain_ops_share.train."""
    names = kernel_names()
    assert len(names) == 6
    for name in names:
        assert profile_step.classify(name).startswith("BN and ReLU"), name
        assert yardstick.classify(name) == "other", name
        assert not any(n in name for n in ("shift_grad", "bwd3d_",
                                           "rubiks_tc_kernel",
                                           "rubiks_entry", "se_gate")), name
