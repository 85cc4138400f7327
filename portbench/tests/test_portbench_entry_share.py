"""``entry_share.serve``, the share of busy time in the entry blocks'
launches (K3, K3-AQ and K3-SE: the tensor-core launches and the gather
pre-pass): read from a fabricated trace, overlapping launches counted
once, None where no entry launch ran; K2's launches and the SE gate's are
not counted; and every entry kernel of the source, named as the profiler
names it, is counted by this metric and by no other metric's table."""

import re
import types

import pytest

from portbench import spec
from portbench.trace import Trace

CU = spec.ROOT / "rubiksnet_torch" / "ops" / "csrc" / "fused_entry_tc.cu"
OTHER_METRICS = ("k2_roofline.serve", "se_gate_share.serve",
                 "shift_roofline.train", "bn_share.train")
TC = "void rubiks::rubiks_entry_tc_kernel<4>(rubiks::EntryArgs)"
AQ = "void rubiks::rubiks_entry_tc_kernel<8>(rubiks::EntryArgs)"
GATHER = "rubiks::rubiks_entry_gather_kernel(rubiks::EntryArgs)"
K2 = "void rubiks::rubiks_tc_kernel<2>(rubiks::TcArgs)"
GATE = "rubiks::(anonymous namespace)::se_gate_tc_kernel(GateArgs)"
STEM = "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop>"


def read(device, window_s=1.0):
    ctx = types.SimpleNamespace(trace=Trace(device, window_s, 2))
    return spec.reader("entry_share.serve")(ctx)


def test_the_share_of_busy_counts_overlapping_launches_once():
    device = [(TC, 0.0, 0.2), (AQ, 0.1, 0.3), (K2, 0.3, 0.8),
              (STEM, 0.9, 1.0)]
    # busy 0.9 s (0.8-0.9 idle); the entry launches' union 0.3 s
    assert read(device) == pytest.approx(100.0 * 0.3 / 0.9)


def test_no_entry_launch_gives_none():
    assert read([(K2, 0.0, 0.5), (GATE, 0.5, 0.6)]) is None
    assert read([]) is None


def test_k2_and_the_gate_are_not_counted():
    device = [(TC, 0.0, 0.1), (K2, 0.1, 0.6), (GATE, 0.6, 0.7),
              (STEM, 0.7, 0.8)]
    assert read(device) == pytest.approx(100.0 * 0.1 / 0.8)


def test_the_gather_is_counted():
    device = [(GATHER, 0.0, 0.05), (TC, 0.05, 0.15), (K2, 0.15, 0.5)]
    assert read(device) == pytest.approx(100.0 * 0.15 / 0.5)
    assert read([(GATHER, 0.0, 0.05), (K2, 0.05, 0.5)]) == pytest.approx(
        100.0 * 0.05 / 0.5)


def entry_kernels():
    """The ``__global__`` kernels of K3's tensor-core source."""
    names = re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
        CU.read_text())
    assert names
    return names


def test_every_entry_kernel_is_counted_here_and_nowhere_else():
    needles = spec.reader("entry_share.serve").__globals__["NAMES"]
    others = [n for m in OTHER_METRICS
              for n in spec.reader(m).__globals__["NAMES"]]
    for kernel in entry_kernels():
        name = f"void rubiks::{kernel}<4>(rubiks::EntryArgs)"
        assert any(n in name for n in needles), kernel
        assert not any(n in name for n in others), kernel
