"""``bn_share.train``, the share of device time in the train-mode BN and
ReLU kernel pair: read from a fabricated trace, None where no such kernel
ran; and the pair's kernel names, as the profiler gives them, sort into
none of the plain classes and match no other metric's names, so their time
leaves ``plain_ops_share.train`` and no roofline reads it."""

import re
import types

import pytest

from portbench import spec
from portbench import yardstick as ys
from portbench.trace import Trace

CU = spec.ROOT / "rubiksnet_torch" / "ops" / "csrc" / "bn_relu_train.cu"
OTHER_METRICS = ("shift_roofline.train", "k2_roofline.serve",
                 "se_gate_share.serve")


def read(trace):
    return spec.reader("bn_share.train")(types.SimpleNamespace(trace=trace))


def kernel_names():
    """Each ``__global__`` kernel of the source as the profiler names an
    instance: its namespace, template arguments and parameter types."""
    text = CU.read_text()
    names = re.findall(
        r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text)
    assert len(names) == 6
    namespace = re.search(r"^namespace (\w+) \{", text, re.M).group(1)
    return [f"void {namespace}::{n}<__nv_bfloat16, 8>(__nv_bfloat16 const*, "
            f"float const*, float*, long, int, int, long)" for n in names]


def test_the_share_of_the_pairs_device_time():
    names = kernel_names()
    trace = Trace(device=[(names[0], 0.0, 0.002), (names[3], 0.004, 0.005),
                          ("void at::native::reduce_kernel<>", 0.002, 0.004),
                          ("void rubiks::bwd3d::bwd3d_forward<>", 0.005,
                           0.010)],
                  window_s=0.02, calls=1)
    assert read(trace) == pytest.approx(100.0 * 0.003 / 0.010)


def test_no_pair_in_the_trace_gives_none():
    trace = Trace(device=[("void at::native::reduce_kernel<>", 0.0, 0.1)],
                  window_s=0.2, calls=1)
    assert read(trace) is None
    assert read(Trace(device=[], window_s=0.1, calls=1)) is None


def test_the_pairs_names_are_out_of_the_plain_classes():
    needles = [n for m in OTHER_METRICS for n in _names_of(m)]
    for name in kernel_names():
        assert ys.classify(name) not in ys.PLAIN_OP_CLASSES, name
        assert ys.classify(name) == "other", name
        assert not any(n in name for n in needles), name


def _names_of(metric):
    """The kernel-name table of a metric's reader."""
    return spec.reader(metric).__globals__["NAMES"]
