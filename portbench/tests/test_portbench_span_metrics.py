"""The three per-layer metrics that read the program's own spans
(``backward_share.train``, ``program_setup_s.serve``,
``program_setup_s.train``): a fabricated
registry gives the expected share or seconds; a program without the
registry, with no matching span, or with no device times gives None and
does not raise."""

import itertools
import sys
import types

import pytest

from portbench import span_readers, spec

SHARES = {"backward_share.train": ("rubiksnet.train.backward",
                                   "rubiksnet.train.step")}
SETUP = ("program_setup_s.serve", "program_setup_s.train")
TRACE_CALLS = 2  # calls traced with the device's activity alone
IDS = itertools.count(1)


def record(name, host=None, device=None, parent=None):
    """A kept span: host (start ns, end ns), device (start s, end s), the
    enclosing record; ids in the order made."""
    a, b = host or (0, 0)
    d0, d1 = device or (None, None)
    return types.SimpleNamespace(name=name, id=next(IDS),
                                 parent=None if parent is None else parent.id,
                                 start_ns=a, end_ns=b, device_start_s=d0,
                                 device_end_s=d1)


def fake_registry(records):
    """A module with the registry's reading function over ``records``."""
    return types.SimpleNamespace(spans=lambda: list(records))


@pytest.fixture
def install(monkeypatch):
    """Put ``module`` where the readers import the registry from."""
    def put(module):
        monkeypatch.setitem(sys.modules, span_readers.REGISTRY, module)
    return put


def read(name):
    ctx = types.SimpleNamespace(traffic={"trace_calls": TRACE_CALLS})
    return spec.reader(name)(ctx)


def calls(part, whole, device):
    """Records of calls named ``whole``, each holding a ``part``: device
    [(call start, call end, part start, part end)]."""
    out = []
    for c0, c1, p0, p1 in device:
        call = record(whole, device=(c0, c1))
        out += [call, record(part, device=(p0, p1), parent=call)]
    return out


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_a_share_of_device_seconds(install, metric):
    part, whole = SHARES[metric]
    install(fake_registry(
        calls(part, whole, [(0.0, 0.010, 0.002, 0.006),
                            (0.010, 0.020, 0.011, 0.012)])
        + [record("rubiksnet.other", device=(0.0, 1.0))]))
    assert read(metric) == pytest.approx(100.0 * 0.005 / 0.020)


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_calls_traced_with_the_host_do_not_move_the_share(install, metric):
    """The calls after the first ``trace_calls`` ran under the host's
    tracer too (its idle-gap window); their slowed parts are left out."""
    part, whole = SHARES[metric]
    window = calls(part, whole, [(0.0, 0.010, 0.002, 0.006),
                                 (0.010, 0.020, 0.011, 0.012)])
    host_traced = calls(part, whole, [(0.030, 0.080, 0.031, 0.079)])
    install(fake_registry(window + host_traced))
    assert read(metric) == pytest.approx(100.0 * 0.005 / 0.020)


@pytest.mark.parametrize("metric", SETUP)
def test_setup_seconds_count_nested_spans_once(install, metric):
    install(fake_registry([
        record("rubiksnet.setup.executor", host=(0, 2_000_000_000)),
        record("rubiksnet.setup.first_call", host=(3_000_000_000,
                                                   4_500_000_000)),
        record("rubiksnet.setup.library", host=(3_100_000_000,
                                                3_600_000_000)),
        record("rubiksnet.serve.call", host=(5_000_000_000,
                                             9_000_000_000))]))
    assert read(metric) == pytest.approx(3.5)


@pytest.mark.parametrize("metric", sorted(SHARES) + list(SETUP))
def test_nothing_to_read_gives_none(install, metric):
    install(None)  # the import fails
    assert read(metric) is None
    install(types.SimpleNamespace(LaunchCounter=object))  # no registry
    assert read(metric) is None
    install(fake_registry([]))  # no matching span
    assert read(metric) is None


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_spans_without_device_times_give_none(install, metric):
    part, whole = SHARES[metric]
    call = record(whole, host=(0, 10))
    install(fake_registry([call, record(part, host=(2, 4), parent=call)]))
    assert read(metric) is None


def test_the_programs_registry_on_the_cpu():
    """The port's own registry: a CPU step has no device times, so the
    share reads None, and the set-up spans read seconds."""
    import torch

    from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult
    from rubiksnet_torch.utils import profiling

    profiling.reset()
    model = create_rubiksnet("tiny", 5, 2, "rubiks3d-aq", max_shift=1,
                             device="cpu")
    step = make_train_step(model, sgd_with_shift_mult(model, 1e-3, 0.1))
    video = torch.zeros((2, 2, 32, 32, 3))
    with profiling.recording():
        step(video, torch.zeros(2, dtype=torch.long))
        FusedExecutor(model.eval())(video)
    try:
        assert any(r.name == "rubiksnet.train.backward"
                   for r in profiling.spans())
        assert read("backward_share.train") is None
        assert read("program_setup_s.serve") > 0.0
    finally:
        profiling.reset()
