"""The port's span and counter registry (``rubiksnet_torch/utils/
profiling.py``) and the spans where the work happens: the fused
executor's steps, the train step's phases, set-up, the device loader and
the prefetch queue, on the CPU at a tiny size.

Off (no profiler, no ``recording()``), a span enters nothing and keeps
nothing; under a CPU ``torch.profiler`` each span is a ``record_function``
range on the profiler's clock and a kept record with its parent, call and
nesting; set-up spans are kept with everything off."""

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from rubiksnet_torch import data as port_data
from rubiksnet_torch.data import device_loader
from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
from rubiksnet_torch.ops import _build, launch_counters
from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult
from rubiksnet_torch.utils import profiling

torch.set_num_threads(1)

T, CLASSES, SIZE = 2, 5, 32
TRAIN = ["rubiksnet.train.zero_grad", "rubiksnet.train.forward",
         "rubiksnet.train.backward", "rubiksnet.train.optimizer",
         "rubiksnet.train.metrics"]


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def model(variant="rubiks3d", seed=0):
    torch.manual_seed(seed)
    return create_rubiksnet("tiny", CLASSES, T, variant, max_shift=1,
                            device="cpu")


def clips(n=2, size=SIZE, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, T, size, size, 3), generator=g)


def train_step(variant="rubiks3d"):
    m = model(variant)
    return make_train_step(m, sgd_with_shift_mult(m, 0.01, 0.1))


@pytest.fixture
def entered(monkeypatch):
    """The names of the profiler ranges the registry's spans open."""
    names = []
    real = profiling._record_function

    def counting(name):
        names.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_record_function", counting)
    return names


def by_name(records, name):
    return [r for r in records if r.name == name]


def inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_off_enters_nothing_and_keeps_nothing(entered):
    ex = FusedExecutor(model().eval())
    step = train_step()
    video = clips()
    labels = torch.tensor([1, 3])
    ex(video)
    step(video, labels)  # the first calls keep their set-up spans
    profiling.reset()
    assert profiling.span("rubiksnet.serve.call") is profiling.NULL
    entered.clear()
    ex(video)
    step(video, labels)
    assert entered == []
    assert profiling.spans() == []


@pytest.mark.parametrize("variant,kinds", [
    ("rubiks3d", {"rubiksnet.serve.block", "rubiksnet.serve.entry"}),
    ("rubiks3d-aq", {"rubiksnet.serve.block", "rubiksnet.serve.entry"})])
def test_executor_spans_under_the_profiler(variant, kinds):
    ex = FusedExecutor(model(variant).eval())
    video = clips()
    ex(video)
    profiling.reset()  # the set-up spans
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex(video)
        ex(video)
    events = {e.name for e in prof.events()}
    records = profiling.spans()
    calls = by_name(records, "rubiksnet.serve.call")
    assert [c.call for c in calls] == [2, 3]
    want = {"rubiksnet.serve.call", "rubiksnet.serve.stem",
            "rubiksnet.serve.head"} | kinds
    assert want <= events
    assert {r.name for r in records} == want
    for call in calls:
        assert call.parent is None
        children = [r for r in records if r.parent == call.id]
        assert {r.name for r in children} == want - {"rubiksnet.serve.call"}
        assert all(r.call == call.call and inside(r, call) for r in children)
        starts = [r.start_ns for r in children]
        assert starts == sorted(starts)
        assert children[0].name == "rubiksnet.serve.stem"
        assert children[-1].name == "rubiksnet.serve.head"
        steps = [r for r in children if r.name in kinds]
        assert sum(r.attrs["blocks"] for r in steps) == len(ex.blocks)
    assert all(r.device_s is None for r in records)  # no card


@pytest.mark.parametrize("tier,se", [("tiny", False), ("small", True)])
def test_executor_step_spans_say_whether_they_are_gated(tier, se):
    """Each ``.block`` and ``.entry`` span carries ``se``: True on every
    step of the SE tier, False without SE, so the records split gated runs
    from ungated ones (``span_totals`` over either part)."""
    torch.manual_seed(0)
    ex = FusedExecutor(create_rubiksnet(tier, CLASSES, T, max_shift=1,
                                        device="cpu").eval())
    video = clips()
    ex(video)
    profiling.reset()  # the set-up spans
    with profile(activities=[ProfilerActivity.CPU]):
        ex(video)
    steps = [r for r in profiling.spans() if r.name in (
        "rubiksnet.serve.block", "rubiksnet.serve.entry")]
    assert steps and all(r.attrs["se"] is se for r in steps)
    gated = profiling.span_totals([r for r in steps if r.attrs["se"]])
    if se:
        assert gated["rubiksnet.serve.block"]["count"] == 5
        assert gated["rubiksnet.serve.entry"]["count"] == 4
        assert sum(r.attrs["blocks"] for r in steps) == 17
    else:
        assert gated == {}


@pytest.mark.card
def test_se_gate_counter_counts_a_launch_per_gated_block():
    """On the card, one fused forward of Small in bfloat16 launches the
    stem once, K2 for its 13 stride-1 blocks, K3 for its 4 entries and the
    SE gate once for each of the 17, as the registry's counters read
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.manual_seed(0)
    m = create_rubiksnet("small", CLASSES, T, max_shift=1,
                         dtype=torch.bfloat16).eval()
    ex = FusedExecutor(m)
    video = clips().cuda()
    ex(video)
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    ex(video)
    torch.cuda.synchronize()
    want = dict.fromkeys(counters, 0)
    want.update(fused_block=13, fused_block_ring=13, fused_entry=4,
                se_gate=17, stem_conv=1)
    assert {n: c.count for n, c in counters.items()} == want
    assert profiling.counters("se_gate") == {"se_gate": 17}


def test_quantized_aq_executor_spans_the_module_path():
    """Quantized rubiks3d-aq keeps every block on the module path (the 2D
    quantize rule has no tap form): one ``.module`` span a block, beside
    the stem and the head, under the call."""
    torch.manual_seed(0)
    m = create_rubiksnet("tiny", CLASSES, T, "rubiks3d-aq", max_shift=1,
                         quantize=True, device="cpu").eval()
    ex = FusedExecutor(m)
    video = clips()
    ex(video)
    profiling.reset()  # the set-up spans
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex(video)
    assert "rubiksnet.serve.module" in {e.name for e in prof.events()}
    names = [r.name for r in profiling.spans()]
    assert set(names) == {"rubiksnet.serve.call", "rubiksnet.serve.stem",
                          "rubiksnet.serve.module", "rubiksnet.serve.head"}
    assert names.count("rubiksnet.serve.module") == len(ex.blocks)


def test_train_step_spans_under_the_profiler():
    step = train_step()
    video, labels = clips(), torch.tensor([1, 3])
    step(video, labels)
    profiling.reset()  # the set-up span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(video, labels)
    events = {e.name for e in prof.events()}
    assert {"rubiksnet.train.step", *TRAIN} <= events
    records = profiling.spans()
    (top,) = by_name(records, "rubiksnet.train.step")
    assert top.parent is None and top.call == 1
    children = [r for r in records if r.parent == top.id]
    assert [r.name for r in children] == TRAIN
    assert all(r.call == 1 and inside(r, top) for r in children)
    totals = profiling.span_totals(records)
    assert totals["rubiksnet.train.step"]["host_self_s"] < (
        totals["rubiksnet.train.step"]["host_s"])


def test_setup_spans_are_kept_with_everything_off(entered, monkeypatch,
                                                  tmp_path):
    ex = FusedExecutor(model().eval())
    ex(clips())
    ex(clips(seed=2))  # the same shape: no second first call
    ex(clips(size=48))  # a new shape
    step = train_step()
    step(clips(), torch.tensor([0, 1]))
    step(clips(), torch.tensor([0, 1]))

    def no_nvcc():
        raise RuntimeError("no nvcc")

    monkeypatch.setattr(_build, "_find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    for load in (_build.load_library, device_loader.load_library):
        with pytest.raises(RuntimeError, match="no nvcc"):
            load()
    records = profiling.spans()
    assert [r.name for r in records] == [
        "rubiksnet.setup.executor", "rubiksnet.setup.first_call",
        "rubiksnet.setup.first_call", "rubiksnet.setup.first_step",
        "rubiksnet.setup.library", "rubiksnet.setup.loader_library"]
    first = by_name(records, "rubiksnet.setup.first_call")
    assert [r.attrs["shape"][2] for r in first] == [SIZE, 48]
    assert all(r.attrs["built"] is False for r in records[-2:])
    assert entered == []


def test_self_time_is_duration_less_the_childrens_cover():
    def record(name, parent, a, b, dev=None):
        r = profiling.SpanRecord(name, parent, None, {})
        r.start_ns, r.end_ns = a, b
        if dev is not None:
            r.device_start_s, r.device_end_s = dev
        return r

    top = record("top", None, 0, 100, (0.0, 1.0))
    kids = [record("kid", top, 10, 30, (0.1, 0.3)),
            record("kid", top, 20, 50, (0.2, 0.5)),  # overlaps the first
            record("kid", top, 90, 120, (0.9, 1.2))]  # runs past the top
    grandchild = record("leaf", kids[0], 12, 14)
    totals = profiling.span_totals([top, *kids, grandchild])
    assert totals["top"]["count"] == 1
    assert totals["top"]["host_s"] == pytest.approx(100e-9)
    assert totals["top"]["host_self_s"] == pytest.approx((100 - 40 - 10)
                                                         * 1e-9)
    assert totals["top"]["device_self_s"] == pytest.approx(1.0 - 0.4 - 0.1)
    assert totals["kid"]["count"] == 3
    assert totals["kid"]["host_self_s"] == pytest.approx((20 - 2 + 30 + 30)
                                                         * 1e-9)
    assert totals["leaf"]["device_s"] is None


def test_recording_turns_spans_on_without_a_profiler(entered):
    with profiling.recording():
        with profiling.span("outer", call=7, kind="x") as outer:
            time.sleep(0.002)
            with profiling.span("inner") as inner:
                time.sleep(0.001)
    assert profiling.span("outer") is profiling.NULL  # off again
    assert entered == []
    assert [r.name for r in profiling.spans()] == ["outer", "inner"]
    assert inner.parent == outer.id and inner.call == outer.call == 7
    assert outer.attrs == {"kind": "x"} and outer.thread == inner.thread
    assert outer.host_s >= 0.003 and inner.host_s >= 0.001
    assert outer.device_s is None
    totals = profiling.span_totals()
    assert totals["outer"]["host_self_s"] == pytest.approx(
        outer.host_s - inner.host_s)


def test_spans_of_another_thread_have_their_own_parents():
    done = []

    def work():
        with profiling.span("worker"):
            done.append(True)

    with profiling.recording(), profiling.span("main") as main:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and done
    (worker,) = by_name(profiling.spans(), "worker")
    assert worker.parent is None and worker.thread != main.thread


def test_the_ring_keeps_the_last_records():
    extra = 7
    with profiling.recording():
        for i in range(profiling.MAX_RECORDS + extra):
            with profiling.span("s", call=i):
                pass
    records = profiling.spans()
    assert len(records) == profiling.MAX_RECORDS
    assert records[0].call == extra
    assert records[-1].call == profiling.MAX_RECORDS + extra - 1


def test_launch_counters_are_the_registrys():
    counters = launch_counters()
    assert sorted(counters) == sorted([
        "shift3d", "shift3d_inverse", "shift_grad", "fused_block",
        "fused_block_ring", "fused_entry", "fused_entry_aq", "se_gate", "shift2d",
        "shift2d_inverse", "bn_relu_train", "bn_relu_train_backward",
        "stem_conv"])
    registry = profiling.counters()
    assert {n: c.count for n, c in counters.items()}.items() <= (
        registry.items())
    assert "resize_crop_u8" in registry
    before = counters["fused_block"].count
    counters["fused_block"].count += 3
    try:
        assert profiling.counters("fused_")["fused_block"] == before + 3
        assert launch_counters()["fused_block"] is counters["fused_block"]
    finally:
        counters["fused_block"].count = before
    ex = FusedExecutor(model().eval())
    ex(clips())  # the plain versions: no launch on the CPU
    assert all(c.count == 0 for c in launch_counters().values())


@pytest.fixture(scope="module")
def frame_root(tmp_path_factory):
    """Three videos of small JPEG frames."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    lines = []
    for v, (w, h) in enumerate([(64, 48), (48, 64), (80, 60)]):
        (root / f"v{v}").mkdir()
        for f in range(1, 5):
            Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
                root / f"v{v}" / f"{f:05d}.jpg", quality=90)
        lines.append(f"v{v} 4 {v}")
    (root / "val.txt").write_text("\n".join(lines) + "\n")
    return root


def test_device_loader_spans_and_prefetch_counters(frame_root):
    ds = port_data.DeviceEvalDataset(port_data.RubiksDataset(
        str(frame_root), str(frame_root / "val.txt"), num_segments=T,
        image_tmpl="{:05d}.jpg", test_mode=True), 40, 32)
    names = ("rubiksnet.data.prefetch_gets", "rubiksnet.data.prefetch_empty",
             "rubiksnet.data.prefetch_depth_sum")
    before = profiling.counters("rubiksnet.data.")
    with profiling.recording():
        feed = port_data.prefetch(port_data.device_batches_from_files(
            ds, 2, 1, T, device="cpu"), depth=2)
        batches = list(feed)
    assert len(batches) == 2
    after = profiling.counters("rubiksnet.data.")
    gets, empty, depth = (after[n] - before[n] for n in names)
    assert gets == 2 and 0 <= empty <= gets and 0 <= depth <= 2 * gets
    totals = profiling.span_totals()
    for name in ("read", "decode", "resize_crop", "copy"):
        assert totals[f"rubiksnet.data.{name}"]["count"] == 2, name
    records = profiling.spans()
    assert {r.thread for r in records} != {threading.get_ident()}
    assert sum(r.attrs.get("frames", 0) for r in records) == 3 * T
