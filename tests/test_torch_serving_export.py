"""Serving export of the PyTorch port (rubiksnet_torch/serving,
rubiksnet_torch/ops/library.py) against the JAX package's
(rubiksnet_tpu/serving/export.py), on the CPU at the tiny tier, 2 frames,
32 px, 2 crops.

The operators are held to their schema and fake implementations by
``torch.library.opcheck``; exported graphs must hold them, one node per
kernel call of the route, and no plain shift's ``gather``; the port's
saved and reloaded program (fused executor and module path, fixed and
symbolic batch) equals JAX's ``export_eval_fn`` -> ``run_exported`` on the
same weights and video within the JAX test's bounds (rtol 2e-4, atol
2e-5: float32 on both sides, summation order apart)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.models import (
    FusedExecutor,
    create_rubiksnet,
    state_dict_from_jax,
)
from rubiksnet_torch.ops import library, stem
from rubiksnet_torch.ops.fused_block import (
    stack_block_params,
    stack_block_params_aq,
    stack_se_params,
)
from rubiksnet_torch.ops.fused_entry import (
    stack_entry_params,
    stack_entry_params_aq,
)
from rubiksnet_torch.scripts import export_model
from rubiksnet_torch.serving import export as serving_export
from rubiksnet_torch.serving import (
    export_eval_fn,
    load_exported,
    operator_counts,
    run_exported,
    save_exported,
)
from rubiksnet_tpu.models import RubiksNet as JaxRubiksNet
from rubiksnet_tpu.models import RubiksNetBundle
from rubiksnet_tpu.serving import export_eval_fn as jax_export_eval_fn
from rubiksnet_tpu.serving import load_exported as jax_load_exported
from rubiksnet_tpu.serving import run_exported as jax_run_exported
from rubiksnet_tpu.serving import save_exported as jax_save_exported

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, CROPS, T, SIZE, CLASSES = 2, 2, 2, 32, 5
RTOL, ATOL = 2e-4, 2e-5
# The operators' names, which saved programs hold: fixed.
OPERATORS = ("fused_block_run", "fused_entry_run", "shift3d_forward",
             "shift2d_forward", "stem_conv")
OPS = {f"rubiksnet.{name}" for name in OPERATORS}


def jax_bundle(seed=0):
    """JAX tiny rubiks3d, max_shift 1, its variables drawn with numpy (the
    tree's shapes from ``jax.eval_shape`` of init, which compiles nothing):
    weights N(0, 0.3), shifts U(-1, 1), BN scale U(0.5, 1.5) and bias
    U(-0.3, 0.3), running mean U(-0.2, 0.2) and var U(0.5, 2)."""
    model = JaxRubiksNet(tier="tiny", num_classes=CLASSES, num_frames=T,
                         shift_max_shift=1)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, T, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        name = keys[-1]
        if keys[0] == "batch_stats":
            lo, hi = (-0.2, 0.2) if name == "mean" else (0.5, 2.0)
            v = rng.uniform(lo, hi, leaf.shape)
        elif name == "shift":
            v = rng.uniform(-1.0, 1.0, leaf.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "bias":
            v = rng.uniform(-0.3, 0.3, leaf.shape)
        else:
            v = rng.normal(0.0, 0.3, leaf.shape)
        return jnp.asarray(v.astype(np.float32))

    variables = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    return RubiksNetBundle(model=model, variables=variables)


def video(batch=N, seed=0):
    return np.random.RandomState(seed).randn(
        batch, CROPS, T, SIZE, SIZE, 3).astype(np.float32)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX bundle, the port's tiny model on the same weights, and JAX's
    own round trip (export_eval_fn, fused=False, save, load, run) at a
    fixed and a symbolic batch: video batch -> logits."""
    bundle = jax_bundle()
    model = create_rubiksnet("tiny", CLASSES, T, max_shift=1, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        bundle.variables["params"], bundle.variables["batch_stats"]))
    want = {}
    for poly, batches in ((False, (N,)), (True, (1, 3))):
        path = str(tmp_path_factory.mktemp("jax") / "tiny.jaxexport")
        jax_save_exported(path, jax_export_eval_fn(
            bundle, N, num_crops=CROPS, input_size=SIZE,
            polymorphic_batch=poly))
        loaded = jax_load_exported(path)
        for b in batches:
            want[poly, b] = np.asarray(jax_run_exported(
                loaded, jnp.asarray(video(b))))
    return bundle, model, want


@pytest.fixture(scope="module")
def programs(weights, tmp_path_factory):
    """The port's programs of the tiny model, saved and reloaded: (fused,
    polymorphic) -> loaded ExportedProgram."""
    _, model, _ = weights
    out = {}
    for fused in (False, True):
        for poly in (False, True):
            path = str(tmp_path_factory.mktemp("export") / "tiny.pt2")
            save_exported(path, export_eval_fn(
                model, N, num_crops=CROPS, input_size=SIZE, fused=fused,
                polymorphic_batch=poly, max_batch=4))
            out[fused, poly] = load_exported(path)
    return out


# ------------------------------------------------------------ operators


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _block_args(se, aq):
    model = create_rubiksnet("small" if se else "tiny", CLASSES, T,
                             "rubiks3d-aq" if aq else "rubiks3d",
                             max_shift=1, device="cpu")
    blocks = list(model.backbone.layer1)[1:3]
    if aq:
        vt, wm = stack_block_params_aq(blocks, torch.float32, 1)
    else:
        vt, wm = stack_block_params(blocks, torch.float32, 1)
    c = blocks[0].in_planes
    x = _rand(np.random.default_rng(1), 2, T, 8, 8, c)
    return (x, vt, wm, stack_se_params(blocks) if se else None, aq, 1)


def _entry_args(se, aq=False):
    model = create_rubiksnet("small" if se else "tiny", CLASSES, T,
                             "rubiks3d-aq" if aq else "rubiks3d",
                             max_shift=1, device="cpu")
    blk = model.backbone.layer1[0]
    params = (stack_entry_params_aq(blk, torch.float32, 1) if aq
              else stack_entry_params(blk, torch.float32, 1))
    x = _rand(np.random.default_rng(2), 2, T, 8, 6, blk.in_planes)
    return (x, *params, stack_se_params([blk])[0] if se else None, 1,
            *((True,) if aq else ()))


def _shift_args(dims, stride, padding, quantize):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, T, 7, 6, 5) if dims == 3 else _rand(rng, 3, 7, 6, 5)
    shift = torch.from_numpy(
        rng.uniform(-1.5, 1.5, (dims, 5)).astype(np.float32))
    return (x, shift, stride, padding, quantize)


def _stem_args(dtype):
    rng = np.random.default_rng(4)
    return (_rand(rng, 2, T, 9, 7, 3).to(dtype),
            stem.pack_stem_weight(_rand(rng, 54, 3, 3, 3), dtype))


OPCHECK_CASES = {
    "fused_block": lambda: (library.fused_block_run, _block_args(False,
                                                                 False)),
    "fused_block_se": lambda: (library.fused_block_run, _block_args(True,
                                                                    False)),
    "fused_block_aq": lambda: (library.fused_block_run, _block_args(False,
                                                                    True)),
    "fused_entry": lambda: (library.fused_entry_run, _entry_args(False)),
    "fused_entry_se": lambda: (library.fused_entry_run, _entry_args(True)),
    "fused_entry_aq": lambda: (library.fused_entry_run,
                               _entry_args(False, aq=True)),
    "shift3d": lambda: (library.shift3d_forward,
                        _shift_args(3, [1, 1, 1], [0, 0, 0], False)),
    "shift3d_strided_quantized": lambda: (
        library.shift3d_forward, _shift_args(3, [2, 2, 2], [1, 1, 1], True)),
    "shift2d": lambda: (library.shift2d_forward,
                        _shift_args(2, [1, 2], [0, 1], False)),
    "stem_conv": lambda: (library.stem_conv, _stem_args(torch.float32)),
    "stem_conv_bf16": lambda: (library.stem_conv,
                               _stem_args(torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_opcheck(case):
    """Schema, fake implementation (also at symbolic sizes) and dispatch of
    each operator, on CPU samples."""
    op, args = OPCHECK_CASES[case]()
    torch.library.opcheck(op, args)


def test_operators_registered_at_import():
    for name in OPERATORS:
        op = getattr(torch.ops.rubiksnet, name).default
        assert op.name() == f"rubiksnet::{name}"


# ------------------------------------------------------------ programs


def test_graph_holds_the_operators(weights, programs):
    """Each K2 run of the route is one fused_block_run node, each entry
    one fused_entry_run node and the stem one stem_conv node; on the module
    path each shift layer is one shift3d_forward node; no plain gather
    anywhere."""
    _, model, _ = weights
    route = FusedExecutor(model).route((N * CROPS, T, SIZE, SIZE, 3))
    runs = sum(kind == "block" for kind, _, _ in route)
    blocks = len(dict(model.backbone.named_blocks()))
    want = {True: {"rubiksnet.fused_block_run": runs,
                   "rubiksnet.fused_entry_run": 4,
                   "rubiksnet.stem_conv": 1},
            False: {"rubiksnet.shift3d_forward": blocks}}
    for (fused, _), program in programs.items():
        counts = operator_counts(program)
        assert {k: v for k, v in counts.items() if k in OPS} == want[fused]
        assert counts["aten.gather"] == 0
        assert program.example_inputs is None  # no example video saved


@pytest.mark.parametrize("fused", [False, True])
def test_aq_graph_holds_the_operators(fused):
    """rubiks3d-aq: the module path's 2D shifts are shift2d_forward nodes;
    fused, K2 runs, the four entries on K3 with the attention mix and the
    stem, and no shift2d_forward node."""
    model = create_rubiksnet("tiny", CLASSES, T, "rubiks3d-aq", max_shift=1,
                             device="cpu")
    program = export_eval_fn(model, N, num_crops=CROPS, input_size=SIZE,
                             fused=fused)
    counts = {k: v for k, v in operator_counts(program).items() if k in OPS}
    blocks = len(dict(model.backbone.named_blocks()))
    if fused:
        route = FusedExecutor(model).route((N * CROPS, T, SIZE, SIZE, 3))
        runs = sum(kind == "block" for kind, _, _ in route)
        assert counts == {"rubiksnet.fused_block_run": runs,
                          "rubiksnet.fused_entry_run": 4,
                          "rubiksnet.stem_conv": 1}
    else:
        assert counts == {"rubiksnet.shift2d_forward": blocks}
    assert operator_counts(program)["aten.gather"] == 0
    v = torch.from_numpy(video())
    with torch.no_grad():
        want = model(v.reshape((-1,) + v.shape[2:])).reshape(N, CROPS, -1)
    torch.testing.assert_close(run_exported(program, v), want.mean(dim=1),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_roundtrip_matches_jax(weights, programs, fused):
    """The reloaded fixed-batch program against JAX's reloaded artifact."""
    _, _, want = weights
    got = run_exported(programs[fused, False], torch.from_numpy(video()))
    np.testing.assert_allclose(got.numpy(), want[False, N], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
@pytest.mark.parametrize("batch", [1, 3])
def test_symbolic_batch_matches_jax(weights, programs, fused, batch):
    """One symbolic-batch program (n in [1, 4]) at batch 1 and 3, against
    JAX's symbolic-batch artifact at the same batch."""
    _, _, want = weights
    got = run_exported(programs[fused, True],
                       torch.from_numpy(video(batch)))
    assert got.shape == (batch, CLASSES)
    np.testing.assert_allclose(got.numpy(), want[True, batch], rtol=RTOL,
                               atol=ATOL)


def test_run_exported_builds_the_module_once(programs):
    program = programs[True, False]
    v = torch.from_numpy(video())
    first = run_exported(program, v)
    module = serving_export._MODULES[program]
    assert torch.equal(run_exported(program, v), first)
    assert serving_export._MODULES[program] is module


# ------------------------------------------------------------ routes


def test_route_for_batches_names_the_batch_where_it_changes():
    """Small in bfloat16 at the default max_shift (4), 224 px: batch 1 takes
    every SE step; from batch 2 the last entry's gate does not fit K3."""
    model = create_rubiksnet("small", 174, device="cpu",
                             dtype=torch.bfloat16)
    executor = FusedExecutor(model)
    shape = (8, 224, 224, 3)
    with pytest.raises(ValueError, match=r"batch 2 .*entry layer4_0 "
                                         r"declined"):
        executor.route_for_batches(shape, 1, 8)
    assert (executor.route_for_batches(shape, 1, 1)
            == executor.route((1,) + shape))
    # The export of that range raises the same way, before any program.
    with pytest.raises(ValueError, match="batch 2"):
        export_eval_fn(model, 1, fused=True, polymorphic_batch=True,
                       max_batch=8)


def test_route_for_batches_agrees_with_route_over_the_range():
    model = create_rubiksnet("tiny", CLASSES, T, max_shift=1, device="cpu")
    executor = FusedExecutor(model)
    steps = executor.route_for_batches((T, SIZE, SIZE, 3), 2, 8, step=2)
    for n in (2, 4, 6, 8):
        assert executor.route((n, T, SIZE, SIZE, 3)) == steps
    with pytest.raises(ValueError, match="no batches"):
        executor.route_for_batches((T, SIZE, SIZE, 3), 0, 8)


def test_symbolic_batch_needs_its_clip_counts():
    """Traced at a symbolic batch without the range it stands for, the
    executor refuses rather than take one batch's route for all."""
    model = create_rubiksnet("tiny", CLASSES, T, max_shift=1, device="cpu")
    executor = FusedExecutor(model)

    class Forward(torch.nn.Module):
        def forward(self, clips):
            return executor(clips)

    with pytest.raises(ValueError, match="clips=range"):
        torch.export.export(
            Forward(), (torch.zeros(2, T, SIZE, SIZE, 3),),
            dynamic_shapes=({0: torch.export.Dim("n", min=1, max=4)},))


# ------------------------------------------------------------ loading


def test_save_exported_replaces_the_file_and_leaves_nothing_else(
        programs, tmp_path):
    path = tmp_path / "tiny.pt2"
    path.write_bytes(b"an older file")
    save_exported(str(path), programs[True, False])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["tiny.pt2"]
    got = run_exported(load_exported(str(path)), torch.from_numpy(video()))
    want = run_exported(programs[True, False], torch.from_numpy(video()))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_save_exported_that_fails_keeps_the_old_file(tmp_path):
    path = tmp_path / "tiny.pt2"
    path.write_bytes(b"an older file")
    with pytest.raises(Exception):
        save_exported(str(path), "not a program")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["tiny.pt2"]
    assert path.read_bytes() == b"an older file"


def test_fresh_process_loads_and_runs(programs, tmp_path):
    """A process that imports only rubiksnet_torch.serving (no JAX, no
    model built) loads the saved program and gives the same logits."""
    path = str(tmp_path / "fused.pt2")
    save_exported(path, programs[True, True])
    np.save(tmp_path / "video.npy", video(3))
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from rubiksnet_torch.serving import load_exported, run_exported\n"
        f"p = load_exported({path!r})\n"
        f"v = torch.from_numpy(np.load({str(tmp_path / 'video.npy')!r}))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, run_exported(p, v).numpy())\n"
        "assert not any(m.split('.')[0] in ('jax', 'rubiksnet_tpu')\n"
        "               for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = run_exported(programs[True, True], torch.from_numpy(video(3)))
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  want.numpy())


def test_export_model_script_checks_on_cpu(tmp_path):
    """``python -m rubiksnet_torch.scripts.export_model --device cpu
    --check``: float32 on the module path."""
    out = tmp_path / "tiny.pt2"
    proc = subprocess.run(
        [sys.executable, "-m", "rubiksnet_torch.scripts.export_model",
         "--device", "cpu", "--tier", "tiny", "--num-classes", "5",
         "--frames", str(T), "--input-size", str(SIZE), "--batch-size", "2",
         "--crops", "2", "--out", str(out), "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "check OK" in proc.stdout and out.exists()
    assert "'rubiksnet.shift3d_forward': 17" in proc.stdout


def test_export_model_script_bfloat16_fused_symbolic(tmp_path, capsys):
    """bfloat16, fused, symbolic batch: the program equals the live
    executor and lies within 5e-2 of the plain model."""
    out = tmp_path / "tiny_bf16.pt2"
    export_model.main([
        "--device", "cpu", "--tier", "tiny", "--num-classes", "5",
        "--frames", str(T), "--input-size", str(SIZE), "--batch-size", "3",
        "--crops", "2", "--fused", "--polymorphic-batch", "--max-batch", "4",
        "--dtype", "bfloat16", "--out", str(out), "--check"])
    text = capsys.readouterr().out
    assert "live executor: bit-identical" in text and "check OK" in text
