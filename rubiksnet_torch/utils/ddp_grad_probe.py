"""Where the DDP train step's gradient departs from the one-process step's
(``chip_smoke.py`` phase 11 (a)): Large in float32 at 8x224x224,
``max_shift`` 1, random weights from seed 0 and BN statistics from seed 1,
one step at batch 8 in one process against two ranks at 4 each on the one
card (gloo), from one state.

    python3 -m rubiksnet_torch.utils.ddp_grad_probe [--out DIR]

It reads two causes apart:

* a ReLU kink: a pre-activation (every BN output feeds a ReLU) whose sign
  differs between the two runs. It counts, for every BN, the elements of
  each rank's rows whose sign differs from the one process's same rows.
* the shift gradient's normalization: each channel's (T, H, W) triple is
  divided by its norm, so a channel whose raw gradient nearly cancels
  turns a rounding difference of the raw sum into a large one. It
  records every raw (3, C) gradient as it enters
  ``normalize_shift_grad_3d`` and prints, for the five worst shifts, the
  raw and the normalized gradient's rel-L2, and each channel's raw relative
  error beside its raw norm.

Prints the card's name and power limit, then the findings, for the free
run and for one with each flipped BN output pinned to the one process's
sign; the last line is a JSON summary, with ``--out`` also written to
``DIR/ddp_grad_probe.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import torch

FRAMES, SIZE, CLASSES, MAX_SHIFT, BATCH, RANKS = 8, 224, 174, 1, 8, 2
SHIFT_CHANNEL_FLOOR = 1e-6


def large_model(dev):
    """Phase 11 (a)'s state: Large f32 from seed 0, BN running mean
    U(-0.2, 0.2) and variance U(0.5, 2) from seed 1, train mode."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.nn.backbone import BN

    m = create_rubiksnet("large", CLASSES, FRAMES, "rubiks3d",
                         max_shift=MAX_SHIFT, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, BN):
                c = mod.running_mean.numel()
                mod.running_mean.copy_(torch.rand(c, generator=gen) * 0.4
                                       - 0.2)
                mod.running_var.copy_(torch.rand(c, generator=gen) * 1.5
                                      + 0.5)
    return m.to(dev).train()


def batch(dev):
    g = torch.Generator().manual_seed(2)
    video = torch.randn((BATCH, FRAMES, SIZE, SIZE, 3), generator=g)
    labels = torch.randint(0, CLASSES, (BATCH,), generator=g)
    return video.to(dev), labels.to(dev)


def packed_signs(x):
    """(N, ...) -> (N, ceil(numel / N / 8)) uint8: the bits of x > 0."""
    bits = (x.detach() > 0).reshape(x.shape[0], -1)
    pad = (-bits.shape[1]) % 8
    bits = torch.nn.functional.pad(bits.to(torch.uint8), (0, pad))
    weights = (2 ** torch.arange(8, device=x.device)).to(torch.uint8)
    return (bits.reshape(bits.shape[0], -1, 8) * weights).sum(
        -1, dtype=torch.uint8)


def popcount(x):
    return sum(int(((x >> k) & 1).sum()) for k in range(8))


def unpacked_signs(packed, shape):
    """The inverse of :func:`packed_signs`: a bool tensor of ``shape``."""
    bits = (packed[..., None] >> torch.arange(8, device=packed.device)) & 1
    n = 1
    for d in shape[1:]:
        n *= d
    return bits.reshape(shape[0], -1)[:, :n].reshape(shape).bool()


def pinned(out, want):
    """``out`` with its signs set to ``want``'s where they differ (to 0 or
    to the least positive float32 value), each element's gradient still
    passing to ``out``: ReLU's mask is then ``want``'s, the values move by
    less than each flipped element's magnitude."""
    tiny = torch.finfo(out.dtype).tiny
    target = torch.where(want, torch.full_like(out, tiny),
                         torch.zeros_like(out))
    # target + (out - out) is target exactly; out + (target - out) may not be
    return torch.where(want != (out > 0), target + (out - out.detach()), out)


def one_step(dev, group=None, pin=None):
    """One step of phase 11 (a) (this rank's rows under ``group``); ->
    (loss, the gradients by name, packed BN output signs by name,
    the raw shift gradients by name). ``pin(name)``, where given, returns
    the signs (bool, the output's shape) that BN ``name``'s output takes
    (:func:`pinned`)."""
    from rubiksnet_torch.nn.backbone import BN
    from rubiksnet_torch.ops import shift3d as s3d
    from rubiksnet_torch.parallel import shard_batch
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    model = large_model(dev)
    step = make_train_step(model, sgd_with_shift_mult(model, 0.01),
                           data_group=group)
    signs, raws = {}, []

    def hook(_mod, _inputs, out, name):
        if pin is not None:
            out = pinned(out, pin(name, out.shape))
        signs[name] = packed_signs(out)
        return out

    hooks = [mod.register_forward_hook(
        lambda mod, i, out, name=name: hook(mod, i, out, name))
        for name, mod in model.named_modules() if isinstance(mod, BN)]
    normalize = s3d.normalize_shift_grad_3d

    def recorded(g, factor):
        raws.append((g.detach().clone(), factor))
        return normalize(g, factor)

    s3d.normalize_shift_grad_3d = recorded
    try:
        video, labels = batch(dev)
        if group is not None:
            video, labels = shard_batch((video, labels), group)
        loss = float(step(video, labels)["loss"])
    finally:
        s3d.normalize_shift_grad_3d = normalize
        for h in hooks:
            h.remove()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    raw = {}
    for g, factor in raws:  # name each raw gradient by its normalized one
        norm = normalize(g, factor)
        name, = [n for n, p in grads.items() if n.endswith(".shift")
                 and p.shape == norm.shape
                 and torch.equal(p, norm.to(p.dtype))]
        raw[name] = g.cpu()
    return loss, {n: g.cpu() for n, g in grads.items()}, signs, raw


def rank_main(rank, store, tmp, pin):
    import torch.distributed as dist

    from rubiksnet_torch.ops import _build
    from rubiksnet_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(init_method=f"file://{store}", world_size=RANKS,
                           rank=rank, device="cuda", log=lambda *a: None)
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.load_library()
    ref = torch.load(f"{tmp}/ref_signs.pt")
    local = BATCH // RANKS
    rows = slice(rank * local, (rank + 1) * local)
    loss, grads, signs, raw = one_step(
        dev, dist.group.WORLD,
        (lambda name, shape: unpacked_signs(ref[name][rows].to(dev), shape))
        if pin else None)
    flips = {n: popcount(s.cpu() ^ ref[n][rows]) for n, s in signs.items()}
    torch.save(dict(loss=loss, grads=grads, raw=raw, flips=flips),
               f"{tmp}/rank{rank}{'_pinned' if pin else ''}.pt")
    dist.destroy_process_group()


def rel_l2(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, metavar="DIR",
                   help="also write the summary to DIR/ddp_grad_probe.json")
    args = p.parse_args(argv)
    import torch.multiprocessing as mp

    from rubiksnet_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("ddp_grad_probe: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.load_library()
    loss, grads, signs, raw = one_step(dev)
    summary = dict(device=smi.strip(), loss=loss)
    with tempfile.TemporaryDirectory(prefix="ddp_grad_probe_") as tmp:
        torch.save({n: s.cpu() for n, s in signs.items()},
                   f"{tmp}/ref_signs.pt")
        del signs
        torch.cuda.empty_cache()
        for pin in (False, True):
            mp.start_processes(rank_main,
                               args=(f"{tmp}/store{pin}", tmp, pin),
                               nprocs=RANKS, join=True, start_method="spawn")
            ranks = [torch.load(
                f"{tmp}/rank{r}{'_pinned' if pin else ''}.pt")
                for r in range(RANKS)]
            label = "pinned" if pin else "free"
            summary[label] = report(label, loss, grads, raw, ranks)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ddp_grad_probe.json"), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))


def report(label, loss, grads, raw, ranks):
    """Print and return one DDP run's departures from the one process:
    its sign flips, the worst gradient, the five worst shifts."""
    flips = {n: sum(r["flips"][n] for r in ranks) for n in ranks[0]["flips"]}
    total = sum(flips.values())
    got, got_raw = ranks[0]["grads"], ranks[0]["raw"]
    worst = max((rel_l2(masked(n, got[n], g), masked(n, g, g)), n)
                for n, g in grads.items())
    print(f"[{label}] loss: one process {loss:.7f}, DDP "
          f"{ranks[0]['loss']:.7f}; pre-ReLU sign flips (BN outputs, both "
          f"ranks' rows against one process's): {total} in "
          f"{sum(1 for v in flips.values() if v)} of {len(flips)} BNs; worst "
          f"gradient rel_l2 {worst[0]:.3e} ({worst[1]})")
    rows = []
    for n in raw:
        r_ref, r_got = raw[n], got_raw[n]
        mag = r_ref.norm(dim=0)
        err = (r_got - r_ref).norm(dim=0) / mag.clamp_min(1e-30)
        rows.append(dict(
            name=n, normalized_rel_l2=rel_l2(masked(n, got[n], grads[n]),
                                             masked(n, grads[n], grads[n])),
            raw_rel_l2=rel_l2(r_got, r_ref),
            channel_raw_rel_err_max=float(err.max()),
            channel_of_max=int(err.argmax()),
            its_raw_norm_over_median=float(
                mag[err.argmax()] / mag.median()),
            channels_raw_rel_err_over_1e_2=int((err > 1e-2).sum()),
            channels=int(mag.numel())))
    rows.sort(key=lambda r: -r["normalized_rel_l2"])
    for r in rows[:5]:
        print(f"[{label}] {r['name']}: normalized rel_l2 "
              f"{r['normalized_rel_l2']:.3e}, raw rel_l2 "
              f"{r['raw_rel_l2']:.3e}; worst channel {r['channel_of_max']} "
              f"raw rel err {r['channel_raw_rel_err_max']:.3e} at a raw "
              f"norm {r['its_raw_norm_over_median']:.3e} x the median; "
              f"{r['channels_raw_rel_err_over_1e_2']} of {r['channels']} "
              f"channels above 1e-2")
    return dict(ddp_loss=ranks[0]["loss"], sign_flips=total,
                worst_gradient=worst, shifts=rows[:5])


def masked(name, g, ref):
    """A shift gradient's channels whose ``ref`` gradient is not zero
    (chip_smoke.py's mask); any other gradient as it is."""
    if not name.endswith(".shift"):
        return g
    norm = ref.norm(dim=0)
    return g[:, norm > SHIFT_CHANNEL_FLOOR * norm.max()]


if __name__ == "__main__":
    main()
