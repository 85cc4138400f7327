"""The plain reference: RubiksNet in plain PyTorch, float32, from the
published description (StanfordVL/RubiksNet: ``rubiksnet/models.py``,
``rubiksnet/shiftlib``), and the weights both sides are given.

Imports nothing of the program. The same configuration file and seed give
the same weights here and in the port (the harness loads this module's
``make_weights`` into the port's model by name). Everything is
channel-last: clips (N, T, H, W, 3), activations (N, T, H, W, C).

* Shifts. A RubiksShift moves every channel by its own fractional offset
  along T, H and W, with linear interpolation between the floor and the
  floor + 1 taps and zero outside the clip. Trilinear interpolation is
  separable, so it is three per-channel 1D shifts; a stride keeps output
  positions 0, s, 2s, ... Its gradient is the published rule: the input
  gradient is the transpose of the forward, the shift gradient is the
  interpolated difference per axis, where a remainder of exactly 0 moves
  the lower tap back a cell, and each channel's (T, H, W) gradient is
  divided by its norm.
* rubiks3d-aq blocks shift 2D (H, W) per frame and mix frames by the
  attention shift: three taps along T, softmax of the weights over their
  row's Bessel-corrected standard deviation plus 1e-6, at temperature 2.
* A block is pre-activation: BN, ReLU, [attention shift], 1x1 conv, BN,
  ReLU, the shift at the block's stride, 1x1 conv, plus the input or, where
  stride or width change, a strided 1x1 conv of the activated input. The
  stem is a 3x3 stride-2 conv; the head BN, ReLU, spatial mean, a dense
  layer per frame and the mean over frames.

``precision="fp8"`` is the control: every operand of a matrix product
(activations and weights, the stem's and the head's included) is rounded
to float8 e4m3 under a per-tensor scale before a float32 product, as an
fp8 path of the program would compute it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
ATTN_TEMPERATURE = 2.0
FP8_MAX = 448.0  # float8 e4m3's largest finite value


# ----------------------------------------------------------- the weights


def block_list(cfg):
    """(prefix, in width, out width, stride) of every block, in order."""
    w = cfg["width"]
    stages = [(w, 1, 1)] + [(w * 2 ** i, r, 2)
                             for i, r in enumerate(cfg["repeats"])]
    out, cin = [], w
    for s, (planes, repeat, stride) in enumerate(stages):
        for b in range(repeat):
            out.append((f"backbone.layer{s}.{b}", cin, planes,
                        stride if b == 0 else 1))
            cin = planes
    return out


def param_spec(cfg):
    """(name, shape, init) of every parameter and buffer, named as the
    reference's torch modules. Inits: ``he`` N(0, 2 / fan_out), ``res`` the
    same at a quarter of the deviation (the last conv of a residual branch,
    so that 51 blocks on random weights keep the activations in range),
    ``dense`` N(0, 1 / fan_in), ``shift`` U(-1, 1), ``attn`` U[0, 1),
    ``scale`` 1 + N(0, 0.1), ``small`` N(0, 0.1), ``var`` U(0.5, 1.5),
    ``temp`` the attention temperature, ``count`` BN's step counter."""
    aq = cfg["variant"] == "rubiks3d-aq"
    spec = [("backbone.conv1.weight", (cfg["width"], 3, 3, 3), "he")]

    def bn(prefix, c):
        spec.extend([(f"{prefix}.weight", (c,), "scale"),
                     (f"{prefix}.bias", (c,), "small"),
                     (f"{prefix}.running_mean", (c,), "small"),
                     (f"{prefix}.running_var", (c,), "var"),
                     (f"{prefix}.num_batches_tracked", (), "count")])

    for p, cin, cout, stride in block_list(cfg):
        bn(f"{p}.bn1", cin)
        if aq:
            spec.append((f"{p}.conv2.0.weight", (cin, 3), "attn"))
            spec.append((f"{p}.conv2.0.T", (), "temp"))
            spec.append((f"{p}.conv2.1.weight", (cout, cin, 1, 1), "he"))
        else:
            spec.append((f"{p}.conv2.weight", (cout, cin, 1, 1), "he"))
        bn(f"{p}.bn2", cout)
        if aq:
            spec.append((f"{p}.as3.shift", (2, cout), "shift"))
        else:
            spec.append((f"{p}.as3.rubiks3d.shift", (3, cout), "shift"))
        spec.append((f"{p}.conv3.weight", (cout, cout, 1, 1), "res"))
        if stride != 1 or cin != cout:
            spec.append((f"{p}.shortcut.weight", (cout, cin, 1, 1), "he"))
    bn("backbone.bn_last", 8 * cfg["width"])
    spec.append(("new_fc.weight", (cfg["num_classes"], 8 * cfg["width"]),
                 "dense"))
    spec.append(("new_fc.bias", (cfg["num_classes"],), "small"))
    return spec


NORMAL = {"he", "res", "dense", "scale", "small"}
UNIFORM = {"shift", "attn", "var"}


def make_weights(cfg, generator, device):
    """{name: float32 tensor} on ``device`` from ``generator``: one normal
    draw and one uniform draw for all of them, then sliced and scaled."""
    spec = param_spec(cfg)
    n_norm = sum(math.prod(s) for _, s, i in spec if i in NORMAL)
    n_unif = sum(math.prod(s) for _, s, i in spec if i in UNIFORM)
    normal = torch.randn(n_norm, generator=generator, device=device)
    unif = torch.rand(n_unif, generator=generator, device=device)
    out, a, b = {}, 0, 0
    for name, shape, init in spec:
        size = math.prod(shape)
        if init in NORMAL:
            v = normal[a:a + size].view(shape)
            a += size
            if init in ("he", "res"):
                std = math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
                v = v * (std / 4 if init == "res" else std)
            elif init == "dense":
                v = v * math.sqrt(1.0 / shape[1])
            elif init == "scale":
                v = 1.0 + 0.1 * v
            else:
                v = 0.1 * v
        elif init in UNIFORM:
            v = unif[b:b + size].view(shape)
            b += size
            if init == "shift":
                v = 2.0 * v - 1.0
            elif init == "var":
                v = 0.5 + v
        elif init == "temp":
            v = torch.tensor(ATTN_TEMPERATURE, device=device)
        else:
            v = torch.tensor(0, dtype=torch.long, device=device)
        out[name] = v.clone() if v.is_floating_point() else v
    return out


def param_group(name: str) -> str:
    """The optimizer group of a parameter: ``shift`` (the shifts, lr times
    the shift multiplier, no decay), ``bias`` (BN's scale and bias, the
    head's bias; no decay) or ``weight`` (the convs, the head, the
    attention weights; decayed)."""
    if name.endswith(".shift"):
        return "shift"
    if ".bn" in name or name == "new_fc.bias":
        return "bias"
    return "weight"


def trainable(weights):
    """The names of the parameters (the buffers left out)."""
    return [n for n in weights if not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked", ".T"))]


# ----------------------------------------------------------- shifts


def _fp8(t):
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())  # rounded forward, gradient passed through


def shift_axis(x, s, axis, stride):
    """Per-channel fractional shift of x along ``axis`` by s (C,): output
    position o reads ``o * stride + s`` interpolated, zero outside."""
    n = x.shape[axis]
    n_out = (n - 1) // stride + 1
    k = torch.floor(s)
    r = s - k
    ki = k.long()
    lo, hi = int(ki.min()), int(ki.max()) + 1
    pad_lo = max(0, -lo)
    pad_hi = max(0, hi + (n_out - 1) * stride - (n - 1))
    xp = F.pad(x, _pad_arg(x.ndim, axis, pad_lo, pad_hi))
    out = None
    for d in range(lo, hi + 1):
        w = torch.where(ki == d, 1 - r, torch.zeros_like(r)) + torch.where(
            ki + 1 == d, r, torch.zeros_like(r))
        if not bool((w != 0).any()):
            continue
        sl = xp.narrow(axis, pad_lo + d, (n_out - 1) * stride + 1)
        if stride > 1:
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(None, None, stride)
            sl = sl[tuple(idx)]
        term = sl * w
        out = term if out is None else out + term
    return out


def _pad_arg(ndim, axis, lo, hi):
    """F.pad's argument padding ``axis`` of an ``ndim`` tensor by (lo, hi)."""
    pad = []
    for a in reversed(range(ndim)):
        pad += [lo, hi] if a == axis else [0, 0]
    return pad


def _taps(x, s, axis, stride):
    """x at the corrected lower tap and at the upper tap of every output
    position along ``axis``, and the remainders: (lower, upper, r). The
    lower tap is the floor, one cell back where the remainder is 0."""
    n = x.shape[axis]
    n_out = (n - 1) // stride + 1
    k = torch.floor(s)
    r = s - k
    low = k.long() - (r == 0).long()
    high = k.long() + 1
    base = torch.arange(n_out, device=x.device)[:, None] * stride

    def gather(off):
        idx = base + off[None, :]  # (n_out, C)
        valid = (idx >= 0) & (idx < n)
        shape = [1] * x.ndim
        shape[axis], shape[-1] = n_out, idx.shape[1]
        full = list(x.shape)
        full[axis] = n_out
        g = torch.gather(x, axis, idx.clamp(0, n - 1).view(shape).expand(
            full))
        return g * valid.view(shape).to(x.dtype)

    return gather(low), gather(high), r


def _lerp(a, b, r):
    return (1 - r) * a + r * b


def shift_grad_raw(og, x, s, strides):
    """The published raw (3, C) shift gradient: for each axis the
    difference of the taps along it, the other axes interpolated, summed
    against og."""
    axes = (1, 2, 3)
    at, bt, rt = _taps(x, s[0], axes[0], strides[0])
    lt, dt = _lerp(at, bt, rt), bt - at
    ah, bh, rh = _taps(lt, s[1], axes[1], strides[1])
    lh_t, dh = _lerp(ah, bh, rh), bh - ah
    ah, bh, _ = _taps(dt, s[1], axes[1], strides[1])
    dt_h = _lerp(ah, bh, rh)
    aw, bw, rw = _taps(dt_h, s[2], axes[2], strides[2])
    g_t = (og * _lerp(aw, bw, rw)).sum((0, 1, 2, 3))
    aw, bw, _ = _taps(dh, s[2], axes[2], strides[2])
    g_h = (og * _lerp(aw, bw, rw)).sum((0, 1, 2, 3))
    aw, bw, _ = _taps(lh_t, s[2], axes[2], strides[2])
    g_w = (og * (bw - aw)).sum((0, 1, 2, 3))
    return torch.stack([g_t, g_h, g_w])


def shift3d(x, s, stride):
    out = shift_axis(x, s[0], 1, 1)
    out = shift_axis(out, s[1], 2, stride)
    return shift_axis(out, s[2], 3, stride)


class Shift3D(torch.autograd.Function):
    """The 3D shift with the published gradient rule."""

    @staticmethod
    def forward(ctx, x, s, stride):
        ctx.save_for_backward(x, s)
        ctx.stride = stride
        return shift3d(x, s, stride)

    @staticmethod
    def backward(ctx, og):
        x, s = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (gx,) = torch.autograd.grad(shift3d(xx, s.detach(), ctx.stride),
                                        xx, og)
        g = shift_grad_raw(og, x, s, (1, ctx.stride, ctx.stride))
        mag = g.norm(dim=0)
        g = torch.where(mag > 0, g / torch.where(mag > 0, mag, 1.0), g)
        return gx, g, None


def shift2d(x, s, stride):
    """Per-frame (H, W) shift of (N, T, H, W, C) by s (2, C)."""
    return shift_axis(shift_axis(x, s[0], 2, stride), s[1], 3, stride)


def attention_shift(x, weight):
    std = weight.std(dim=1, keepdim=True, correction=1)
    w = torch.softmax(weight / (std + 1e-6) / ATTN_TEMPERATURE, dim=1)
    t = x.shape[1]
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    return w[:, 0] * xp[:, 0:t] + w[:, 1] * x + w[:, 2] * xp[:, 2:t + 2]


# ----------------------------------------------------------- the model


class Reference:
    """RubiksNet of ``cfg`` on ``weights`` (a dict as :func:`make_weights`
    makes it; float32 copies are taken), float32 with TF32 off, or with
    the fp8 control's rounding."""

    def __init__(self, cfg, weights, precision="float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.fp8 = cfg, precision == "fp8"
        self.aq = cfg["variant"] == "rubiks3d-aq"
        self.p = {k: (v.detach().float().clone() if v.is_floating_point()
                      else v) for k, v in weights.items()}
        self.blocks = block_list(cfg)

    def _q(self, t):
        return _fp8(t) if self.fp8 else t

    def _mm(self, x, w):
        """x (..., Cin) times a (Cout, Cin[, 1, 1]) weight."""
        return self._q(x) @ self._q(w.reshape(w.shape[0], -1)).t()

    def _bn(self, x, prefix, train):
        w, b = self.p[f"{prefix}.weight"], self.p[f"{prefix}.bias"]
        if train:
            var, mean = torch.var_mean(x, dim=(0, 1, 2, 3), correction=0)
        else:
            mean = self.p[f"{prefix}.running_mean"]
            var = self.p[f"{prefix}.running_var"]
        return (x - mean) * torch.rsqrt(var + BN_EPS) * w + b

    def _block(self, x, prefix, cin, cout, stride, train):
        p = self.p
        out = torch.relu(self._bn(x, f"{prefix}.bn1", train))
        if stride != 1 or cin != cout:
            sc = out[:, :, ::stride, ::stride]
            shortcut = self._mm(sc, p[f"{prefix}.shortcut.weight"])
        else:
            shortcut = x
        if self.aq:
            out = attention_shift(out, p[f"{prefix}.conv2.0.weight"])
            out = self._mm(out, p[f"{prefix}.conv2.1.weight"])
        else:
            out = self._mm(out, p[f"{prefix}.conv2.weight"])
        out = torch.relu(self._bn(out, f"{prefix}.bn2", train))
        if self.aq:
            out = shift2d(out, p[f"{prefix}.as3.shift"], stride)
        else:
            out = Shift3D.apply(out, p[f"{prefix}.as3.rubiks3d.shift"],
                                stride)
        return self._mm(out, p[f"{prefix}.conv3.weight"]) + shortcut

    def forward(self, video, train=False):
        """(N, T, H, W, 3) -> (N, classes) float32 logits. ``train``: BN
        on batch statistics and every block under activation
        checkpointing (the same values; memory of the block inputs
        only)."""
        p = self.p
        n, t, h, w, _ = video.shape
        x = video.float().reshape(n * t, h, w, 3).permute(0, 3, 1, 2)
        x = F.conv2d(self._q(x), self._q(p["backbone.conv1.weight"]),
                     stride=2, padding=1)
        x = x.permute(0, 2, 3, 1).reshape(n, t, *x.shape[2:4], -1)
        for prefix, cin, cout, stride in self.blocks:
            if train:
                x = checkpoint(self._block, x, prefix, cin, cout, stride,
                               True, use_reentrant=False)
            else:
                x = self._block(x, prefix, cin, cout, stride, False)
        x = torch.relu(self._bn(x, "backbone.bn_last", train))
        feats = x.mean(dim=(2, 3))  # (N, T, C)
        logits = self._mm(feats, p["new_fc.weight"]) + p["new_fc.bias"]
        return logits.mean(dim=1)

    @torch.no_grad()
    def logits(self, video, rows=8):
        """Eval-mode logits of ``video``, ``rows`` clips at a time."""
        return torch.cat([self.forward(video[i:i + rows])
                          for i in range(0, video.shape[0], rows)])

    def train_steps(self, batches, lr, shift_mult, momentum, weight_decay,
                    rows=None):
        """SGD with momentum on cross entropy over ``batches`` [(video,
        labels)], one step each, in the groups of :func:`param_group`
        (``torch.optim.SGD``'s update: ``buf = momentum * buf + g + d * p``,
        the first ``buf = g + d * p``; ``p -= lr * buf``). ``rows``: the
        loss is the mean over the first ``rows`` clips only (a fault the
        check must catch). Returns (losses, the first step's gradients,
        the parameters after the last step). The rubiks3d variant only:
        the 2D shift here has autograd's gradient, not the published
        normalized rule."""
        if self.aq:
            raise NotImplementedError("the reference trains rubiks3d only")
        names = trainable(self.p)
        for n in names:
            self.p[n].requires_grad_(True)
        bufs, losses, first = {}, [], None
        for video, labels in batches:
            if rows is not None:
                video, labels = video[:rows], labels[:rows]
            logits = self.forward(video, train=True)
            loss = F.cross_entropy(logits, labels.long())
            grads = torch.autograd.grad(loss, [self.p[n] for n in names])
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: g.detach().clone() for n, g in zip(names, grads)}
            with torch.no_grad():
                for n, g in zip(names, grads):
                    group = param_group(n)
                    d = weight_decay if group == "weight" else 0.0
                    step_lr = lr * (shift_mult if group == "shift" else 1.0)
                    g = g + d * self.p[n] if d else g
                    buf = bufs.get(n)
                    buf = g.clone() if buf is None else buf.mul_(
                        momentum).add_(g)
                    bufs[n] = buf
                    self.p[n].sub_(step_lr * buf)
        for n in names:
            self.p[n].requires_grad_(False)
        return losses, first, {n: self.p[n].detach().clone() for n in names}
