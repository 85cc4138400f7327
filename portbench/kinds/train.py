"""Fine-tuning: back-to-back ``TrainStep`` calls (SGD with the shift
learning-rate multiplier, cross entropy), each ending with its loss on the
host.

Set-up builds the one train step and drives it from the seed through its
first ``first_steps`` steps on distinct pool batches; the window goes on
with the same object. The check runs the reference through the same
steps from the same weights and compares each step's loss, the first
gradient (read from the optimizer's momentum buffers after step 1) and
the change of the parameters after the last of them.

Traffic keys: ``batch``, ``pool`` (distinct batches, with labels drawn
from the seed), ``first_steps``, ``lr``, ``shift_mult``, ``momentum``,
``weight_decay``, ``trace_calls``.
"""

from __future__ import annotations

from ..compare import checks, leaf_norm_gap, moved_leaves, rel_gaps
from ..reference import Reference, make_weights, param_group, trainable
from . import build_model, clips, torch_dtype


def make_inputs(cfg, traffic, seed, device):
    """(weights, pool of (video, labels)) from the seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    weights = make_weights(cfg, gen, device)
    b, p = traffic["batch"], traffic["pool"]
    flat = clips(cfg, p * b, gen, device, torch_dtype(cfg["dtype"]))
    labels = torch.randint(0, cfg["num_classes"], (p, b), generator=gen,
                           device=device)
    return weights, [(flat[i * b:(i + 1) * b], labels[i]) for i in range(p)]


def reference_steps(cfg, traffic, weights, pool, precision="float32",
                    rows=None):
    """The reference through the first steps: (losses, first gradients,
    parameters after)."""
    ref = Reference(cfg, weights, precision)
    batches = [pool[i % len(pool)] for i in range(traffic["first_steps"])]
    return ref.train_steps(batches, traffic["lr"], traffic["shift_mult"],
                           traffic["momentum"], traffic["weight_decay"],
                           rows=rows)


def compared(cfg, traffic, weights, got, want):
    """The three numbers: the worst step's relative loss gap, the worst
    leaf's gap of the first gradient's norm and of the change's norm (of
    the leaves the reference moves)."""
    losses, grads, params = got
    r_losses, r_grads, r_params = want
    names = trainable(weights)
    moved = moved_leaves(r_grads)
    change = {n: params[n].to(weights[n].device) - weights[n] for n in moved}
    r_change = {n: r_params[n] - weights[n] for n in moved}
    return {"loss_rel": rel_gaps(losses, r_losses),
            "grad_norm_gap": leaf_norm_gap(grads, r_grads, names),
            "update_norm_gap": leaf_norm_gap(change, r_change, moved)}


class Session:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.losses = []

    def setup(self):
        from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

        t = self.traffic
        self.weights, self.pool = make_inputs(self.cfg, t, self.seed,
                                              self.device)
        self.model = build_model(self.cfg, self.weights, self.device)
        self.optimizer = sgd_with_shift_mult(
            self.model, t["lr"], t["shift_mult"], momentum=t["momentum"],
            weight_decay=t["weight_decay"])
        self.step = make_train_step(self.model, self.optimizer)
        params = dict(self.model.named_parameters())
        for i in range(t["first_steps"]):
            self.call()
            if i == 0:
                self.first_grads = self._grads(params)
        self.params_after = {n: p.detach().float().cpu().clone()
                             for n, p in params.items()}

    def _grads(self, params):
        """Each parameter's first gradient as the optimizer got it: the
        momentum buffer after one step, less the decay term."""
        import torch

        d = self.traffic["weight_decay"]
        out = {}
        for n, p in params.items():
            buf = self.optimizer.state[p].get("momentum_buffer")
            if buf is None:  # the optimizer took no step
                buf = torch.zeros_like(p)
            elif param_group(n) == "weight":
                buf = buf - d * self.weights[n]
            out[n] = buf.detach().float().cpu().clone()
        return out

    def call(self):
        video, labels = self.pool[len(self.losses) % len(self.pool)]
        self.losses.append(float(self.step(video, labels)["loss"]))

    def quantities(self, window_s, calls):
        return {"train_clips_per_s": calls * self.traffic["batch"]
                / window_s, "batch": self.traffic["batch"], "calls": calls,
                "window_s": window_s}

    def release(self):
        import torch

        del self.step, self.optimizer, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits):
        t = self.traffic
        got = (self.losses[:t["first_steps"]], self.first_grads,
               self.params_after)
        want = reference_steps(self.cfg, t, self.weights, self.pool)
        return checks(compared(self.cfg, t, self.weights, got, want), limits)
