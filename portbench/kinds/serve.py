"""Offline scoring: a closed loop of one caller sending batches of clips to
the fused executor (``FusedExecutor.__call__``), each batch's logits copied
to the host before the next is sent.

Traffic keys: ``batch`` clips a call, ``pool`` distinct batches the loop
cycles through, ``warmup_calls`` untimed calls, ``trace_calls`` calls in
the traced window, ``check_calls`` calls the check compares (drawn from
the seed among the window's, each of another pool batch) and
``reference_rows`` clips the reference runs at a time.
"""

from __future__ import annotations

import random

from ..compare import checks, worst_clip_rel_l2
from ..reference import Reference, make_weights
from . import build_model, clips, torch_dtype


def make_inputs(cfg, traffic, seed, device):
    """(weights, pool): the seed's weights, then its ``pool`` batches."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    weights = make_weights(cfg, gen, device)
    b = traffic["batch"]
    flat = clips(cfg, traffic["pool"] * b, gen, device,
                 torch_dtype(cfg["dtype"]))
    return weights, [flat[i * b:(i + 1) * b] for i in range(traffic["pool"])]


def sampled_calls(calls, pool, count, seed):
    """``count`` window calls drawn from the seed, each of another pool
    batch (call i sends batch i % pool)."""
    rng = random.Random(seed)
    batches = rng.sample(range(pool), min(count, pool, calls))
    return [rng.choice(range(p, calls, pool)) for p in batches]


class Session:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.outputs = []

    def setup(self):
        from rubiksnet_torch.models.fused_infer import FusedExecutor

        self.weights, self.pool = make_inputs(self.cfg, self.traffic,
                                              self.seed, self.device)
        self.model = build_model(self.cfg, self.weights, self.device).eval()
        self.executor = FusedExecutor(self.model)
        for i in range(self.traffic["warmup_calls"]):
            self.executor(self.pool[i % len(self.pool)]).float().cpu()

    def call(self):
        x = self.pool[len(self.outputs) % len(self.pool)]
        self.outputs.append(self.executor(x).float().cpu())

    def quantities(self, window_s, calls):
        return {"clips_per_s": calls * self.traffic["batch"] / window_s,
                "batch": self.traffic["batch"], "calls": calls,
                "window_s": window_s}

    def release(self):
        import torch

        del self.executor, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits):
        ref = Reference(self.cfg, self.weights)
        worst = 0.0
        for i in sampled_calls(len(self.outputs), len(self.pool),
                               self.traffic["check_calls"], self.seed):
            want = ref.logits(self.pool[i % len(self.pool)],
                              self.traffic["reference_rows"])
            worst = max(worst, worst_clip_rel_l2(self.outputs[i], want))
        return checks({"logits_rel_l2": worst}, limits)
