"""Offline scoring of the SE tier: ``serve``'s closed loop, quantities and
traffic keys, with the weights from ``reference_se.make_weights`` (the SE
gate's dense layers drawn after the others) and the check against
``reference_se.Reference`` (the gate in every block). A kind of its own
because ``serve`` reads ``reference.py``, which has no SE."""

from __future__ import annotations

from ..compare import checks, worst_clip_rel_l2
from ..reference_se import Reference, make_weights
from . import build_model, clips, serve, torch_dtype


def make_inputs(cfg, traffic, seed, device):
    """(weights, pool): the seed's weights, then its ``pool`` batches."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    weights = make_weights(cfg, gen, device)
    b = traffic["batch"]
    flat = clips(cfg, traffic["pool"] * b, gen, device,
                 torch_dtype(cfg["dtype"]))
    return weights, [flat[i * b:(i + 1) * b] for i in range(traffic["pool"])]


class Session(serve.Session):
    def setup(self):
        from rubiksnet_torch.models.fused_infer import FusedExecutor

        self.weights, self.pool = make_inputs(self.cfg, self.traffic,
                                              self.seed, self.device)
        self.model = build_model(self.cfg, self.weights, self.device).eval()
        self.executor = FusedExecutor(self.model)
        for i in range(self.traffic["warmup_calls"]):
            self.executor(self.pool[i % len(self.pool)]).float().cpu()

    def check(self, limits):
        ref = Reference(self.cfg, self.weights)
        worst = 0.0
        for i in serve.sampled_calls(len(self.outputs), len(self.pool),
                                     self.traffic["check_calls"], self.seed):
            want = ref.logits(self.pool[i % len(self.pool)],
                              self.traffic["reference_rows"])
            worst = max(worst, worst_clip_rel_l2(self.outputs[i], want))
        return checks({"logits_rel_l2": worst}, limits)
