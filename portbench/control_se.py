"""The correctness check's control for the SE tier's serving cells, read on
the card at a cell's own size:

    python3 -m portbench.control_se --workload small.serve.b64 \
        --seeds 1 2 3 [--batch N]

``control.py``'s command and output line, for cells of the ``serve_se``
kind: for each seed the cell's weights and inputs as a run makes them, and
``fp8``, the worst clip's logit rel-L2 of ``reference_se`` with every
matrix product's operands (the SE gate's included) rounded to float8 e4m3
against the float32 ``reference_se``. A file of its own because
``control.py`` reads ``reference.py``, which has no SE.
"""

from __future__ import annotations

import sys

from . import control
from .compare import worst_clip_rel_l2
from .kinds import serve_se
from .reference_se import Reference


def serve_readings(cfg, traffic, seed, device):
    weights, pool = serve_se.make_inputs(cfg, traffic, seed, device)
    ref = Reference(cfg, weights)
    low = Reference(cfg, weights, "fp8")
    worst = 0.0
    for p in range(min(traffic["check_calls"], len(pool))):
        rows = traffic["reference_rows"]
        worst = max(worst, worst_clip_rel_l2(low.logits(pool[p], rows),
                                             ref.logits(pool[p], rows)))
    return {"fp8": {"logits_rel_l2": worst}}


def main(argv=None) -> int:
    control.READINGS["serve_se"] = serve_readings
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
