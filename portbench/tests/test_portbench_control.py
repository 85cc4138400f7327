"""The controls fail the check on the card: the reference computed with
fp8 operands put in the program's place (and, for training, the mean
taken over half of each batch) reads above the cell's limits. At a small
batch, so that a test run holds it; ``python -m portbench.control`` reads
the same at the cells' own sizes."""

import pytest
import torch

from portbench import control, spec
from portbench.compare import passed

CELLS = {"large.serve.b64": 8, "large_aq.serve.b64": 8,
         "large.train.b32": 4, "large.eval.1clip": 8}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_the_check(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = spec.load_benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        pytest.skip(f"{name} is not a cell")
    cell = spec.cell(bench, name)
    traffic = dict(cell["traffic"], batch=CELLS[name])
    if traffic["kind"] == "evaluate":
        traffic["videos"] = CELLS[name]
    read = control.READINGS[traffic["kind"]]
    readings = read(cell["config"], traffic, 2**31 + 17,
                    torch.device("cuda", 0))
    for case, values in readings.items():
        failed = [k for k, v in values.items() if k in cell["limits"]
                  and not passed({"value": v, "limit": cell["limits"][k]})]
        assert failed, (case, values, cell["limits"])
