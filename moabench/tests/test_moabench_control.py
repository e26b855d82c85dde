"""The control of each cell on the card, at the cell's own size: the
reference put in the program's place one precision below the
configuration's (float8 weights for the bfloat16 models, bfloat16 pixels
for the float32 scorer) must come out not correct on three seeds, while
the program itself comes out correct on the same runs. Needs one CUDA
device and about three minutes a cell; run it on the card with

    python -m pytest -m gpu moabench/tests/test_moabench_control.py
"""
from __future__ import annotations

import pytest

from moabench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cells_size(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    from moabench import calibrate, run
    from moabench.reference import check

    run._caches()
    limits = spec.cell(name)["limits"]
    seeds = [3 * 10 ** 9 + 17 * i for i in range(3)]
    lines = []
    calibrate.readings(name, seeds, 12.0, len(seeds), log=lines.append)
    import json

    for line in lines:
        rec = json.loads(line)
        assert rec["correct"], rec
        ok, rows = check.verdict(rec["control"], limits)
        assert not ok, rows
