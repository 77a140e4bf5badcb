"""The frozen work counts against chip_smoke.py's, at the cells' shapes."""

import json

import pytest

import chip_smoke
from portbench import harness, work

SHAPES = sorted({(c["n"], c["m"], c["q"], c["d"]) for c in (
    json.loads((harness.ROOT / e["file"]).read_text())
    for e in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["configs"])})


@pytest.mark.parametrize("shape", SHAPES + [(1000, 50, 10, 12), (100_000, 256, 100, 128)])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_psi_work_is_chip_smokes(shape, kind):
    assert work.psi_work(kind, *shape) == chip_smoke._work(kind, *shape)
    assert work.psi1_pair(kind, shape[2], shape[3]) == chip_smoke._psi1_pair(kind, shape[2],
                                                                             shape[3])


def test_the_slice_reads_the_issue_numbers():
    ops = work.eval_ops(1_000_000, 200, 10, 12)
    assert 3.07e12 <= ops <= 3.09e12          # 3.08e12 Psi operations, the bound ~1e8
    assert work.bound_ops(200, 10, 12) < 1e-3 * ops
