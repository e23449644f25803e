"""The control in the program's place: the plain reference one precision
lower (the exact neighbours of fp8-rounded vectors) must come out not
correct, at a size a test run holds. On the card the same comparison runs
at the cells' own size through `tools/calibrate.py`."""

import pytest

from conftest import run_tiny
from portbench.reference.control import control_knn


def control_in_place(System):
    class Control(System):
        def build(self, rows, seed, mark):
            super().build(rows, seed, mark)
            self.all_rows = rows

        def search(self, queries, mark):
            with mark("search"):
                return control_knn(self.all_rows, queries, self.k)
    return Control


@pytest.mark.parametrize("workload", ["deep10m-ivfpq.batch10k", "sift1m-ivfflat.batch10k",
                                      "deep10m-ivfpq.build"])
def test_control_is_not_correct(tiny_manifest, workload):
    result, err = run_tiny(tiny_manifest, workload, control_in_place)
    assert not result["correct"], err
    assert "check dist_gap" in err and "FAILED" in err.split("check dist_gap", 1)[1].split("\n")[0]
