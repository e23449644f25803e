"""A run of each cell on the CPU, with the card's look skipped and the
timed path broken underneath: `correct` must come out false for each
fault the cell can have. One chip: no exchange between chips to leave
out."""

import pytest
import torch

from conftest import run_tiny

SEARCH_CELLS = ("deep10m-ivfpq.batch10k", "sift1m-ivfflat.batch10k")


def half_batch(System):
    """Half of each batch searched; the other half answered with its
    answers."""
    class Broken(System):
        def search(self, queries, mark):
            h = queries.shape[0] // 2
            d, i = super().search(queries[:h], mark)
            return torch.cat([d, d]), torch.cat([i, i])
    return Broken


def altered_answer(System):
    """One id of each batch altered where the search produces it."""
    class Broken(System):
        def search(self, queries, mark):
            d, i = super().search(queries, mark)
            i = i.clone()
            i[0, 0] = (i[0, 0] + 1) % self.n_rows
            return d, i
    return Broken


def half_rows(System):
    """The build indexes only the first half of the rows."""
    class Broken(System):
        def build(self, rows, seed, mark):
            super().build(rows[: rows.shape[0] // 2], seed, mark)
            self.rows = rows
    return Broken


def unchanged_state(System):
    """The build hands back the index it starts from, with no rows."""
    class Broken(System):
        def build(self, rows, seed, mark):
            super().build(rows, seed, mark)
            self.index.slot_rows = torch.full_like(self.index.slot_rows, -1)
    return Broken


def skipped_digest(System):
    """The build leaves the integrity sidecar out."""
    class Broken(System):
        def build(self, rows, seed, mark):
            super().build(rows, seed, mark)
            self.index.list_digests = None
    return Broken


def _with_rows(System):
    class Counted(System):
        def build(self, rows, seed, mark):
            self.n_rows = rows.shape[0]
            super().build(rows, seed, mark)
    return Counted


@pytest.mark.parametrize("workload", SEARCH_CELLS + ("deep10m-ivfpq.build",
                                                     "sift1m-ivfflat.build"))
def test_sound_run_is_correct(tiny_manifest, workload):
    result, err = run_tiny(tiny_manifest, workload)
    assert result["correct"], err
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", [half_batch, altered_answer])
@pytest.mark.parametrize("workload", SEARCH_CELLS)
def test_search_fault_is_caught(tiny_manifest, workload, fault):
    result, err = run_tiny(tiny_manifest, workload, lambda S: fault(_with_rows(S)))
    assert not result["correct"], err


@pytest.mark.parametrize("fault", [half_rows, altered_answer, unchanged_state,
                                   skipped_digest])
def test_build_fault_is_caught(tiny_manifest, fault):
    try:
        result, err = run_tiny(tiny_manifest, "deep10m-ivfpq.build",
                               lambda S: fault(_with_rows(S)))
    except ValueError:   # an index with no rows refuses the check's search
        return
    assert not result["correct"], err
    assert result["failed"] == (0 if fault is altered_answer else 1)
