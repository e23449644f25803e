"""The plain reference against a NumPy float64 brute force, and the
control's rounding."""

import numpy as np
import torch

from portbench.reference.control import control_knn, round_fp8
from portbench.reference.exact_knn import exact_knn, pair_distances


def _brute(rows, queries, k):
    d = ((queries[:, None, :].astype(np.float64) - rows[None, :, :].astype(np.float64)) ** 2).sum(2)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids


def test_exact_knn_matches_numpy_float64_brute_force():
    g = torch.Generator().manual_seed(3)
    rows = torch.randn(3000, 24, generator=g)
    queries = torch.randn(70, 24, generator=g)
    d, i = exact_knn(rows, queries, 10, query_block=32, row_block=700, margin=8)
    bd, bi = _brute(rows.numpy(), queries.numpy(), 10)
    assert np.array_equal(i.numpy(), bi)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_exact_knn_breaks_ties_to_the_smaller_id():
    rows = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [5.0, 5.0]])
    d, i = exact_knn(rows, torch.zeros(1, 2), 3, row_block=2)
    assert i.tolist() == [[0, 1, 2]]
    assert d.tolist() == [[1.0, 1.0, 1.0]]


def test_pair_distances_is_float64_and_marks_bad_ids():
    rows = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    d = pair_distances(rows, torch.zeros(1, 2), torch.tensor([[1, -1, 2]]))
    assert d.dtype == torch.float64
    assert d[0, 0] == 25.0 and torch.isnan(d[0, 1]) and torch.isnan(d[0, 2])


def test_control_rounds_to_fp8_and_answers_for_the_rounded_vectors():
    x = torch.tensor([[1.0, 1.0625, 3.3, -0.1]])
    assert round_fp8(x).tolist() == [[1.0, 1.0, 3.25, -0.1015625]]
    g = torch.Generator().manual_seed(4)
    rows, queries = torch.randn(500, 8, generator=g), torch.randn(20, 8, generator=g)
    d, i = control_knn(rows, queries, 5)
    rd, ri = exact_knn(round_fp8(rows), round_fp8(queries), 5)
    assert torch.equal(i.long(), ri) and torch.equal(d, rd.float())
