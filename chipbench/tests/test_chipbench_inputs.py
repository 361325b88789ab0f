"""The generators' inputs: the stencil's closed forms, the Kronecker
graph's determinism and symmetry."""
import numpy as np
import pytest
import torch

from chipbench.generators import find, kronecker, stencil27


def plain_stencil(n):
    """The 27-point stencil's pattern counted point by point."""
    rows = []
    for z in range(n):
        for y in range(n):
            for x in range(n):
                rows.append(sorted(
                    (x + dx) + n * (y + dy) + n * n * (z + dz)
                    for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dx in (-1, 0, 1)
                    if 0 <= x + dx < n and 0 <= y + dy < n
                    and 0 <= z + dz < n))
    return rows


@pytest.mark.parametrize("n", [4, 5, 6, 7, 8])
def test_stencil_closed_forms(n):
    pat = stencil27.make(dict(n=n), 0, "cpu")
    rows = plain_stencil(n)
    rpt, col = pat.rpt.numpy(), pat.col.numpy()
    assert [list(col[rpt[r]:rpt[r + 1]]) for r in range(n ** 3)] == rows
    products = sum(len(rows[k]) for r in rows for k in r)
    nnz_c = sum(len({j for k in r for j in rows[k]}) for r in rows)
    assert stencil27.closed_forms(n) == dict(
        nnz_a=sum(map(len, rows)), products=products, nnz_c=nnz_c)


def test_stencil_closed_forms_at_the_cell_size():
    assert stencil27.closed_forms(128) == dict(
        nnz_a=55_742_968, products=1_489_355_288, nnz_c=254_840_104)


CFG = dict(scale=9, edgefactor=8, initiator=[0.57, 0.19, 0.19, 0.05],
           structure_seed=1)


def dense(pat):
    n = pat.rpt.shape[0] - 1
    d = np.zeros((n, n), dtype=np.int64)
    rpt, col = pat.rpt.numpy(), pat.col.numpy()
    for r in range(n):
        d[r, col[rpt[r]:rpt[r + 1]]] += 1
    return d


def test_kronecker_is_deterministic_and_symmetric():
    a = kronecker.make(CFG, 2**33 + 5, "cpu", member=3, labels_index=7)
    b = kronecker.make(CFG, 2**33 + 5, "cpu", member=3, labels_index=7)
    assert torch.equal(a.rpt, b.rpt) and torch.equal(a.col, b.col)
    d = dense(a)
    assert d.max() == 1 and (d == d.T).all() and not d.diagonal().any()
    rpt, col = a.rpt.numpy(), a.col.numpy()
    for r in range(len(rpt) - 1):
        assert (np.diff(col[rpt[r]:rpt[r + 1]]) > 0).all()


def test_kronecker_labels_give_an_isomorphic_graph():
    a = kronecker.make(CFG, 11, "cpu", member=2, labels_index=0)
    b = kronecker.make(CFG, 12, "cpu", member=2, labels_index=5)
    assert not torch.equal(a.col, b.col)
    # both are the member's graph: undo each run's labels
    da, db = dense(a), dense(b)
    ga = da[np.ix_(a.perm.numpy(), a.perm.numpy())]
    gb = db[np.ix_(b.perm.numpy(), b.perm.numpy())]
    assert (ga == gb).all()


def test_kronecker_members_differ():
    a = kronecker.make(CFG, 11, "cpu", member=0)
    b = kronecker.make(CFG, 11, "cpu", member=1)
    assert a.col.shape != b.col.shape or not torch.equal(a.col, b.col)


def test_generators_are_found_by_name():
    assert find("kronecker") is kronecker and find("stencil27") is stencil27
