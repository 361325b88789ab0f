"""The plain reference and the work counts against dense arithmetic."""
import numpy as np
import pytest
import torch

from chipbench import work
from chipbench.generators import kronecker
from chipbench.reference import predict, spgemm as ref


def small(seed=0, n=40, m=50, density=0.08):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, m)) < density) * rng.uniform(-1, 1, (n, m))
    d = d.astype(np.float32)
    rpt = np.concatenate([[0], np.cumsum((d != 0).sum(1))])
    col = np.nonzero(d)[1]
    return d, ref.Matrix(torch.from_numpy(rpt).long(),
                         torch.from_numpy(col).long(),
                         torch.from_numpy(d[d != 0]), m)


@pytest.mark.parametrize("budget", [1, 7, 1 << 20])
def test_product_blocks_equal_dense(budget):
    da, a = small(0, 40, 50)
    db, b = small(1, 50, 30)
    want = da.astype(np.float64) @ db.astype(np.float64)
    mag = np.abs(da.astype(np.float64)) @ np.abs(db.astype(np.float64))
    blocks = list(ref.blocks(a, b, budget))
    assert blocks[0].r0 == 0 and blocks[-1].r1 == 40
    counts = torch.cat([bk.counts for bk in blocks]).numpy()
    rows = np.repeat(np.arange(40), counts)
    col = torch.cat([bk.col for bk in blocks]).numpy()
    val = torch.cat([bk.val for bk in blocks]).numpy()
    got = np.zeros_like(want)
    got[rows, col] = val
    pattern = ((da != 0).astype(int) @ (db != 0).astype(int)) > 0
    assert (counts == pattern.sum(1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        torch.cat([bk.mag for bk in blocks]).numpy(), mag[pattern],
        rtol=1e-12)
    assert (ref.exact_row_counts(a, b, budget=budget).numpy()
            == pattern.sum(1)).all()


def test_panel_counts_split_the_row_counts():
    da, a = small(2, 30, 40)
    db, b = small(3, 40, 60)
    edges = [0, 13, 14, 40, 60]
    per = ref.exact_row_counts(a, b, edges).numpy()
    pattern = ((da != 0).astype(int) @ (db != 0).astype(int)) > 0
    for p in range(4):
        assert (per[:, p] == pattern[:, edges[p]:edges[p + 1]].sum(1)).all()


def test_take_rows_keeps_order_and_repeats():
    da, a = small(4, 20, 20)
    sub = ref.take_rows(a, [5, 0, 5, 19])
    dense = np.zeros((4, 20), np.float32)
    rpt, col, val = sub.rpt.numpy(), sub.col.numpy(), sub.val.numpy()
    for r in range(4):
        dense[r, col[rpt[r]:rpt[r + 1]]] = val[rpt[r]:rpt[r + 1]]
    assert (dense == da[[5, 0, 5, 19]]).all()


def test_work_counts_a_small_product():
    da, a = small(5, 25, 35)
    db, b = small(6, 35, 45)
    products = int(((da != 0).astype(int) @ (db != 0).sum(1)).sum())
    assert int(ref.row_products(a, b).sum()) == products
    nnz_c = int((((da != 0).astype(int) @ (db != 0).astype(int)) > 0).sum())
    w = work.product_work(25, 35, int((da != 0).sum()), int((db != 0).sum()),
                          products, nnz_c)
    assert w.ops == 2 * products
    assert w.bytes == (4 * 26 + 8 * (da != 0).sum() + 4 * 36
                       + 8 * (db != 0).sum() + 4 * 26 + 8 * nnz_c)
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    t, which = work.bound_seconds(w, peak)
    assert which == "bytes" and t == pytest.approx(w.bytes / 3.35e12)


def test_sampling_rule_and_eq4():
    rows = predict.sample_rows(65_536, 9)
    assert rows.size == 196 and rows.min() >= 0 and rows.max() < 65_536
    assert (rows == predict.sample_rows(65_536, 9)).all()
    assert predict.sample_num(10) == 1 and predict.sample_num(10**8) == 300
    flop = torch.tensor([10, 0, 4, 6], dtype=torch.int64)
    s, total = predict.eq4(flop, z_star=5, f_star=10)
    assert s.tolist() == [5.0, 0.0, 2.0, 3.0] and total == 10.0
    s, total = predict.eq4(flop, z_star=0, f_star=0)
    assert s.tolist() == [10, 0, 4, 6] and total == 20


def test_graph_product_counts_agree_with_a_dense_square():
    pat = kronecker.make(dict(scale=7, edgefactor=8,
                              initiator=[0.57, 0.19, 0.19, 0.05],
                              structure_seed=3), 5, "cpu")
    n = pat.rpt.shape[0] - 1
    a = ref.Matrix(pat.rpt, pat.col.long(),
                   torch.ones(pat.col.shape[0]), n)
    d = np.zeros((n, n), np.int64)
    rpt, col = pat.rpt.numpy(), pat.col.numpy()
    for r in range(n):
        d[r, col[rpt[r]:rpt[r + 1]]] = 1
    assert (ref.row_products(a, a).numpy() == d @ d.sum(1)).all()
    assert (ref.exact_row_counts(a, a).numpy() == ((d @ d) > 0).sum(1)).all()
