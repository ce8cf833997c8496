"""The comparison on hand-made answers."""

import torch

from perfbench import verdict
from perfbench.reference import knn


def setup():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(500, 16, generator=g)
    q = torch.randn(40, 16, generator=g)
    gt_d, gt_i = knn.exact_topk(q, x, 5, "sq_l2")
    return x, q, gt_d, gt_i


def pair64(x):
    def f(q, i):
        rows = x[i]
        qq = q[:, None, :].expand_as(rows)
        return (knn.pair_distance64("sq_l2", qq, rows),
                knn.pair_scale64("sq_l2", qq, rows))
    return f


def test_exact_answers_read_zero():
    x, q, gt_d, gt_i = setup()
    out = verdict.compare(q, gt_i, gt_d.float(), pair64(x), 500, gt_i)
    assert out["bad"] == 0
    assert out["dist_err"] < 1e-6 and out["hits"] == 40 * 5


def test_each_fault_reads_on_its_number():
    x, q, gt_d, gt_i = setup()
    ids, d = gt_i.clone(), gt_d.float().clone()
    ids[3, 0] = (ids[3, 0] + 1) % 500               # an id altered
    out = verdict.compare(q, ids, d, pair64(x), 500, gt_i)
    assert out["dist_err"] > 1e-3 and out["hits"] == 40 * 5 - 1
    ids = gt_i.clone()
    ids[4, 1] = ids[4, 0]                            # a repeated id
    out = verdict.compare(q, ids, d, pair64(x), 500, gt_i)
    assert out["bad"] == 1
    ids = gt_i.clone()
    ids[5, 2] = 500                                  # outside the corpus
    assert verdict.compare(q, ids, d, pair64(x), 500, gt_i)["bad"] == 1
    d2 = d.clone()
    d2[6] = d2[6].flip(0)                            # out of order
    assert verdict.compare(q, gt_i, d2, pair64(x), 500, gt_i)["bad"] == 1


def test_limits_decide():
    cfg = {"limits": {"dist_err": 1e-5},
           "guarantees": {"recall_at_10_min": 0.8}}
    ok = {"bad": 0, "dist_err": 1e-7, "hits": 90, "rows": 10}
    assert verdict.passed(verdict.checks(ok, cfg, 10))
    low = dict(ok, hits=70)
    assert not verdict.passed(verdict.checks(low, cfg, 10))
    far = dict(ok, dist_err=1e-3)
    assert not verdict.passed(verdict.checks(far, cfg, 10))
    bad = dict(ok, bad=1)
    assert not verdict.passed(verdict.checks(bad, cfg, 10))


def test_reference_holds_ties_to_the_lowest_id():
    x = torch.zeros(10, 4)
    q = torch.zeros(2, 4)
    d, i = knn.exact_topk(q, x, 3, "sq_l2")
    assert i.tolist() == [[0, 1, 2], [0, 1, 2]]
    x[7] = 1.0
    d, i = knn.exact_topk(q, x, 9, "sq_l2")
    assert i.tolist() == [[0, 1, 2, 3, 4, 5, 6, 8, 9]] * 2
