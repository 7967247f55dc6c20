"""The traffic generator: the same seed gives the same requests; a fit
request's design and key are new for every request and every seed; the
query pool's sizes are the same for every seed, in another order."""
import collections

import torch

from harness import spec
from harness.traffic import Stream, query_sizes


def _stream(workload, seed, **traffic):
    cell = spec.load_cell(workload)
    cell.traffic.update(traffic)
    return Stream(cell.config, cell.traffic, seed, "cpu", torch.float64)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _fields(r):
    return (r.design.x, r.design.y, r.x_new, r.key_fit, r.key_predict)


def test_same_seed_same_requests():
    a, b = _stream("bench2d.n100", 2**31 + 5), _stream("bench2d.n100",
                                                      2**31 + 5)
    for i in range(5):
        ra, rb = a.request(i), b.request(i)
        assert ra.member == rb.member
        assert _same(_fields(ra), _fields(rb))


def test_seeds_reorder_the_same_pool():
    a, b = _stream("bench2d.n100", 11), _stream("bench2d.n100", 12)
    n = a.members
    assert n == 99
    ma = [a.request(i).member for i in range(2 * n)]
    mb = [b.request(i).member for i in range(2 * n)]
    assert ma != mb
    assert collections.Counter(ma) == collections.Counter(mb)
    for c in range(2):
        assert sorted(ma[c * n:(c + 1) * n]) == list(range(n))
    j = ma[0]
    ra, rb = a.request(0), b.request(mb.index(j))
    assert _same(_fields(ra), _fields(rb))
    r = [a.pool_request(0, j) for j in range(3)]
    assert not torch.equal(r[0].design.x, r[1].design.x)
    assert not torch.equal(r[1].key_fit, r[2].key_fit)
    assert r[0].design.x.shape == (100, 2) and r[0].x_new.shape == (625, 2)


def test_gv_splits_in_turn():
    s = _stream("gv9d.splits", 3)
    xs = [s.pool_request(0, j).design.x for j in range(s.members)]
    assert {tuple(x.shape) for x in xs} == {(50, 9)}
    assert s.pool_request(0, 0).x_new.shape == (150, 9)
    sums = collections.Counter(round(x.sum().item(), 9) for x in xs)
    assert len(sums) == 9 and set(sums.values()) == {11}
    assert not torch.equal(s.pool_request(0, 0).key_fit,
                           s.pool_request(0, 9).key_fit)


def test_query_sizes_fixed_and_in_range():
    cell = spec.load_cell("bench2d.predict")
    sizes = query_sizes(cell.traffic)
    assert len(sizes) == 64 and min(sizes) == 1 and max(sizes) == 4096
    a, b = _stream("bench2d.predict", 7), _stream("bench2d.predict", 8)
    assert a.sizes == b.sizes == sizes
    assert [p.shape[0] for p in a.points] == sizes
    assert not torch.equal(a.points[5], b.points[5])
    assert torch.equal(a.points[5], _stream("bench2d.predict", 7).points[5])
    n = a.members
    ma = [a.request(i).member for i in range(3 * n)]
    mb = [b.request(i).member for i in range(3 * n)]
    assert ma != mb
    assert collections.Counter(ma) == collections.Counter(mb)
    for c in range(3):
        assert sorted(ma[c * n:(c + 1) * n]) == list(range(n))
