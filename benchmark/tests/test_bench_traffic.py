"""The seeded traffic: the same seed gives the same inputs and requests,
another seed other ones, and every seed the same set of sizes."""

import itertools

import numpy as np
import torch

from benchmark.harness import core

areas = core.load_part("traffic", "areas")
train_batches = core.load_part("traffic", "train_batches")


def load(mix):
    return core.load_json(core.BENCH_DIR / "traffic" / f"{mix}.json")


AOI = {**load("aoi"), "granule_lst_px": 256, "pool_granules": 2}
STATS = {"mean_lst": 307.0, "std_lst": 3.0, "mean_ndvi": 0.6, "std_ndvi": 0.14}
BIG = 3_000_000_017   # past 32 signed bits, as the driver's seeds are


def _areas(seed):
    return areas.Areas(AOI, seed, 4, torch.device("cpu"))


def test_areas_are_seeded():
    a, b, c = _areas(BIG), _areas(BIG), _areas(BIG + 1)
    for (la, na), (lb, nb) in zip(a.pool, b.pool):
        assert np.array_equal(la, lb) and np.array_equal(na, nb)
    assert not np.array_equal(a.pool[0][0], c.pool[0][0])
    ra = list(itertools.islice(a.requests(), 40))
    assert ra == list(itertools.islice(b.requests(), 40))
    assert ra != list(itertools.islice(c.requests(), 40))


def test_areas_ranges_and_shapes():
    a = _areas(7)
    lst, ndvi = a.pool[0]
    assert lst.shape == (256, 256) and ndvi.shape == (1024, 1024)
    assert lst.dtype == np.float32 and 290.0 <= lst.min() and lst.max() <= 320.0
    assert 0.1 <= ndvi.min() and ndvi.max() <= 0.8
    for req in itertools.islice(a.requests(), 50):
        l, n = a.inputs(req)
        assert l.shape == (req.h, req.w) and n.shape == (4 * req.h, 4 * req.w)


def test_every_round_sends_every_size_once():
    for seed in (1, BIG):
        reqs = list(itertools.islice(_areas(seed).requests(), 50))
        sizes = sorted(tuple(s) for s in AOI["areas_lst_px"])
        k = len(sizes)
        for r in range(50 // k):
            assert sorted((q.h, q.w) for q in reqs[k * r:k * r + k]) == sizes
        per_round = sum((h // 64) * (w // 64) for h, w in sizes)
        assert sum(q.blocks(64) for q in reqs[:k * 10]) == 10 * per_round


def test_granule_traffic_cycles_the_pool():
    spec = {**load("granule"), "granule_lst_px": 128, "areas_lst_px": [[128, 128]]}
    reqs = list(itertools.islice(areas.Areas(spec, 3, 4, "cpu").requests(), 8))
    assert [r.granule for r in reqs] == [0, 1, 2, 3, 0, 1, 2, 3]
    assert all((r.y, r.x, r.h, r.w) == (0, 0, 128, 128) for r in reqs)


def test_train_pairs_are_seeded_and_batches_distinct():
    spec = {**load("train_pairs"), "pool_pairs": 16}
    a = train_batches.TrainPairs(spec, BIG, STATS, 4, "cpu")
    b = train_batches.TrainPairs(spec, BIG, STATS, 4, "cpu")
    c = train_batches.TrainPairs(spec, BIG + 1, STATS, 4, "cpu")
    assert np.array_equal(a.lst, b.lst) and np.array_equal(a.ndvi, b.ndvi)
    assert not np.array_equal(a.lst, c.lst)
    assert a.lst.shape == (16, 64, 64) and a.ndvi.shape == (16, 256, 256)
    oa = [tuple(i) for i in itertools.islice(a.order(), 8)]
    assert oa == [tuple(i) for i in itertools.islice(b.order(), 8)]
    for epoch in (oa[:4], oa[4:]):
        assert sorted(itertools.chain(*epoch)) == list(range(16))
    batch = a.batch(np.asarray(oa[0]))
    assert batch["lst"].shape == (4, 64, 64, 1) and batch["ndvi"].shape == (4, 256, 256, 1)
