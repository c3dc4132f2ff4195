"""The readers of a world's cell (``wire_mb_per_outer``,
``collectives_per_outer``, ``rank_step_roofline``,
``rank_kernels_roofline``) on a hand-made ``ctx``: their values, and None
where their field is missing."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import spec
from perfbench.metrics import _roofline
from perfbench.traffic import Mix

CELL = "convdiff-n1024-p4.nccl"
H100 = "NVIDIA H100 80GB HBM3"
READERS = ("wire_mb_per_outer", "collectives_per_outer", "rank_step_roofline",
           "rank_kernels_roofline")


def _reader(name):
    return spec.load_module(spec.ROOT / "perfbench" / "metrics" / f"{name}.py")


def _ctx(**kw):
    cell = spec.load(CELL)
    base = dict(config=cell.config, mix=Mix.read(cell.traffic), device_kind=H100,
                outers=0, window_s=0.0, busy_s=0.0, kernel_count=0, kernel_s=0.0, syncs=0,
                sync_outers=0, outer_s=0.0)
    return SimpleNamespace(**dict(base, **kw))


def test_the_readers_are_the_cells_and_only_its():
    assert set(READERS) <= set(spec.readers(spec.load(CELL)))
    for w in ("convdiff-n1024-p256.pfait", "convdiff-n1024-p256.blocking"):
        assert not set(READERS) & set(spec.readers(spec.load(w)))


def test_the_counters_over_the_outer_spans():
    # two solves of 107 outer iterations on rank 0: a face and a lane an
    # iteration, and each solve's opening exchange
    face, lane, outers = 1024 * 1024 * 8, 4, 214
    ctx = _ctx(counts={"wire_bytes": outers * (face + lane) + 2 * face,
                       "collectives": 3 * outers + 2 * 2, "host_syncs": outers + 4},
               span_totals={"shard.outer": {"count": outers, "seconds": 3.6,
                                            "self_seconds": 0.1}})
    assert _reader("wire_mb_per_outer").read(ctx) == pytest.approx(
        (face + lane + 2 * face / outers) / 1e6)
    assert 8.38 < _reader("wire_mb_per_outer").read(ctx) < 8.60
    assert _reader("collectives_per_outer").read(ctx) == pytest.approx(3 + 4 / outers)


def test_a_ranks_least_time_over_its_iteration_and_its_kernels():
    ctx = _ctx(outer_s=17.05e-3, outers=8, kernel_s=8 * 15e-3)
    least = _roofline.least_seconds(ctx) / 4
    # bytes bound it: 24 B a cell of a rank's 2.68e8 at 3.35 TB/s, 1.92 ms
    assert least == pytest.approx(24 * 1024 ** 3 / 4 / 3.35e12)
    assert least == pytest.approx(1.923e-3, rel=1e-3)
    assert _reader("rank_step_roofline").read(ctx) == pytest.approx(100 * least / 17.05e-3)
    assert _reader("rank_kernels_roofline").read(ctx) == pytest.approx(100 * least / 15e-3)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_gives_none(name):
    reader = _reader(name)
    assert reader.read(_ctx()) is None
    # the parent's program counts no wire: the counters' fields are missing
    assert reader.read(_ctx(counts={"host_syncs": 9},
                            span_totals={"shard.sync": {"count": 9, "seconds": 0.1,
                                                        "self_seconds": 0.1}})) is None
    # a card with no peaks in the table gives no least time
    assert reader.read(_ctx(device_kind="a card with no peaks", outer_s=0.02, outers=4,
                            kernel_s=0.05, counts={},
                            span_totals={"shard.outer": {"count": 0, "seconds": 0.0,
                                                         "self_seconds": 0.0}})) is None
