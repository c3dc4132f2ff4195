"""The plain reference against the program's plain CPU path, at tiny
sizes, for every cell's mix and one uneven mix more."""
from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench import spec
from perfbench.tests._tiny import tiny
from perfbench.traffic import Mix

#: a mix with every knob uneven across shards, beside the cells' own
UNEVEN = {"protocol": {"mode": "pfait", "reduction": "nonblocking", "staleness": 4,
                       "margin": 10.0},
          "knobs": {"inner_sweeps": [1, 2, 1, 3], "halo_delay": [0, 1, 0, 2],
                    "contrib_lag": [0, 1, 0, 1]},
          "max_outer": 1000}
CASES = [("convdiff-n1024-p256", "pfait-k4-inner4"), ("convdiff-n1024-p256", "blocking-inner4"),
         ("convdiff-n1024-p256", UNEVEN)]


@pytest.mark.parametrize("config,traffic", CASES)
@pytest.mark.parametrize("index", [0, 1, 3, 6])
def test_reference_follows_the_program(config, traffic, index):
    def read(rel):
        return json.loads((spec.ROOT / "perfbench" / rel).read_text())

    cell = spec.Cell(name="t", chips=1, config=read(f"configs/{config}.json"),
                     traffic=traffic if isinstance(traffic, dict)
                     else read(f"traffic/{traffic}.json"))
    cell.config.update(tiny(cell.config))
    mix = Mix.read(cell.traffic)
    prob = spec.family(cell).Problem(cell.config, mix, 2 ** 33 + 1, "cpu")
    got = prob.runtime(1000)(*prob.inputs(index))
    want = prob.reference(index, 1000)
    assert got.converged and want.converged
    assert got.outer_iters == want.outer
    assert prob.gap(got.x, want.x) < 1e-13
    tr = got.trace[:want.outer].numpy().astype(np.float64)
    assert np.max(np.abs(tr - want.trace) / want.trace) < 1e-6
    assert prob.exact_residual(index, got.x) < prob.eps_tilde
