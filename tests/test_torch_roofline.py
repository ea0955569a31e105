"""The per-level roofline study of the port (``studies.roofline``) against
the JAX package's ``sequitr_tpu.studies.roofline`` on the CPU.

``run(size=64, iters=2, device="cpu")``: the nine stages of the JAX study
(normalize, enc0-enc3, dec2-dec0, head) by name, each row's analytic GFLOP
equal to the JAX row's, the summary's FLOP total the sum of the rows', a
time for every stage and for the whole frame inferrer, and the sliced
chain's labels equal to the ``UNet`` forward's on the same normalized
frame. Times here are the CPU's; the card's table comes from
``chip_smoke.py --phases quant`` and ``python -m
sequitr_tpu_torch.studies.roofline``.
"""

import numpy as np
import pytest
import torch

from sequitr_tpu.studies import roofline as jax_roofline
from sequitr_tpu_torch.studies import roofline


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    torch.set_num_threads(1)
    return roofline.run(size=64, iters=2, device="cpu"), jax_roofline.run(size=64, iters=2)


def test_stages_and_flops_equal_jax(tables):
    (rows, summary), (jrows, jsummary) = tables
    assert len(rows) == 9
    assert [r["stage"] for r in rows] == [r["stage"] for r in jrows]
    assert [r["gflop"] for r in rows] == [r["gflop"] for r in jrows]
    assert summary["gflop"] == jsummary["gflop"]
    assert abs(sum(r["gflop"] for r in rows) - summary["gflop"]) < 0.1
    assert set(jsummary) <= set(summary) and set(jrows[0]) == set(rows[0])


def test_every_stage_is_timed(tables):
    (rows, summary), _ = tables
    assert all(r["ms"] > 0 for r in rows)
    assert summary["fused_ms"] > 0 and summary["device"] == "cpu"
    convs = [r for r in rows if r["gflop"] > 0 and not r["stage"].startswith("head")]
    assert all(r["ceiling_ms"] > 0 for r in convs)


def test_sliced_chain_is_the_forward(tables):
    (_, summary), _ = tables
    assert summary["chain_argmax_agreement"] == 1.0


def test_graph_timer_on_the_cpu_is_a_host_clock():
    calls = []
    t = roofline._rate_graph(lambda x: calls.append(x), (torch.zeros(1),), 5)
    assert len(calls) == 6 and t >= 0
    assert roofline._conv_flops(3, 32, 32, (1024, 1024)) == pytest.approx(19.33e9, rel=1e-3)
    assert np.isclose(roofline._conv_flops(1, 32, 3, (4, 4)), 2 * 32 * 3 * 16)
