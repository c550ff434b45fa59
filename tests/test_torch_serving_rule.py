"""``chip_smoke.compare_rows``, the serving check of phases 13, 19 and 20,
on synthetic logits: phase 13's rule where the CPU's fp32 forward is
well-conditioned, and the float64 rule where it is not, whose bound the
card's own error cannot widen."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import BINARY_COLUMNS, compare_rows  # noqa: E402

ROW = {c: "0.5" for c in BINARY_COLUMNS[1:]}


def _logits(seed=0, shape=(6, 6, 5)):
    """Float64 logits with every top-2 margin at least 1."""
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((*shape, 2)) * 10.0
    lg[..., 1] = lg[..., 0] + np.where(rng.random(shape) < 0.5, -1.0, 1.0) \
        * (1.0 + rng.random(shape))
    return lg


def _ref64(cpu64, tiles_err=0.0):
    tiles = cpu64[None]
    return (tiles + tiles_err, tiles), cpu64


def test_phase13_rule_without_float64():
    cpu = _logits()
    scale = np.abs(cpu).max()
    out = compare_rows("m", cpu + 0.9e-5 * scale, cpu, ROW, ROW,
                       BINARY_COLUMNS)
    assert out["tol"] == pytest.approx(1e-5 * scale)
    with pytest.raises(AssertionError, match="logits err"):
        compare_rows("m", cpu + 1.1e-5 * scale, cpu, ROW, ROW,
                     BINARY_COLUMNS)


def test_float64_tiles_must_agree():
    cpu64 = _logits()
    scale = np.abs(cpu64).max()
    compare_rows("m", cpu64, cpu64, ROW, ROW, BINARY_COLUMNS,
                 _ref64(cpu64, 0.9e-10 * scale))
    with pytest.raises(AssertionError, match="float64"):
        compare_rows("m", cpu64, cpu64, ROW, ROW, BINARY_COLUMNS,
                     _ref64(cpu64, 1.1e-10 * scale))


def test_well_conditioned_stays_on_phase13_rule():
    """A CPU fp32 distance from float64 under a quarter of 1e-5 of the
    scale leaves phase 13's bound on card vs CPU fp32."""
    cpu64 = _logits()
    scale = np.abs(cpu64).max()
    cpu = cpu64 + 2e-6 * scale
    out = compare_rows("m", cpu + 0.9e-5 * scale, cpu, ROW, ROW,
                       BINARY_COLUMNS, _ref64(cpu64))
    assert not out["float64_rule"]
    with pytest.raises(AssertionError, match="logits err"):
        compare_rows("m", cpu + 1.1e-5 * scale, cpu, ROW, ROW,
                     BINARY_COLUMNS, _ref64(cpu64))


@pytest.mark.parametrize("card_err,passes", [(3.9, True), (4.1, False)])
def test_ill_conditioned_bound_is_the_cpus(card_err, passes):
    """The card's fp32 logits against the CPU's float64 ones within 4×
    the CPU's own fp32 distance: a card error of 4.1× fails, however far
    the card lies from its own float64 forward."""
    cpu64 = _logits()
    scale = np.abs(cpu64).max()
    own = 1e-4 * scale
    cpu = cpu64.copy()
    cpu[0, 0, 0, 0] += own
    card = cpu64.copy()
    card[1, 1, 1, 1] -= card_err * own
    if passes:
        out = compare_rows("m", card, cpu, ROW, ROW, BINARY_COLUMNS,
                           _ref64(cpu64))
        assert out["float64_rule"] and out["tol"] == pytest.approx(4 * own)
    else:
        with pytest.raises(AssertionError, match="logits err"):
            compare_rows("m", card, cpu, ROW, ROW, BINARY_COLUMNS,
                         _ref64(cpu64))


def test_ill_conditioned_flip_needs_a_small_float64_margin():
    cpu64 = _logits()
    scale = np.abs(cpu64).max()
    own = 1e-2 * scale
    cpu = cpu64.copy()
    cpu[0, 0, 0, 0] += own
    card = cpu.copy()
    # a flip at a voxel whose float64 margin is below 2 x tol passes
    v = (2, 2, 2)
    cpu64[v] = [1.0, 1.0 + 0.5 * own]
    cpu[v] = cpu64[v]
    card[v] = [1.0 + own, 1.0]
    out = compare_rows("m", card, cpu, ROW, ROW, BINARY_COLUMNS,
                       _ref64(cpu64))
    assert out["flips"] == 1
    # one whose float64 margin is 9 x own (above 2 x tol) flips only with
    # the card beyond tol of float64: it fails
    cpu64[v] = [1.0, 1.0 + 9 * own]
    cpu[v] = cpu64[v]
    card[v] = [1.0 + 9 * own, 1.0 + 8.9 * own]
    with pytest.raises(AssertionError):
        compare_rows("m", card, cpu, ROW, ROW, BINARY_COLUMNS,
                     _ref64(cpu64))
