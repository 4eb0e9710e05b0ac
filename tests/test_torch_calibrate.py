"""Port parity: calibration statistics against the JAX package's, on the CPU.

The same numpy data goes through both packages' `CalibrationData`,
`QuantileSketch` and `AdaptiveQuantizer`; every statistic, parameter and
quantized level must be equal, and the documented values of DESIGN.md
("Behavior defined fresh" #1) must hold.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_llm_rs_tpu.quant import calibrate as jc
from diffusion_llm_rs_tpu_torch.quant import calibrate as tc


def _params(cal, bits, symmetric):
    return dataclasses.asdict(cal.compute_params(bits, symmetric))


def test_documented_values_eight_bit_asymmetric():
    """8-bit asymmetric over [1..6]: scale 6/255, zero point -43."""
    cal = tc.CalibrationData()
    cal.update(torch.arange(1, 7, dtype=torch.float32))
    p = cal.compute_params(8, symmetric=False)
    assert p.scale == pytest.approx(6.0 / 255.0, rel=1e-6)
    assert p.zero_point == -43
    assert cal.total_samples == 6 and cal.histogram.sum() == 6


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("symmetric", [True, False])
def test_calibration_data_matches_jax(bits, symmetric):
    """Three batches of different ranges (each re-binned against the running
    range), per-channel stats, then the parameters."""
    rng = np.random.default_rng(bits + 10 * symmetric)
    batches = [rng.normal(0.5, s, size=(64, 8)).astype(np.float32)
               for s in (1.0, 3.0, 0.5)]
    j, t = jc.CalibrationData(per_channel=True), tc.CalibrationData(
        per_channel=True)
    for c, b in enumerate(batches):
        j.update(jnp.asarray(b), channel=c % 2)
        t.update(torch.from_numpy(b), channel=c % 2)
    assert (t.min, t.max, t.total_samples) == (j.min, j.max, j.total_samples)
    np.testing.assert_array_equal(t.histogram, j.histogram)
    assert t.get_per_channel_stats() == j.get_per_channel_stats()
    assert _params(t, bits, symmetric) == _params(j, bits, symmetric)


def test_calibration_edge_cases_match_jax():
    for cls in (jc.CalibrationData, tc.CalibrationData):
        with pytest.raises(ValueError):
            cls().compute_params(8, False)
    for data in (np.zeros(5, np.float32), np.full(4, -2.5, np.float32)):
        j, t = jc.CalibrationData(), tc.CalibrationData()
        j.update(jnp.asarray(data))
        t.update(torch.from_numpy(data))
        np.testing.assert_array_equal(t.histogram, j.histogram)
        for sym in (True, False):
            assert _params(t, 4, sym) == _params(j, 4, sym)


@pytest.mark.parametrize("eps", [0.01, 0.05])
def test_quantile_sketch_matches_jax(eps):
    rng = np.random.default_rng(7)
    j, t = jc.QuantileSketch(eps), tc.QuantileSketch(eps)
    for _ in range(5):
        d = rng.standard_normal(1000).astype(np.float32) * rng.random() * 4
        j.insert(jnp.asarray(d))
        t.insert(torch.from_numpy(d))
    assert t.count == j.count
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0):
        assert t.query(q) == j.query(q)
    with pytest.raises(ValueError):
        tc.QuantileSketch().query(0.5)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("clip", [0.0, 0.02])
def test_adaptive_quantizer_matches_jax(bits, clip):
    rng = np.random.default_rng(bits)
    data = (rng.standard_normal((32, 16)) * 2 + 0.7).astype(np.float32)
    j = jc.AdaptiveQuantizer(bits, clip_quantile=clip)
    t = tc.AdaptiveQuantizer(bits, clip_quantile=clip)
    assert t.compute_params() == j.compute_params() == (
        1.0 / ((1 << bits) - 1), 0.0)  # an empty sketch's defaults
    j.update_stats(jnp.asarray(data))
    t.update_stats(torch.from_numpy(data))
    assert t.compute_params() == j.compute_params()
    jq, js, jz = j.quantize(jnp.asarray(data))
    tq, ts, tz = t.quantize(torch.from_numpy(data))
    assert (ts, tz) == (js, jz) and tq.dtype == torch.uint8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
