"""The port's TPU v1 performance model (``core/perfmodel.py``) and the
quantization helpers it and the paper apps read, against the JAX
package's, on the CPU.

Both models are pure Python on the same constants, so every value must be
exactly the reference's (``==`` on floats); ``bits_speed_factor`` and
``QTensor.dequantize`` likewise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perfmodel as jpm
from repro.core.quant import bits_speed_factor as jbits_speed_factor
from repro.core.quant import dequantize as jdequantize
from repro.core.quant import quantize as jquantize
from repro.core.quant import quantize_weight as jquantize_weight
from repro_torch.core import batching as bt
from repro_torch.core import perfmodel as pm
from repro_torch.core.quant import bits_speed_factor, dequantize, quantize
from repro_torch.core.quant import quantize_weight

APPS = [a.name for a in jpm.PAPER_APPS]


def _as_dict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_hardware_and_apps_are_the_reference_s():
    for name in ("TPU_V1", "TPU_PRIME"):
        a, b = getattr(pm, name), getattr(jpm, name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for prop in ("peak_ops", "bytes_per_cycle", "tile_bytes",
                     "tile_fetch_cycles", "ridge_ops_per_byte"):
            assert getattr(a, prop) == getattr(b, prop), (name, prop)
    assert [a.name for a in pm.PAPER_APPS] == APPS
    for a, b in zip(pm.PAPER_APPS, jpm.PAPER_APPS):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.weight_bytes == b.weight_bytes
        assert a.macs_per_batch == b.macs_per_batch
        assert a.ops_per_weight_byte == b.ops_per_weight_byte
    assert set(pm.APP_BY_NAME) == set(jpm.APP_BY_NAME)


@pytest.mark.parametrize("name", APPS)
def test_simulate_equals_reference(name):
    for hw in ("TPU_V1", "TPU_PRIME"):
        got = pm.simulate(pm.APP_BY_NAME[name], getattr(pm, hw))
        want = jpm.simulate(jpm.APP_BY_NAME[name], getattr(jpm, hw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("active_frac", "stall_frac", "shift_frac",
                     "nonmatrix_frac"):
            assert getattr(got, prop) == getattr(want, prop), prop
    assert (pm.roofline_point(pm.APP_BY_NAME[name])
            == jpm.roofline_point(jpm.APP_BY_NAME[name]))
    assert (pm.unified_buffer_mib(pm.APP_BY_NAME[name])
            == jpm.unified_buffer_mib(jpm.APP_BY_NAME[name]))


@pytest.mark.parametrize("name", APPS)
def test_service_time_sweep_equals_reference(name):
    app, japp = pm.APP_BY_NAME[name], jpm.APP_BY_NAME[name]
    assert pm.service_time(app) == jpm.service_time(japp)
    for b in (1, 2, 7, 8, 16, 32, 64, 100, 128, 200, 250, 256, 1000):
        assert pm.service_time(app, batch=b) == jpm.service_time(japp,
                                                                 batch=b)


def test_sweeps_and_gains_equal_reference():
    assert pm.fig11_sweep() == jpm.fig11_sweep()
    assert pm.fig11_sweep((0.5, 3.0)) == jpm.fig11_sweep((0.5, 3.0))
    assert pm.tpu_prime_gains() == jpm.tpu_prime_gains()
    for hw in ("TPU_V1", "TPU_PRIME"):
        assert (pm.weighted_mean_perf(getattr(pm, hw))
                == jpm.weighted_mean_perf(getattr(jpm, hw)))
    scaled = pm.TPU_V1.scaled(memory=4.0, clock=2.0)
    jscaled = jpm.TPU_V1.scaled(memory=4.0, clock=2.0)
    assert dataclasses.asdict(scaled) == dataclasses.asdict(jscaled)
    assert pm.weighted_mean_perf(scaled) == jpm.weighted_mean_perf(jscaled)


@pytest.mark.parametrize("w_bits", [4, 8, 16])
@pytest.mark.parametrize("a_bits", [4, 8, 16])
def test_bits_speed_factor_equals_reference(w_bits, a_bits):
    assert bits_speed_factor(w_bits, a_bits) == jbits_speed_factor(w_bits,
                                                                   a_bits)


@pytest.mark.parametrize("shape,axis", [((24, 10), (0,)), ((3, 3, 6, 5),
                                                          (2,)),
                                        ((7, 9), None)])
def test_dequantize_equals_reference(shape, axis):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = jdequantize(jquantize(jnp.asarray(x), bits=8, axis=axis))
    q = quantize(torch.from_numpy(x), bits=8, axis=axis)
    np.testing.assert_array_equal(dequantize(q).numpy(), np.asarray(want))
    np.testing.assert_array_equal(q.dequantize(torch.float32).numpy(),
                                  np.asarray(want))


def test_padded_weight_dequantizes_as_the_reference():
    """A weight stored padded for the kernels dequantizes to its logical
    (K, N), equal to the reference's."""
    x = np.random.default_rng(1).standard_normal((37, 18)).astype(np.float32)
    want = jquantize_weight(jnp.asarray(x)).dequantize()
    q = quantize_weight(torch.from_numpy(x))
    assert q.values.shape == (48, 20) and tuple(q.shape) == (37, 18)
    np.testing.assert_array_equal(q.dequantize().numpy(), np.asarray(want))


def test_perfmodel_integration():
    """The port's batching consumes the port's perfmodel service times end
    to end (the reference's ``test_batching.py::
    test_perfmodel_integration``), with the reference's trace."""
    from repro.core import batching as jbt
    app = pm.APP_BY_NAME["MLP0"]
    service = lambda b: pm.service_time(app, batch=b)
    q = bt.BatchQueue(service, max_batch=200)
    reqs = bt.poisson_arrivals(50000, 400, deadline_s=7e-3)
    recs = q.run(reqs)
    assert recs and all(len(r.rids) <= 200 for r in recs)
    jreqs = jbt.poisson_arrivals(50000, 400, deadline_s=7e-3)
    jrecs = jbt.BatchQueue(
        lambda b: jpm.service_time(jpm.APP_BY_NAME["MLP0"], batch=b),
        max_batch=200).run(jreqs)
    assert [r.arrival_s for r in reqs] == [r.arrival_s for r in jreqs]
    assert ([(r.rids, r.start_s, r.finish_s) for r in recs]
            == [(r.rids, r.start_s, r.finish_s) for r in jrecs])
