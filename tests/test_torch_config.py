"""The port's config and case generators equal the JAX package's exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import sphexample_tpu.config as jc
import sphexample_tpu.io.casegen as jcase
import sphexample_tpu_torch.config as tc
import sphexample_tpu_torch.io.casegen as tcase

torch.set_num_threads(1)


def _plain(obj):
    """Dataclass fields as comparable values (enums by value)."""
    return {k: (v.value if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(obj).items()}


@pytest.mark.parametrize("kwargs", [
    {},
    dict(dx=0.0085, c0=33.14, alpha=0.1, m0=1000 * 0.0085**3, cfl=0.2),
    dict(dx=0.01, c0=88.14487860902641, cfl=0.5, alpha=0.01),
    dict(dx=0.02, c0=30.0, cfl=0.3, g=0.0, gamma=7.0, Cb=123.0),
])
def test_constants_derived(kwargs):
    a, b = jc.SimulationConstants(**kwargs), tc.SimulationConstants(**kwargs)
    assert _plain(a) == _plain(b)
    assert (a.gamma_inv, a.Cb_inv) == (b.gamma_inv, b.Cb_inv)


@pytest.mark.parametrize("family", ["WENDLAND_C2", "CUBIC_SPLINE"])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("size", [dict(dx=0.02), dict(h=float(np.sqrt(3 * 0.0085**2))),
                                  dict(dx=0.02, k=float(np.sqrt(2)))])
def test_make_kernel(family, dims, size):
    a = jc.make_kernel(jc.KernelFamily[family], dims, **size)
    b = tc.make_kernel(tc.KernelFamily[family], dims, **size)
    assert _plain(a) == _plain(b)


def test_kernel_argument_errors():
    for mod in (jc, tc):
        with pytest.raises(ValueError):
            mod.make_kernel(mod.KernelFamily.WENDLAND_C2, 2)
        with pytest.raises(ValueError):
            mod.make_kernel(mod.KernelFamily.WENDLAND_C2, 1, dx=0.1)


def test_enums_and_meta_defaults():
    for name in ("ParticleType", "ShiftingMode", "KernelOutputMode", "MDBCMode",
                 "LogMode", "KernelFamily", "ViscosityModel",
                 "DensityDiffusionModel"):
        ja, ta = getattr(jc, name), getattr(tc, name)
        assert [(m.name, m.value) for m in ja] == [(m.name, m.value) for m in ta]
    a = jc.SimulationMetaData(simulation_name="a", save_location=".")
    b = tc.SimulationMetaData(simulation_name="a", save_location=".")
    shared = set(_plain(b)) & set(_plain(a))
    assert {k: _plain(a)[k] for k in shared} == {k: _plain(b)[k] for k in shared}
    assert shared == set(_plain(b))
    for times in (0.05, (0.1, 0.2, 0.3)):
        ma = jc.SimulationMetaData("a", ".", output_times=times, simulation_time=0.5)
        mb = tc.SimulationMetaData("a", ".", output_times=times, simulation_time=0.5)
        assert [ma.output_time_for(k) for k in range(1, 5)] == \
               [mb.output_time_for(k) for k in range(1, 5)]


@pytest.mark.parametrize("gen,dx", [("dam_break_3d", 0.05), ("dam_break_3d", 0.0085),
                                    ("dam_break_2d", 0.01), ("dam_break_2d", 0.02)])
def test_casegen_identical(gen, dx):
    a = getattr(jcase, gen)(dx)
    b = getattr(tcase, gen)(dx)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    if gen == "dam_break_3d" and dx == 0.0085:
        assert len(b[0]) == 159712
