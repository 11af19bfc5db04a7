"""The port's logger and validation helpers on the CPU: the log file's
lines, ``check_determinism`` through the plain block and cell sweeps, and
``compare_states`` matching rows by particle id (against the JAX
package's)."""

import pytest
import torch

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.utils.validation import compare_states as j_compare
from sphexample_tpu_torch.core.step import make_fixed_steps_fn
from sphexample_tpu_torch.state import split_state
from sphexample_tpu_torch.utils.logger import SimulationLogger, torch_devices
from sphexample_tpu_torch.utils.validation import check_determinism, compare_states
from test_torch_driver import tiny

torch.set_num_threads(1)


def _tiny(M=T, **meta_kw):
    return tiny(M, capacity=96 if M is T else None, **meta_kw)


def test_logger_writes_the_run(tmp_path):
    sim = _tiny()
    log = SimulationLogger(str(tmp_path), to_console=False)
    log.initialize(sim.meta, sim.cfg.spec.constants, sim.cfg.spec.kernel,
                   T.ViscosityModel.ARTIFICIAL, T.DensityDiffusionModel.LINEAR,
                   [T.Geometry("fluid.csv", 1, T.ParticleType.FLUID)], sim.n_live)
    infos = []
    T.run_simulation(sim, log_callback=infos.append, max_intervals=2)
    for info in infos:
        log.log_step(info, sim.meta.simulation_time)
    log.log_final(split_state(sim.state, [torch.device("cpu")] * 2),
                  timesteps=[i["dt"] for i in infos])
    log.close()
    text = (tmp_path / "SimulationLog.log").read_text()
    assert f"torch {torch.__version__}; devices: {torch_devices()}" in text
    assert "jax" not in text
    assert "geometry: marker=1 type=FLUID csv=fluid.csv" in text
    assert "total particles: 78" in text
    assert "Part     2 |" in text and "Part     3 |" in text
    assert f"in {infos[-1]['iteration']} steps" in text and "dt stats" in text
    assert torch_devices() == (["cpu"] if not torch.cuda.is_available() else
                               [torch.cuda.get_device_name(i)
                                for i in range(torch.cuda.device_count())])


@pytest.mark.parametrize("block_sweep", [True, False])
def test_determinism_on_the_cpu(block_sweep):
    """The plain sweeps sum through ``index_add_``: single-threaded on the CPU
    two runs give the same bits (nothing in PyTorch promises it; the card's
    kernels are held to it in tests/test_torch_cuda.py)."""
    sim = _tiny(block_sweep=block_sweep)
    assert sim.cfg.sweep_kernel == ("block" if block_sweep else "cell")
    assert check_determinism(sim, n_steps=5)


def test_determinism_sees_a_difference(monkeypatch):
    sim = _tiny()
    from sphexample_tpu_torch.core import step

    calls = []
    real = step.sph_step

    def noisy(cfg, state, dx):
        out, dx = real(cfg, state, dx)
        calls.append(1)
        if len(calls) == 7:  # the second run's second step
            p = out.particles
            out = out.replace(particles=p.replace(density=p.density + 1e-12))
        return out, dx

    monkeypatch.setattr(step, "sph_step", noisy)
    assert not check_determinism(sim, n_steps=5)
    with pytest.raises(ValueError, match="single-device"):
        from sphexample_tpu_torch.parallel.mesh import make_mesh, shard_simulation

        check_determinism(shard_simulation(_tiny(), make_mesh(2, "cpu")))


def test_compare_states_matches_by_id():
    sim = _tiny()
    a = make_fixed_steps_fn(sim.cfg, 8)(sim.state)
    b = make_fixed_steps_fn(sim.cfg, 9)(sim.state)
    # the same state in another row order compares equal
    perm = torch.randperm(a.particles.capacity, generator=torch.Generator().manual_seed(0))
    shuffled = a.replace(particles=a.particles.permute(perm))
    assert compare_states(shuffled, a, sim.n_live) == {
        "position": 0.0, "velocity": 0.0, "density": 0.0, "pressure": 0.0}
    assert compare_states(split_state(a, [torch.device("cpu")] * 4), shuffled,
                          sim.n_live)["density"] == 0.0
    got = compare_states(a, b, sim.n_live)
    assert all(v > 0 for v in got.values())

    # the JAX function on the same two states
    import dataclasses

    def jax_state(s):
        sj = _tiny(J)
        import jax.numpy as jnp

        p = sj.state.particles
        fields = {f.name: jnp.asarray(getattr(s.particles, f.name)[:sim.n_live].numpy())
                  for f in dataclasses.fields(p)}
        return sj.state.replace(particles=p.replace(**fields))

    want = j_compare(jax_state(a), jax_state(b), sim.n_live)
    assert got == pytest.approx(want, rel=1e-12)
