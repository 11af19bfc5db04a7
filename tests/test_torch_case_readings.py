"""``sphexample_tpu_torch.utils.validation.case_readings`` against
``tools/analyze_case.py`` itself, on the CPU: the tool (unchanged, run as a
subprocess) reads the VTKHDF that the port writes - from the
``duckling_mdbc`` and ``moving_square_2d`` CLIs on small procedural inputs
(``procedural_decks.py``), and from hand-built states with the failures that
``tests/test_analyze_case.py`` pins for the tool (a spike beyond
``--allow-outliers``, outliers within and beyond the hard band, a NaN, a body
off its track).  At every snapshot its printed rho_min / rho_max / |v|max (2
decimals), NaN count, body error and messages, and its OK / FAIL line, must
be what ``case_readings`` read from the same states."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.utils.validation import CaseReader, case_readings

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import procedural_decks as pd  # noqa: E402

torch.set_num_threads(1)
TINY_TANK = dict(nx=4, ny=4, depth=6, height=8)

TANK_GATES = {
    "band": {"band": (950.0, 1100.0)},
    "tight": {"band": (1000.0, 1000.5)},
    "hard": {"band": (999.9, 1000.5), "allow_outliers": 100000},
}
SQUARE_GATES = {
    "track": {"band": (900.0, 1150.0), "allow_outliers": 2, "track_marker": 3,
              "speed": pd.SQUARE_SPEED},
    "slow": {"band": (900.0, 1150.0), "allow_outliers": 2, "track_marker": 3, "speed": 2.5},
}


def tool_args(gate):
    args = ["--band", *map(repr, gate["band"])]
    if gate.get("allow_outliers"):
        args += ["--allow-outliers", str(gate["allow_outliers"])]
    if gate.get("track_marker") is not None:
        args += ["--track-marker", str(gate["track_marker"]), "--speed", repr(gate["speed"])]
    return args


def analyze_case(path, gate):
    """The tool's exit code, snapshot lines and last line."""
    r = subprocess.run([sys.executable, "tools/analyze_case.py", str(path), *tool_args(gate)],
                       cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    lines = r.stdout.strip().splitlines()
    assert lines, r.stderr
    return r.returncode, lines[1:-1], lines[-1]


def assert_tool_agrees(path, reader, gate):
    """Snapshot by snapshot, the tool's line is what ``reader`` read; its
    verdict is the reader's."""
    rc, rows, verdict = analyze_case(path, gate)
    assert len(rows) == len(reader.readings) > 1
    track = gate.get("track_marker") is not None
    for row, r in zip(rows, reader.readings):
        tok = row.split()
        assert tok[:5] == [f"{r['t']:.3f}", f"{r['rho_min']:.2f}", f"{r['rho_max']:.2f}",
                           f"{r['vmax']:.2f}", str(r["nan"])], (row, r)
        if track:
            assert tok[-1] == f"{r['body_err']:.2e}", (row, r)
        assert ("DENSITY OUT OF BAND" in row) == ("out_of_band" in r["flags"]), (row, r)
        assert ("BEYOND HARD BAND" in row) == ("hard_band" in r["flags"]), (row, r)
        assert ("BODY OFF TRAJECTORY" in row) == ("off_trajectory" in r["flags"]), (row, r)
        assert ("within hard band" in row) == (r["out_band"] > 0 and not {
            "out_of_band", "hard_band"} & set(r["flags"])), (row, r)
        if "DENSITY OUT OF BAND" in row:
            assert f"({r['out_band']} particles)" in row
    assert verdict == ("OK" if reader.bad == 0 else f"FAIL ({reader.bad} bad snapshots)")
    assert rc == (reader.bad > 0)
    return reader


def run_deck(deck, argv, save, gates, monkeypatch):
    """The port's deck CLI with ``--cpu``; a :class:`CaseReader` per gate
    reads every snapshot it saves."""
    from sphexample_tpu_torch.core import driver

    readers = {k: CaseReader(**g) for k, g in gates.items()}
    real = driver.run_simulation

    def run_simulation(sim, save_callback=None, **kw):
        def save(counter, state):
            for reader in readers.values():
                reader(state)
            save_callback(counter, state)

        return real(sim, save_callback=save, **kw)

    monkeypatch.setattr(driver, "run_simulation", run_simulation)
    import importlib

    importlib.import_module(f"sphexample_tpu_torch.examples.{deck}").main(
        ["--cpu", *argv, "--save", str(save)])
    return readers


@pytest.fixture(scope="module")
def tank_run(tmp_path_factory):
    pytest.importorskip("h5py")
    tmp = tmp_path_factory.mktemp("tank")
    pd.write_still_tank(str(tmp / "input"), TINY_TANK)
    with pytest.MonkeyPatch.context() as mp:
        readers = run_deck("duckling_mdbc", ["--input", str(tmp / "input"),
                                             "--max-intervals", "2"],
                           tmp / "out", TANK_GATES, mp)
    return tmp / "out" / "CaseDuckling.vtkhdf", readers


@pytest.fixture(scope="module")
def square_run(tmp_path_factory):
    pytest.importorskip("h5py")
    tmp = tmp_path_factory.mktemp("square")
    dp = pd.SQUARE_DP["coarse"]
    pd.write_moving_square(str(tmp / "input"), dp)
    with pytest.MonkeyPatch.context() as mp:
        readers = run_deck("moving_square_2d", ["--dp", str(dp), "--input", str(tmp / "input"),
                                                "--max-intervals", "3"],
                           tmp / "out", SQUARE_GATES, mp)
    return tmp / "out" / "MovingSquare2D.vtkhdf", readers


@pytest.mark.parametrize("name", sorted(TANK_GATES))
def test_tank_cli_output_reads_as_the_tool_reads_it(tank_run, name):
    """The duckling_mdbc CLI on a small still tank (mDBC, 3D), 3 snapshots:
    the analyzer gate's band reads OK; a band tighter than the hydrostatic
    column fails, out of band and (with the outliers allowed) beyond the
    hard band."""
    path, readers = tank_run
    reader = assert_tool_agrees(path, readers[name], TANK_GATES[name])
    assert (reader.bad == 0) == (name == "band")
    if name != "band":
        assert {"tight": "out_of_band", "hard": "hard_band"}[name] in reader.readings[0]["flags"]


@pytest.mark.parametrize("name", sorted(SQUARE_GATES))
def test_square_cli_output_reads_as_the_tool_reads_it(square_run, name):
    """The moving_square_2d CLI on the coarse box, 4 snapshots, the square
    tracked: on its 2.8 m/s track it reads OK; held to 2.5 m/s it is off its
    trajectory from the second snapshot on."""
    path, readers = square_run
    reader = assert_tool_agrees(path, readers[name], SQUARE_GATES[name])
    if name == "track":
        assert reader.bad == 0 and 0 < reader.readings[-1]["body_err"] < 1e-3
    else:
        assert [r["flags"] for r in reader.readings[1:]] == [["off_trajectory"]] * 3


# --- hand-built states: tests/test_analyze_case.py's cases ------------------------

def _square_sim(tmp_path):
    """The moving square at dp 0.5 (420 rows, a 2 x 2 square), with its
    output going to ``tmp_path``."""
    case = pd.moving_square(0.5)
    arrays = pd.moving_square_arrays(case)
    const = T.SimulationConstants(dx=0.5, c0=28.0, g=0.0)
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=0.5)
    meta = T.SimulationMetaData(simulation_name="Hand", save_location=str(tmp_path), dims=2)
    geoms = (T.Geometry("", 1, T.ParticleType.FIXED), T.Geometry("", 2, T.ParticleType.FLUID),
             T.Geometry("", 3, T.ParticleType.MOVING,
                        T.MotionDetails(velocity=0.5, start_time=0.0, duration=1e3,
                                        direction=(1.0, 0.0))))
    return T.assemble_simulation(*arrays, meta, const, kern, T.ViscosityModel.ARTIFICIAL,
                                 T.DensityDiffusionModel.LINEAR, geometries=geoms,
                                 device="cpu")


def _states(sim, speed=0.5, spike=None, nan_at=None, nsteps=4, dt=0.1):
    """tests/test_analyze_case.py:_write_deck's series on the port's state:
    the body advancing at ``speed`` along x, ``spike`` = (step, count, value)
    fluid densities at one step, one NaN position at step ``nan_at``."""
    p = sim.state.particles
    fluid = torch.nonzero(p.ptype == int(T.ParticleType.FLUID)).flatten()
    body = (p.ptype == int(T.ParticleType.MOVING))[:, None]
    for k in range(nsteps):
        t = dt * k
        pos = torch.where(body, p.position + torch.tensor([speed * t, 0.0]), p.position)
        rho = torch.full_like(p.density, 1000.0)
        if spike is not None and spike[0] == k:
            rho[fluid[: spike[1]]] = spike[2]
        if nan_at == k:
            pos[fluid[0], 0] = float("nan")
        yield sim.state.replace(particles=p.replace(position=pos, density=rho),
                                total_time=torch.tensor(t, dtype=sim.state.total_time.dtype))


HAND = {  # tests/test_analyze_case.py: series, tool arguments, whether it passes
    "clean": ({}, {"band": (950.0, 1050.0)}, True),
    "nan": ({"nan_at": 2}, {"band": (950.0, 1050.0)}, False),
    "spike": ({"spike": (1, 5, 1100.0)}, {"band": (950.0, 1050.0)}, False),
    "two_outliers": ({"spike": (1, 2, 1060.0)},
                     {"band": (950.0, 1050.0), "allow_outliers": 2}, True),
    "three_outliers": ({"spike": (1, 3, 1060.0)},
                       {"band": (950.0, 1050.0), "allow_outliers": 2}, False),
    "beyond_hard_band": ({"spike": (1, 1, 1300.0)},
                         {"band": (950.0, 1050.0), "allow_outliers": 2}, False),
    "on_track": ({}, {"band": (950.0, 1050.0), "track_marker": 3, "speed": 0.5}, True),
    "off_track": ({}, {"band": (950.0, 1050.0), "track_marker": 3, "speed": 0.7}, False),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_built_verdicts_agree_with_the_tool(tmp_path, name):
    """Each series through the port's VTKHDF writer and the tool: the tool's
    lines and verdict are ``case_readings``'s, and the verdict is the one
    tests/test_analyze_case.py pins."""
    pytest.importorskip("h5py")
    from sphexample_tpu_torch.io.output import make_save_callback

    series, gate, passes = HAND[name]
    sim = _square_sim(tmp_path)
    save = make_save_callback(sim)
    reader = CaseReader(**gate)
    for counter, state in enumerate(_states(sim, **series), start=1):
        save(counter, state)
        reader(state)
    save.close()
    assert_tool_agrees(tmp_path / "Hand.vtkhdf", reader, gate)
    assert (reader.bad == 0) == passes
    flags = {f for r in reader.readings for f in r["flags"]}
    assert flags == {"nan": {"nan"}, "spike": {"out_of_band"}, "three_outliers": {"out_of_band"},
                     "beyond_hard_band": {"hard_band"},
                     "off_track": {"off_trajectory"}}.get(name, set())


def test_origin_argument_and_reader_agree(tmp_path):
    """``case_readings(origin=...)`` with the first snapshot's body position
    and time reads what :class:`CaseReader` reads; without an origin the
    body error is 0; ``nonfinite`` counts a NaN that ``nan`` counts too."""
    sim = _square_sim(tmp_path)
    gate = {"band": (950.0, 1050.0), "track_marker": 3, "speed": 0.6}
    states = list(_states(sim, nan_at=3))
    reader = CaseReader(**gate)
    for s in states:
        reader(s)
    first = case_readings(states[0], **gate)
    assert first["body_err"] == 0.0 and reader.origin == (first["x_body"], first["t"])
    for s, r in zip(states[1:], reader.readings[1:]):
        assert case_readings(s, origin=reader.origin, **gate) == r
    assert reader.readings[2]["body_err"] == pytest.approx(0.1 * 2 * 0.1, rel=1e-5)
    assert reader.readings[3]["nan"] == 1 and reader.readings[3]["nonfinite"] == 1
    assert reader.bad == sum(r["bad"] for r in reader.readings) == 4
    assert np.isfinite(reader.readings[0]["vmax"])
