"""Package rules of the port: no JAX anywhere in it or in chip_smoke.py,
importable with JAX blocked, entry points on the card by default."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sphexample_tpu_torch as T
from sphexample_tpu_torch.core import driver

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sphexample_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "sphexample_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    # exact names or their submodules: sphexample_tpu_torch is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_forbidden_name_matching():
    assert _forbidden("sphexample_tpu") and _forbidden("sphexample_tpu.ops")
    assert _forbidden("jax.numpy") and not _forbidden("sphexample_tpu_torch")
    assert not _forbidden("jaxfoo")


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_the_run_and_its_checkpoints_import_without_h5py():
    """The card may have no h5py: the package, the driver and the
    checkpoints import with it (and JAX) blocked; only the VTKHDF modules
    need it."""
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN + ('h5py',)!r}: sys.modules[m] = None\n"
        "import sphexample_tpu_torch, sphexample_tpu_torch.core.driver\n"
        "import sphexample_tpu_torch.io.checkpoint, sphexample_tpu_torch.utils.validation\n"
        "import sphexample_tpu_torch.utils.logger, sphexample_tpu_torch.utils.timers\n"
        "try:\n"
        "    import sphexample_tpu_torch.io.output\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    importers = sorted(
        p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")
        if any(isinstance(n, ast.Import) and any(a.name == "h5py" for a in n.names)
               for n in ast.walk(ast.parse(p.read_text()))))
    assert importers == ["io/vtkhdf.py"]


def test_sharded_modules_are_among_the_checked():
    """The modules of the sharded path are part of what the two tests above
    walk: they import with JAX blocked and import nothing of the JAX package."""
    mods = _modules()
    for name in ("parallel", "parallel.context", "parallel.mesh", "ops.halo"):
        assert f"sphexample_tpu_torch.{name}" in mods
    from sphexample_tpu_torch.ops import _build

    # importing every module of the package loads no kernel's library
    for name in mods:
        importlib.import_module(name)
    assert not _build._libs


DECKS = ("dam_break_3d", "moving_square_2d", "still_wedge_mdbc",
         "still_wedge_middle_square_mdbc", "dam_break_2d_mdbc", "duckling_mdbc")


def test_the_deck_clis_import_without_jax_or_h5py():
    """The deck CLIs, their runner, the ParaView state file and the neighbor
    list are among the modules the tests above walk, and they import with
    JAX and ``h5py`` blocked (the runner imports the VTKHDF writers only
    when it runs)."""
    new = (["sphexample_tpu_torch.examples", "sphexample_tpu_torch.examples._runner",
            "sphexample_tpu_torch.io.paraview", "sphexample_tpu_torch.ops.neighbor_list"]
           + [f"sphexample_tpu_torch.examples.{d}" for d in DECKS])
    assert set(new) <= set(_modules())
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN + ('h5py',)!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {new!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _tiny():
    meta = T.SimulationMetaData("tiny", ".", dims=2, dtype="float64")
    const = T.SimulationConstants()
    kern = T.make_kernel(T.KernelFamily.WENDLAND_C2, 2, dx=const.dx)
    arrays = (np.zeros((1, 2)), np.array([1000.0]), np.array([1], np.int32),
              np.array([1], np.int32), np.array([1]))
    return arrays, meta, const, kern


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays, meta, const, kern = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.assemble_simulation(*arrays, meta, const, kern, T.ViscosityModel.ZERO,
                              T.DensityDiffusionModel.ZERO)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.resolve_device("cuda:0")
    assert driver.resolve_device("cpu") == torch.device("cpu")
    sim = T.assemble_simulation(*arrays, meta, const, kern, T.ViscosityModel.ZERO,
                                T.DensityDiffusionModel.ZERO, device="cpu")
    assert sim.state.particles.position.device.type == "cpu"


def test_isolated_particle_free_fall():
    """The reference suite's single falling particle (test/runtests.jl:18-75)
    through the port's entry points on the CPU."""
    arrays, meta, const, kern = _tiny()
    sim = T.assemble_simulation(*arrays, meta, const, kern, T.ViscosityModel.ZERO,
                                T.DensityDiffusionModel.ZERO, device="cpu")
    from sphexample_tpu_torch.core.step import make_fixed_steps_fn

    final = make_fixed_steps_fn(sim.cfg, 200)(sim.state)
    p = final.particles
    assert float(p.density[0]) == pytest.approx(const.rho0, abs=1e-10)
    assert float(p.position[0, 0]) == pytest.approx(0.0, abs=1e-12)
    t = float(final.total_time)
    assert float(p.velocity[0, 1]) == pytest.approx(-const.g * t, rel=1e-9)


def test_build_is_lazy():
    """Importing the port builds nothing; the build helpers find the sources."""
    from sphexample_tpu_torch.ops import _build

    assert list(_build.sources()) == ["block_sweep", "cell_sweep", "chunk_graph",
                                      "mdbc_moments", "pack_fields"]
    # a library's name carries its source, the shared headers and the flags
    assert _build._target("mdbc_moments").name.startswith("libmdbc_moments-")
    assert not _build._libs
