"""The port's ParaView state file (``io/paraview.py``) against the JAX
package's, byte for byte: 2D and 3D, single-file and multi-file output, a
name with regex characters and a subset of the output variables."""

import pytest

import sphexample_tpu as J
import sphexample_tpu_torch as T
from sphexample_tpu.io.paraview import write_paraview_state as j_write
from sphexample_tpu_torch.io.paraview import write_paraview_state


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("single", [True, False])
@pytest.mark.parametrize("name,variables", [
    ("DamBreak3D", None), ("run(3) v1.2", ("Density", "Velocity", "ID"))])
def test_state_file_is_the_jax_file(tmp_path, dims, single, name, variables):
    paths = []
    for M, write, sub in ((J, j_write, "jax"), (T, write_paraview_state, "port")):
        kw = {} if variables is None else {"output_variables": variables}
        meta = M.SimulationMetaData(name, str(tmp_path / sub), dims=dims,
                                    export_single_vtkhdf=single, **kw)
        paths.append(write(meta))
    jax, port = paths
    assert port.endswith("_SingleVTKHDFStateFile.py" if single else "_StateFile.py")
    text = open(port).read().replace(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert text == open(jax).read()
    compile(text, port, "exec")   # a Python script ParaView can run
