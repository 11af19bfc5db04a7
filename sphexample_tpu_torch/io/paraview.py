"""ParaView 5.12 state-file generator (a copy of
``sphexample_tpu/io/paraview.py``; the file it writes is the JAX package's,
byte for byte).

Python analog of ``AutoOpenParaview`` (reference
``src/OpenExternalPrograms.jl:65-186``): writes a ``.py`` state file that
loads the run's VTKHDF output with a PointGaussian representation colored by
Density.  Auto-launching ParaView/editors is deliberately not replicated.
"""

from __future__ import annotations

import os

from ..config import SimulationMetaData

_TEMPLATE = '''# import regex library
import re

# state file generated for paraview version 5.12
import paraview
paraview.compatibility.major = 5
paraview.compatibility.minor = 12

# Directory containing the .vtkhdf files
directory = {directory!r}

import os
regex = {regex!r}
file_list = [os.path.join(directory, f) for f in os.listdir(directory) if re.search(regex, f)]

from paraview.simple import *
paraview.simple._DisableFirstRenderCameraReset()

materialLibrary1 = GetMaterialLibrary()
renderView1 = CreateView('RenderView')
renderView1.AxesGrid.Visibility = 1
renderView1.InteractionMode = {view_dim!r}
SetActiveView(None)

layout1 = CreateLayout(name='Layout #1')
layout1.AssignView(0, renderView1)
SetActiveView(renderView1)

Simulation_vtkhdf = VTKHDFReader(registrationName={reg_name!r}, FileName=file_list)
Simulation_vtkhdf.PointArrayStatus = {point_arrays}

Simulation_vtkhdfDisplay = Show(Simulation_vtkhdf, renderView1, 'GeometryRepresentation')
Simulation_vtkhdfDisplay.SetRepresentationType({representation!r})
Simulation_vtkhdfDisplay.Position = [0.0, 0.0, 0.0]
ColorBy(Simulation_vtkhdfDisplay, ('POINTS', {color_variable!r}))
Simulation_vtkhdfDisplay.RescaleTransferFunctionToDataRange(True, False)
Simulation_vtkhdfDisplay.SetScalarBarVisibility(renderView1, True)
renderView1.ResetCamera()
Render()
'''


def write_paraview_state(
    meta: SimulationMetaData,
    representation: str = "Point Gaussian",
    color_variable: str = "Density",
) -> str:
    """Write the state file next to the outputs; returns its path."""
    import re as _re

    base = os.path.join(meta.save_location, meta.simulation_name)
    # the name is interpolated into a regex inside the generated script:
    # escape it (names like "run(3)" or "v1.2" would match nothing or crash)
    name_re = _re.escape(meta.simulation_name)
    if meta.export_single_vtkhdf:
        path = base + "_SingleVTKHDFStateFile.py"
        regex = f"^{name_re}\\.vtkhdf$"
    else:
        path = base + "_StateFile.py"
        regex = f"^{name_re}_(\\d+)\\.vtk"

    content = _TEMPLATE.format(
        directory=meta.save_location,
        regex=regex,
        view_dim="2D" if meta.dims == 2 else "3D",
        reg_name=f"{meta.simulation_name}.vtkhdf*",
        point_arrays=list(meta.output_variables),
        representation=representation,
        color_variable=color_variable,
    )
    os.makedirs(meta.save_location, exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
    return path
