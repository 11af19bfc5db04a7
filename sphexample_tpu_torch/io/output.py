"""Output manager: wires the VTKHDF writers into the driver's save callback
(port of ``sphexample_tpu/io/output.py``; imports ``h5py`` through
``io/vtkhdf.py``).

The analog of ``SetupVTKOutput`` (reference ``src/ProduceHDFVTK.jl:461-621``):
returns an object whose ``save`` method pulls the device snapshot (a tuple of
slab states is gathered first) and feeds the particle file, and optionally
the cell-grid debug file, in either single-file transient or multi-file mode.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import SimulationMetaData
from ..state import SimulationState, gather_state
from . import vtkhdf as vh


_VAR_DTYPES = {
    "ChunkID": (vh.ID_T, False),
    "Kernel": (vh.F_T, False),
    "KernelGradient": (vh.F_T, True),
    "Density": (vh.F_T, False),
    "Pressure": (vh.F_T, False),
    "Velocity": (vh.F_T, True),
    "Acceleration": (vh.F_T, True),
    "BoundaryBool": (np.uint8, False),
    "ID": (vh.ID_T, False),
    "Type": (np.int8, False),
    "GroupMarker": (vh.ID_T, False),
    "GhostPoints": (vh.F_T, True),
    "GhostNormals": (vh.F_T, True),
}


class OutputManager:
    def __init__(self, meta: SimulationMetaData, kernel, grid, n_live: int,
                 resume_counter: Optional[int] = None):
        """``resume_counter``: reopen existing transient files in append mode
        and truncate them to the checkpoint's snapshot count (counters 1..c
        are c snapshots) so a resumed run continues the same file."""
        self.meta = meta
        self.kernel = kernel
        self.grid = grid
        self.n_live = n_live
        os.makedirs(meta.save_location, exist_ok=True)
        base = os.path.join(meta.save_location, meta.simulation_name)
        self.base = base
        self.var_specs = {name: _VAR_DTYPES[name] for name in meta.output_variables}

        mode = "a" if resume_counter else "w"
        self.particle_writer: Optional[vh.TransientPolyDataWriter] = None
        self.grid_writer: Optional[vh.TransientGridWriter] = None
        if meta.export_single_vtkhdf:
            self.particle_writer = vh.TransientPolyDataWriter(
                f"{base}.vtkhdf", self.var_specs, mode=mode
            )
            if meta.export_grid_cells:
                self.grid_writer = vh.TransientGridWriter(
                    f"{base}_GridCells.vtkhdf", mode=mode
                )
        if resume_counter:
            if self.particle_writer is not None:
                self.particle_writer.truncate_steps(resume_counter)
            if self.grid_writer is not None:
                self.grid_writer.truncate_steps(resume_counter)

    def save(self, counter: int, state: SimulationState):
        state = gather_state(state)
        n = self.n_live
        t = float(state.total_time)
        pos = np.asarray(vh.host(state.particles.position[:n]), dtype=np.float64)
        pos3 = vh._to_3d(pos)
        data = vh.extract_output_arrays(state, n, self.meta.output_variables)

        if self.meta.export_single_vtkhdf:
            self.particle_writer.append(t, pos3, data)
        else:
            path = f"{self.base}_{counter:06d}.vtkhdf"
            vh.save_polydata_snapshot(path, pos3, data)

        if self.meta.export_grid_cells:
            cells, chunk_ids = self._occupied_cells(state)
            if len(cells):
                if self.grid_writer is not None:
                    self.grid_writer.append(t, self.kernel.H, cells, chunk_ids)
                else:
                    # multi-file grid snapshots (reference SaveCellGridVTKHDF)
                    vh.save_grid_snapshot(
                        f"{self.base}_GridCells_{counter:06d}.vtkhdf",
                        self.kernel.H, cells, chunk_ids,
                    )

    def _occupied_cells(self, state: SimulationState):
        """Occupied-cell coords + the compute block owning each cell's first
        particle (the analog of the reference's per-cell thread id)."""
        cs = vh.host(state.cell_start)
        ncells = self.grid.ncells
        counts = cs[1 : ncells + 1] - cs[:ncells]
        keys = np.nonzero(counts > 0)[0]
        if not len(keys):
            return np.zeros((0, self.grid.dims), dtype=np.int64), np.zeros(0, dtype=np.int64)
        coords = np.empty((len(keys), self.grid.dims), dtype=np.int64)
        rem = keys.copy()
        for d, n in enumerate(self.grid.shape):
            coords[:, d] = rem % n + self.grid.cmin[d]
            rem //= n
        chunk = vh.host(state.particles.chunk_id)[cs[keys]]
        return coords, chunk

    def close(self):
        if self.particle_writer is not None:
            self.particle_writer.close()
        if self.grid_writer is not None:
            self.grid_writer.close()


def make_save_callback(sim, resume_counter: Optional[int] = None):
    """Convenience wrapper: build an :class:`OutputManager` from an assembled
    ``Simulation`` and return a ``save(counter, state)`` callable suitable for
    ``run_simulation(sim, save_callback=...)``.

    The returned callable carries ``.manager`` (the OutputManager) and
    ``.close()``; call ``close()`` after the run to flush the VTKHDF files.
    The reference analog is the ``save_particles`` closure returned by
    ``SetupVTKOutput`` (``src/ProduceHDFVTK.jl:461-621``).
    """
    out = OutputManager(sim.meta, sim.cfg.spec.kernel, sim.cfg.grid, sim.n_live,
                        resume_counter=resume_counter)

    def save(counter: int, state: SimulationState):
        # the grid the snapshot was stepped on: a re-grid replaces sim.cfg
        # (run_simulation drains the asynchronous saver before it does)
        out.grid = sim.cfg.grid
        out.save(counter, state)

    save.manager = out
    save.close = out.close
    return save
