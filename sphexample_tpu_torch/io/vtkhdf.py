"""VTKHDF v2.3 output writers (h5py) with the reference's file layout (a
copy of ``sphexample_tpu/io/vtkhdf.py``; the two functions that read a state
take torch tensors, gathering a tuple of slab states first, and copy each
field to the host once).

Reference: ``src/ProduceHDFVTK.jl``.  Three outputs are supported, matching
``SetupVTKOutput`` (ProduceHDFVTK.jl:461-621):

  * transient single-file PolyData - one ``<name>.vtkhdf`` with a ``Steps``
    group, datasets extended per output (GenerateGeometryStructure :163-214,
    GenerateStepStructure :216-249, AppendVTKHDFData :251-325),
  * multi-file PolyData - one file per output step (SaveVTKHDF :120-160),
  * transient cell-grid debug output - UnstructuredGrid of occupied cells
    (QUAD=9 / HEXAHEDRON=12) with per-cell ids + owning compute block
    (compute_grid_geometry :44-118, AppendVTKHDFGridData :327-414).

Note on axis order: HDF5.jl is column-major, h5py row-major; the on-disk
layouts are identical (Points is (N, 3) on disk in both).

2D runs live in the x-z plane and are padded to 3D as (x, z, 0)
(to_3d!, reference AuxiliaryFunctions.jl:28-34).

This is the only module of the port that imports ``h5py``: the package, the
driver and the checkpoints import without it.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import h5py
import numpy as np

from ..state import gather_state

ID_T = np.int64
F_T = np.float64

VECTOR_VARS = {"KernelGradient", "Velocity", "Acceleration", "GhostPoints", "GhostNormals"}
_CONNECTIVITY_GROUPS = ("Vertices", "Lines", "Polygons", "Strips")


def _ascii_attr(group, name, value: str):
    group.attrs.create(name, np.bytes_(value))


def _to_3d(a: np.ndarray) -> np.ndarray:
    """(x, z) -> (x, z, 0) padding for 2D data (reference to_3d!)."""
    if a.shape[1] == 3:
        return a
    out = np.zeros((a.shape[0], 3), dtype=a.dtype)
    out[:, :2] = a
    return out


def host(t) -> np.ndarray:
    """A tensor's values on the host, as numpy (one copy)."""
    return t.detach().cpu().numpy()


def extract_output_arrays(state, n_live: int, variable_names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Pull the requested per-particle output variables to host, in the
    current (cell-sorted) order, live slots only - the same 13-variable menu
    as the reference (SetupVTKOutput, ProduceHDFVTK.jl:489-504).  A tuple of
    slab states is gathered first."""
    p = gather_state(state).particles
    sl = slice(0, n_live)
    available = {
        "ChunkID": lambda: np.asarray(host(p.chunk_id[sl]), dtype=ID_T),
        "Kernel": lambda: np.asarray(host(p.kernel_w[sl]), dtype=F_T),
        "KernelGradient": lambda: _to_3d(np.asarray(host(p.kernel_grad[sl]), dtype=F_T)),
        "Density": lambda: np.asarray(host(p.density[sl]), dtype=F_T),
        "Pressure": lambda: np.asarray(host(p.pressure[sl]), dtype=F_T),
        "Velocity": lambda: _to_3d(np.asarray(host(p.velocity[sl]), dtype=F_T)),
        "Acceleration": lambda: _to_3d(np.asarray(host(p.acceleration[sl]), dtype=F_T)),
        "BoundaryBool": lambda: np.asarray(host(p.boundary_bool[sl]), dtype=np.uint8),
        "ID": lambda: np.asarray(host(p.id[sl]), dtype=ID_T),
        "Type": lambda: np.asarray(host(p.ptype[sl]), dtype=np.int8),
        "GroupMarker": lambda: np.asarray(host(p.group_marker[sl]), dtype=ID_T),
        "GhostPoints": lambda: _to_3d(np.asarray(host(p.ghost_points[sl]), dtype=F_T)),
        "GhostNormals": lambda: _to_3d(np.asarray(host(p.ghost_normals[sl]), dtype=F_T)),
    }
    return {name: available[name]() for name in variable_names}


def _append(ds, rows: np.ndarray):
    n0 = ds.shape[0]
    ds.resize(n0 + len(rows), axis=0)
    ds[n0:] = rows
    return n0


class TransientPolyDataWriter:
    """Single-file transient particle output (default mode).

    ``mode="a"`` reopens an existing transient file and appends after its
    last snapshot (crash-resume); combine with :meth:`truncate_steps` to drop
    snapshots written after the checkpoint being resumed from.
    """

    def __init__(self, path: str, var_specs: Dict[str, tuple], mode: str = "w"):
        """``var_specs``: ordered {name: (numpy dtype, is_vector)}."""
        self.path = path
        self.variable_names = list(var_specs)
        if mode == "a" and os.path.exists(path):
            self.file = h5py.File(path, "a", locking=False)
            self.root = self.file["VTKHDF"]
            self.steps = self.root["Steps"]
            missing = [n for n in self.variable_names
                       if n not in self.root["PointData"]]
            # extra file variables are just as fatal: append/truncate loop
            # only over variable_names, so a dropped variable's data and
            # offsets would silently stop tracking NSteps (garbage reads)
            extra = [n for n in self.root["PointData"]
                     if n not in self.variable_names]
            if missing or extra:
                raise ValueError(
                    f"cannot append to {path}: output variables "
                    f"{self.variable_names} != file variables "
                    f"{list(self.root['PointData'])} (resume with the same "
                    "output_variables the file was written with)"
                )
            return
        self.file = h5py.File(path, "w", locking=False)
        root = self.file.create_group("VTKHDF")
        self.root = root
        root.attrs.create("Version", np.asarray([2, 3], dtype=np.int32))
        _ascii_attr(root, "Type", "PolyData")

        root.create_dataset("NumberOfPoints", shape=(0,), maxshape=(None,), dtype=ID_T, chunks=True)
        root.create_dataset("Points", shape=(0, 3), maxshape=(None, 3), dtype=F_T, chunks=True)

        for grp_name in _CONNECTIVITY_GROUPS:
            g = root.create_group(grp_name)
            for ds in ("NumberOfConnectivityIds", "NumberOfCells", "Offsets", "Connectivity"):
                g.create_dataset(ds, shape=(0,), maxshape=(None,), dtype=ID_T, chunks=True)

        pdata = root.create_group("PointData")
        for name, (dtype, is_vector) in var_specs.items():
            if is_vector:
                pdata.create_dataset(name, shape=(0, 3), maxshape=(None, 3), dtype=dtype, chunks=True)
            else:
                pdata.create_dataset(name, shape=(0,), maxshape=(None,), dtype=dtype, chunks=True)

        steps = root.create_group("Steps")
        self.steps = steps
        steps.attrs.create("NSteps", np.asarray(0, dtype=np.int32))
        steps.create_dataset("Values", shape=(0,), maxshape=(None,), dtype=F_T, chunks=True)
        for name in ("PartOffsets", "NumberOfParts", "PointOffsets"):
            steps.create_dataset(name, shape=(0,), maxshape=(None,), dtype=ID_T, chunks=True)
        for name in ("CellOffsets", "ConnectivityIdOffsets"):
            steps.create_dataset(name, shape=(0, 4), maxshape=(None, 4), dtype=ID_T, chunks=True)
        pdo = steps.create_group("PointDataOffsets")
        for name in self.variable_names:
            pdo.create_dataset(name, shape=(0,), maxshape=(None,), dtype=ID_T, chunks=True)

    def append(self, time_value: float, points3d: np.ndarray, data: Dict[str, np.ndarray]):
        """AppendVTKHDFData (reference ProduceHDFVTK.jl:251-325)."""
        root, steps = self.root, self.steps
        steps.attrs.modify("NSteps", np.asarray(steps.attrs["NSteps"] + 1, dtype=np.int64))
        _append(steps["Values"], np.asarray([time_value], dtype=F_T))

        start = _append(root["Points"], points3d.astype(F_T))
        _append(steps["PointOffsets"], np.asarray([start], dtype=ID_T))
        _append(root["NumberOfPoints"], np.asarray([len(points3d)], dtype=ID_T))

        npart = steps["PartOffsets"].shape[0]
        _append(steps["PartOffsets"], np.asarray([npart], dtype=ID_T))
        # reference appends NumberOfParts twice per step (:275-277 and
        # :292-294) - an existing-layout quirk ParaView tolerates; we write a
        # single entry per step (one part).
        _append(steps["NumberOfParts"], np.asarray([1], dtype=ID_T))

        _append(steps["CellOffsets"], np.zeros((1, 4), dtype=ID_T))
        _append(steps["ConnectivityIdOffsets"], np.zeros((1, 4), dtype=ID_T))

        for name in self.variable_names:
            _append(steps["PointDataOffsets"][name], np.asarray([start], dtype=ID_T))
            arr = data[name]
            ds = root["PointData"][name]
            _append(ds, arr.astype(ds.dtype))  # scalar [n] and vector [n, 3] alike

        # transient PolyData keeps all topology groups empty (zeros appended,
        # reference :318-324); ParaView renders points via PointGaussian.
        for grp in _CONNECTIVITY_GROUPS:
            for ds in ("NumberOfCells", "NumberOfConnectivityIds", "Offsets", "Connectivity"):
                _append(root[grp][ds], np.zeros(1, dtype=ID_T))

        # flush per snapshot: keeps the file readable mid-run and bounds data
        # loss on a crash to the last interval (the reference only closes
        # files at exit / via CloseHDFVTKManually).
        self.file.flush()

    def truncate_steps(self, n_keep: int):
        """Drop all snapshots after the first ``n_keep`` (resume support)."""
        root, steps = self.root, self.steps
        nsteps = int(steps.attrs["NSteps"])
        if n_keep >= nsteps:
            return
        point_off = np.asarray(steps["PointOffsets"])
        npts = int(point_off[n_keep])  # start of the first dropped step
        root["Points"].resize(npts, axis=0)
        root["NumberOfPoints"].resize(n_keep, axis=0)
        for name in self.variable_names:
            voff = int(np.asarray(steps["PointDataOffsets"][name])[n_keep])
            root["PointData"][name].resize(voff, axis=0)
            steps["PointDataOffsets"][name].resize(n_keep, axis=0)
        for grp in _CONNECTIVITY_GROUPS:
            for ds in ("NumberOfCells", "NumberOfConnectivityIds", "Offsets",
                       "Connectivity"):
                root[grp][ds].resize(n_keep, axis=0)
        for name in ("Values", "PartOffsets", "NumberOfParts", "PointOffsets"):
            steps[name].resize(n_keep, axis=0)
        for name in ("CellOffsets", "ConnectivityIdOffsets"):
            steps[name].resize(n_keep, axis=0)
        steps.attrs.modify("NSteps", np.asarray(n_keep, dtype=np.int64))
        self.file.flush()

    def close(self):
        if self.file:
            self.file.close()
            self.file = None


def read_transient_polydata(path: str, variables: Sequence[str] | None = None,
                            steps: Sequence[int] | None = None):
    """Read back a transient PolyData ``.vtkhdf`` written by
    :class:`TransientPolyDataWriter` (post-processing / validation without
    ParaView).

    Yields ``(time, points, data)`` per step - ``points`` is [n, 3] float64,
    ``data`` maps each requested PointData variable to its per-step slice.
    ``variables=None`` reads every stored variable; ``steps`` selects a subset
    of step indices (default: all).

    Reading while a writer is appending works (per-snapshot flush +
    lock-free open) but is not SWMR: a read racing the in-progress append
    can transiently fail with ``OSError: addr overflow``.  Retry, or
    restrict ``steps`` to all-but-the-last snapshot.
    """
    # locking=False: read-only access must work alongside a live writer and on
    # files whose writer died without clearing the HDF5 in-use superblock mark.
    with h5py.File(path, "r", locking=False) as f:
        root = f["VTKHDF"]
        sgrp = root["Steps"]
        times = np.asarray(sgrp["Values"])
        point_off = np.asarray(sgrp["PointOffsets"])
        n_points = np.asarray(root["NumberOfPoints"])
        pdo = sgrp["PointDataOffsets"]
        names = list(variables) if variables is not None else list(root["PointData"])
        for name in names:
            if name not in root["PointData"]:
                raise KeyError(f"variable {name!r} not stored in {path}")
        idxs = range(len(times)) if steps is None else steps
        for k in idxs:
            s, n = int(point_off[k]), int(n_points[k])
            pts = np.asarray(root["Points"][s : s + n])
            data = {}
            for name in names:
                vs = int(np.asarray(pdo[name])[k])
                data[name] = np.asarray(root["PointData"][name][vs : vs + n])
            yield float(times[k]), pts, data


def save_polydata_snapshot(path: str, points3d: np.ndarray, data: Dict[str, np.ndarray]):
    """Multi-file mode: one PolyData file with real vertex cells
    (reference SaveVTKHDF, ProduceHDFVTK.jl:120-160)."""
    with h5py.File(path, "w", locking=False) as f:
        root = f.create_group("VTKHDF")
        root.attrs.create("Version", np.asarray([2, 3], dtype=np.int32))
        _ascii_attr(root, "Type", "PolyData")
        n = len(points3d)
        root.create_dataset("NumberOfPoints", data=np.asarray([n], dtype=ID_T))
        root.create_dataset("Points", data=points3d.astype(F_T))
        pdata = root.create_group("PointData")
        for name, arr in data.items():
            pdata.create_dataset(name, data=arr)
        g = root.create_group("Vertices")
        g.create_dataset("NumberOfCells", data=np.asarray([n], dtype=ID_T))
        g.create_dataset("NumberOfConnectivityIds", data=np.asarray([n], dtype=ID_T))
        g.create_dataset("Connectivity", data=np.arange(n, dtype=ID_T))
        g.create_dataset("Offsets", data=np.arange(n + 1, dtype=ID_T))
        for name in ("Lines", "Polygons", "Strips"):
            g2 = root.create_group(name)
            g2.create_dataset("NumberOfCells", data=np.asarray([0], dtype=ID_T))
            g2.create_dataset("NumberOfConnectivityIds", data=np.asarray([0], dtype=ID_T))
            g2.create_dataset("Connectivity", data=np.zeros(0, dtype=ID_T))
            g2.create_dataset("Offsets", data=np.asarray([0], dtype=ID_T))


def save_grid_snapshot(path: str, H: float, cells: np.ndarray,
                       chunk_ids: np.ndarray):
    """Multi-file mode: one UnstructuredGrid file of occupied cells
    (reference SaveCellGridVTKHDF, ProduceHDFVTK.jl:330-365).  Owns the
    format beside :func:`save_polydata_snapshot` / the transient writers -
    any VTKHDF layout change happens in this module only."""
    pts3, offsets, vtk_type, ids = compute_grid_geometry(H, cells)
    with h5py.File(path, "w", locking=False) as f:
        root = f.create_group("VTKHDF")
        root.attrs.create("Version", np.asarray([2, 3], dtype=np.int32))
        _ascii_attr(root, "Type", "UnstructuredGrid")
        root.create_dataset("NumberOfPoints",
                            data=np.asarray([len(pts3)], dtype=ID_T))
        root.create_dataset("NumberOfCells",
                            data=np.asarray([len(cells)], dtype=ID_T))
        root.create_dataset("NumberOfConnectivityIds",
                            data=np.asarray([len(pts3)], dtype=ID_T))
        root.create_dataset("Points", data=pts3)
        root.create_dataset("Connectivity",
                            data=np.arange(len(pts3), dtype=ID_T))
        root.create_dataset("Offsets", data=offsets)
        root.create_dataset("Types",
                            data=np.full(len(cells), vtk_type, dtype=np.uint8))
        cg = root.create_group("CellData")
        cg.create_dataset("CellData", data=ids)
        cg.create_dataset("ChunkID", data=chunk_ids.astype(ID_T))
        root.create_group("FieldData")


def compute_grid_geometry(H: float, cells: np.ndarray):
    """Corner points + connectivity for occupied cells
    (reference compute_grid_geometry, ProduceHDFVTK.jl:44-118).

    ``cells``: [n, D] integer cell coords; pitch H per axis.  Returns
    (points3d, offsets, vtk_type, cell_ids).
    """
    n, dims = cells.shape
    lo = cells.min(axis=0)
    nx = cells[:, 0].max() - lo[0] + 1
    if dims == 2:
        vtk_type = np.uint8(9)  # QUAD
        ids = (cells[:, 1] - lo[1]) * nx + (cells[:, 0] - lo[0]) + 1
        centers = cells * H
        h2 = H / 2
        corners = np.array(
            [[-h2, -h2], [h2, -h2], [h2, h2], [-h2, h2]]
        )
        pts = centers[:, None, :] + corners[None, :, :]
        pts3 = np.zeros((n * 4, 3))
        pts3[:, :2] = pts.reshape(-1, 2)
        offsets = np.arange(n + 1, dtype=ID_T) * 4
    else:
        vtk_type = np.uint8(12)  # HEXAHEDRON
        ny = cells[:, 1].max() - lo[1] + 1
        ids = (
            (cells[:, 2] - lo[2]) * (nx * ny)
            + (cells[:, 1] - lo[1]) * nx
            + (cells[:, 0] - lo[0])
            + 1
        )
        centers = cells * H
        h2 = H / 2
        corners = np.array(
            [
                [-h2, -h2, -h2], [h2, -h2, -h2], [h2, h2, -h2], [-h2, h2, -h2],
                [-h2, -h2, h2], [h2, -h2, h2], [h2, h2, h2], [-h2, h2, h2],
            ]
        )
        pts3 = (centers[:, None, :] + corners[None, :, :]).reshape(-1, 3)
        offsets = np.arange(n + 1, dtype=ID_T) * 8
    return pts3, offsets, vtk_type, ids.astype(ID_T)


class TransientGridWriter:
    """Transient UnstructuredGrid cell-list debug output
    (reference AppendVTKHDFGridData, ProduceHDFVTK.jl:327-414)."""

    def __init__(self, path: str, mode: str = "w"):
        if mode == "a" and os.path.exists(path):
            self.file = h5py.File(path, "a", locking=False)
            self.root = self.file["VTKHDF"]
            self.steps = self.root["Steps"]
            return
        self.file = h5py.File(path, "w", locking=False)
        root = self.file.create_group("VTKHDF")
        self.root = root
        root.attrs.create("Version", np.asarray([2, 3], dtype=np.int32))
        _ascii_attr(root, "Type", "UnstructuredGrid")
        for name in ("NumberOfPoints", "NumberOfCells", "NumberOfConnectivityIds",
                     "Connectivity", "Offsets"):
            root.create_dataset(name, shape=(0,), maxshape=(None,), dtype=ID_T, chunks=True)
        root.create_dataset("Types", shape=(0,), maxshape=(None,), dtype=np.uint8, chunks=True)
        root.create_dataset("Points", shape=(0, 3), maxshape=(None, 3), dtype=F_T, chunks=True)
        root.create_group("FieldData")
        cdata = root.create_group("CellData")
        cdata.create_dataset("CellData", shape=(0,), maxshape=(None,), dtype=ID_T, chunks=True)
        cdata.create_dataset("ChunkID", shape=(0,), maxshape=(None,), dtype=ID_T, chunks=True)

        steps = root.create_group("Steps")
        self.steps = steps
        steps.attrs.create("NSteps", np.asarray(0, dtype=np.int32))
        steps.create_dataset("Values", shape=(0,), maxshape=(None,), dtype=F_T, chunks=True)
        for name in ("PartOffsets", "NumberOfParts", "PointOffsets",
                     "CellOffsets", "ConnectivityIdOffsets"):
            steps.create_dataset(name, shape=(0,), maxshape=(None,), dtype=ID_T, chunks=True)
        steps.create_group("PointDataOffsets")

    def append(self, time_value: float, H: float, cells: np.ndarray, chunk_ids: np.ndarray):
        root, steps = self.root, self.steps
        pts3, offsets, vtk_type, cell_ids = compute_grid_geometry(H, cells)
        ncells = len(cells)

        steps.attrs.modify("NSteps", np.asarray(steps.attrs["NSteps"] + 1, dtype=np.int64))
        _append(steps["Values"], np.asarray([time_value], dtype=F_T))

        start = _append(root["Points"], pts3)
        _append(steps["PointOffsets"], np.asarray([start], dtype=ID_T))
        _append(steps["NumberOfParts"], np.asarray([1], dtype=ID_T))
        npart = steps["PartOffsets"].shape[0]
        _append(steps["PartOffsets"], np.asarray([npart], dtype=ID_T))
        _append(steps["ConnectivityIdOffsets"], np.asarray([start], dtype=ID_T))
        _append(root["NumberOfPoints"], np.asarray([len(pts3)], dtype=ID_T))
        prev_cells = int(np.sum(root["NumberOfCells"][:])) if root["NumberOfCells"].shape[0] else 0
        _append(root["NumberOfCells"], np.asarray([ncells], dtype=ID_T))
        _append(root["Connectivity"], np.arange(len(pts3), dtype=ID_T))
        _append(root["NumberOfConnectivityIds"], np.asarray([len(pts3)], dtype=ID_T))
        _append(steps["CellOffsets"], np.asarray([prev_cells], dtype=ID_T))
        _append(root["Offsets"], offsets)
        _append(root["Types"], np.full(ncells, vtk_type, dtype=np.uint8))
        _append(root["CellData"]["CellData"], cell_ids)
        _append(root["CellData"]["ChunkID"], chunk_ids.astype(ID_T))
        self.file.flush()

    def truncate_steps(self, n_keep: int):
        """Drop all snapshots after the first ``n_keep`` (resume support).

        Per-step row counts vary with the occupied-cell count, so lengths are
        reconstructed from the per-step NumberOfCells/NumberOfPoints records.
        """
        root, steps = self.root, self.steps
        nsteps = int(steps.attrs["NSteps"])
        if n_keep >= nsteps:
            return
        n_cells = np.asarray(root["NumberOfCells"])[:n_keep]
        tot_cells = int(n_cells.sum())
        npts = int(np.asarray(steps["PointOffsets"])[n_keep])
        root["Points"].resize(npts, axis=0)
        root["Connectivity"].resize(npts, axis=0)
        # Offsets: each step contributes ncells_j + 1 rows
        root["Offsets"].resize(tot_cells + n_keep, axis=0)
        root["Types"].resize(tot_cells, axis=0)
        root["CellData"]["CellData"].resize(tot_cells, axis=0)
        root["CellData"]["ChunkID"].resize(tot_cells, axis=0)
        for name in ("NumberOfPoints", "NumberOfCells", "NumberOfConnectivityIds"):
            root[name].resize(n_keep, axis=0)
        for name in ("Values", "PartOffsets", "NumberOfParts", "PointOffsets",
                     "CellOffsets", "ConnectivityIdOffsets"):
            steps[name].resize(n_keep, axis=0)
        steps.attrs.modify("NSteps", np.asarray(n_keep, dtype=np.int64))
        self.file.flush()

    def close(self):
        if self.file:
            self.file.close()
            self.file = None


def close_hdf_vtk_manually(directory: str):
    """Crash-recovery sweep over ``.vtkhdf`` files (reference
    CloseHDFVTKManually, AuxiliaryFunctions.jl:42-54): open + close each file
    to flush/validate handles after an aborted run; returns the list of files
    that failed to open (corrupt/truncated)."""
    bad = []
    if not os.path.isdir(directory):
        return bad
    for fn in os.listdir(directory):
        if not fn.endswith(".vtkhdf"):
            continue
        p = os.path.join(directory, fn)
        try:
            with h5py.File(p, "r"):
                pass
        except OSError:
            bad.append(p)
    return bad


def clean_simulation_folder(path: str):
    """Delete stale .vtkhdf outputs (reference CleanUpSimulationFolder,
    AuxiliaryFunctions.jl:61-71)."""
    if not os.path.isdir(path):
        return
    for fn in os.listdir(path):
        if fn.endswith(".vtkhdf"):
            try:
                os.remove(os.path.join(path, fn))
            except OSError:
                pass
