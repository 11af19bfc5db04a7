"""Host-side CSV ingestion of DualSPHysics-style particle layouts (port of
``sphexample_tpu/io/csv_io.py``).

Reference: ``src/PreProcess.jl`` - identical column conventions for numerical
parity: particle files carry ``Idp, Points:0..2, Rhop`` (2D takes Points:0 and
Points:2, i.e. the x-z plane, PreProcess.jl:30-34; Idp is shifted +1 to be
1-based, :28); ghost-node files carry ``Normal:0..2, Points:0..2`` with
ghost_point = point + normal (:217-243).

Read by the port's C++ reader (``io/native.py``) where it builds and the
file is one it reads as the csv-module path would, else with the standard
``csv`` module and numpy (no pandas): headers may be quoted and space-padded,
fields may follow their comma with blanks.
"""

from __future__ import annotations

import csv
from typing import Sequence, Tuple

import numpy as np

from ..config import Geometry
from . import native


def read_csv_columns(path: str, columns: Sequence[str]) -> np.ndarray:
    """The named columns of a comma-separated file with one header line, as
    float64 [rows, len(columns)].  Raises ``KeyError`` for a missing column
    and ``ValueError`` for a row that is short or not numeric.  The native
    reader serves where it can (the bits of the csv-module path); on None,
    :func:`read_csv_columns_plain` reads the file.  ``native.calls`` counts
    which served."""
    arr = native.read_csv_columns(path, list(columns))
    if arr is not None:
        native.calls["native"] += 1
        return arr
    native.calls["python"] += 1
    return read_csv_columns_plain(path, columns)


def read_csv_columns_plain(path: str, columns: Sequence[str]) -> np.ndarray:
    """:func:`read_csv_columns` with the standard ``csv`` module alone."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh, skipinitialspace=True)
        header = [c.strip().strip('"').strip() for c in next(reader)]
        missing = [c for c in columns if c not in header]
        if missing:
            raise KeyError(f"{path}: no column {missing} in header {header}")
        idx = [header.index(c) for c in columns]
        rows = []
        for lineno, row in enumerate(reader, start=2):
            if not row:
                continue  # blank line
            try:
                rows.append([float(row[i]) for i in idx])
            except (IndexError, ValueError) as err:
                raise ValueError(f"{path}:{lineno}: {err}") from err
    return np.asarray(rows, dtype=np.float64).reshape(len(rows), len(columns))


def load_particle_csv(path: str, dims: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (points [n, dims], density [n], idp [n])."""
    pt_cols = ["Points:0", "Points:1", "Points:2"] if dims == 3 else ["Points:0", "Points:2"]
    arr = read_csv_columns(path, pt_cols + ["Rhop", "Idp"])
    pts = arr[:, : len(pt_cols)]
    rho = arr[:, len(pt_cols)]
    idp = arr[:, len(pt_cols) + 1].astype(np.int64) + 1
    return pts, rho, idp


def load_geometries(
    geometries: Sequence[Geometry], dims: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate all bodies (reference AllocateDataStructures,
    PreProcess.jl:45-73).  Returns (position, density, ptype, group_marker, idp).
    """
    pos_l, rho_l, typ_l, grp_l, idp_l = [], [], [], [], []
    for geom in geometries:
        pts, rho, idp = load_particle_csv(geom.csv_file, dims)
        pos_l.append(pts)
        rho_l.append(rho)
        typ_l.append(np.full(len(rho), int(geom.type), dtype=np.int32))
        grp_l.append(np.full(len(rho), geom.group_marker, dtype=np.int32))
        idp_l.append(idp)
    return (
        np.concatenate(pos_l),
        np.concatenate(rho_l),
        np.concatenate(typ_l),
        np.concatenate(grp_l),
        np.concatenate(idp_l),
    )


def load_boundary_normals(path: str, dims: int):
    """Returns (points, ghost_points, normals), each [n, dims]
    (reference LoadBoundaryNormals, PreProcess.jl:217-243)."""
    axes = (0, 1, 2) if dims == 3 else (0, 2)
    arr = read_csv_columns(path, [f"Normal:{a}" for a in axes]
                           + [f"Points:{a}" for a in axes])
    nrm, pts = arr[:, : len(axes)], arr[:, len(axes):]
    return pts, pts + nrm, nrm
