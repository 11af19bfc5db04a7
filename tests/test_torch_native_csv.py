"""The port's C++ CSV reader (``io/native.py`` + ``csrc/fastcsv.cpp``) against
the JAX package's native reader and the port's csv-module path, bit for bit,
on synthetic DualSPHysics-style files written from a numpy seed."""

import os
import re

import numpy as np
import pytest

from sphexample_tpu.io import csv_io as jcsv
from sphexample_tpu.io import native as jnative
from sphexample_tpu_torch.io import csv_io as tcsv
from sphexample_tpu_torch.io import native

pytestmark = pytest.mark.skipif(native._compiler() is None,
                                reason="no host C++ compiler: the csv-module path serves")

COLS = {2: ["Points:0", "Points:2", "Rhop", "Idp"],
        3: ["Points:0", "Points:1", "Points:2", "Rhop", "Idp"]}


def _values(rng, n):
    """Columns Idp, Points:0..2, Rhop, Vel:0: negatives, exponents both ways,
    IDs up to 2^53 - 1 (exact in float64)."""
    idp = np.arange(n, dtype=np.int64)
    idp[-3:] = [2**52 + 1, 2**53 - 2, 2**53 - 1][: min(3, n)]
    pts = rng.uniform(-1.0, 2.0, (n, 3)) * 10.0 ** rng.integers(-7, 4, (n, 1))
    rho = rng.uniform(980.0, 1020.0, n)
    vel = rng.standard_normal(n) * 1e-12
    return idp, pts, rho, vel


def _write(path, n, style, seed=0):
    """``style``: plain | quoted (quoted, space-padded header, blanks after
    the commas, another column order) | crlf (CRLF line ends, blank last
    line) | exp (every value in exponent form, explicit signs)."""
    idp, pts, rho, vel = (a.tolist() for a in _values(np.random.default_rng(seed), n))
    eol = "\r\n" if style == "crlf" else "\n"
    if style == "quoted":
        head = '"Idp" , "Rhop" , "Type" , "Points:0" , "Points:1" , "Points:2"'
        rows = (f"{i}, {r!r}, 0, {p[0]!r}, {p[1]!r}, {p[2]!r}"
                for i, r, p in zip(idp, rho, pts))
    elif style == "exp":
        head = "Points:0,Points:1,Points:2,Idp,Vel:0,Rhop"
        rows = (f"{p[0]:+.16e},{p[1]:+.16e},{p[2]:+.16e},{float(i):e},{v:+.3E},{r:+.12e}"
                for i, r, p, v in zip(idp[:-3], rho, pts, vel))
    else:
        head = "Points:0,Points:1,Points:2,Idp,Vel:0,Rhop"
        rows = (f"{p[0]!r},{p[1]!r},{p[2]!r},{i},{v!r},{r!r}"
                for i, r, p, v in zip(idp, rho, pts, vel))
    with open(path, "w", newline="") as fh:
        fh.write(head + eol)
        for row in rows:
            fh.write(row + eol)
        if style == "crlf":
            fh.write(eol)


def _three(path, cols):
    a = native.read_csv_columns(path, cols)
    b = jnative.read_csv_columns(path, cols)
    c = tcsv.read_csv_columns_plain(path, cols)
    return a, b, c


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("style", ["plain", "quoted", "crlf", "exp"])
def test_three_readers_agree_bit_for_bit(tmp_path, dims, style):
    path = str(tmp_path / f"{style}.csv")
    _write(path, 257, style, seed=dims)
    a, b, c = _three(path, COLS[dims])
    assert a is not None and b is not None
    assert a.dtype == b.dtype == c.dtype == np.float64
    assert a.shape == c.shape == (257 - 3 * (style == "exp"), len(COLS[dims]))
    np.testing.assert_array_equal(a.view(np.int64), c.view(np.int64))
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))
    # the IDs stay exact, the loaders agree with the JAX package's
    if style != "exp":
        assert int(a[-1, -1]) == 2**53 - 1
    before = dict(native.calls)
    for x, y in zip(tcsv.load_particle_csv(path, dims), jcsv.load_particle_csv(path, dims)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert native.calls["native"] == before["native"] + 1
    assert native.calls["python"] == before["python"]


def test_fifty_thousand_rows(tmp_path):
    path = str(tmp_path / "big.csv")
    _write(path, 50_000, "plain", seed=7)
    a, b, c = _three(path, COLS[3] + ["Vel:0"])
    assert a.shape == (50_000, 6)
    np.testing.assert_array_equal(a.view(np.int64), c.view(np.int64))
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


def test_ghost_normal_reader_takes_the_native_path(tmp_path):
    rng = np.random.default_rng(3)
    nrm, pts = rng.standard_normal((40, 3)) * 1e-3, rng.uniform(0, 1, (40, 3))
    path = tmp_path / "normals.csv"
    with open(path, "w") as fh:
        fh.write('"Normal:0" , "Normal:1" , "Normal:2" , "Points:0" , "Points:1" , '
                 '"Points:2"\n')
        for n, p in zip(nrm, pts):
            fh.write(", ".join(repr(float(v)) for v in (*n, *p)) + "\n")
    before = dict(native.calls)
    got = tcsv.load_boundary_normals(str(path), 3)
    assert native.calls["native"] == before["native"] + 1
    np.testing.assert_array_equal(got[0], pts)
    np.testing.assert_array_equal(got[2], nrm)
    np.testing.assert_array_equal(got[1], pts + nrm)


def test_missing_column(tmp_path):
    path = str(tmp_path / "plain.csv")
    _write(path, 5, "plain")
    assert native.read_csv_columns(path, ["Points:0", "NotAColumn"]) is None
    assert jnative.read_csv_columns(path, ["Points:0", "NotAColumn"]) is None
    before = dict(native.calls)
    with pytest.raises(KeyError, match="NotAColumn"):
        tcsv.read_csv_columns(path, ["Points:0", "NotAColumn"])
    assert native.calls["python"] == before["python"] + 1


# rows the csv-module path must judge: the native reader declines them and
# that path raises its error, naming the file and line
MALFORMED = {
    "short_row": "A,B,C\n1,2,3\n4\n7,8,9\n",
    "empty_field": "A,B,C\n1,2,3\n4,,6\n",
    "empty_last_field": "A,B,C\n1,2,3\n4,5,\n6,7,8\n",
    "not_numeric": "A,B,C\n1,2,3\n4,x5,6\n",
    "trailing_text": "A,B,C\n1,2,3\n4,5abc,6\n",
    "blank_only_line": "A,B,C\n1,2,3\n   \n7,8,9\n",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_rows_go_to_the_csv_module_path(tmp_path, name):
    path = tmp_path / f"{name}.csv"
    path.write_text(MALFORMED[name])
    assert native.read_csv_columns(str(path), ["A", "B", "C"]) is None
    with pytest.raises(ValueError, match=re.escape(f"{name}.csv:3")):
        tcsv.read_csv_columns(str(path), ["A", "B", "C"])


@pytest.mark.parametrize("name,text,jax_rows", [
    ("short_row", MALFORMED["short_row"], [[1, 2, 3], [4, 0, 0], [7, 8, 9]]),
    ("empty_last_field", MALFORMED["empty_last_field"], [[1, 2, 3], [4, 5, 0], [6, 7, 8]]),
    ("quoted_field", 'A,B,C\n1,"2.5",3\n', [[1, 0, 3]]),
])
def test_where_the_jax_reader_reads_zeros(tmp_path, name, text, jax_rows):
    """The JAX native reader puts 0.0 where a row is short, a field empty or
    quoted (``tests/test_native_csv.py`` pins the short row); the port's
    reader declines such files, and its csv-module path raises or reads the
    quoted value."""
    path = tmp_path / f"{name}.csv"
    path.write_text(text)
    np.testing.assert_array_equal(jnative.read_csv_columns(str(path), ["A", "B", "C"]),
                                  jax_rows)
    assert native.read_csv_columns(str(path), ["A", "B", "C"]) is None
    if name == "quoted_field":
        np.testing.assert_array_equal(tcsv.read_csv_columns(str(path), ["A", "B", "C"]),
                                      [[1, 2.5, 3]])
    else:
        with pytest.raises(ValueError):
            tcsv.read_csv_columns(str(path), ["A", "B", "C"])


@pytest.mark.parametrize("body", ["1,2.5,nan\n", "1,2_5,3\n", "1,inf,3\n"])
def test_values_only_python_reads_are_left_to_it(tmp_path, body):
    """nan / inf and underscores: the csv-module path reads them (Python's
    float), the native reader declines the file."""
    path = tmp_path / "odd.csv"
    path.write_text("A,B,C\n" + body)
    assert native.read_csv_columns(str(path), ["A", "B", "C"]) is None
    got = tcsv.read_csv_columns(str(path), ["A", "B", "C"])
    want = [[float(v) for v in body.strip().split(",")]]
    np.testing.assert_array_equal(got, want)


def test_long_header_grows_the_buffer(tmp_path):
    """A header past the 64 KiB names buffer: the port grows it (the JAX
    binding gives up and falls back)."""
    names = [f"Column_{'x' * 40}_{k}" for k in range(2000)]
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((3, len(names)))
    path = tmp_path / "wide.csv"
    with open(path, "w") as fh:
        fh.write(",".join(names) + "\n")
        for row in vals:
            fh.write(",".join(repr(float(v)) for v in row) + "\n")
    assert len(",".join(names)) > native.HEADER_BYTES
    cols = [names[0], names[1234], names[-1]]
    a = native.read_csv_columns(str(path), cols)
    assert a is not None and jnative.read_csv_columns(str(path), cols) is None
    np.testing.assert_array_equal(a, vals[:, [0, 1234, len(names) - 1]])
    np.testing.assert_array_equal(a, tcsv.read_csv_columns_plain(str(path), cols))


def test_header_only_and_no_final_newline(tmp_path):
    head = tmp_path / "head.csv"
    head.write_text("A,B\n")
    assert native.read_csv_columns(str(head), ["B"]).shape == (0, 1)
    assert tcsv.read_csv_columns_plain(str(head), ["B"]).shape == (0, 1)
    last = tmp_path / "last.csv"
    last.write_text("A,B\n1,2\n3,4")
    np.testing.assert_array_equal(native.read_csv_columns(str(last), ["B", "A"]),
                                  [[2, 1], [4, 3]])


def test_the_library_is_built_into_the_ignored_build_directory():
    assert native.get_lib() is not None, native.build_error
    out = native.target()
    assert out.parent.name == "_build" and out.parent.parent.name == "sphexample_tpu_torch"
    assert re.fullmatch(r"libfastcsv-[0-9a-f]{16}\.so", out.name) and out.is_file()
    assert native.SRC.suffix == ".cpp" and native.SRC.parent.name == "csrc"


def _fresh(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)


def test_no_compiler_means_the_csv_module_path(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    path = str(tmp_path / "plain.csv")
    _write(path, 9, "plain")
    assert native.get_lib() is None and "compiler" in native.build_error
    before = dict(native.calls)
    got = tcsv.read_csv_columns(path, COLS[3])
    assert native.calls["python"] == before["python"] + 1
    np.testing.assert_array_equal(got, tcsv.read_csv_columns_plain(path, COLS[3]))


def test_a_failed_build_keeps_the_compiler_message(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    bad = tmp_path / "fastcsv.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    assert native.get_lib() is None
    assert "failed" in native.build_error and "error" in native.build_error
    assert not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())
    assert not os.path.exists(native.target())
