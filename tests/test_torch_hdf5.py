"""The port's HDF5 subset (acinoset_tpu_torch.utils.hdf5) and its DLC
.h5 files (pipeline.data._read_dlc_h5, save_dlc_points_h5) against h5py
and the JAX package's reader and writer, on the CPU.

Files cross both ways: the port reads the JAX package's (h5py-written)
files to the JAX reader's arrays bit for bit, NaN included; h5py and the
JAX reader read the port's files to the arrays and names written. The
pandas/PyTables "table" layout is built here with h5py (a chunked
compound ``table`` of ``index`` and ``values_block_0``, its last chunk
partial, ``non_index_axes`` pickled as a string or as opaque data), as
no real DeepLabCut file is in the repository. Structures outside the
subset raise, naming the file.
"""
import pickle

import h5py
import numpy as np
import pytest

from acinoset_tpu.pipeline import data as jdata
from acinoset_tpu_torch.models import cheetah as tcheetah
from acinoset_tpu_torch.pipeline import data as tdata
from acinoset_tpu_torch.utils import hdf5


def _points(seed, N, L):
    """Pixels (N, L, 2) and likelihoods (N, L) with NaN detections."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, 2704, (N, L, 2))
    lik = rng.uniform(0, 1, (N, L))
    px[rng.integers(0, N, 5), rng.integers(0, L, 5)] = np.nan
    lik[rng.integers(0, N, 3), rng.integers(0, L, 3)] = np.nan
    return px, lik


def _assert_reads_equal(got, want):
    (fg, bg, vg), (fw, bw, vw) = got, want
    assert fg.dtype == fw.dtype and vg.dtype == vw.dtype
    np.testing.assert_array_equal(fg, fw)
    assert bg == bw
    np.testing.assert_array_equal(vg, vw)  # NaN where NaN: bit for bit otherwise
    assert np.array_equal(vg.view(np.uint64), vw.view(np.uint64))


@pytest.mark.parametrize("seed,N,L", [(0, 50, 20), (1, 1, 3), (2, 300, 7)])
def test_port_reads_jax_files_exactly(tmp_path, seed, N, L):
    px, lik = _points(seed, N, L)
    markers = tcheetah.get_markers()[:L] if L == 20 else [f"m{i}" for i in range(L)]
    fp = str(tmp_path / "cam1DLC.h5")
    jdata.save_dlc_points_h5(fp, px, lik, markers, scorer="DLC_resnet50")
    _assert_reads_equal(tdata._read_dlc_h5(fp), jdata._read_dlc_h5(fp))
    p_t, p_j = tdata.load_dlc_points([fp, fp]), jdata.load_dlc_points([fp, fp])
    for key in ("pixels", "likelihood", "frames"):
        np.testing.assert_array_equal(getattr(p_t, key), getattr(p_j, key))
    assert p_t.markers == p_j.markers == markers


@pytest.mark.parametrize("strings", ["vlen", "fixed"])
def test_h5py_and_jax_read_port_files(tmp_path, strings):
    px, lik = _points(3, 40, 20)
    markers = tcheetah.get_markers()
    fp = str(tmp_path / "x.h5")
    frames = np.arange(17, 57)
    tdata.save_dlc_points_h5(fp, px, lik, markers, frames=frames, strings=strings)
    with h5py.File(fp, "r") as f:
        assert list(f.keys()) == ["df_with_missing"]
        g = f["df_with_missing"]
        assert g.attrs["pandas_type"] == b"frame" and g.attrs["CLASS"] == b"GROUP"
        assert [s.decode() for s in g["axis0_level1"][:]] == markers
        assert [s.decode() for s in g["axis0_level0"][:]] == ["acinoset_tpu"]
        assert g["axis0_level2"].dtype.kind == ("O" if strings == "vlen" else "S")
        np.testing.assert_array_equal(g["axis1"][:], frames)
        vals = np.concatenate([px, lik[..., None]], axis=-1).reshape(40, 60)
        np.testing.assert_array_equal(g["block0_values"][:], vals)
        np.testing.assert_array_equal(g["axis0_label1"][:], np.repeat(np.arange(20), 3))
    want = jdata._read_dlc_h5(fp)
    _assert_reads_equal(tdata._read_dlc_h5(fp), want)
    np.testing.assert_array_equal(want[0], frames)
    assert want[1] == markers
    np.testing.assert_array_equal(want[2][..., :2], px)
    np.testing.assert_array_equal(want[2][..., 2], lik)


def _table_file(fp, N, L, attr, filters, chunk=16, seed=4):
    """A pandas "table" DLC layout written with h5py."""
    rng = np.random.default_rng(seed)
    cols = [("DLC_resnet50", f"part{i}", c) for i in range(L) for c in ("x", "y", "likelihood")]
    blob = pickle.dumps([(1, cols)])
    dt = np.dtype([("index", "<i8"), ("values_block_0", "<f8", (3 * L,))])
    tab = np.zeros(N, dt)
    tab["index"] = np.arange(N) + 3
    tab["values_block_0"] = rng.normal(300.0, 100.0, (N, 3 * L))
    tab["values_block_0"][5, 7] = np.nan
    with h5py.File(fp, "w") as f:
        g = f.create_group("df_with_missing")
        g.attrs["non_index_axes"] = np.bytes_(blob) if attr == "string" else np.void(blob)
        g.attrs["pandas_type"] = np.bytes_(b"frame_table")
        g.create_dataset("table", data=tab, chunks=(chunk,), **filters)
    return tab, cols


FILTERS = {"none": {}, "deflate": dict(compression="gzip"),
           "shuffle+deflate": dict(compression="gzip", compression_opts=6, shuffle=True)}


@pytest.mark.parametrize("attr", ["string", "opaque"])
@pytest.mark.parametrize("filters", sorted(FILTERS))
def test_port_reads_table_layout_like_jax(tmp_path, attr, filters):
    """53 rows in chunks of 16: the last chunk is stored whole and holds 5."""
    fp = str(tmp_path / "table.h5")
    tab, cols = _table_file(fp, 53, 6, attr, FILTERS[filters])
    got, want = tdata._read_dlc_h5(fp), jdata._read_dlc_h5(fp)
    _assert_reads_equal(got, want)
    np.testing.assert_array_equal(got[0], tab["index"])
    np.testing.assert_array_equal(got[2].reshape(53, -1), tab["values_block_0"])
    root = hdf5.open_file(fp)
    assert pickle.loads(bytes(root["df_with_missing"].attrs["non_index_axes"])) == [(1, cols)]


def test_reader_matches_h5py_on_other_layouts(tmp_path):
    """What h5py writes by default beyond the DLC files: 2-D chunks with
    partial edges, shuffle + deflate, compact and contiguous data, float32
    and int16, fixed-length strings, scalar and array attributes, nested
    groups, and an object header long enough to continue elsewhere."""
    rng = np.random.default_rng(5)
    fp = str(tmp_path / "misc.h5")
    arrays = {
        "a/chunked": rng.normal(size=(37, 11)).astype(np.float32),
        "a/b/ints": rng.integers(-500, 500, (7, 3, 2)).astype(np.int16),
        "strings": np.array([b"nose", b"l_eye", b""]),
        "scalar": np.float64(2.5),
        "u8": np.arange(9, dtype=np.uint8),
    }
    with h5py.File(fp, "w") as f:
        f.create_dataset("a/chunked", data=arrays["a/chunked"], chunks=(8, 4), compression="gzip",
                         shuffle=True)
        f.create_dataset("a/b/ints", data=arrays["a/b/ints"])
        f.create_dataset("strings", data=arrays["strings"])
        f.create_dataset("scalar", data=arrays["scalar"])
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((9,))
        h5py.h5d.create(f.id, b"u8", h5py.h5t.NATIVE_UINT8, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, arrays["u8"])
        for i in range(40):  # attributes enough to need a continuation block
            f["a"].attrs[f"attr{i:02d}"] = np.arange(i + 1, dtype=np.int64)
        f["a"].attrs["name"] = np.bytes_(b"cheetah")
        f["a"].attrs["vlen"] = "utf-8 text"
    root = hdf5.open_file(fp)
    assert root.keys() == ["a", "scalar", "strings", "u8"]
    assert root["a"].keys() == ["b", "chunked"]
    for name, want in arrays.items():
        got = root[name].read()
        assert got.dtype == want.dtype and got.shape == np.shape(want), name
        np.testing.assert_array_equal(got, want)
    attrs = root["a"].attrs
    for i in range(40):
        np.testing.assert_array_equal(attrs[f"attr{i:02d}"], np.arange(i + 1))
    assert attrs["name"] == b"cheetah" and attrs["vlen"] == b"utf-8 text"


def _write_refused(fp, case):
    if case == "superblock 2":
        with h5py.File(fp, "w", libver=("v108", "v108")) as f:
            f.create_dataset("x", data=np.arange(3.0))
    elif case == "superblock 3":
        with h5py.File(fp, "w", libver="latest") as f:
            f.create_dataset("x", data=np.arange(3.0))
    elif case == "LZF filter":
        with h5py.File(fp, "w") as f:
            f.create_dataset("x", data=np.arange(30.0), chunks=(10,), compression="lzf")
    elif case == "big-endian":
        with h5py.File(fp, "w") as f:
            f.create_dataset("x", data=np.arange(30.0).astype(">f8"))
    elif case == "v2 object header":
        with h5py.File(fp, "w", track_order=True) as f:
            f.create_dataset("x", data=np.arange(3.0))


@pytest.mark.parametrize("case,match", [
    ("superblock 2", "superblock version 2"),
    ("superblock 3", "superblock version 3"),
    ("LZF filter", "filter id 32000 \\(LZF\\)"),
    ("big-endian", "big-endian"),
    ("v2 object header", "version-2 object header"),
])
def test_unsupported_structures_raise_naming_the_file(tmp_path, case, match):
    fp = str(tmp_path / "refused.h5")
    _write_refused(fp, case)
    with pytest.raises(hdf5.HDF5FormatError, match=match) as err:
        hdf5.open_file(fp)["x"].read()
    assert fp in str(err.value)


def test_not_an_hdf5_file_raises_naming_it(tmp_path):
    fp = tmp_path / "junk.h5"
    fp.write_bytes(b"not hdf5" * 200)
    with pytest.raises(hdf5.HDF5FormatError, match="no HDF5 signature") as err:
        tdata._read_dlc_h5(str(fp))
    assert str(fp) in str(err.value)


def test_save_dlc_points_h5_refuses_an_unknown_string_kind(tmp_path):
    px, lik = _points(6, 3, 2)
    with pytest.raises(ValueError, match="'vlen' or 'fixed'"):
        tdata.save_dlc_points_h5(str(tmp_path / "x.h5"), px, lik, ["a", "b"], strings="utf16")
