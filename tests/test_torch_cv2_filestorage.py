"""The port's FileStorage / FileNode (``rustcv_tpu_torch.cv2._filestorage``,
host code) against the reference's: in each format the reference writes
(YAML, JSON, XML; to a file and to memory) the port's bytes equal the
reference's, the reference reads what the port writes and the port reads
what the reference writes, node for node. A matrix written as a CPU tensor
gives the bytes of the same numpy matrix. ``open`` keeps cv2's False for a
missing or unreadable file and lets other errors through."""
import numpy as np
import pytest
import torch

import rustcv_tpu.cv2 as R
import rustcv_tpu_torch.cv2 as P

MATS = {
    "m_f32": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
    "m_f64": np.array([[1.5, -2.25], [0.0, 1e-3]]),
    "m_u8": np.arange(4, dtype=np.uint8).reshape(2, 2),
    "m_i16": np.array([[1, -2]], np.int16),
    "m_i32": np.array([[70000, -3], [5, 6]], np.int32),
    "m_3u": np.arange(12, dtype=np.uint8).reshape(2, 2, 3),
    "corners": np.random.default_rng(3).random((9, 1, 2)).astype(np.float32) * 100,
}
FORMATS = ["yml", "json", "xml"]


def _write_all(fs, cv, tensors=False):
    fs.write("an_int", 42)
    fs.write("a_real", 3.25)
    fs.write("a_string", "hello world")
    for k, v in MATS.items():
        fs.write(k, torch.from_numpy(v) if tensors else v)
    fs.startWriteStruct("a_seq", cv.FileNode_SEQ)
    for v in (1, 2.5, "x"):
        fs.write("", v)
    fs.endWriteStruct()
    fs.startWriteStruct("a_map", cv.FileNode_MAP)
    fs.write("k1", 7)
    fs.startWriteStruct("inner", cv.FileNode_SEQ)
    fs.write("", np.int64(3))
    fs.write("", np.float32(0.5))
    fs.endWriteStruct()
    fs.endWriteStruct()


def _check_all(fs):
    assert fs.isOpened()
    n = fs.getNode("an_int")
    assert n.isInt() and n.real() == 42 and not n.empty()
    assert fs.getNode("a_real").isReal() and fs.getNode("a_real").real() == 3.25
    assert fs.getNode("a_string").string() == "hello world"
    for k, v in MATS.items():
        got = fs.getNode(k).mat()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got.reshape(v.shape), v, err_msg=k)
    seq = fs.getNode("a_seq")
    assert seq.isSeq() and seq.size() == 3
    assert (seq.at(0).real(), seq.at(1).real(), seq.at(2).string()) == (1, 2.5, "x")
    m = fs["a_map"]
    assert m.isMap() and tuple(m.keys()) == ("k1", "inner")
    assert m["k1"].real() == 7 and m["inner"][0].real() == 3 and m["inner"][1].real() == 0.5
    assert fs.getNode("nonexistent").empty()


def _write(cv, path, tensors=False):
    fs = cv.FileStorage(path, cv.FILE_STORAGE_WRITE)
    assert fs.isOpened()
    _write_all(fs, cv, tensors)
    fs.release()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ext", FORMATS)
def test_port_writes_the_references_bytes_and_each_reads_the_other(tmp_path, ext):
    port = _write(P, str(tmp_path / f"port.{ext}"))
    ref = _write(R, str(tmp_path / f"ref.{ext}"))
    assert port == ref
    _check_all(R.FileStorage(str(tmp_path / f"port.{ext}"), R.FILE_STORAGE_READ))
    _check_all(P.FileStorage(str(tmp_path / f"ref.{ext}"), P.FILE_STORAGE_READ))
    g = P.FileStorage(str(tmp_path / f"ref.{ext}"), P.FILE_STORAGE_READ)
    assert g.getFormat() == R.FileStorage(str(tmp_path / f"ref.{ext}"),
                                          R.FILE_STORAGE_READ).getFormat()


@pytest.mark.parametrize("ext", FORMATS)
def test_tensor_matrices_write_as_their_values(tmp_path, ext):
    assert _write(P, str(tmp_path / f"t.{ext}"), tensors=True) == \
        _write(R, str(tmp_path / f"r.{ext}"))


@pytest.mark.parametrize("ext", FORMATS)
def test_memory_mode_both_ways(ext):
    strings = []
    for cv in (P, R):
        fs = cv.FileStorage("." + ext, cv.FILE_STORAGE_WRITE | cv.FILE_STORAGE_MEMORY)
        _write_all(fs, cv)
        strings.append(fs.releaseAndGetString())
    assert strings[0] == strings[1]
    _check_all(R.FileStorage(strings[0], R.FILE_STORAGE_READ | R.FILE_STORAGE_MEMORY))
    _check_all(P.FileStorage(strings[1], P.FILE_STORAGE_READ | P.FILE_STORAGE_MEMORY))


def test_append_and_legacy_header(tmp_path):
    for cv, name in ((P, "p.yml"), (R, "r.yml")):
        p = str(tmp_path / name)
        fs = cv.FileStorage(p, cv.FILE_STORAGE_WRITE)
        fs.write("first", 1)
        fs.release()
        fs = cv.FileStorage(p, cv.FILE_STORAGE_APPEND)
        fs.write("second", np.eye(2, dtype=np.float32))
        fs.release()
    assert open(tmp_path / "p.yml").read() == open(tmp_path / "r.yml").read()
    legacy = ("%YAML:1.0\n---\nv: 3\nm: !!opencv-matrix\n   rows: 1\n"
              "   cols: 2\n   dt: f\n   data: [ 1., 2. ]\n")
    g = P.FileStorage(legacy, P.FILE_STORAGE_READ | P.FILE_STORAGE_MEMORY)
    assert g.getNode("v").real() == 3
    np.testing.assert_array_equal(g.getNode("m").mat(), np.array([[1.0, 2.0]], np.float32))


@pytest.mark.parametrize("content", ["<opencv_storage><a>1</a", "{\"a\": [1,", "a: [1, 2\nb: :\n",
                                     "<html></html>"])
def test_an_unreadable_file_opens_false_as_the_reference(tmp_path, content):
    for ext in ("xml", "json", "yml"):
        p = tmp_path / f"bad.{ext}"
        p.write_text(content)
        assert R.FileStorage(str(p), R.FILE_STORAGE_READ).isOpened() is \
            P.FileStorage(str(p), P.FILE_STORAGE_READ).isOpened()
    assert not P.FileStorage(str(tmp_path / "missing.yml"), P.FILE_STORAGE_READ).isOpened()
    assert P.FileStorage().open(str(tmp_path / "missing.json"), P.FILE_STORAGE_READ) is False


def test_open_lets_other_errors_through(tmp_path, monkeypatch):
    """The reference returns False on every exception; the port only on an
    unreadable file: an error of the port's own (here a stand-in
    ``not_ported`` from the parser) reaches the caller."""
    from rustcv_tpu_torch.core.errors import not_ported
    from rustcv_tpu_torch.cv2 import _filestorage

    def refuse(text):
        raise not_ported("a test parser", item="8")

    p = tmp_path / "a.json"
    p.write_text("{\"a\": 1}")
    monkeypatch.setattr(_filestorage.FileStorage, "_parse", lambda self, text: refuse(text))
    with pytest.raises(NotImplementedError):
        P.FileStorage(str(p), P.FILE_STORAGE_READ)
