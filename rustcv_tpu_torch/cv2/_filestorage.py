"""cv2 facade: FileStorage / FileNode persistence (YAML / JSON / XML), a
copy of ``rustcv_tpu.cv2._filestorage`` (host code).

Writes files OpenCV 5.0 can read and reads files OpenCV 5.0 writes
(including ``!!opencv-matrix`` YAML tags, JSON ``type_id`` maps and
``<opencv_storage>`` XML); ``tests/test_torch_cv2_filestorage.py`` holds
the port's files byte-equal to the reference's, each read by the other.
Legacy ``%YAML:1.0`` headers from older OpenCV builds are accepted on
read. Reading YAML needs PyYAML; JSON and XML need only the standard
library.

``open`` keeps cv2's False for a missing or unreadable file (``OSError``;
a parse error, raised as ``ValueError``) and lets any other error through,
where the reference returns False on every exception.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np

__all__ = ["FileStorage", "FileNode"]

# dt codes <-> numpy dtypes (OpenCV persistence typecodes)
_DT2NP = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
          "i": np.int32, "f": np.float32, "d": np.float64}
_NP2DT = {np.dtype(np.uint8): "u", np.dtype(np.int8): "c",
          np.dtype(np.uint16): "w", np.dtype(np.int16): "s",
          np.dtype(np.int32): "i", np.dtype(np.float32): "f",
          np.dtype(np.float64): "d", np.dtype(np.bool_): "u"}


class _Matrix:
    """Internal tagged value for opencv-matrix nodes."""

    def __init__(self, arr: np.ndarray):
        self.arr = np.asarray(arr)

    @property
    def dt(self) -> str:
        base = _NP2DT[self.arr.dtype]
        ch = self.arr.shape[2] if self.arr.ndim == 3 else 1
        return base if ch == 1 else f"{ch}{base}"


def _parse_dt(dt: str):
    m = re.fullmatch(r"(\d*)([ucwsifd])", dt.strip().strip('"'))
    if not m:
        raise ValueError(f"unsupported matrix dt {dt!r}")
    ch = int(m.group(1)) if m.group(1) else 1
    return _DT2NP[m.group(2)], ch


def _matrix_from_fields(fields) -> _Matrix:
    rows = int(fields["rows"])
    cols = int(fields["cols"])
    dtype, ch = _parse_dt(str(fields["dt"]))
    data = np.asarray(fields["data"], np.float64)
    arr = data.reshape((rows, cols) if ch == 1 else (rows, cols, ch))
    return _Matrix(arr.astype(dtype))


# --------------------------------------------------------------- FileNode

class FileNode:
    NONE = 0
    INT = 1
    REAL = 2
    FLOAT = 2
    STR = 3
    STRING = 3
    SEQ = 4
    MAP = 5
    TYPE_MASK = 7
    FLOW = 8
    UNIFORM = 8
    EMPTY = 16
    NAMED = 32

    def __init__(self, value=None, name=None, missing=False):
        self._v = value
        self._name = name
        self._missing = missing

    # --- type queries
    def empty(self):
        return self._missing or self._v is None

    def isNone(self):
        return self._missing or self._v is None

    def isInt(self):
        return isinstance(self._v, (int, np.integer)) \
            and not isinstance(self._v, bool)

    def isReal(self):
        return isinstance(self._v, (float, np.floating))

    def isString(self):
        return isinstance(self._v, str)

    def isSeq(self):
        return isinstance(self._v, list)

    def isMap(self):
        return isinstance(self._v, dict) or isinstance(self._v, _Matrix)

    def isNamed(self):
        return self._name is not None

    def type(self):
        if self.empty():
            return FileNode.NONE
        if self.isInt():
            return FileNode.INT
        if self.isReal():
            return FileNode.REAL
        if self.isString():
            return FileNode.STR
        if self.isSeq():
            return FileNode.SEQ
        return FileNode.MAP

    # --- accessors
    def name(self):
        return self._name or ""

    def size(self):
        if isinstance(self._v, (list, dict)):
            return len(self._v)
        return 1 if not self.empty() else 0

    def real(self):
        if isinstance(self._v, (int, float, np.integer, np.floating)):
            return float(self._v)
        return 0.0

    def string(self):
        return self._v if isinstance(self._v, str) else ""

    def mat(self):
        if isinstance(self._v, _Matrix):
            return self._v.arr.copy()
        return None

    def at(self, i):
        if isinstance(self._v, list):
            return FileNode(self._v[int(i)])
        raise IndexError("FileNode.at on a non-sequence node")

    def getNode(self, key):
        if isinstance(self._v, dict) and key in self._v:
            return FileNode(self._v[key], name=key)
        return FileNode(missing=True, name=key)

    def keys(self):
        if isinstance(self._v, dict):
            return tuple(self._v.keys())
        return ()

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.at(key)
        return self.getNode(key)


# ------------------------------------------------------------ YAML writer

def _yaml_scalar(v):
    if isinstance(v, str):
        if v == "" or re.search(r"[:#\[\]{}\"']|^[\s\-?&*!|>%@`]", v):
            return json.dumps(v)
        return v
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    f = float(v)
    if f == int(f) and abs(f) < 1e16:
        return f"{int(f)}."
    return repr(f)


def _yaml_data_list(arr):
    vals = [_yaml_scalar(x) for x in
            (arr.ravel().tolist() if isinstance(arr, np.ndarray) else arr)]
    return "[ " + ", ".join(vals) + " ]"


def _emit_yaml(tree, out, indent=0):
    pad = " " * indent
    for k, v in tree.items():
        if isinstance(v, _Matrix):
            out.append(f"{pad}{k}: !!opencv-matrix")
            out.append(f"{pad}   rows: {v.arr.shape[0]}")
            out.append(f"{pad}   cols: {v.arr.shape[1]}")
            dt = v.dt
            out.append(f"{pad}   dt: " + (f'"{dt}"' if len(dt) > 1 else dt))
            flat = v.arr.reshape(-1)
            if np.issubdtype(v.arr.dtype, np.floating):
                flat = flat.astype(np.float64)
            else:
                flat = flat.astype(np.int64)
            out.append(f"{pad}   data: " + _yaml_data_list(flat))
        elif isinstance(v, dict):
            out.append(f"{pad}{k}:")
            _emit_yaml(v, out, indent + 3)
        elif isinstance(v, list):
            out.append(f"{pad}{k}:")
            for item in v:
                if isinstance(item, dict):
                    out.append(f"{pad}   -")
                    _emit_yaml(item, out, indent + 6)
                else:
                    out.append(f"{pad}   - {_yaml_scalar(item)}")
        else:
            out.append(f"{pad}{k}: {_yaml_scalar(v)}")


def _dump_yaml(tree) -> str:
    out = ["%YAML 1.2", "---"]
    _emit_yaml(tree, out)
    return "\n".join(out) + "\n"


def _load_yaml(text: str):
    import yaml

    # accept legacy OpenCV "%YAML:1.0" headers
    text = re.sub(r"^%YAML:1\.0", "%YAML 1.1", text)

    class _L(yaml.SafeLoader):
        pass

    def _mat(loader, node):
        return _matrix_from_fields(loader.construct_mapping(node,
                                                            deep=True))

    _L.add_constructor("tag:yaml.org,2002:opencv-matrix", _mat)
    _L.add_constructor("!opencv-matrix", _mat)
    try:
        data = yaml.load(text, Loader=_L)
    except yaml.YAMLError as e:
        raise ValueError(f"not a readable YAML file: {e}") from e
    return data or {}


# ------------------------------------------------------------ JSON dialect

def _to_jsonable(v):
    if isinstance(v, _Matrix):
        flat = v.arr.reshape(-1)
        if np.issubdtype(v.arr.dtype, np.floating):
            data = [float(x) for x in flat]
        else:
            data = [int(x) for x in flat]
        return {"type_id": "opencv-matrix", "rows": v.arr.shape[0],
                "cols": v.arr.shape[1], "dt": v.dt, "data": data}
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def _from_jsonlike(v):
    if isinstance(v, dict):
        if v.get("type_id") == "opencv-matrix":
            return _matrix_from_fields(v)
        return {k: _from_jsonlike(x) for k, x in v.items()
                if k != "type_id"}
    if isinstance(v, list):
        return [_from_jsonlike(x) for x in v]
    return v


# ------------------------------------------------------------- XML dialect

def _xml_scalar_str(v):
    if isinstance(v, str):
        return f'"{v}"'
    return _yaml_scalar(v)


def _emit_xml(tree, out, indent=0):
    for k, v in tree.items():
        if isinstance(v, _Matrix):
            flat = v.arr.reshape(-1)
            if np.issubdtype(v.arr.dtype, np.floating):
                data = " ".join(_yaml_scalar(float(x)) for x in flat)
            else:
                data = " ".join(str(int(x)) for x in flat)
            dt = v.dt
            out.append(
                f'<{k} type_id="opencv-matrix"><rows>{v.arr.shape[0]}'
                f"</rows><cols>{v.arr.shape[1]}</cols><dt>"
                + (f'"{dt}"' if len(dt) > 1 else dt)
                + f"</dt><data>{data}</data></{k}>")
        elif isinstance(v, dict):
            out.append(f"<{k}>")
            _emit_xml(v, out)
            out.append(f"</{k}>")
        elif isinstance(v, list):
            body = " ".join(_xml_scalar_str(x) for x in v)
            out.append(f"<{k}>{body}</{k}>")
        else:
            out.append(f"<{k}>{_xml_scalar_str(v)}</{k}>")


def _dump_xml(tree) -> str:
    out = ['<?xml version="1.0"?>', "<opencv_storage>"]
    _emit_xml(tree, out)
    out.append("</opencv_storage>")
    return "\n".join(out) + "\n"


def _xml_token(tok: str):
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def _from_xml_elem(e):
    kids = list(e)
    if e.get("type_id") == "opencv-matrix" or (
            kids and {k.tag for k in kids} >= {"rows", "cols", "dt",
                                               "data"}):
        fields = {}
        for k in kids:
            if k.tag == "data":
                fields["data"] = [float(t) for t in k.text.split()]
            else:
                fields[k.tag] = k.text.strip().strip('"')
        return _matrix_from_fields(fields)
    if kids:
        return {k.tag: _from_xml_elem(k) for k in kids}
    text = (e.text or "").strip()
    if not text:
        return {}
    # a quoted string (may contain spaces) or a space-separated sequence
    if text.startswith('"') and text.endswith('"') and \
            text.count('"') == 2:
        return text[1:-1]
    toks = re.findall(r'"[^"]*"|\S+', text)
    vals = [_xml_token(t) for t in toks]
    return vals[0] if len(vals) == 1 else vals


def _load_xml(text: str):
    import xml.etree.ElementTree as ET

    try:
        root = ET.fromstring(text)
    except ET.ParseError as e:
        raise ValueError(f"not a readable XML file: {e}") from e
    if root.tag != "opencv_storage":
        raise ValueError("not an opencv_storage XML file")
    return {e.tag: _from_xml_elem(e) for e in root}


# ------------------------------------------------------------- FileStorage

class FileStorage:
    READ = 0
    WRITE = 1
    APPEND = 2
    MEMORY = 4
    FORMAT_AUTO = 0
    FORMAT_XML = 8
    FORMAT_YAML = 16
    FORMAT_JSON = 24
    FORMAT_MASK = 56

    def __init__(self, filename=None, flags=0, encoding=""):
        self._tree = {}
        self._stack = []       # (container, kind) while writing structs
        self._open = False
        self._mode = None
        self._path = None
        self._memory = False
        self._fmt = None
        if filename is not None:
            self.open(filename, flags, encoding)

    # -- plumbing ----------------------------------------------------------
    def _detect_fmt(self, name_or_content, flags, is_content):
        f = flags & FileStorage.FORMAT_MASK
        if f == FileStorage.FORMAT_XML:
            return "xml"
        if f in (FileStorage.FORMAT_YAML, 32):
            return "yml"
        if f == FileStorage.FORMAT_JSON:
            return "json"
        probe = name_or_content.lstrip() if is_content else name_or_content
        if is_content:
            if probe.startswith("<"):
                return "xml"
            if probe.startswith("{"):
                return "json"
            return "yml"
        ext = os.path.splitext(name_or_content)[1].lower().lstrip(".")
        return {"xml": "xml", "json": "json"}.get(ext, "yml")

    def open(self, filename, flags, encoding=""):
        mode = flags & 3
        self._memory = bool(flags & FileStorage.MEMORY)
        self._fmt = self._detect_fmt(filename, flags,
                                     self._memory and mode == 0)
        self._mode = mode
        self._tree = {}
        self._stack = []
        if mode == FileStorage.READ:
            try:
                text = filename if self._memory else open(filename).read()
                self._tree = self._parse(text)
                self._open = True
            except (OSError, ValueError):
                self._open = False
                return False
        else:
            self._path = None if self._memory else filename
            if mode == FileStorage.APPEND and self._path \
                    and os.path.exists(self._path):
                try:
                    self._tree = self._parse(open(self._path).read())
                except (OSError, ValueError):
                    self._tree = {}
            self._open = True
        return self._open

    def _parse(self, text):
        fmt = self._detect_fmt(text, 0, True)
        self._fmt = fmt
        if fmt == "json":
            return _from_jsonlike(json.loads(text))
        if fmt == "xml":
            return _load_xml(text)
        return _load_yaml(text)

    def isOpened(self):
        return self._open

    def _serialize(self):
        if self._fmt == "json":
            return json.dumps(_to_jsonable(self._tree), indent=4) + "\n"
        if self._fmt == "xml":
            return _dump_xml(self._tree)
        return _dump_yaml(self._tree)

    def release(self):
        if self._open and self._mode in (FileStorage.WRITE,
                                         FileStorage.APPEND) \
                and self._path:
            with open(self._path, "w") as fh:
                fh.write(self._serialize())
        self._open = False

    def releaseAndGetString(self):
        s = self._serialize() if self._mode != FileStorage.READ else ""
        self.release()
        return s

    # -- writing -----------------------------------------------------------
    def _sink(self):
        return self._stack[-1][0] if self._stack else self._tree

    @staticmethod
    def _coerce(val):
        if hasattr(val, "detach"):  # a tensor: its values, on the host
            val = val.detach().cpu().numpy()
        if isinstance(val, np.ndarray):
            if val.dtype not in _NP2DT:
                val = val.astype(np.float64)
            return _Matrix(val)
        if isinstance(val, (np.integer,)):
            return int(val)
        if isinstance(val, (np.floating,)):
            return float(val)
        return val

    def write(self, name, val):
        v = self._coerce(val)
        sink = self._sink()
        if isinstance(sink, list):
            sink.append(v)
        else:
            sink[str(name)] = v

    def startWriteStruct(self, name, flags, typeName=""):
        kind = flags & FileNode.TYPE_MASK
        node = [] if kind == FileNode.SEQ else {}
        sink = self._sink()
        if isinstance(sink, list):
            sink.append(node)
        else:
            sink[str(name)] = node
        self._stack.append((node, kind))

    def endWriteStruct(self):
        self._stack.pop()

    def writeComment(self, comment, append=False):
        pass  # comments are not part of the data model

    # -- reading -----------------------------------------------------------
    def getNode(self, name):
        if name in self._tree:
            return FileNode(self._tree[name], name=name)
        return FileNode(missing=True, name=name)

    def root(self, streamidx=0):
        return FileNode(self._tree)

    def getFirstTopLevelNode(self):
        for k, v in self._tree.items():
            return FileNode(v, name=k)
        return FileNode(missing=True)

    def getFormat(self):
        return {"xml": FileStorage.FORMAT_XML,
                "yml": FileStorage.FORMAT_YAML,
                "json": FileStorage.FORMAT_JSON}[self._fmt or "yml"]

    def __getitem__(self, name):
        return self.getNode(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
