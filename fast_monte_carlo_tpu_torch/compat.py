"""Loaders of pickled model artifacts with neither scikit-learn, joblib nor
xgboost: the port of fast_monte_carlo_tpu/compat.py.

The trained heads are joblib files of sklearn objects (GradientBoosting
pipelines, ColumnTransformer preprocessors) and plain pickles (feature
lists, label encoders).  The JAX package unpickles them under sklearn;
the card's machine has no sklearn, so here they are read by
`ArtifactUnpickler`, a restricted `pickle._Unpickler`:

* every ``sklearn.*`` global becomes a stand-in class of its own (one per
  module and name) that keeps the pickled state as attributes, which is
  all the compile functions read (`models.sklearn_gbr`).  The tree arrays
  (``sklearn.tree._tree.Tree``, rebuilt through REDUCE from
  ``(n_features, n_classes, n_outputs)`` and a state of ``max_depth``,
  ``node_count``, ``nodes`` and ``values``) come out as `TreeStandIn`, with
  ``children_left``, ``children_right``, ``feature``, ``threshold``,
  ``value`` and ``node_count`` as sklearn's Tree has them;
* a joblib ``NumpyArrayWrapper`` is followed by its array's raw bytes
  (after a padding byte and ``numpy_array_alignment_bytes`` padding where
  the wrapper has that field), read on BUILD as joblib's
  ``NumpyUnpickler`` reads them; an object array is a nested pickle,
  loaded through this same restricted unpickler;
* numpy's array reconstructors, ``dtype``, ``ndarray`` and scalar types are
  allowed under both ``numpy.core`` and ``numpy._core`` (sklearn 1.3-era
  files and sklearn 1.9 files); ``numpy.random`` objects (a fitted
  estimator's ``_rng``, unused at inference) become inert stand-ins;
* the Cython loss objects (``*._loss`` modules and their
  ``__pyx_unpickle_*`` reconstructors) become `_StubLoss`, as in the JAX
  package.

Any other global raises ValueError naming it.  Whole-file compression as
joblib writes it (zlib, gzip, bz2, lzma, xz) is undone by the stdlib codecs
first, recognised by its magic bytes; lz4 raises.

``extract_xgb_pickle_raw`` pulls the serialized booster bytes out of a
pickled ``xgboost.sklearn`` estimator without xgboost, through the same
restricted unpickler with every ``xgboost.*`` class recorded as state.
"""
from __future__ import annotations

import bz2
import gzip
import importlib
import io
import lzma
import pickle
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np


class _StubLoss:
    """Placeholder for pickled sklearn Cython loss objects (training-only)."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        self._state = state

    def __call__(self, *a, **k):  # pragma: no cover - never used at inference
        raise RuntimeError("stubbed sklearn loss object is inference-only")


def _stub_pyx_unpickle(cls, checksum, state):
    obj = _StubLoss()
    if state is not None:
        obj.__setstate__(state)
    return obj


class StandIn:
    """A pickled object's state without its class: `__setstate__` keeps a
    dict as attributes (anything else as `_state`).  `standin_of` names
    the class it stands for."""

    standin_of = ""

    def __init__(self, *args, **kw):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __repr__(self):
        return f"<stand-in for {self.standin_of}>"


class TreeStandIn(StandIn):
    """sklearn.tree._tree.Tree: its node arrays from the pickled state."""

    standin_of = "sklearn.tree._tree.Tree"

    def __init__(self, n_features=None, n_classes=None, n_outputs=None, *args):
        self.n_features = n_features
        self.n_classes = n_classes
        self.n_outputs = n_outputs

    def __setstate__(self, state):
        nodes = state["nodes"]
        self.max_depth = int(state["max_depth"])
        self.node_count = int(state["node_count"])
        self.children_left = np.ascontiguousarray(nodes["left_child"])
        self.children_right = np.ascontiguousarray(nodes["right_child"])
        self.feature = np.ascontiguousarray(nodes["feature"])
        self.threshold = np.ascontiguousarray(nodes["threshold"])
        self.value = np.asarray(state["values"])
        self.nodes = nodes


class _ArrayWrapper(StandIn):
    """joblib's NumpyArrayWrapper: on BUILD the array's bytes follow it."""

    standin_of = "joblib.numpy_pickle.NumpyArrayWrapper"

    def read(self, up: "ArtifactUnpickler") -> np.ndarray:
        if self.dtype.hasobject:
            return ArtifactUnpickler(up.fh, up.extra).load()
        align = self.__dict__.get("numpy_array_alignment_bytes")
        if align is not None:
            pad = up.fh.read(1)
            if len(pad) != 1:
                raise ValueError("artifact ends inside an array's padding")
            if pad[0]:
                up.fh.read(pad[0])
        count = int(np.prod(self.shape, dtype=np.int64)) if len(self.shape) else 1
        nbytes = count * self.dtype.itemsize
        data = up.fh.read(nbytes)
        if len(data) != nbytes:
            raise ValueError(f"artifact ends inside an array: {len(data)} of {nbytes} bytes")
        arr = np.frombuffer(data, dtype=self.dtype, count=count).copy()
        if self.order == "F":
            return arr.reshape(tuple(self.shape)[::-1]).transpose()
        return arr.reshape(self.shape)


_STANDINS: Dict[Tuple[str, str], type] = {("sklearn.tree._tree", "Tree"): TreeStandIn}


def standin_class(module: str, name: str) -> type:
    """The stand-in class of `module.name`, one per (module, name)."""
    cls = _STANDINS.get((module, name))
    if cls is None:
        cls = _STANDINS[(module, name)] = type(
            name, (StandIn,), {"standin_of": f"{module}.{name}", "__module__": __name__})
    return cls


def _numpy_attr(module: str, name: str):
    """`name` of numpy's module `module` ('numpy.core.multiarray' and
    'numpy._core.multiarray' alike), from whichever this numpy has."""
    tail = module.split(".", 2)[2] if module.count(".") >= 2 else ""
    for base in ("numpy._core", "numpy.core"):
        try:
            return getattr(importlib.import_module(f"{base}.{tail}"), name)
        except (ImportError, AttributeError):
            continue
    raise ValueError(f"artifact names {module}.{name}, which this numpy does not have")


_NUMPY_CORE = {("multiarray", "_reconstruct"), ("multiarray", "scalar"),
               ("numeric", "_frombuffer")}
_BUILTINS = {"slice": slice, "set": set, "frozenset": frozenset, "bytearray": bytearray,
             "complex": complex}


def _allowed(module: str, name: str):
    """The object a pickle's global stands for, or None if not allowed."""
    if name.startswith("__pyx_unpickle_"):
        return _stub_pyx_unpickle
    if module == "_loss" or module.endswith("._loss"):
        return _StubLoss
    if name == "NumpyArrayWrapper" and module.endswith("numpy_pickle"):
        return _ArrayWrapper
    if module == "sklearn" or module.startswith("sklearn."):
        return standin_class(module, name)
    if module == "numpy":
        if name in ("dtype", "ndarray"):
            return getattr(np, name)
        obj = getattr(np, name, None)
        if isinstance(obj, type) and issubclass(obj, np.generic):
            return obj
        return None
    if module.startswith("numpy.random"):
        return standin_class(module, name)
    if module in ("numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric") and \
            (module.rsplit(".", 1)[1], name) in _NUMPY_CORE:
        return _numpy_attr(module, name)
    if module == "builtins":
        return _BUILTINS.get(name)
    if (module, name) == ("_codecs", "encode"):     # bytes in a protocol-2 pickle
        import codecs
        return codecs.encode
    return None


class ArtifactUnpickler(pickle._Unpickler):
    """pickle's Python unpickler with an allow-list of globals (`_allowed`,
    plus `extra(module, name)` where given) and joblib's array wrapper read
    on BUILD.  `fh` is the binary file the stream is read from."""

    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, fh, extra=None):
        super().__init__(fh)
        self.fh = fh
        self.extra = extra

    def find_class(self, module: str, name: str):
        obj = self.extra(module, name) if self.extra is not None else None
        if obj is None:
            obj = _allowed(module, name)
        if obj is None:
            raise ValueError(f"artifact names the global {module}.{name}, which the "
                             "artifact reader does not allow")
        return obj

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self.stack.pop().read(self))

    dispatch[pickle.BUILD[0]] = load_build


# whole-file compression as joblib writes it, by magic bytes
_CODECS = ((b"\x78", zlib.decompress), (b"\x1f\x8b", gzip.decompress),
           (b"BZ", bz2.decompress), (b"\xfd\x37\x7a\x58\x5a", lzma.decompress),
           (b"\x5d\x00", lzma.decompress))
_LZ4_PREFIX = b"\x04\x22\x4d\x18"


def _artifact_bytes(path: Path) -> bytes:
    raw = path.read_bytes()
    if raw.startswith(_LZ4_PREFIX):
        raise ValueError(f"{path}: lz4-compressed artifacts are not supported "
                         "(the stdlib has no lz4 codec)")
    for magic, decompress in _CODECS:
        if raw.startswith(magic):
            return decompress(raw)
    return raw


def _load(path, extra=None) -> Any:
    path = Path(path)
    return ArtifactUnpickler(io.BytesIO(_artifact_bytes(path)), extra).load()


def load_sklearn_artifact(path: str | Path) -> Any:
    """Load a joblib/pickle artifact of sklearn objects as stand-ins."""
    return _load(path)


def load_plain_pickle(path: str | Path) -> Any:
    """A plain pickle (e.g. *.pkl files) through the same restricted reader."""
    return _load(path)


# ---------------------------------------------------------------------------
# xgboost-free extraction of a pickled xgboost sklearn estimator
# ---------------------------------------------------------------------------

class _FakeXGBObject(StandIn):
    """Records pickled attribute state of any xgboost class without xgboost."""


def _xgb_class(module: str, name: str) -> Optional[type]:
    if module.startswith("xgboost"):
        return type(name, (_FakeXGBObject,), {"standin_of": f"{module}.{name}"})
    return None


def extract_xgb_pickle_raw(path: str | Path) -> bytes:
    """Return the serialized booster bytes embedded in a pickled xgboost
    sklearn estimator (a ``play_model.xgb`` is such a pickle, not a native
    xgboost binary).  The bytes are UBJSON or JSON depending on the
    xgboost version that wrote them; see models.xgb_json.loads_auto."""
    est = _load(path, _xgb_class)

    def _hunt(obj, depth=0):
        if depth > 4:
            return None
        if isinstance(obj, (bytes, bytearray)) and len(obj) > 256:
            return bytes(obj)
        d = getattr(obj, "__dict__", None)
        if isinstance(d, dict):
            for key in ("handle", "_handle", "raw", "_Booster"):
                if key in d:
                    found = _hunt(d[key], depth + 1)
                    if found is not None:
                        return found
            for v in d.values():
                found = _hunt(v, depth + 1)
                if found is not None:
                    return found
        return None

    raw = _hunt(est)
    if raw is None:
        raise ValueError(f"no embedded booster bytes found in {path}")
    return raw
