"""Tables as columns, without pandas: a CSV read as `pandas.read_csv`
types it, DataFrames and row dicts as columns, and the DataFrame wrappers.

A table here is a dict of equal-length numpy columns, name -> array, in
the file's column order.  `read_csv_columns` gives each column the type
pandas' reader gives it: int64 where every cell is an integer, float64
where every cell is a number or missing (missing is NaN), bool where every
cell is True or False, else an object column of strings with NaN where a
cell is missing; pandas' default NA strings (`data.sp.NA_STRINGS`) count as
missing.  Numbers parse to pandas' own values, bit for bit, also where its
parser rounds a 17-digit cell an ulp away from the nearest double (the
saved players files write float32 yards that way).  `frame` wraps columns
into a DataFrame, importing pandas only there.
"""
from __future__ import annotations

import csv
import io
import math
from typing import Dict, Iterable, List

import numpy as np

from .sp import NA_STRINGS

Columns = Dict[str, np.ndarray]
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})


def is_na(v) -> bool:
    """A missing cell: None or a float NaN (pandas' isna on one value)."""
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def _mangled(names: List[str]) -> List[str]:
    """Header names with duplicates renamed as pandas renames them: a, a.1, a.2."""
    seen: Dict[str, int] = {}
    out = []
    for name in names:
        k = seen.get(name, 0)
        seen[name] = k + 1
        out.append(name if k == 0 else f"{name}.{k}")
    return out


# pandas' float parser (precise_xstrtod in its tokenizer.c): at most 17
# digits accumulated in a double, number = number * 10 + digit, then one
# multiplication or division by a power of ten from this table.  A cell of
# 17 significant digits can land an ulp from Python's correctly rounded
# float; this reproduces pandas' value.
_MAX_DIGITS = 17
_POW10 = np.array([float(f"1e{k}") for k in range(309)])
_POW10_INT = 10 ** np.arange(19, dtype=np.int64)
_DIGIT0, _DOT, _PLUS, _MINUS = ord("0"), ord("."), ord("+"), ord("-")
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-infinity": -math.inf}


def _codes(arr: np.ndarray) -> np.ndarray:
    """(n, width) code points of a fixed-width unicode or ASCII bytes array,
    0 past a cell's end."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "S":
        c = arr.view(np.uint8).reshape(len(arr), arr.dtype.itemsize)
    else:
        c = arr.view(np.uint32).reshape(len(arr), arr.dtype.itemsize // 4)
    used = np.flatnonzero((c != 0).any(axis=0))
    return c[:, :used[-1] + 1 if len(used) else 1]


def _text(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def _cells_like(arr: np.ndarray, texts) -> list:
    """`texts` as cells of `arr`'s kind: bytes for a bytes array."""
    return sorted(t.encode() for t in texts) if arr.dtype.kind == "S" else sorted(texts)


def _ints(arr: np.ndarray):
    """The cells of a unicode array as int64, or None unless every cell is
    an optional sign and then 1 to 18 digits."""
    if len(arr) > 1 and _ints(arr[:1]) is None:
        return None                      # told by the first cell
    c = _codes(arr)
    digit = (c >= _DIGIT0) & (c <= _DIGIT0 + 9)
    allowed = digit | (c == 0)
    allowed[:, 0] |= (c[:, 0] == _PLUS) | (c[:, 0] == _MINUS)
    n_digits = digit.sum(axis=1)
    if not (allowed.all() and (n_digits >= 1).all() and (n_digits <= 18).all()):
        return None
    # a digit's place: the digits after it in its cell
    place = n_digits[:, None] - np.cumsum(digit, axis=1)
    value = (np.where(digit, c.astype(np.int64) - _DIGIT0, 0)
             * _POW10_INT[np.where(digit, place, 0)]).sum(axis=1)
    return np.where(c[:, 0] == _MINUS, -value, value)


def _scale(number: np.ndarray, exponent: np.ndarray) -> np.ndarray:
    """number * 10**exponent as pandas' parser scales it."""
    out = number.copy()
    up = exponent > 0
    out[up] = number[up] * _POW10[np.minimum(exponent[up], 308)]
    out[up & (exponent > 308)] = math.inf
    mid = (exponent <= 0) & (exponent >= -308)
    out[mid] = number[mid] / _POW10[-exponent[mid]]
    low = exponent < -308
    tiny = low & (exponent < -616)
    sub = low & ~tiny
    out[sub] = number[sub] / _POW10[-308 - exponent[sub]] / _POW10[308]
    out[tiny] = 0.0
    return out


def _pandas_floats(arr: np.ndarray):
    """The cells of a unicode array as pandas' reader parses them, or None
    if one is not a number.  The form [+-]digits[.digits][(e|E)[+-]digits]
    is parsed in bulk; other cells (spaces around a number, inf) one by
    one."""
    if len(arr) > 1 and _pandas_floats(arr[:1]) is None:
        return None                      # a text column, told by its first cell
    c = _codes(arr)
    n, w = c.shape
    pos = np.arange(w)
    digit = (c >= _DIGIT0) & (c <= _DIGIT0 + 9)
    is_e = (c == ord("e")) | (c == ord("E"))
    epos = np.where(is_e.any(axis=1), is_e.argmax(axis=1), w)[:, None]
    mant_digit = digit & (pos < epos)
    dot = (c == _DOT) & (pos < epos)
    dpos = np.where(dot.any(axis=1), dot.argmax(axis=1), w)[:, None]
    signed = (c == _PLUS) | (c == _MINUS)
    # the exponent: e, an optional sign, at least one digit, nothing else
    e_sign = signed & (pos == epos + 1)
    e_digit = digit & (pos > epos)
    allowed = mant_digit | dot | (is_e & (pos == epos)) | e_sign | e_digit | (c == 0)
    allowed[:, 0] |= signed[:, 0]
    ok = (allowed.all(axis=1) & (dot.sum(axis=1) <= 1) & (mant_digit.sum(axis=1) >= 1)
          & ((epos[:, 0] == w) | e_digit.any(axis=1)))
    out = np.empty(n)
    for i in np.flatnonzero(~ok):
        text = _text(arr[i]).strip()
        if text.lower() in _INF:
            out[i] = _INF[text.lower()]
            continue
        v = _pandas_floats(np.array([text])) if text and text != _text(arr[i]) else None
        if v is None:
            return None
        out[i] = v[0]
    # digits numbered from 0 in order; pandas accumulates the first 17
    ordinal = np.cumsum(mant_digit, axis=1) - 1
    kept = mant_digit & (ordinal < _MAX_DIGITS)
    rows, cols = np.nonzero(kept)
    digits = np.zeros((n, _MAX_DIGITS))
    digits[rows, ordinal[rows, cols]] = c[rows, cols].astype(np.float64) - _DIGIT0
    count = kept.sum(axis=1)
    number = np.zeros(n)
    for k in range(_MAX_DIGITS):
        number = np.where(k < count, number * 10.0 + digits[:, k], number)
    exponent = ((mant_digit & ~kept & (pos < dpos)).sum(axis=1)
                - (kept & (pos > dpos)).sum(axis=1))
    e_val = np.zeros(n, dtype=np.int64)
    for k in np.flatnonzero(e_digit.any(axis=0)):
        e_val = np.where(e_digit[:, k], e_val * 10 + c[:, k].astype(np.int64) - _DIGIT0, e_val)
    exponent = exponent + np.where((e_sign & (c == _MINUS)).any(axis=1), -e_val, e_val)
    number = np.where(c[:, 0] == _MINUS, -number, number)
    out[ok] = _scale(number, exponent)[ok]
    return out


def text_column(arr: np.ndarray) -> np.ndarray:
    """One CSV column's cells (a fixed-width unicode or ASCII bytes array)
    typed as pandas' reader types them."""
    if not len(arr):
        return np.array([], dtype=object)
    na = np.isin(arr, _cells_like(arr, NA_STRINGS))
    if na.all():
        return np.full(len(arr), math.nan)
    present = arr[~na]
    ints = None if na.any() else _ints(present)
    if ints is not None:
        return ints
    # each distinct cell parsed once (a yards column repeats most of them)
    floats = None
    if _pandas_floats(present[:1]) is not None:
        distinct, where = np.unique(present, return_inverse=True)
        floats = _pandas_floats(distinct)
    if floats is not None:
        out = np.full(len(arr), math.nan)
        out[~na] = floats[where]
        return out
    if np.isin(present, _cells_like(arr, _TRUE | _FALSE)).all():
        flags = np.isin(arr, _cells_like(arr, _TRUE))
        if not na.any():
            return flags
        out = flags.astype(object)
        out[na] = math.nan
        return out
    out = (arr.astype(str) if arr.dtype.kind == "S" else arr).astype(object)
    out[na] = math.nan
    return out


def _byte_fields(data: bytes):
    """(header names, one ASCII bytes array a column) of a CSV with no
    quote, no carriage return and no byte past ASCII, a header on its first
    line and every row as wide as it, cut by numpy's C reader; None for any
    other file (the `csv` module reads it)."""
    buf = np.frombuffer(data, np.uint8)
    if (not len(buf) or buf[0] == 10 or buf.max() >= 128 or b'"' in data
            or b"\r" in data):
        return None
    names = data.split(b"\n", 1)[0].decode().split(",")
    delim = np.flatnonzero((buf == 44) | (buf == 10))
    if len(delim) <= len(names):
        return None            # no row after the header
    width = int(np.diff(delim).max())
    try:
        cells = np.loadtxt(io.BytesIO(data), delimiter=",", dtype=f"S{max(width, 1)}",
                           skiprows=1, comments=None, ndmin=2)
    except ValueError:         # a row narrower or wider than the others
        return None
    if cells.shape[1] != len(names):
        return None
    return names, [np.ascontiguousarray(cells[:, j]) for j in range(len(names))]


def _csv_fields(path):
    """(header names, one unicode array a column) of any CSV, cut by the
    `csv` module: blank lines skipped, a short row padded with empty cells.
    A row longer than the header raises ValueError, as does a file with no
    header."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse from file")
    names, body = rows[0], rows[1:]
    width = len(names)
    lengths = set(map(len, body))
    if lengths and max(lengths) > width:
        raise ValueError(f"{path}: a row has {max(lengths)} fields, the header {width}")
    if lengths and min(lengths) < width:
        body = [r + [""] * (width - len(r)) for r in body]
    return names, [np.array(col) for col in zip(*body)] if body else [np.array([])] * width


def read_csv_columns(path) -> Columns:
    """A CSV file as columns typed as `pandas.read_csv(path)` types them:
    the first row is the header, blank lines are skipped, a short row's
    missing cells are NaN.  A row longer than the header raises ValueError,
    as does a file with no header.  The fields are cut by numpy's C reader
    where `_byte_fields` can, else by `csv` (`probes/csv_read.py` times
    both on a players file)."""
    with open(path, "rb") as f:
        data = f.read()
    names, cells = _byte_fields(data) or _csv_fields(path)
    return {name: text_column(col) for name, col in zip(_mangled(names), cells)}


def object_column(values: List) -> np.ndarray:
    """Python values (None or NaN where missing) typed as a DataFrame built
    from records types them: int64 where all are integers and none is
    missing, float64 where all are numbers, bool where all are booleans and
    none is missing, else object with NaN where missing."""
    missing = [is_na(v) for v in values]
    present = [v for v, m in zip(values, missing) if not m]
    if present and all(isinstance(v, (bool, np.bool_)) for v in present):
        if not any(missing):
            return np.array(present, dtype=bool)
    elif present and all(isinstance(v, (int, float, np.integer, np.floating))
                         and not isinstance(v, (bool, np.bool_)) for v in present):
        if not any(missing) and all(isinstance(v, (int, np.integer)) for v in present):
            return np.array(values, dtype=np.int64)
        return np.array([math.nan if m else v for v, m in zip(values, missing)],
                        dtype=np.float64)
    elif not present and values:
        return np.full(len(values), math.nan)
    return np.array([math.nan if m else v for v, m in zip(values, missing)], dtype=object)


def columns_from_records(records: Iterable[dict]) -> Columns:
    """Row dicts as columns, as `pandas.DataFrame(records)` lays them out:
    keys in the order they first appear, a row without a key NaN there."""
    records = list(records)
    names = list(dict.fromkeys(k for r in records for k in r))
    return {k: object_column([r.get(k) for r in records]) for k in names}


def columns_of(table) -> Columns:
    """A DataFrame (each column `.to_numpy()`) or a dict of columns, as a
    dict of numpy columns."""
    if hasattr(table, "to_numpy") and hasattr(table, "columns"):
        return {c: table[c].to_numpy() for c in table.columns}
    return {k: np.asarray(v) for k, v in table.items()}


def records_of(cols: Columns) -> List[dict]:
    """Columns as row dicts, each cell a Python value."""
    names = list(cols)
    n = len(cols[names[0]]) if names else 0
    return [{k: (v.item() if hasattr(v, "item") else v)
             for k, v in ((k, cols[k][i]) for k in names)} for i in range(n)]


def take(cols: Columns, mask: np.ndarray) -> Columns:
    """The rows of `cols` where `mask` holds."""
    return {k: v[mask] for k, v in cols.items()}


def to_numeric(col: np.ndarray) -> np.ndarray:
    """`pandas.to_numeric(col, errors="coerce")`: a numeric column as it
    is, else each cell a number where it parses as one and NaN where it
    does not (int64 if every cell is an integer)."""
    col = np.asarray(col)
    if col.dtype.kind in "iufb":
        return col
    out = []
    for v in col:
        if is_na(v):
            out.append(math.nan)
        elif isinstance(v, (int, float, np.integer, np.floating)):
            out.append(v)
        else:
            s = str(v).strip()
            try:
                out.append(int(s))
            except ValueError:
                try:
                    out.append(float(s))
                except ValueError:
                    out.append(math.nan)
    if out and all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in out):
        return np.array(out, dtype=np.int64)
    return np.array(out, dtype=np.float64)


def lowered(col: np.ndarray) -> np.ndarray:
    """`col.astype(str).str.lower()` under pandas 3: each cell's text in
    lower case, a missing cell left missing."""
    low = {v: math.nan if is_na(v) else str(v).lower() for v in set(col.tolist())}
    return np.array([low[v] for v in col.tolist()], dtype=object)


def frame(cols: Columns):
    """Columns as a DataFrame (pandas imported here)."""
    import pandas as pd

    return pd.DataFrame(cols)
