"""A CSV reader for the dataset classes, without pandas (the card's machine
has none).

Counterpart of the JAX package's `_read_csv` (`pandas.read_csv(path)` with
its defaults): `read_csv` gives the values and types that the dataset
classes read from a pandas frame, and the few operations they use.

- The first row names the columns (a UTF-8 byte-order mark dropped, a
  repeated name `a` renamed `a.1`, `a.2`, ...); blank lines are skipped;
  quoted fields follow the `csv` module's default dialect, as pandas' do;
  a row shorter than the header is filled with missing values, a longer
  one raises.
- A field in pandas' default NA list (the empty field, "NA", "nan",
  "null", ...) is missing: NaN.  A column whose every field is an integer
  reads as int; otherwise one whose every field is a number, or missing,
  as float; one of "True"/"true"/"TRUE" and "False"/... as bool;
  anything else as str, its missing fields NaN.  Numbers are pandas'
  forms: surrounding spaces, a sign, digits, a decimal point, an exponent,
  "inf" / "infinity" in any case; not "1_000" or "0x1f".  A bool column
  with missing fields is an object column of bools and NaN.
- `Frame`: `frame[name]` (a `Column`), `frame[mask]` (the rows where a
  bool column or list is true, keeping their row numbers), `len`,
  `columns`, `iterrows()` ((row number, `Row`) in file order), `values` (int64 when every column is int, float64
  when every column is numeric, else an object array of Python values).
  A `Row` holds that row of `values`, so an all-numeric frame's ints read
  as floats there, as pandas upcasts them.
- `Column`: `tolist()`, `isin(values)` (numbers equal by value, strings
  by value: an int column matches no str), `astype(str)` (1.0 -> "1.0";
  NaN stays missing, as pandas 3's string dtype keeps it),
  `unique()` in order of appearance, iteration, `len`.
"""

from __future__ import annotations

import csv as _csv
import math
import re

import numpy as np

# pandas' default `na_values`
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
TRUE_VALUES = frozenset({"True", "TRUE", "true"})
FALSE_VALUES = frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"\s*[+-]?\d+\s*\Z")
_FLOAT = re.compile(
    r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*\Z",
    re.IGNORECASE)


def _column(fields: list[str]) -> tuple[str, list]:
    """The fields of one column -> (dtype, values)."""
    present = [f for f in fields if f not in NA_VALUES]
    missing = len(present) < len(fields)
    if present and not missing and all(_INT.match(f) for f in present):
        return "int64", [int(f) for f in fields]
    if all(_FLOAT.match(f) for f in present):
        return "float64", [math.nan if f in NA_VALUES else float(f)
                           for f in fields]
    if present and all(f in TRUE_VALUES or f in FALSE_VALUES
                       for f in present):
        return ("object" if missing else "bool"), [
            math.nan if f in NA_VALUES else f in TRUE_VALUES
            for f in fields]
    return "str", [math.nan if f in NA_VALUES else f for f in fields]


class Column:
    """One column of a `Frame`: its name, pandas' dtype name and values."""

    def __init__(self, name: str, dtype: str, values: list):
        self.name, self.dtype, self._values = name, dtype, list(values)

    def __len__(self):
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def tolist(self) -> list:
        return list(self._values)

    def isin(self, values) -> Column:
        """Per value, whether it equals one of `values`: numbers by value,
        strings by value, a number never a string; NaN matches a NaN."""
        values = list(values)
        numbers = {float(v) for v in values if _is_number(v)}
        strings = {v for v in values if isinstance(v, str)}
        nan = any(_isnan(v) for v in values)
        return Column(self.name, "bool", [
            nan if _isnan(v) else
            float(v) in numbers if _is_number(v) else v in strings
            for v in self._values])

    def astype(self, kind) -> Column:
        if kind is not str:
            raise NotImplementedError(f"astype({kind!r}): only str")
        return Column(self.name, "str", [v if _isnan(v) else _as_str(v)
                                         for v in self._values])

    def unique(self) -> list:
        seen, out = set(), []
        for v in self._values:
            k = "nan" if _isnan(v) else v
            if k not in seen:
                seen.add(k)
                out.append(v)
        return out


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) \
        and not _isnan(v)


def _isnan(v) -> bool:
    return isinstance(v, (float, np.floating)) and math.isnan(v)


def _as_str(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


class Row:
    """One row of a `Frame`: `row[name]`, `row.values`."""

    def __init__(self, columns: dict, values):
        self._at, self.values = columns, values

    def __getitem__(self, name):
        return self.values[self._at[name]]


class Frame:
    """The columns of a CSV file, in file order."""

    def __init__(self, columns: list[Column], index=None):
        self._columns = columns
        self._at = {c.name: i for i, c in enumerate(columns)}
        self.index = list(range(len(self))) if index is None else index

    @property
    def columns(self) -> list[str]:
        return [c.name for c in self._columns]

    def __len__(self):
        return len(self._columns[0]) if self._columns else 0

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._columns[self._at[key]]
        mask = list(key)
        if len(mask) != len(self):
            raise ValueError(f"a mask of {len(mask)} rows for {len(self)}")
        return Frame([Column(c.name, c.dtype,
                             [v for v, m in zip(c, mask) if m])
                      for c in self._columns],
                     [i for i, m in zip(self.index, mask) if m])

    @property
    def values(self) -> np.ndarray:
        dtypes = {c.dtype for c in self._columns}
        if dtypes == {"int64"}:
            dtype = np.int64
        elif dtypes <= {"int64", "float64"}:
            dtype = np.float64
        elif dtypes == {"bool"}:
            dtype = np.bool_
        else:
            dtype = object
        out = np.empty((len(self), len(self._columns)), dtype)
        for j, c in enumerate(self._columns):
            for i, v in enumerate(c):
                out[i, j] = v
        return out

    def iterrows(self):
        for i, values in zip(self.index, self.values):
            yield i, Row(self._at, values)


def _names(header: list[str]) -> list[str]:
    """pandas' renaming of repeated column names: a, a.1, a.2, ..."""
    seen, out = {}, []
    for name in header:
        new = name
        while new in seen:
            seen[name] += 1
            new = f"{name}.{seen[name]}"
        seen.setdefault(new, 0)
        out.append(new)
    return out


def read_csv(path: str) -> Frame:
    """A CSV file -> `Frame`, as `pandas.read_csv(path)` reads it (see the
    module's docstring for what is covered)."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in _csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    header, body = _names(rows[0]), rows[1:]
    for n, r in enumerate(body, 2):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {n} has {len(r)} fields, the "
                             f"header {len(header)}")
    cols = []
    for j, name in enumerate(header):
        dtype, values = _column([r[j] if j < len(r) else "" for r in body])
        cols.append(Column(name, dtype, values))
    return Frame(cols)
