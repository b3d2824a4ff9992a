"""CSV tables as ordered dicts of numpy columns: the port's counterpart
of the pandas calls the JAX package's host pipeline makes, on the
standard library's ``csv`` module and numpy alone.

A table is a ``dict`` of column name -> 1-D numpy array, in file order,
all of one length. Semantics kept from ``pd.read_csv(path, dtype=...)``
and the frame methods the pipeline uses:

- ``str`` columns hold Python ``str`` (object arrays), ``float`` columns
  float64, ``int`` columns int64; a column without a dtype is read as
  ``str`` (the pipeline reads no such column);
- a cell in pandas' default ``na_values`` (``NA_VALUES``) is missing:
  NaN in a float column, ``None`` in a ``str`` column (pandas' NaN
  there), and an error in an int column, as in pandas;
- blank lines are skipped;
- ``take`` is ``frame.take(rows).reset_index()``: the taken rows with
  their old positions in a new leading ``index`` column (``level_0``
  when ``index`` exists);
- ``write_csv`` is ``to_csv(index=False)``: floats by ``repr``, missing
  cells empty, minimal quoting.
"""

import csv

import numpy as np

#: pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
                       "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
                       "None", "n/a", "nan", "null"])

_DTYPE_NAMES = {str: "str", float: "float", int: "int",
                "str": "str", "float": "float", "int": "int"}


def _dtype_name(dtype):
    if dtype is None:
        return None
    if dtype not in _DTYPE_NAMES:
        raise NotImplementedError("column dtype={!r}".format(dtype))
    return _DTYPE_NAMES[dtype]


def _parse_float(cells):
    try:
        return np.array(cells, dtype=np.float64)
    except ValueError:
        return np.array([np.nan if v in NA_VALUES else float(v) for v in cells],
                        dtype=np.float64)


def _parse_int(cells, name):
    if any(v in NA_VALUES for v in cells):
        raise ValueError("Integer column {} has NA values".format(name))
    return np.array([int(v) for v in cells], dtype=np.int64)


def _parse_str(cells):
    return np.array([None if v in NA_VALUES else v for v in cells], dtype=object)


def _parse(cells, dtype, name):
    kind = _dtype_name(dtype)
    if kind == "float":
        return _parse_float(cells)
    if kind == "int":
        return _parse_int(cells, name)
    return _parse_str(cells)


def _read_one(path, dtypes):
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = list(filter(None, reader))
    widths = set(map(len, rows))
    if widths - {len(header)}:
        raise ValueError("{}: rows of {} cells under a header of {}".format(
            path, sorted(widths - {len(header)}), len(header)))
    cols = list(zip(*rows)) if rows else [()] * len(header)
    return {name: _parse(cells, dtypes.get(name), name)
            for name, cells in zip(header, cols)}


def read_csv(paths, dtypes=None):
    """One table from one CSV path or several (rows concatenated);
    ``dtypes`` maps column -> ``str``/``float``/``int`` (or their
    names)."""
    paths = [paths] if isinstance(paths, str) else list(paths)
    tables = [_read_one(p, dtypes or {}) for p in paths]
    return tables[0] if len(tables) == 1 else concat(tables)


def num_rows(table):
    return len(next(iter(table.values()))) if table else 0


def is_missing(values):
    """Boolean mask of missing cells (pandas ``isnull``)."""
    if values.dtype == object:
        return np.fromiter((v is None or (isinstance(v, float) and v != v)
                            for v in values), dtype=bool, count=len(values))
    if values.dtype.kind == "f":
        return np.isnan(values)
    return np.zeros(len(values), dtype=bool)


def take(table, rows):
    """``frame.take(rows).reset_index()``: the rows, in the given order,
    with their old positions as a leading ``index`` column."""
    rows = np.asarray(rows, dtype=np.int64)
    name = "index" if "index" not in table else "level_0"
    if name in table:
        raise ValueError("cannot insert level_0, already exists")
    out = {name: rows.copy()}
    out.update((k, v[rows]) for k, v in table.items())
    return out


def concat(tables):
    """Rows of several tables, one after another, over the union of
    their columns (a column a table lacks is missing there)."""
    names = list(dict.fromkeys(n for t in tables for n in t))
    out = {}
    for name in names:
        parts = [t[name] if name in t else np.full(num_rows(t), np.nan)
                 for t in tables]
        out[name] = np.concatenate(parts)
    return out


def _format(values):
    if values.dtype.kind == "f":
        return ["" if v != v else repr(v) for v in values.tolist()]
    if values.dtype == object:
        return ["" if v is None or (isinstance(v, float) and v != v) else str(v)
                for v in values.tolist()]
    return [str(v) for v in values.tolist()]


def write_csv(path, table, mode="w", header=True):
    """Write (or with ``mode="a"`` append) the table as CSV."""
    with open(path, mode, newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        if header:
            writer.writerow(list(table))
        writer.writerows(zip(*(_format(v) for v in table.values())))
