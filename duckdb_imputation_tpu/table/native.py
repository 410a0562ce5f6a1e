"""ctypes binding for the native columnar store / CSV loader
(native/columnar.cpp) — the C++ host-runtime half of the framework: parse
and encode on CPU threads, hand dense features-first buffers to JAX.

The shared library is not tracked: it is built from native/columnar.cpp
with `make` on first use (and rebuilt when its ABI is older than this
checkout's).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..schema import FeatureSchema
from .table import Table, from_numpy

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libdbi_native.so"))
_lib = None


def _build():
    """Build to a temporary name, then rename into place: a concurrent
    loader never sees a half-written library, and the rename gives the
    new library a fresh inode (glibc's dlopen caches by (dev, inode))."""
    tmp = f"libdbi_native.so.{os.getpid()}.tmp"
    res = subprocess.run(
        ["make", "-B", "-C", os.path.abspath(_NATIVE_DIR), f"TARGET={tmp}"],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the native library failed "
                           f"(make -C native):\n{res.stdout}{res.stderr}")
    os.replace(os.path.join(os.path.abspath(_NATIVE_DIR), tmp), _LIB_PATH)


_ABI_VERSION = 3


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    # stale-.so guard: rebuild when the checkout's ABI moved past the
    # compiled library (a missing-symbol crash otherwise)
    try:
        lib.dbi_version.restype = ctypes.c_int64
        stale = lib.dbi_version() < _ABI_VERSION
    except AttributeError:
        stale = True
    if stale:
        del lib
        _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.dbi_version.restype = ctypes.c_int64
        if lib.dbi_version() < _ABI_VERSION:
            raise RuntimeError(
                f"{_LIB_PATH} reports ABI {lib.dbi_version()} after a "
                f"rebuild; this checkout needs {_ABI_VERSION}")
    lib.dbi_load_csv.restype = ctypes.c_void_p
    lib.dbi_load_csv.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.dbi_free.argtypes = [ctypes.c_void_p]
    lib.dbi_error.restype = ctypes.c_char_p
    lib.dbi_error.argtypes = [ctypes.c_void_p]
    lib.dbi_n_rows.restype = ctypes.c_int64
    lib.dbi_n_rows.argtypes = [ctypes.c_void_p]
    lib.dbi_n_cols.restype = ctypes.c_int64
    lib.dbi_n_cols.argtypes = [ctypes.c_void_p]
    lib.dbi_col_is_numeric.restype = ctypes.c_int
    lib.dbi_col_is_numeric.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_is_string.restype = ctypes.c_int
    lib.dbi_col_is_string.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_labels_bytes.restype = ctypes.c_int64
    lib.dbi_col_labels_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_labels_fill.restype = None
    lib.dbi_col_labels_fill.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_char_p]
    lib.dbi_col_name.restype = ctypes.c_char_p
    lib.dbi_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_f32.restype = ctypes.POINTER(ctypes.c_float)
    lib.dbi_col_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_i64.restype = ctypes.POINTER(ctypes.c_int64)
    lib.dbi_col_i64.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_null_mask.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.dbi_col_null_mask.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_vocab_size.restype = ctypes.c_int64
    lib.dbi_col_vocab_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_vocab.restype = ctypes.POINTER(ctypes.c_int64)
    lib.dbi_col_vocab.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_col_codes.restype = ctypes.POINTER(ctypes.c_int32)
    lib.dbi_col_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_swap_col_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float)]
    lib.dbi_swap_col_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_int32)]
    lib.dbi_csv_open.restype = ctypes.c_void_p
    lib.dbi_csv_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.dbi_csv_stream_error.restype = ctypes.c_char_p
    lib.dbi_csv_stream_error.argtypes = [ctypes.c_void_p]
    lib.dbi_csv_stream_ncols.restype = ctypes.c_int64
    lib.dbi_csv_stream_ncols.argtypes = [ctypes.c_void_p]
    lib.dbi_csv_stream_col_name.restype = ctypes.c_char_p
    lib.dbi_csv_stream_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_csv_next_chunk.restype = ctypes.c_void_p
    lib.dbi_csv_next_chunk.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dbi_csv_close.argtypes = [ctypes.c_void_p]
    lib.dbi_format_csv.restype = ctypes.c_int64
    lib.dbi_format_csv.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int]
    _lib = lib
    return lib


def format_csv_block(cols, is_int, n_threads: int = 0) -> memoryview:
    """Format a chunk of columns into CSV text natively (multithreaded
    to_chars — the write-back half of the out-of-core path, in place of
    np.savetxt). cols: list of [m] arrays; is_int[c] selects integer
    formatting (exact to 2^53) vs float. Float cells are NARROWED TO f32
    and emitted as the shortest f32 round-trip repr — bit-exact through
    reload for the pipeline's f32 tables, lossy for genuine f64 input.
    NaN ⇒ empty field (the loader's null convention). Returns a
    memoryview over the formatted bytes in a buffer of its own — file
    writes take it without a copy; `bytes(...)` makes a bytes object."""
    lib = load_library()
    k = len(cols)
    m = len(cols[0]) if k else 0
    data = np.ascontiguousarray(np.stack(
        [np.asarray(c, np.float64) for c in cols]))
    flags = np.asarray(is_int, np.uint8)
    cap = int(m * (27 * k + 2))
    # numpy-backed buffer: create_string_buffer zeroes + .raw copies,
    # ~10x the formatting cost at 100MB chunks; a memoryview slice is free
    buf = np.empty(cap, np.uint8)
    nb = lib.dbi_format_csv(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), k, m,
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.ctypes.data_as(ctypes.c_char_p), cap, n_threads)
    if nb < 0:
        raise RuntimeError("dbi_format_csv: buffer too small")
    return memoryview(buf)[:nb]


class NativeTable:
    """Thin RAII wrapper over the native table handle with zero-copy numpy
    views of the columnar buffers."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        err = lib.dbi_error(handle)
        if err:
            raise RuntimeError(err.decode())

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dbi_free(self._h)
            self._h = None

    @property
    def n_rows(self) -> int:
        return self._lib.dbi_n_rows(self._h)

    @property
    def n_cols(self) -> int:
        return self._lib.dbi_n_cols(self._h)

    def col_name(self, c: int) -> str:
        return self._lib.dbi_col_name(self._h, c).decode()

    def is_numeric(self, c: int) -> bool:
        return bool(self._lib.dbi_col_is_numeric(self._h, c))

    def is_string(self, c: int) -> bool:
        return bool(self._lib.dbi_col_is_string(self._h, c))

    def col_labels(self, c: int) -> tuple[str, ...]:
        """Sorted label dictionary of a string-categorical column; raw
        value v decodes to labels[v]."""
        nbytes = self._lib.dbi_col_labels_bytes(self._h, c)
        if nbytes == 0:
            return ()
        buf = ctypes.create_string_buffer(int(nbytes))
        self._lib.dbi_col_labels_fill(self._h, c, buf)
        return tuple(buf.raw.decode().split("\n")[:-1])

    def _view(self, ptr, dtype):
        return np.ctypeslib.as_array(ptr, shape=(self.n_rows,)).view(dtype)

    def col_f32(self, c: int) -> np.ndarray:
        return np.ctypeslib.as_array(self._lib.dbi_col_f32(self._h, c),
                                     shape=(self.n_rows,))

    def col_i64(self, c: int) -> np.ndarray:
        return np.ctypeslib.as_array(self._lib.dbi_col_i64(self._h, c),
                                     shape=(self.n_rows,))

    def col_null(self, c: int) -> np.ndarray:
        return np.ctypeslib.as_array(
            self._lib.dbi_col_null_mask(self._h, c),
            shape=(self.n_rows,)).astype(bool)

    def col_vocab(self, c: int) -> np.ndarray:
        v = self._lib.dbi_col_vocab_size(self._h, c)
        if v == 0:
            return np.zeros((0,), np.int64)
        return np.ctypeslib.as_array(self._lib.dbi_col_vocab(self._h, c),
                                     shape=(v,))

    def col_codes(self, c: int) -> np.ndarray:
        return np.ctypeslib.as_array(self._lib.dbi_col_codes(self._h, c),
                                     shape=(self.n_rows,))

    def swap_col_f32(self, c: int, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, np.float32)
        self._lib.dbi_swap_col_f32(
            self._h, c, values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def to_table(self) -> Table:
        """Assemble the device Table (features-first + null masks + schema)
        from the native buffers."""
        num_idx = [c for c in range(self.n_cols) if self.is_numeric(c)]
        cat_idx = [c for c in range(self.n_cols) if not self.is_numeric(c)]
        n = self.n_rows
        num = np.zeros((len(num_idx), n), np.float32)
        num_null = np.zeros((len(num_idx), n), bool)
        for j, c in enumerate(num_idx):
            num[j] = self.col_f32(c)
            num_null[j] = self.col_null(c)
        cat = np.zeros((len(cat_idx), n), np.int64)
        cat_null = np.zeros((len(cat_idx), n), bool)
        keys, labels = [], []
        for j, c in enumerate(cat_idx):
            cat[j] = self.col_i64(c)
            cat_null[j] = self.col_null(c)
            keys.append(tuple(int(v) for v in self.col_vocab(c)))
            labels.append(self.col_labels(c) if self.is_string(c) else None)
        schema = FeatureSchema(num_cols=len(num_idx), cat_keys=tuple(keys))
        t = from_numpy(
            num, cat, num_null, cat_null,
            num_names=tuple(self.col_name(c) for c in num_idx),
            cat_names=tuple(self.col_name(c) for c in cat_idx),
            schema=schema, rows_first=False)
        if any(lb is not None for lb in labels):
            import dataclasses
            t = dataclasses.replace(t, cat_labels=tuple(labels))
        return t


def load_csv(path: str, has_header: bool = True,
             n_threads: int = 0) -> NativeTable:
    """Load a CSV through the native multithreaded parser."""
    lib = load_library()
    h = lib.dbi_load_csv(path.encode(), 1 if has_header else 0, n_threads)
    return NativeTable(h, lib)


def read_csv(path: str, has_header: bool = True) -> Table:
    """CSV -> device Table in one call (the framework's data-loading front
    door)."""
    return load_csv(path, has_header).to_table()


class CsvStream:
    """Chunked native CSV reader for the out-of-core path: each
    next_chunk() parses ~block_bytes on CPU threads and returns a
    standalone NativeTable. Column types are fixed from the first chunk.
    Column split (numeric vs categorical, file order within kind) matches
    NativeTable.to_table so streamed and resident schemas line up."""

    def __init__(self, path: str, has_header: bool = True,
                 block_bytes: int = 64 << 20, n_threads: int = 0):
        self._lib = load_library()
        self._h = self._lib.dbi_csv_open(
            path.encode(), 1 if has_header else 0, n_threads)
        self.block_bytes = block_bytes
        err = self._lib.dbi_csv_stream_error(self._h)
        if err:
            raise RuntimeError(err.decode())

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dbi_csv_close(self._h)
            self._h = None

    @property
    def col_names(self) -> tuple[str, ...]:
        n = self._lib.dbi_csv_stream_ncols(self._h)
        return tuple(self._lib.dbi_csv_stream_col_name(self._h, c).decode()
                     for c in range(n))

    def next_chunk(self) -> NativeTable | None:
        h = self._lib.dbi_csv_next_chunk(self._h, self.block_bytes)
        if not h:
            err = self._lib.dbi_csv_stream_error(self._h)
            if err:
                raise RuntimeError(err.decode())
            return None
        return NativeTable(h, self._lib)


def csv_chunk_source(path: str, has_header: bool = True,
                     block_bytes: int = 64 << 20, n_threads: int = 0):
    """Chunk source over a CSV file for ring.streaming / mice.streaming:
    a callable returning an iterator of (num, cat, num_null, cat_null)
    features-first chunks. Each call re-opens the file (the streaming
    aggregation makes two passes). The chunk arrays COPY out of the native
    buffers so the NativeTable can be freed eagerly."""

    def source():
        stream = CsvStream(path, has_header, block_bytes, n_threads)
        while True:
            nt = stream.next_chunk()
            if nt is None:
                return
            num_idx = [c for c in range(nt.n_cols) if nt.is_numeric(c)]
            cat_idx = [c for c in range(nt.n_cols) if not nt.is_numeric(c)]
            m = nt.n_rows
            num = np.empty((len(num_idx), m), np.float32)
            num_null = np.empty((len(num_idx), m), bool)
            for j, c in enumerate(num_idx):
                num[j] = nt.col_f32(c)
                num_null[j] = nt.col_null(c)
            cat = np.empty((len(cat_idx), m), np.int64)
            cat_null = np.empty((len(cat_idx), m), bool)
            for j, c in enumerate(cat_idx):
                cat[j] = nt.col_i64(c)
                cat_null[j] = nt.col_null(c)
            yield num, cat, num_null, cat_null
    return source
