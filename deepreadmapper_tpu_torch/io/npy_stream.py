# Copied from deepreadmapper_tpu/io/npy_stream.py, the JAX-free host layer; kept in step with it.
"""Incremental .npy writer.

The reference's `inference` tool pre-writes an npy header sized for the full
output and appends embedding batches as they stream off the model
(write_npy_header + batch loop, src/inference/test_inference.cpp:6-36,
160-227).  Same contract here: fixed row count declared up front, float32
C-order rows appended.
"""

from __future__ import annotations

import struct


class NpyStreamWriter:
    def __init__(self, path: str, n_rows: int, n_cols: int, dtype: str = "<f4"):
        self.path = path
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.dtype = dtype
        self.rows_written = 0
        self._f = open(path, "wb")
        header_dict = (
            "{'descr': '%s', 'fortran_order': False, 'shape': (%d, %d), }"
            % (dtype, n_rows, n_cols)
        )
        # Pad header to 64-byte alignment per the npy v1 spec.
        base = 10 + len(header_dict) + 1
        pad = (64 - base % 64) % 64
        header = header_dict + " " * pad + "\n"
        self._f.write(b"\x93NUMPY\x01\x00")
        self._f.write(struct.pack("<H", len(header)))
        self._f.write(header.encode("latin1"))

    @classmethod
    def resume(cls, path: str, n_rows: int, n_cols: int, dtype: str = "<f4"):
        """Reopen a partially-written stream and continue appending.

        Validates the on-disk header against the declared geometry, drops
        any trailing partial row (a crash mid-write leaves one), and
        positions at the end; `rows_written` reflects the complete rows
        already on disk.  Fresh-start fallback when the file is absent."""
        import os

        import numpy as np

        if not os.path.exists(path):
            return cls(path, n_rows, n_cols, dtype)
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != b"\x93NUMPY\x01\x00":
                raise ValueError(f"{path}: not an npy v1 file")
            (hlen,) = struct.unpack("<H", f.read(2))
            header = f.read(hlen).decode("latin1")
            import ast

            meta = ast.literal_eval(header)
            data_start = 10 + hlen
        if meta["shape"] != (n_rows, n_cols) or np.dtype(
            meta["descr"]
        ) != np.dtype(dtype):
            raise ValueError(
                f"{path}: on-disk stream is {meta['descr']} {meta['shape']}, "
                f"expected {dtype} ({n_rows}, {n_cols}) — params changed; "
                "delete the partial file to restart"
            )
        row_bytes = np.dtype(dtype).itemsize * n_cols
        data_bytes = os.path.getsize(path) - data_start
        done = min(data_bytes // row_bytes, n_rows)
        self = cls.__new__(cls)
        self.path = path
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.dtype = dtype
        self.rows_written = int(done)
        self._f = open(path, "r+b")
        self._f.truncate(data_start + done * row_bytes)
        self._f.seek(0, 2)
        return self

    def append(self, arr) -> None:
        import numpy as np

        # rows are cast to the DECLARED header dtype (f4 default; int
        # streams use the same writer)
        a = np.ascontiguousarray(arr, dtype=np.dtype(self.dtype))
        if a.ndim != 2 or a.shape[1] != self.n_cols:
            raise ValueError(f"expected [*, {self.n_cols}], got {a.shape}")
        if self.rows_written + a.shape[0] > self.n_rows:
            raise ValueError("writing past declared row count")
        self._f.write(a.tobytes())
        self.rows_written += a.shape[0]

    def truncate_to(self, rows: int) -> None:
        """Roll the stream back to `rows` complete rows (resume support:
        a crash can leave rows from a half-appended chunk; the chunk
        grid is deterministic, so callers truncate to the last chunk
        boundary and re-embed from there)."""
        import numpy as np

        if not 0 <= rows <= self.rows_written:
            raise ValueError(f"cannot truncate to {rows} rows")
        row_bytes = np.dtype(self.dtype).itemsize * self.n_cols
        self._f.flush()
        data_start = self._f.tell() - self.rows_written * row_bytes
        self._f.truncate(data_start + rows * row_bytes)
        self._f.seek(0, 2)
        self.rows_written = rows

    def close(self) -> None:
        if self.rows_written != self.n_rows:
            raise ValueError(
                f"declared {self.n_rows} rows but wrote {self.rows_written}"
            )
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._f.close()
