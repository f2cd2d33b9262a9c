"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is a plain C entry point of one ``csrc/<source>.cu`` (by default
``csrc/<name>.cu``; the four IVF scans share ``csrc/ivf_chunk.cu``).  At
first use the source is compiled by nvcc for ``sm_90a`` into a shared
library and loaded with ctypes.  The library's file name carries a hash of
the sources and flags: dlopen caches by path, so a rebuilt library under an
old name would hand back the stale handle (the same trap ``native``
records).  There is no fallback: a missing nvcc or a failed build raises.

Each C entry takes every pointer and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` (``<source>_error_string`` names it);
:meth:`CudaKernel.launch` raises when it is not 0 and otherwise adds one to
the kernel's launch count.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch was built against."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (CUDA_HOME unset); the port's kernels "
            "need nvcc to build"
        )
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


class CudaKernel:
    """One C entry point of a ``csrc/<source>.cu`` and its launch count."""

    def __init__(self, name: str, argtypes: list, source: str | None = None):
        self.name = name
        self.source_name = source or name
        self.source = os.path.join(CSRC, self.source_name + ".cu")
        self.argtypes = argtypes
        self.launches = 0
        self.build_seconds: float | None = None
        self.build_log = ""
        self._fn = None
        self._errstr = None
        self._lock = threading.Lock()

    def so_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [
            self.source
        ]:
            with open(path, "rb") as f:
                h.update(f.read())
        return os.path.join(BUILD_DIR, f"{self.source_name}-{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile the source unless a library for it already exists;
        returns the library path.  ``build_log`` keeps nvcc's ptxas report
        (registers, shared memory, spills) of the compile that ran."""
        so = self.so_path()
        if os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {self.source}:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        return so

    def _load(self):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(self.build())
                fn = getattr(lib, self.name)
                fn.argtypes = self.argtypes
                fn.restype = _I
                err = getattr(lib, self.source_name + "_error_string")
                err.argtypes = [_I]
                err.restype = ctypes.c_char_p
                self._errstr = err
                self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry (which launches on the given stream) and count it."""
        code = self._load()(*args)
        if code != 0:
            msg = self._errstr(code).decode()
            raise RuntimeError(f"{self.name}: CUDA error {code} ({msg})")
        self.launches += 1


# gru_fwd(x, w, bzr, r, rbh, hs, h_last, t_steps, batch, din, reverse, bf16, stream)
GRU_FWD = CudaKernel("gru_fwd", [_P] * 7 + [_I] * 5 + [_P])
# gru_bwd(h_prev, z, r, n, gnb, ct, rT, dgx, dghn, t_steps, batch, reverse, stream)
GRU_BWD = CudaKernel("gru_bwd", [_P] * 9 + [_I] * 3 + [_P])
# int8_winmin(q8, r8, vals, args, qp, np, w, ntotal, ratio2, stream)
INT8_WINMIN = CudaKernel("int8_winmin", [_P] * 4 + [_I] * 4 + [_F, _P])
# sw_score(a, alen, b, blen, out, scratch, np, lr, lc, groups, strip, passes,
#          tier, stream)
SW_SCORE = CudaKernel("sw_score", [_P] * 6 + [_I] * 7 + [_P])
# sw_score_by_id(genome, glen, ids, q, qlen, pairs_a_query, first, windows_rows,
#                out, scratch, np, lr, lc, groups, strip, passes, tier, stream)
SW_SCORE_BY_ID = CudaKernel("sw_score_by_id", [_P, _L] + [_P] * 3 + [_I] * 3 + [_P] * 2
                            + [_I] * 7 + [_P], "sw_score")
# pq_winmin(q8, codes, cent8, vals, args, qp, np, w, ntotal, ratio2, m, ksub, stream)
PQ_WINMIN = CudaKernel("pq_winmin", [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P])

# ivf_chunk_int8(step_chunk, vfirst, vcount, qsteps, codes, rn, out, n_visits,
#                ratio2, stream)
IVF_CHUNK_INT8 = CudaKernel("ivf_chunk_int8", [_P] * 7 + [_I, _F, _P], "ivf_chunk")
# ivf_chunk_int8_fold(step_chunk, vfirst, vcount, qsteps, codes, rn, order,
#                     qstart, qcount, scratch, facc, n_visits, nq, rows, ratio2,
#                     stream)
IVF_CHUNK_INT8_FOLD = CudaKernel("ivf_chunk_int8_fold", [_P] * 11 + [_I] * 3 + [_F, _P],
                                 "ivf_chunk")
# ivf_chunk_pq(step_chunk, vfirst, vcount, qsteps, packed, rn, cent, out,
#              n_visits, ratio2, m, ksub, stream)
IVF_CHUNK_PQ = CudaKernel("ivf_chunk_pq", [_P] * 8 + [_I, _F, _I, _I, _P], "ivf_chunk")
# ivf_chunk_pq_fold(step_chunk, vfirst, vcount, qsteps, packed, rn, cent, order,
#                   qstart, qcount, scratch, facc, n_visits, nq, rows, ratio2,
#                   m, ksub, stream)
IVF_CHUNK_PQ_FOLD = CudaKernel("ivf_chunk_pq_fold",
                               [_P] * 12 + [_I] * 3 + [_F, _I, _I, _P], "ivf_chunk")

# ivf_fold(states, order, qstart, qcount, facc, nq, rows, stream): the fold
# pass of the two fold scans alone, for timing it; not a kernel of its own
# (the main path runs it inside ivf_chunk_int8_fold / ivf_chunk_pq_fold), so
# not in ALL
IVF_FOLD = CudaKernel("ivf_fold", [_P] * 5 + [_I] * 2 + [_P], "ivf_chunk")

# sw_dpx_rate(out, blocks, iters, s32, stream): a loop of DPX add-max
# instructions (16-bit halves, or 32-bit values when s32 is 1), the rates
# sw_score's bounds divide by; not a kernel of the main path, so not in ALL
SW_DPX_RATE = CudaKernel("sw_dpx_rate", [_P] + [_I] * 3 + [_P], "sw_score")

# sw_comp_table(out): the complement table the by-id flavour reads, copied
# to host memory for the tests; not a kernel, so not in ALL
SW_COMP_TABLE = CudaKernel("sw_comp_table", [_P], "sw_score")

ALL = (GRU_FWD, INT8_WINMIN, SW_SCORE, SW_SCORE_BY_ID, PQ_WINMIN, IVF_CHUNK_INT8,
       IVF_CHUNK_INT8_FOLD, IVF_CHUNK_PQ, IVF_CHUNK_PQ_FOLD, GRU_BWD)


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0


def counts() -> dict[str, int]:
    return {k.name: k.launches for k in ALL}
