"""The JAX package's native library, loaded in spite of a concurrent build.

``deepreadmapper_tpu/native.py`` compiles its library with g++ straight
onto the final path and takes any file there as finished, and its
``_tried`` flag keeps a failed load for the life of the process.  Under
pytest-xdist several workers start at once on a fresh tree: one compiles,
and another that loads the half-written file has no JAX native library
for the rest of the run -- its CIGARs, mate rescue and fast paths quietly
go missing, and the port tests that compare against those JAX functions
fail.  The JAX package stays as it is; the port's tests that call a JAX
function reaching ``deepreadmapper_tpu.native`` in process use the fixture
below before their first such call."""

import os
import shutil
import time

import pytest

from deepreadmapper_tpu import native as jnative


def can_build() -> bool:
    """g++ and the library's sources are there."""
    return shutil.which("g++") is not None and os.path.exists(jnative._SRC)


def jax_native_available(settle_s: float = 2.0, limit_s: float = 60.0) -> bool:
    """jnative.available(), robust to another test process that is still
    compiling the reference library: when it reports unavailable though g++
    and its sources exist, wait until the file has stopped changing, clear
    the module's cache (``_lib``, ``_tried``) and load again.  A file still
    missing after two polls has no writer: the load then builds it itself
    (or fails fast)."""
    if jnative.available():
        return True
    if not can_build():
        return False
    deadline = time.monotonic() + limit_s
    last, missing = None, 0
    while time.monotonic() < deadline:
        try:
            st = os.stat(jnative._SO)
            now = (st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            now = None
            missing += 1
        if (now is not None and now == last) or missing >= 2:
            break
        last = now
        time.sleep(settle_s)
    jnative._lib = None
    jnative._tried = False
    return jnative.available()


def require_jax_native() -> bool:
    """jax_native_available(), asserted where g++ and the sources exist."""
    ok = jax_native_available()
    if can_build():
        assert ok, f"the JAX package's native library did not load ({jnative._SO})"
    return ok


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    """Module fixture: the JAX native library is loaded before the module's
    first test (import it into a test module to apply it there)."""
    require_jax_native()
