# Copied from deepreadmapper_tpu/utils/logging.py, the JAX-free host layer; kept in step with it.
"""Structured-prefix logging (reference: [MAIN]/[POST-PROCESS]/[BATCH]
std::cout logging throughout src/main.cpp and src/utils/post_processor.cpp,
gated by Config::VERBOSE)."""

from __future__ import annotations

import sys
import time

_VERBOSE = True
_T0 = time.time()


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = v


def log(tag: str, msg: str) -> None:
    if _VERBOSE:
        print(f"[{tag}] {msg}", file=sys.stderr)


def log_timed(tag: str, msg: str) -> None:
    if _VERBOSE:
        print(f"[{tag}] +{time.time() - _T0:8.2f}s {msg}", file=sys.stderr)
