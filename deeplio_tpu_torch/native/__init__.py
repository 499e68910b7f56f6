"""Host C++ ops of the data pipeline (the port's copy of
``deeplio_tpu/native``): slot binning of raw scans for the slot-aligned
projection routes (``slot_bin_core.cpp``, ``slot_bin_trig.cpp``).

This is host code, not a device kernel. The library is compiled with
``g++`` on first use, each source with its own flags (the trig pass with
``-Ofast`` for libmvec, the core without fast-math), into
``<repo>/build/native/``, named by a hash of the sources and flags, and
loaded with ``ctypes``, which releases the GIL for each call, so the
loader's batch threads bin scans in parallel. ``lib()`` returns None
when it cannot be built (no ``g++``); callers then use the numpy oracle
``data/synthetic.py::slot_bin_scan_np``, which computes the same bins.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parents[1] / "build" / "native"
_SOURCES = ("slot_bin_trig.cpp", "slot_bin_core.cpp")
# per-source flags: the trig pass gets fast-math for libmvec (ulp-level
# drift of the transcendentals); the core stays exact
_FLAGS = {
    "slot_bin_trig.cpp": ["-Ofast", "-march=native", "-fopenmp"],
    "slot_bin_core.cpp": ["-O3", "-march=native", "-fopenmp",
                          "-ffp-contract=off"],
}

_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_error: Optional[str] = None


def _tag() -> str:
    h = hashlib.sha256()
    for s in _SOURCES:
        h.update((_SRC_DIR / s).read_bytes())
        h.update(" ".join(_FLAGS[s]).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libslot_bin-{_tag()}.so"


def _build(so_path: Path) -> None:
    work = BUILD_DIR / f"tmp.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs = []
        for s in _SOURCES:
            obj = work / (s + ".o")
            subprocess.run(["g++", "-c", str(_SRC_DIR / s), "-o", str(obj),
                            "-std=c++17", "-fPIC"] + _FLAGS[s],
                           check=True, capture_output=True, text=True)
            objs.append(str(obj))
        tmp_so = work / "lib.so"
        subprocess.run(["g++", "-shared", "-fopenmp", "-o", str(tmp_so)]
                       + objs + ["-lm"],
                       check=True, capture_output=True, text=True)
        # processes building at once publish the same bytes; the rename
        # is atomic
        os.replace(tmp_so, so_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    f32p, u8p, i32p = (c.POINTER(c.c_float), c.POINTER(c.c_uint8),
                       c.POINTER(c.c_int32))
    cdll.dlt_slot_bin_scan.argtypes = [
        f32p, u8p, c.c_int64, c.c_int32, c.c_int32, c.c_int32, c.c_float,
        c.c_float, c.c_float, c.c_int32, c.c_int32, f32p, u8p]
    cdll.dlt_slot_bin_scan.restype = None
    cdll.dlt_slot_bin_batch.argtypes = [
        f32p, u8p, c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
        c.c_float, c.c_float, c.c_float, c.c_int32, c.c_int32, f32p, u8p]
    cdll.dlt_slot_bin_batch.restype = None
    cdll.dlt_slot_bin_from_keys.argtypes = [
        i32p, i32p, u8p, c.c_int64, c.c_int32, c.c_int32, c.c_int32, i32p]
    cdll.dlt_slot_bin_from_keys.restype = None
    cdll.dlt_yaw_pitch.argtypes = [f32p, f32p, f32p, c.c_int64, f32p, f32p]
    cdll.dlt_yaw_pitch.restype = None
    return cdll


def lib() -> Optional[ctypes.CDLL]:
    """The native library, built on the first call; None if it cannot be
    built (the reason: :func:`build_error`)."""
    global _lib, _tried, _build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so_path = library_path()
    try:
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build(so_path)
        _lib = _bind(ctypes.CDLL(str(so_path)))
    except (OSError, subprocess.CalledProcessError) as e:
        _build_error = (getattr(e, "stderr", None) or str(e))[:2000]
        _lib = None
    return _lib


def build_error() -> Optional[str]:
    return _build_error
