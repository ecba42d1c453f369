"""Build + load the native exact scorer (the host C++ library of
``string_grouper_tpu.native``, copied so the port stands alone).

Compiles ``exact_scorer.cpp`` with the system C++ compiler into a cached
shared library (keyed by source hash) and binds it with ctypes.  No
pybind11/pip machinery: one translation unit, ``extern "C"`` ABI.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).with_name("exact_scorer.cpp")
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _cache_dir() -> Optional[Path]:
    """Per-user cache directory (mode 0700, ownership-checked).

    A world-readable shared location would let another local user plant a
    pre-built ``.so`` that gets dlopen'd into this process, so the cache
    lives under the user's home/XDG cache and is refused when its ownership
    or permissions are off.
    """
    d = os.environ.get("STRING_GROUPER_TPU_TORCH_NATIVE_CACHE")
    if d:
        p = Path(d)
    else:
        xdg = os.environ.get("XDG_CACHE_HOME")
        try:
            base = Path(xdg) if xdg else Path.home() / ".cache"
        except RuntimeError:  # HOME unresolvable (daemon/container)
            return None
        p = base / "string_grouper_tpu_torch" / "native"
    try:
        p.mkdir(parents=True, exist_ok=True, mode=0o700)
        if hasattr(os, "geteuid"):
            st = p.stat()
            if st.st_uid != os.geteuid() or (st.st_mode & 0o022):
                return None
    except OSError:
        return None
    return p


_CXXFLAGS = [
    # -std pinned: the source needs C++17, and older compilers default
    # below it (a silent compile failure disables the whole native layer).
    # -ffp-contract=off: no FMA contraction -- the exact scorer and encoder
    # must round identically to numpy (multiply THEN add), bit for bit.
    "-O3", "-std=c++17", "-march=native", "-ffp-contract=off", "-fopenmp",
    "-shared", "-fPIC",
]


def _host_cpu_key() -> bytes:
    """Microarchitecture discriminator for the cache key: -march=native
    output run on a lesser CPU (shared home dirs) would SIGILL, and
    platform.machine() alone cannot tell two x86-64 generations apart, so
    include the kernel's CPU flags when available."""
    host = f"{platform.machine()}:{platform.processor()}"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    host += ":" + line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return host.encode()


def _compiler_key(cxx: str) -> bytes:
    """Compiler identity+version for the cache key (g++<->clang++ or a
    version switch must not reuse the other's binary)."""
    try:
        r = subprocess.run(
            [cxx, "--version"], capture_output=True, timeout=10
        )
        return cxx.encode() + b":" + r.stdout.splitlines()[0]
    except Exception:
        return cxx.encode()


#: why the last build attempt produced no library (None after success)
BUILD_ERROR: Optional[str] = None


def _compilers():
    """$CXX first, then the usual names on PATH: a $CXX that cannot build
    with -fopenmp (e.g. a wrapper without libgomp) must not disable the
    native layer when another compiler can."""
    seen = []
    for c in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if c and c not in seen:
            seen.append(c)
    return seen


def _build() -> Optional[Path]:
    global BUILD_ERROR
    try:
        src = _SRC.read_bytes()
    except OSError:  # packaged without the source: numpy fallbacks
        BUILD_ERROR = f"{_SRC} is missing"
        return None
    cache = _cache_dir()
    if cache is None:
        BUILD_ERROR = "no usable per-user cache directory"
        return None
    errors = []
    for cxx in _compilers():
        key = b"\0".join(
            [src, _host_cpu_key(), _compiler_key(cxx),
             " ".join(_CXXFLAGS).encode()]
        )
        tag = hashlib.sha256(key).hexdigest()[:16]
        out = cache / f"exact_scorer_{tag}.so"
        try:
            if out.exists():
                if hasattr(os, "geteuid") and out.stat().st_uid != os.geteuid():
                    errors.append(f"{out} is owned by another user")
                    continue
                BUILD_ERROR = None
                return out
        except OSError:  # racing deletion between exists() and stat()
            continue
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
        cmd = [cxx, *_CXXFLAGS, str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except subprocess.CalledProcessError as e:
            errors.append(f"{cxx}: {e.stderr.decode(errors='replace')[-500:]}")
            continue
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{cxx}: {e}")
            continue
        BUILD_ERROR = None
        return out
    BUILD_ERROR = "; ".join(errors) or "no C++ compiler found"
    return None


def get_scorer_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first call; None if no
    compiler is available (numpy fallbacks are used instead)."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("STRING_GROUPER_TPU_TORCH_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64 = ctypes.c_int64
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.score_pairs_f64.restype = None
    lib.score_pairs_f64.argtypes = [
        p_i32, p_f64, i64, p_i32, p_f64, i64, p_i64, p_i64, i64, p_f64,
    ]
    lib.row_dot_f64.restype = None
    lib.row_dot_f64.argtypes = [
        p_i32, p_f64, i64, p_i32, p_f64, i64, i64, p_f64,
    ]
    lib.score_pairs_f32_acc.restype = None
    lib.score_pairs_f32_acc.argtypes = lib.score_pairs_f64.argtypes
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    p_u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.hash_project_bf16.restype = None
    lib.hash_project_bf16.argtypes = [p_i32, p_f32, i64, i64, i64, p_u16]
    lib.pack_hash_rows.restype = None
    lib.pack_hash_rows.argtypes = [
        p_i32, p_f64, i64, p_i32, i64, i64, i64, p_i32,
    ]
    f64 = ctypes.c_double
    lib.select_topn_f64.restype = i64
    lib.select_topn_f64.argtypes = [
        p_i64, p_i64, p_f64, i64, i64, f64, i64, p_i64, p_i64, p_f64,
    ]
    lib.selfjoin_fixups_f64.restype = i64
    lib.selfjoin_fixups_f64.argtypes = [
        p_i64, p_i64, p_f64, i64, i64, p_i64, p_i64, p_f64,
    ]
    lib.connected_components_i64.restype = None
    lib.connected_components_i64.argtypes = [p_i64, p_i64, i64, i64, p_i64]
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.encode_fit_phase1.restype = None
    lib.encode_fit_phase1.argtypes = [p_u8, p_i64, i64, p_u8, p_u8, i64, p_i64]
    lib.encode_transform_phase1.restype = None
    lib.encode_transform_phase1.argtypes = [
        p_u8, p_i64, i64, p_u8, p_u8, i64, p_u32, i64, p_i64,
    ]
    lib.encode_get_vocab_df.restype = None
    lib.encode_get_vocab_df.argtypes = [p_u32, p_i32]
    lib.encode_phase2.restype = None
    lib.encode_phase2.argtypes = [p_f64, i64, p_i32, p_f64]
    lib.encode_clean_total.restype = i64
    lib.encode_clean_total.argtypes = []
    lib.encode_get_clean.restype = None
    lib.encode_get_clean.argtypes = [p_u8, p_i64]
    lib.encode_row_norms.restype = None
    lib.encode_row_norms.argtypes = [p_f64, p_f32]
    p_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.encode_row_hashes.restype = None
    lib.encode_row_hashes.argtypes = [p_u64]
    lib.fill_code_rows.restype = None
    lib.fill_code_rows.argtypes = [p_u8, p_i64, p_i32, i64, i64, p_u8]
    lib.fill_code_rows6.restype = None
    lib.fill_code_rows6.argtypes = [p_u8, p_i64, p_i32, i64, i64, p_u32]
    lib.gather_rows_u8.restype = None
    lib.gather_rows_u8.argtypes = [p_u8, p_i64, p_i64, i64, p_i64, p_u8]
    lib.clean_group_positions.restype = i64
    lib.clean_group_positions.argtypes = [
        p_u8, p_i64, p_u64, i64, p_i64, p_i32, p_i64, p_i64, p_i64,
    ]
    lib.expand_dedup_phase1.restype = i64
    lib.expand_dedup_phase1.argtypes = [
        p_i64, p_i64, p_f64, i64, p_i64, p_i64, p_i64, i64, p_i64, i64,
        f64, i64, p_i64,
    ]
    lib.expand_dedup_phase2.restype = None
    lib.expand_dedup_phase2.argtypes = [p_i64, i64, p_i64, p_i64, p_f64]
    lib.set_num_threads.restype = None
    lib.set_num_threads.argtypes = [i64]
    lib.get_max_threads.restype = i64
    lib.get_max_threads.argtypes = []
    _lib = lib
    return _lib


def set_native_threads(n: int) -> None:
    """Cap the OpenMP thread count of every native kernel -- the plumbing
    behind the reference's ``number_of_processes`` option (reference
    string_grouper.py:22, :731 routes it to sp_matmul_topn's n_threads)."""
    lib = get_scorer_lib()
    if lib is not None and n and n > 0:
        lib.set_num_threads(int(n))
