"""Build + load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ctypes, at first use: into ``build/torch_kernels/``
beside the package, keyed by a hash of the source and the flags.  Nothing
is prebuilt or downloaded.  Pointers and the stream cross the C boundary as
``c_void_p``, sizes as ``c_int64``; every entry point returns the
``cudaError_t`` of its launch, which the wrapper turns into an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]
KERNELS = ("p1_fused_closed2", "p1_fused_chain", "p1_tri_fused",
           "device_hash_codes", "p1_mm_floor", "p1_closed2_variant",
           "p1_fused_topk")

_p = ctypes.c_void_p
_i = ctypes.c_int64
_f = ctypes.c_float
#: C signatures: every entry point returns int (cudaError_t).
_ARGTYPES = {
    # A, B, thr, m, n, d, tile, cand_c, ship, counts, tmax, bound, vbuf, stream
    "p1_fused_closed2": [_p, _p, _f, _i, _i, _i, _i, _i, _p, _p, _p, _p, _p, _p],
    # A, B, thr, col_off, m, n, d, tile, cand_c, v, c, meta, tb, ship, counts,
    # tmax, bound, stream
    "p1_fused_chain": [_p, _p, _f, _i, _i, _i, _i, _i, _i,
                       _p, _p, _p, _p, _p, _p, _p, _p, _p],
    # A, B, thr, j0, seg_rows, n_pad, d, tile, cand_c, block_m, rv, rc,
    # rmeta, fpack, stats_i, stats_f, stream
    "p1_tri_fused": [_p, _p, _f, _i, _i, _i, _i, _i, _i, _i,
                     _p, _p, _p, _p, _p, _p, _p],
    # codes, packed, stride, width, inv_norm, table, idf, n, dim, base,
    # ngram, out, stream
    "device_hash_codes": [_p, _i, _i, _i, _p, _p, _p, _i, _i, _i, _i, _p, _p],
    # A, B, thr, m, n, d, counts, stream
    "p1_mm_floor": [_p, _p, _f, _i, _i, _i, _p, _p],
    # A, B, thr, m, n, d, tile, cand_c, block_rows, minidx, ship, counts,
    # tmax, bound, vbuf, stream
    "p1_closed2_variant": [_p, _p, _f, _i, _i, _i, _i, _i, _i, _i,
                           _p, _p, _p, _p, _p, _p],
    # A, B, thr, m, n, d, tile, cand_c, k_tile, splits, ship, counts, tmax,
    # bound, the splits' v, c, meta and tb, stream
    "p1_fused_topk": [_p, _p, _f, _i, _i, _i, _i, _i, _i, _i,
                      _p, _p, _p, _p, _p, _p, _p, _p, _p],
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds each source took to compile in this process (0.0: cache hit)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of "
            "string_grouper_tpu_torch build from source at first use"
        )
    return str(path)


def _target(name: str) -> Path:
    # Every header under csrc/ is part of the key: an edited header must
    # not reuse a library built from the old one.
    src = (_CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(_CSRC.glob("*.cuh"))
    )
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def _start(name: str):
    """Start one nvcc for ``name`` (None when the library is built)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}.{threading.get_ident()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        BUILD_SECONDS.setdefault(name, 0.0)
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu:\n{log.decode(errors='replace')}"
        )
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, one nvcc
    per source, all started together.  Returns ``BUILD_SECONDS``."""
    with _LOCK:
        started = {n: _start(n) for n in names if n not in _LIBS}
        for n, s in started.items():
            _finish(n, s)
    return BUILD_SECONDS


def ptxas_report(names: Iterable[str]) -> Dict[str, str]:
    """``nvcc -Xptxas -v`` for each named source (registers, shared memory,
    stack and spills of each kernel), compiled to a throwaway cubin, one
    nvcc per source, all started together.  Returns the ptxas lines per
    name, with the stack and spill lines that follow them."""
    out_dir = BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = {
        n: subprocess.Popen(
            [_nvcc(), *flags, "-Xptxas", "-v", "-cubin",
             "-o", str(out_dir / f"{n}.cubin"), str(_CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for n in names
    }
    report = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for csrc/{n}.cu:\n{text}")
        report[n] = "\n".join(
            line for line in text.splitlines()
            if "ptxas" in line or "stack frame" in line or "spill" in line
        )
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_target(name)))
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


#: the libraries whose scan streams A past d = 512 (csrc/p1_scan_sm90.cuh)
STREAM_A_KERNELS = ("p1_fused_closed2", "p1_fused_chain", "p1_tri_fused")


@contextlib.contextmanager
def force_stream_a(on: bool = True):
    """Tests only: while the block runs, the scans of ``STREAM_A_KERNELS``
    stream A through their ring at d <= 512 too, where they keep it
    resident; the two must give the same bits.  Off again on exit."""
    libs = [load(n) for n in STREAM_A_KERNELS] if on else []
    for lib in libs:
        lib.p1h_force_stream_a(1)
    try:
        yield
    finally:
        for lib in libs:
            lib.p1h_force_stream_a(0)


def scan_plan(name: str, d: int) -> Dict[str, int]:
    """The launch plan of ``name``'s scan (one of ``STREAM_A_KERNELS``) at
    width ``d`` under the current ``force_stream_a`` switch, launching
    nothing: dynamic shared bytes, ring stages, kTri's column buffers,
    blocks of a cluster, and ``cudaOccupancyMaxActiveClusters``."""
    fn = load(name).p1h_plan
    fn.argtypes = [_i, _p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    check(name, fn(d, ctypes.addressof(out)))
    keys = ("smem_bytes", "stages", "col_bufs", "cluster", "max_active_clusters")
    return dict(zip(keys, out))


#: offset of a CUresult from cuTensorMapEncodeTiled in a launch's return
#: code (csrc/p1_scan_sm90.cuh, kEncodeError)
ENCODE_ERROR = 10000


def check(name: str, err: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if err >= ENCODE_ERROR:
        raise RuntimeError(
            f"CUDA kernel {name}: TMA descriptor not built (CUresult "
            f"{err - ENCODE_ERROR}; {ENCODE_ERROR} = no driver entry point)"
        )
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
