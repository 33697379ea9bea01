"""Build and load the port's CUDA kernels and its host library.

``nvcc`` compiles every ``ops/csrc/*.cu`` (one process per source, all
started together) and links them into one shared library with a plain C
interface, ``build/torch_kernels/libspecpride_torch.so`` beside the
package, at first use; it is rebuilt when the sources' hash changes.  The
host C++ compiler (``g++``, no CUDA needed) builds every ``ops/csrc/*.cpp``
the same way into ``build/torch_kernels/libspecpride_host.so``
(``load_host``).  Both are loaded with ``ctypes``.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))
BUILD_DIR = os.path.join(_PKG_ROOT, "build", "torch_kernels")
LIB_NAME = "libspecpride_torch.so"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_LIB_NAME = "libspecpride_host.so"
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_host_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_host_lib: ctypes.CDLL | None = None
# seconds and compiler output of this process's build (None: loaded as is)
build_info: dict | None = None


def _sources(pattern: str = "*.cu") -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, pattern)))


def _digest(compiler: str, flags: tuple, sources: list[str]) -> str:
    """Hash of the compiler, its flags and every source and header."""
    h = hashlib.sha256(" ".join((compiler,) + flags).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _fresh(lib_path: str, digest: str) -> bool:
    """True when ``lib_path`` exists and its stamp holds ``digest``."""
    try:
        with open(lib_path + ".sha256") as fh:
            return fh.read() == digest and os.path.exists(lib_path)
    except FileNotFoundError:
        return False


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA toolkit is needed to build the port's kernels"
        )
    return nvcc


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their joined output, or raise with
    the output of the first that failed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{log}"
            )
    return "".join(logs)


def _build(nvcc: str, digest: str) -> tuple[str, dict]:
    """Compile each source to an object in parallel, link, and rename the
    library into place: a reader never sees a half-written one.  Returns
    the library's path and the build's ``build_info``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib_path + ".sha256"
    tmp = f"{lib_path}.tmp{os.getpid()}"
    obj_dir = os.path.join(BUILD_DIR, f"obj{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    objs = [
        os.path.join(obj_dir, os.path.basename(src) + ".o")
        for src in _sources()
    ]
    t0 = time.perf_counter()
    log = _run_all([
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        for src, obj in zip(_sources(), objs)
    ])
    compile_s = time.perf_counter() - t0
    log += _run_all([[nvcc, *GENCODE, "-shared", "-o", tmp, *objs]])
    shutil.rmtree(obj_dir, ignore_errors=True)
    os.replace(tmp, lib_path)
    with open(stamp, "w") as fh:
        fh.write(digest)
    return lib_path, {
        "seconds": time.perf_counter() - t0,
        "compile_seconds": compile_s,
        "log": log,
    }


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of the entry points, set once; ``lib.tile`` and
    ``lib.record_bytes`` are the scan's tile size and workspace record."""
    vp = ctypes.c_void_p
    for fn in (lib.seg_tile_size, lib.seg_record_bytes):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    # (runs, in0, in1, in2, out0, out1, out2, n, channels, workspace,
    #  base, device, stream); seg_mean_heads' channels are its kinds
    for fn in (lib.seg_mean_f32, lib.seg_mean_heads, lib.seg_scan_flags_f32,
               lib.seg_scan_keys_f32):
        fn.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
            vp, ctypes.c_ulonglong, ctypes.c_int, vp,
        ]
        fn.restype = ctypes.c_int
    lib.tile = lib.seg_tile_size()
    lib.record_bytes = lib.seg_record_bytes()
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    global _lib, build_info
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = _find_nvcc()
        digest = _digest(nvcc, NVCC_FLAGS,
                         _sources("*.cu") + _sources("*.cuh"))
        lib_path = os.path.join(BUILD_DIR, LIB_NAME)
        if not _fresh(lib_path, digest):
            lib_path, build_info = _build(nvcc, digest)
        _lib = _declare(ctypes.CDLL(lib_path))
        return _lib


def _find_cxx() -> str:
    for name in ("g++", "c++"):
        cxx = shutil.which(name)
        if cxx is not None:
            return cxx
    raise RuntimeError(
        "no host C++ compiler (g++ or c++ on PATH): it is needed to build "
        "the port's host library"
    )


def _declare_host(lib: ctypes.CDLL) -> ctypes.CDLL:
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.seg_argsort_i64.argtypes = [p64, p64, ctypes.c_int64, p64,
                                    ctypes.c_int]
    lib.seg_argsort_i64.restype = ctypes.c_int
    lib.searchsorted_right_i32.argtypes = [p32, ctypes.c_int64, p32,
                                           ctypes.c_int64, p64, ctypes.c_int]
    lib.searchsorted_right_i32.restype = ctypes.c_int
    # the MGF parser: a handle (c_void_p) and its columns.  Titles and
    # extras are length-delimited buffers, so c_void_p: c_char_p would cut
    # them at a NUL byte.  Every pointer argument is declared, or ctypes
    # passes it as a 32-bit int.
    vp, pd = ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
    lib.mgf_parse.argtypes = [ctypes.c_char_p, vp, ctypes.c_int]
    lib.mgf_parse_buffer.argtypes = [vp, ctypes.c_int64, ctypes.c_int, vp,
                                     ctypes.c_int]
    for fn in (lib.mgf_parse, lib.mgf_parse_buffer):
        fn.restype = vp
    for name, restype in (
        ("mgf_n_spectra", ctypes.c_int64), ("mgf_n_peaks", ctypes.c_int64),
        ("mgf_mz", pd), ("mgf_intensity", pd), ("mgf_peak_offsets", p64),
        ("mgf_precursor_mz", pd), ("mgf_charge", p32), ("mgf_rt", pd),
        ("mgf_titles", vp), ("mgf_title_offsets", p64),
        ("mgf_extras", vp), ("mgf_extra_offsets", p64),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [vp]
        fn.restype = restype
    lib.mgf_free.argtypes = [vp]
    lib.mgf_free.restype = None
    # the byte index of a streamed MGF and its clusters: a handle and its
    # columns
    lib.mgf_index.argtypes = [ctypes.c_char_p, ctypes.c_int, vp,
                              ctypes.c_int]
    lib.mgf_index.restype = vp
    for name, restype in (
        ("mgf_index_n_records", ctypes.c_int64),
        ("mgf_index_begin", p64), ("mgf_index_end", p64),
        ("mgf_index_has_title", ctypes.POINTER(ctypes.c_uint8)),
        ("mgf_index_titles", vp), ("mgf_index_title_offsets", p64),
        ("mgf_index_n_spans", ctypes.c_int64),
        ("mgf_index_span_begin", p64), ("mgf_index_span_end", p64),
        ("mgf_index_bad_title", ctypes.c_int64),
        ("mgf_index_n_clusters", ctypes.c_int64),
        ("mgf_index_names", vp), ("mgf_index_name_offsets", p64),
        ("mgf_index_group_offsets", p64),
        ("mgf_index_member_begin", p64), ("mgf_index_member_end", p64),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [vp]
        fn.restype = restype
    lib.mgf_index_free.argtypes = [vp]
    lib.mgf_index_free.restype = None
    # the MGF peak-line formatter
    lib.mgf_format_peaks.argtypes = [pd, pd, ctypes.c_int64, vp,
                                     ctypes.c_int64]
    lib.mgf_format_batch.argtypes = [pd, pd, p64, ctypes.c_int64, vp,
                                     ctypes.c_int64, p64, ctypes.c_int]
    for fn in (lib.mgf_format_peaks, lib.mgf_format_batch):
        fn.restype = ctypes.c_int64
    return lib


def load_host() -> ctypes.CDLL:
    """The host library (``ops/csrc/*.cpp``: the segmented sort and the
    search, the MGF parser and byte index, and the MGF peak formatter),
    built first with the host C++ compiler if its sources changed.
    Processes that build
    at once serialize on a file lock in the build directory (released by
    the kernel if a holder dies), and each writes its own temporary
    library before renaming it into place.
    A failed build raises with the compiler's output."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    with _host_lock:
        if _host_lib is not None:
            return _host_lib
        cxx = _find_cxx()
        sources = _sources("*.cpp")
        digest = _digest(cxx, HOST_FLAGS, sources)
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(BUILD_DIR, HOST_LIB_NAME)
        with open(lib_path + ".lock", "w") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            if not _fresh(lib_path, digest):
                tmp = f"{lib_path}.tmp{os.getpid()}"
                cmd = [cxx, *HOST_FLAGS, "-o", tmp, *sources]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"host library build failed ({proc.returncode}): "
                        f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                    )
                os.replace(tmp, lib_path)
                with open(lib_path + ".sha256", "w") as fh:
                    fh.write(digest)
            _host_lib = _declare_host(ctypes.CDLL(lib_path))
        return _host_lib
