"""Build-on-first-use of the package's native code and its ctypes binding.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into an object file, and the objects are linked into
one shared library with a plain C interface.  The host libraries of the MPC
engine (``mpc/native/*.cpp``) are compiled by ``g++`` (``build_host``).  Each
build lands in ``apsu_tpu_torch/_build/<hash>/`` keyed by a hash of its
sources and flags, so a fresh checkout builds once and an edited source
rebuilds; a build is made in a private directory and published by one atomic
rename, so processes that build at once never see a partial library.  A
missing compiler or a failed compile raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-fopenmp"]

_lib = None
build_seconds: float | None = None   # wall time of this process's build
ptxas_log: str = ""                  # nvcc's -Xptxas -v report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(sources, flags) -> str:
    h = hashlib.sha256()
    for f in sorted(sources):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _private_dir() -> Path:
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    return Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))


def _publish(tmp: Path, out_dir: Path) -> None:
    try:
        os.replace(tmp, out_dir)   # atomic publish; a concurrent build wins
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_seconds, ptxas_log
    out_dir = BUILD_ROOT / _digest(CSRC.glob("*.cu*"), ARCH_FLAGS + CFLAGS)
    lib_path = out_dir / "libapsu_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = _private_dir()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        objs.append(str(obj))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / lib_path.name), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    _publish(tmp, out_dir)
    build_seconds = time.perf_counter() - t0
    ptxas_log = "\n".join(logs)
    return lib_path


def build_host(src: Path) -> Path:
    """Compile (if needed) one C++ source of the MPC engine with ``g++`` and
    return the path of its shared library ``lib<stem>.so``."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {src.name} cannot be built")
    out_dir = BUILD_ROOT / _digest([src], ["g++", *HOST_FLAGS])
    lib_path = out_dir / f"lib{src.stem}.so"
    if lib_path.exists():
        return lib_path
    tmp = _private_dir()
    res = subprocess.run([cxx, *HOST_FLAGS, str(src), "-o", str(tmp / lib_path.name)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"g++ failed on {src.name}:\n{res.stdout}")
    _publish(tmp, out_dir)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        L.apsu_ntt.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, vp]
        L.apsu_ntt.restype = i32
        L.apsu_ps_inner.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                    i32, i32, vp]
        L.apsu_ps_inner.restype = i32
        L.apsu_ps_inner_plan.argtypes = [i32, i32, i32, i32, i32, i32, vp]
        L.apsu_ps_inner_plan.restype = i32
        L.apsu_eval_dot_split.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                          vp, vp]
        L.apsu_eval_dot_split.restype = i32
        L.apsu_eval_dot_clusters.argtypes = [i32, i32, i32, i32, i32, i32, vp, vp]
        L.apsu_eval_dot_clusters.restype = i32
        u32 = ctypes.c_uint32
        L.apsu_vpu_loop.argtypes = [vp, vp, i64, i32, u32, u32, i32, vp]
        L.apsu_vpu_loop.restype = i32
        L.apsu_add_one.argtypes = [vp, vp, i64, vp]
        L.apsu_add_one.restype = i32
        L.apsu_behz_lift.argtypes = [vp, *[i64] * 4, vp, vp, i64, i32, i32, i32, i32, vp, vp]
        L.apsu_behz_lift.restype = i32
        L.apsu_mont_mac.argtypes = [vp, *[i64] * 6, vp, *[i64] * 6, vp, i64, i32, i32, i32,
                                    i32, i32, vp, vp]
        L.apsu_mont_mac.restype = i32
        L.apsu_behz_scaledown.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp, vp]
        L.apsu_behz_scaledown.restype = i32
        L.apsu_rns_divround.argtypes = [vp, *[i64] * 3, vp, *[i64] * 4, vp, i64, i32, i32, i32,
                                        i32, vp, vp]
        L.apsu_rns_divround.restype = i32
        L.apsu_scale_add.argtypes = [vp, *[i64] * 3, vp, *[i64] * 4, vp, *[i64] * 4, vp, i32,
                                     i32, i64, i32, i32, i32, vp, vp]
        L.apsu_scale_add.restype = i32
        u64 = ctypes.c_uint64
        L.apsu_ctr_mod.argtypes = [vp, vp, u64, u64, i32, u32, u32, u64, vp, vp, i64, vp, i32,
                                   vp]
        L.apsu_ctr_mod.restype = i32
        _lib = L
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream (the capture
    stream under graph capture), read without building a ``Stream``."""
    index = torch.device(device).index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def launch(name: str, entry, index: int, *args) -> int:
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of CUDA device ``index`` (a tensor's ``get_device()``), and raise if it
    reports an error (``cudaGetLastError``).  A launch goes to the current
    device, whichever device its pointers lie on, so device ``index`` is
    made current for the call when it is not.  Returns 1, or 0 while the
    stream is being captured into a CUDA graph: the wrappers add it to their
    launch counts, and a captured launch counts at each replay
    (``ops/counts.py``).  The device, the raw stream and the capture state
    are read through ``torch._C`` (what ``torch.cuda.current_device``,
    ``current_stream().cuda_stream`` and ``is_current_stream_capturing``
    wrap): a ``Stream`` object costs more than the launch itself."""
    C = torch._C
    if C._cuda_getDevice() == index:
        err = entry(*args, C._cuda_getCurrentRawStream(index))
        captured = C._cuda_isCurrentStreamCapturing()
    else:
        with torch.cuda.device(index):
            err = entry(*args, C._cuda_getCurrentRawStream(index))
            captured = C._cuda_isCurrentStreamCapturing()
    if err:
        check(err, name)
    return 0 if captured else 1
