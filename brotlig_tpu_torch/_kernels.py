"""Build-on-first-use loader for the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds) that is loaded with ctypes. Nothing is built or loaded
when this module is imported: the first CUDA tensor that reaches a kernel
wrapper triggers the build. A machine without ``nvcc`` can import the
package and run every plain version; a CUDA tensor on such a machine
raises instead of falling back.

Each C entry point launches one kernel on the given stream and returns
``cudaGetLastError()``; the wrappers raise when it is not 0.

The wrappers call the entry points through ``launch``, which makes the
tensors' device current in the calling thread first: an entry point sets
its kernel's attributes and launches on whatever device is current, and
torch's current device is per thread.

``LAUNCHES`` counts, per kernel, the launches the wrappers made (the
texture postprocess and preprocess kernels of precondition.cu both under
"precond", the sort and walk kernels of ref_parse.cu both under
"ref_parse"), and
``SWEEP_LAUNCHES`` splits the sweep kernel's count by group width; a run
resets both (``reset_launches``) and reads them to show that its main
path went through the kernels. Threads that launch on several devices at
once count under a lock.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libbrotlig_kernels.so")
SOURCES = ("tables.cu", "decode.cu", "phase_a.cu", "sweep.cu",
           "dp_parse.cu", "pack.cu", "match.cu", "cost_model.cu",
           "precondition.cu", "ref_parse.cu")
HEADERS = ("lane_ops.cuh", "page_round.cuh", "page_tables.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES = {"tables": 0, "decode": 0, "phase_a": 0, "sweep": 0,
            "dp_parse": 0, "pack": 0, "match": 0, "cost": 0, "precond": 0,
            "ref_parse": 0}
SWEEP_LAUNCHES = {128: 0, 512: 0, 1024: 0, 2048: 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
BUILD_LOG = ""


def reset_launches() -> None:
    with _count_lock:
        for counts in (LAUNCHES, SWEEP_LAUNCHES):
            for k in counts:
                counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built
               for f in SOURCES + HEADERS)


def build() -> float:
    """Compile csrc/*.cu, one nvcc per source in parallel, and link them
    into the shared library; returns seconds taken. The compiler's
    register/shared-memory report lands in BUILD_LOG."""
    global BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{f}.{tag}.o") for f in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o,
         os.path.join(CSRC, f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(f, p.returncode, log) for f, p, log
              in zip(SOURCES, procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{f} ({rc}):\n{log}" for f, rc, log in failed))
    tmp = f"{LIB_PATH}.{tag}"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                         capture_output=True, text=True)
    for o in objs:
        os.remove(o)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, LIB_PATH)
    BUILD_LOG = "".join(logs)
    return time.perf_counter() - t0


def library():
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(LIB_PATH)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.blg_load_tables.restype = i32
        lib.blg_load_tables.argtypes = [vp, i32, i32, vp, vp, vp, vp, vp]
        lib.blg_decode_pages.restype = i32
        lib.blg_decode_pages.argtypes = [vp, i32, i32, vp, vp, vp, vp, vp,
                                         i32, i32, vp, vp, vp, vp]
        lib.blg_phase_a.restype = i32
        lib.blg_phase_a.argtypes = [vp, i32, i32, vp, vp, vp, vp, vp, i32,
                                    i32, vp, vp, vp, vp, vp, vp, vp]
        lib.blg_sweep.restype = i32
        lib.blg_sweep.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                  i32, vp, vp, vp]
        lib.blg_dp_parse.restype = i32
        lib.blg_dp_parse.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                     i32, i32, vp, vp, vp]
        lib.blg_dp_smem.restype = i32
        lib.blg_dp_smem.argtypes = [i32, i32, i32]
        lib.blg_pack_pages.restype = i32
        lib.blg_pack_pages.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32,
                                       i32, i32, i32, vp, vp, vp, vp]
        for fn in (lib.blg_pack_scratch_ints, lib.blg_pack_info_offset,
                   lib.blg_pack_smem):
            fn.restype = ctypes.c_longlong
            fn.argtypes = [i32, i32, i32]
        for fn in (lib.blg_match_sort_probe_smem, lib.blg_match_finish_smem):
            fn.restype = ctypes.c_longlong
        lib.blg_match_sort_probe_smem.argtypes = [i32, i32]
        lib.blg_match_finish_smem.argtypes = [i32]
        for fn in (lib.blg_match_cluster_size, lib.blg_match_finish_parts):
            fn.restype = i32
            fn.argtypes = [i32, i32, i32]
        lib.blg_match_max_clusters.restype = i32
        lib.blg_match_max_clusters.argtypes = [i32, i32]
        lib.blg_match_scratch_ints.restype = ctypes.c_longlong
        lib.blg_match_scratch_ints.argtypes = [i32, i32, i32]
        lib.blg_match_sort_probe.restype = i32
        lib.blg_match_sort_probe.argtypes = [vp, vp, i32, i32, i32, i32, vp,
                                             vp]
        lib.blg_match_finish.restype = i32
        lib.blg_match_finish.argtypes = [vp, vp, i32, i32, i32, i32, i32,
                                         i32, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.blg_cost_scratch_ints.restype = ctypes.c_longlong
        lib.blg_cost_scratch_ints.argtypes = [i32, i32, i32]
        lib.blg_cost_plan.restype = ctypes.c_longlong
        lib.blg_cost_plan.argtypes = [i32, i32, i32, i32]
        lib.blg_cost_positions_smem.restype = ctypes.c_longlong
        lib.blg_cost_positions_smem.argtypes = []
        lib.blg_cost_tables.restype = i32
        lib.blg_cost_tables.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                        vp, vp, vp, vp, vp]
        lib.blg_cost_unseen_check.restype = i32
        lib.blg_cost_unseen_check.argtypes = [i32, ctypes.c_float, vp, vp]
        lib.blg_cost_positions.restype = i32
        lib.blg_cost_positions.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp,
                                           vp, vp, vp, vp, vp]
        lib.blg_postprocess.restype = i32
        lib.blg_postprocess.argtypes = [vp, vp, vp, vp, vp, vp, vp]
        lib.blg_preprocess.restype = i32
        lib.blg_preprocess.argtypes = [vp, vp, vp, vp, vp, vp, vp]
        lib.blg_precond_tiles.restype = ctypes.c_longlong
        lib.blg_precond_tiles.argtypes = [vp]
        lib.blg_precond_grid.restype = i32
        lib.blg_precond_grid.argtypes = [vp, i32]
        lib.blg_precond_tile_bytes.restype = i32
        lib.blg_precond_tile_bytes.argtypes = []
        lib.blg_ref_parse_sort.restype = i32
        lib.blg_ref_parse_sort.argtypes = [vp, vp, i32, i32, vp, vp]
        lib.blg_ref_parse_walk.restype = i32
        lib.blg_ref_parse_walk.argtypes = [vp, vp, i32, i32, i32, i32, vp, vp,
                                           vp, vp, vp, vp, vp]
        _lib = lib
        return _lib


def check_cuda_args(*tensors) -> None:
    """Raise unless every tensor is a contiguous int32/uint8 CUDA tensor on
    one device (what the C entry points take)."""
    import torch
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel argument on {t.device}, want {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel argument is not contiguous")
        if t.dtype not in (torch.int32, torch.uint8):
            raise ValueError(f"kernel argument dtype {t.dtype}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def launch(kernel: str, entry: str, device, *args, cw: int | None = None):
    """Call the C entry point `entry` with args and the current stream of
    `device`, with `device` the calling thread's current device; raise
    RuntimeError if it returns a CUDA error, else count one launch of
    `kernel` (and of the sweep at group width `cw`)."""
    import torch
    with torch.cuda.device(device):
        rc = getattr(library(), entry)(*args, stream_ptr(device))
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed (cudaError {rc})")
    with _count_lock:
        LAUNCHES[kernel] += 1
        if cw is not None:
            SWEEP_LAUNCHES[cw] += 1
