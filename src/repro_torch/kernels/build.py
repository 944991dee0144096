"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` on first use -- one ``nvcc -c`` per source, all started together
-- and linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library lives under ``<checkout>/build/kernels`` and its
name carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as is.

Nothing here touches CUDA at import time: the CPU tests import every module
of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ["-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build did: seconds, whether it compiled or reused, ptxas log
last_build: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signatures of the entry points in csrc/*.cu (all return cudaError_t)
SIGNATURES = {
    "windve_flash_attention": [_P, _P, _P, _P, _P, _P,      # q k v kv_len o lse
                               _I, _I, _I, _I, _I, _I, _I,  # dtype B H KV Sq Sk hd
                               _L, _L, _L, _L, _L, _L,      # q, k strides
                               _L, _L, _L, _L, _L, _L,      # v, o strides
                               _I, _I, _P],                 # causal window stream
    "windve_flash_attention_bwd": [_P, _P, _P, _P, _P,      # q k v o dout
                                   _P, _P, _P, _P, _P,      # lse kv_len dq dk dv
                                   _P,                      # delta workspace
                                   _I, _I, _I, _I, _I, _I,  # dtype B H KV Sq Sk
                                   _I, _P,                  # hd strides[24]
                                   _I, _I, _P],             # causal window stream
    "windve_pool_norm": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "windve_quant_matmul": [_P, _L, _P, _P, _P,             # x ldx w8 scale out
                            _I, _I, _I, _I, _P],            # dtype M N K stream
    "windve_quantize_rows": [_P, _L, _P, _P,                # x ldx x8 x_scale
                             _I, _I, _I, _P],               # dtype M K stream
    "windve_w8a8_matmul": [_P, _L, _P, _P, _P, _P,          # x8 ldx w8 xs ws out
                           _I, _I, _I, _I, _P],             # dtype M N K stream
    "windve_rmsnorm": [_P, _L, _P, _P,                      # x ldx scale out
                       _I, _I, _I, ctypes.c_float, _P],     # dtype R D eps stream
    "windve_rmsnorm_bwd": [_P, _L, _P, _P, _L,              # x ldx scale dy ldy
                           _P, _P, _P,                      # dx dscale workspace
                           _I, _I, _I, ctypes.c_float, _P], # dtype R D eps stream
    "windve_rmsnorm_bwd_blocks": [_I],                      # R
    "windve_ssm_scan": [_P, _P, _P, _P, _P, _P, _P, _P,     # x dt B C A y h hs
                        _I, _I, _I, _I, _I, _P],            # dtype B S DI lanes stream
    "windve_ssm_scan_bwd": [_P, _P, _P, _P, _P, _P, _P, _P,  # x dt B C A dy dh hs
                            _P, _P, _P, _P, _P,             # dx ddt dB dC dA
                            _P, _P,                         # part dA_part
                            _I, _I, _I, _I, _P],            # dtype B S DI stream
    "windve_ssm_scan_bwd_channels": [],
    "windve_flash_decode": [_P, _P, _P, _P, _P, _P,         # q k v kpos o lse
                            _I, _I, _I, _I, _I, _I, _I,     # 2 dtypes B KV G Sc hd
                            _L, _L, _L, _L, _L, _L,         # q, k strides
                            _L, _L, _L,                     # v strides
                            _I, _I, _P],                    # pos window stream
}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwindve_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path, verbose: bool) -> str:
    """nvcc every source to an object in parallel, then link one .so."""
    exe = nvcc()
    work = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [exe, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs, failed = [], [], []
        for src, obj, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp = work / out.name
        link = subprocess.run([exe, ARCH, "-shared", "-o", str(tmp), *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, out)       # atomic: concurrent loaders see all or none
        return "\n".join(logs)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        t0 = time.monotonic()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = ""
        built = not path.exists()
        if built:
            log = _compile(path, verbose)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.windve_error_string.argtypes = [ctypes.c_int]
        lib.windve_error_string.restype = ctypes.c_char_p
        last_build.update(seconds=time.monotonic() - t0, compiled=built,
                          library=str(path), log=log)
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib.windve_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
