"""Builds the package's CUDA kernels (`csrc/*.cu`) at first use.

Each source compiles with `nvcc` for sm_90a into its own shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). A source may hold several kernels
(composite_fwd.cu holds composite_fwd and composite_train_fwd, which share
their device code with composite_bwd.cu through composite_common.cuh).
Libraries go to `wheat3dgs_tpu_torch/_build/` under a name that carries a
hash of the source, the shared headers and the flags, so an edited source
rebuilds and concurrent processes never load a half-written file. Nothing
is built at import time.

`build()` starts one nvcc per missing library and waits for all of them,
so the kernels compile in parallel. `launch()` calls a kernel's C entry
point on PyTorch's current stream and counts it in `launches`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]
# Per-source extra flags. decode_cull's tile cull must round exactly as the
# plain version's separate float32 ops do: no FMA contraction.
# composite_bwd runs two 1024-thread blocks per SM, so 32 registers a
# thread: at ptxas's default register-usage level it spills, at 2 it fits.
KERNELS = {
    "decode_cull": ["-fmad=false"],
    "composite_fwd": [],
    "composite_bwd": ["-Xptxas", "--register-usage-level=2"],
    "segsum": [],
    "scan_probe": [],
}

# Kernel launches per kernel name (a source may hold several kernels).
launches = {"decode_cull": 0, "composite_fwd": 0, "composite_train_fwd": 0,
            "composite_bwd": 0, "segsum": 0, "scan_probe": 0}

_loaded: dict = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> list:
    return ARCH_FLAGS + COMMON_FLAGS + KERNELS[name]


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:12]}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel. Returns {name: seconds} for the ones compiled now; the
    compiler's resource report goes to `_build/<name>.log`."""
    names = list(KERNELS) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib


@contextlib.contextmanager
def sources(csrc):
    """Build and launch the kernels from another `csrc/` directory (another
    tree's, with the same C entry points) for the duration, so that two
    trees' kernels can be timed in one process on the same inputs."""
    global CSRC
    saved, saved_loaded = CSRC, dict(_loaded)
    CSRC = Path(csrc).resolve()
    _loaded.clear()
    try:
        yield
    finally:
        CSRC = saved
        _loaded.clear()
        _loaded.update(saved_loaded)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def launch(name: str, argtypes: list, args: tuple, device: torch.device,
           source: str = "") -> None:
    """Call `<name>_launch(*args, stream)` from the library built from
    csrc/<source or name>.cu on the current stream of `device`, raise on a
    non-zero CUDA error, and count the launch. `argtypes` are the ctypes of
    `args` (c_void_p for every pointer, so none is cut to 32 bits)."""
    src = source or name
    lib = load(src)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        err = getattr(lib, f"{src}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {rc} ({err(rc).decode()})")
    launches[name] += 1
