"""Build and load the port's CUDA kernels.

All ``torchfcn/csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a``
(Hopper), one ``nvcc`` process per source, all started together, and link
into one shared library with a plain C interface, loaded with ``ctypes`` (a
few seconds to build; no PyTorch headers).  The library is built at first
use into ``torchfcn/_build`` (listed in ``.gitignore``), named by a hash of
the sources and flags, so a changed source rebuilds
(``torchfcn/utils/native.py::hashed_build``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

from torchfcn.utils.native import PACKAGE_DIR, hashed_build

CSRC_DIR = PACKAGE_DIR / "csrc"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3",
    # a*b+c rounds twice, like the reference's separate multiply and add
    "-fmad=false",
    "-Xcompiler", "-fPIC",
)
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# exported C functions: argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    # rects, valid, out_rects, out_weights, out_valid, m, n, threshold, eps,
    # stream
    "torchfcn_group_rects": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x, y, pixels, channels, size, alpha/size, k, dtype, vector, tile
    # pixels, blocks, shared bytes, stream
    "torchfcn_lrn": (_P, _P, _L, _I, _I, _F, _F, _I, _I, _I, _I, _I, _P),
    # x, y, batch, h, w, channels, ho, wo, size, alpha/size, k, dtype,
    # vector, stripe rows, stripes, column tile, tiles, shared bytes, stream
    "torchfcn_lrn_maxpool": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                             _I, _I, _I, _I, _I, _I, _P),
    # x, wr, br, w2, b2, y, batch, h, w, ho, wo, stripe rows, stripes,
    # shared bytes, dtype, halo top, halo bottom, stream
    "torchfcn_stem_tail": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _P),
}

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e5m2: 2}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _check(cmd, returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed with code {returncode}:\n"
                           f"{' '.join(map(str, cmd))}\n{output}")


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library's path, named by a hash of the sources and flags."""
    sources = sorted(CSRC_DIR.glob("*.cu"))

    def make(tmp: Path) -> None:
        objects = [tmp.with_name(f"{src.stem}.{tmp.name}.o")
                   for src in sources]
        compiles = [[nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objects)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        try:
            for cmd, proc in zip(compiles, procs):
                output, _ = proc.communicate()
                _check(cmd, proc.returncode, output)
            link = [nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]
            linked = subprocess.run(link, capture_output=True, text=True)
            _check(link, linked.returncode, linked.stdout + linked.stderr)
        finally:   # after a failure, stop the compiles still running
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                if not proc.stdout.closed:
                    proc.communicate()
            for obj in objects:
                obj.unlink(missing_ok=True)
    return hashed_build("libtorchfcn_kernels", ".so",
                        COMPILE_FLAGS + LINK_FLAGS,
                        sorted(CSRC_DIR.glob("*.cu*")), make)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.torchfcn_error_string.argtypes = (ctypes.c_int,)
    lib.torchfcn_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call exported kernel launcher ``name`` on ``device`` and its current
    stream (appended as the last argument); raise if it reports a CUDA
    error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, name)(*args, stream)
    if status != 0:
        msg = lib.torchfcn_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def check_device(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is on the CPU (the plain version) or a CUDA
    device (the kernel).  A wrapper checks before it calls its op, whose
    fake implementation would otherwise answer for a meta tensor."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got one on "
                         f"{t.device}")
