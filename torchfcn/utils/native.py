"""Builds of the port's native code into ``torchfcn/_build`` (listed in
``.gitignore``), each named by a hash of its sources and flags so that a
changed source rebuilds: the host C++ programs (the point-map library, the
bus broker) here with ``g++`` at first use (no ``make``), and the CUDA
kernels in ``torchfcn/ops/cuda/build.py`` through :func:`hashed_build`."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")


def hashed_build(name: str, suffix: str, flags: Sequence[str],
                 sources: Sequence[Path],
                 make: Callable[[Path], None]) -> Path:
    """``torchfcn/_build/<name>-<hash><suffix>``, the hash taken over
    ``flags`` and the names and bytes of ``sources``.  Unless it exists,
    ``make(tmp)`` writes it to a temporary path of this process, which is
    then renamed into place, so no process loads a half-written file."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}{suffix}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        make(tmp)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def build(name: str, sources: Sequence[Path], shared: bool) -> Path:
    """Compile ``sources`` (the ``.cpp`` files; headers are hashed too)
    with ``g++`` into ``torchfcn/_build/<name>-<hash>`` (``.so`` when
    ``shared``) unless that exact build exists; returns its path."""
    flags = CXX_FLAGS + (("-fPIC", "-shared") if shared else ())

    def make(tmp: Path) -> None:
        cmd = [shutil.which("g++") or "g++", *flags, "-o", str(tmp),
               *(str(s) for s in sources if s.suffix == ".cpp")]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed with code {done.returncode}:\n"
                               f"{' '.join(cmd)}\n{done.stdout}{done.stderr}")
    return hashed_build(name, ".so" if shared else "", flags, sources, make)
