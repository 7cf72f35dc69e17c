"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded through :mod:`ctypes`; the ``csrc/*.cuh`` headers hold
the device code that several sources share. The output directory is
keyed by a hash of every source and header and of ``nvcc --version``,
under ``build/`` at the root of the checkout, so an edited source or
another toolkit builds anew and an unchanged one loads what is there. :func:`build_all` starts
one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: on ``PATH``, else under ``$CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            path = str(candidate)
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the repro_torch CUDA kernels build at first use and need the "
            "CUDA toolkit")
    return path


def build_dir() -> Path:
    """The build directory for the current sources and toolkit."""
    nvcc = nvcc_path()
    version = subprocess.run([nvcc, "--version"], check=True,
                             capture_output=True, text=True).stdout
    h = hashlib.sha256(version.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _start(nvcc: str, name: str, out_dir: Path) -> Tuple[Path, Path,
                                                          subprocess.Popen]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no CUDA source {src}")
    lib = out_dir / f"lib{name}.so"
    tmp = out_dir / f".lib{name}.{os.getpid()}.{threading.get_ident()}.so"
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, tmp, proc


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds per name.

    Libraries already built for these sources are loaded, not rebuilt
    (0.0 seconds). Raises ``RuntimeError`` with the compiler's output
    when a build fails.
    """
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: 0.0 for n in names}
        nvcc = nvcc_path()
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        running = {n: _start(nvcc, n, out_dir) for n in todo
                   if not (out_dir / f"lib{n}.so").exists()}
        seconds = {n: 0.0 for n in names}
        failures = []
        for n, (lib, tmp, proc) in running.items():
            output, _ = proc.communicate()
            seconds[n] = time.perf_counter() - t0
            (out_dir / f"{n}.log").write_text(output)
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {n}.cu "
                                f"(exit {proc.returncode}):\n{output}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)   # atomic: a reader never sees half a file
        if failures:
            raise RuntimeError("\n".join(failures))
        for n in todo:
            _libs[n] = ctypes.CDLL(str(out_dir / f"lib{n}.so"))
        return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``csrc/<name>.cu``, or "" if it was not
    built in this checkout."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""
