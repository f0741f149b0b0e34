"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` has a plain C interface and is compiled
by ``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries land in
``build/kernels/`` at the repository root, a directory ``.gitignore``
lists, named by a hash of the source and the shared headers so an edited
source rebuilds. Nothing
here runs at import: this module imports on a machine without ``nvcc``,
and ``load`` builds at first use. ``build_all`` returns each compiler's
register and spill report (``-Xptxas -v``); chip_smoke.py prints it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"fused_prefix_fifo": "fused_prefix_fifo.cu",
           "fused_prefix_ffd": "fused_prefix_ffd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lands: named by a hash of its source
    and of every header in ``csrc/``, which the sources include."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns each compiler's report
    (empty for a library that was already built). Raises on a failed
    build, with the compiler's output."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        report, _ = proc.communicate()
        reports[name] = report
        if proc.returncode != 0:
            failed.append(f"{name}:\n{report}")
            continue
        os.replace(tmp, out)  # atomic: a half-written library never loads
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for kernel ``name`` (building it first if needed)."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
