"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` has a plain C interface and is compiled
by ``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries land in
``build/kernels/`` at the repository root, a directory ``.gitignore``
lists, named by a hash of the source, the shared headers and the flags so
an edited source rebuilds. Nothing
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
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"fused_prefix_fifo": "fused_prefix_fifo.cu",
           "fused_prefix_ffd": "fused_prefix_ffd.cu",
           "fused_prefix_delay": "fused_prefix_delay.cu",
           "fused_prefix_scored": "fused_prefix_scored.cu",
           "sinkhorn_round": "sinkhorn_round.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags. The scored kernel's tesserae score and the sinkhorn
# round must round exactly as the reference's do: their fused multiply-adds
# are written out, and nvcc must contract no other multiply and add into one.
EXTRA_FLAGS = {"fused_prefix_scored": ["--fmad=false"],
               "sinkhorn_round": ["--fmad=false"]}


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
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
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
        cmd = [nvcc_path(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o",
               str(tmp), str(CSRC / SOURCES[name])]
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


# Guards the first build and load of a kernel: the services launch from
# several threads (tick threads, the drive thread, handler threads), and two
# threads reaching a kernel's first use together would both run nvcc into
# the same temporary name. One builds; the others wait for its library.
_LOAD_LOCK = threading.Lock()


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


def load(name: str) -> ctypes.CDLL:
    """The built library for kernel ``name`` (building it first if needed).
    Safe to call from several threads: the library is built and loaded
    once."""
    with _LOAD_LOCK:
        return _load(name)
