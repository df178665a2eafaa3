"""Build and load the port's CUDA kernels.

Each kernel is one `.cu` file under `moco_tpu_torch/csrc/` with a plain C
interface (helpers shared between sources are `.cuh` headers there). It is compiled by `nvcc` for `sm_90a` into a shared library
under `build/kernels/` at the repository root, named by a hash of the
source so an edited source is rebuilt, and loaded with `ctypes`. Nothing is
built when a module is imported: the first launch builds, and
`build_all` builds every source at once, one `nvcc` process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (`nvcc`, `cuobjdump`): on PATH or
    under the toolkit torch finds."""
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", name)):
        return os.path.join(CUDA_HOME, "bin", name)
    raise RuntimeError(f"{name} not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to (the hash pins the source and every
    `csrc/*.cuh` header, so an edited header rebuilds what includes it)."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start `nvcc` for `name` unless its library exists; returns
    (process or None, temporary output, final path)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every `csrc/*.cu`, all `nvcc` processes started together;
    returns {name: compiler log} (the `-Xptxas -v` register and spill
    report; empty for a library that was already built)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [(n, *_start(n)) for n in names]
    logs, errors = {}, []
    for n, proc, tmp, out in started:  # wait for every process, then raise
        try:
            logs[n] = _finish(n, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    _finish(name, *_start(name))
    return ctypes.CDLL(str(library_path(name)))
