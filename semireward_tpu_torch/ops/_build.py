"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the repository root (``build/`` is
git-ignored) and is loaded with ``ctypes``; its functions take plain
pointers, ints and the CUDA stream. A source may link libraries of the
toolkit beyond ``NVCC_FLAGS`` (``LINK_FLAGS``: ``jpeg_decode`` links
nvJPEG, found at run time through an rpath to the toolkit's library
folder). The file name carries a hash of the source, of every
``csrc/*.cuh`` header and of the source's whole flag list, so an edited
source, header or flag never loads a stale library. Nothing builds at
import time: the first launch builds, or ``build_all`` builds every source
at once, one ``nvcc`` process per source, all started together. Each
library's compiler output (ptxas's registers and spills) is kept beside it
(``compiler_log``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# each source's flags beyond NVCC_FLAGS: the toolkit libraries it links
LINK_FLAGS = {"jpeg_decode": ["-lnvjpeg"]}

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from semireward_tpu_torch/csrc at first use")


def flags(name: str) -> list:
    """``csrc/<name>.cu``'s nvcc flags: ``NVCC_FLAGS``, then its
    ``LINK_FLAGS`` and, where it links a library, an rpath to the toolkit's
    ``lib64`` beside the ``bin`` that holds nvcc."""
    link = LINK_FLAGS.get(name, [])
    if not link:
        return list(NVCC_FLAGS)
    lib = Path(_nvcc()).resolve().parents[1] / "lib64"
    return [*NVCC_FLAGS, *link, "-Xlinker", f"-rpath={lib}"]


def command(name: str, out: str) -> list:
    """The nvcc command line that builds ``csrc/<name>.cu`` into ``out``."""
    return [_nvcc(), *flags(name), "-o", out, str(CSRC / f"{name}.cu")]


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = None) -> Dict[str, str]:
    """Compile every named source that is not built yet, all in parallel.
    Returns {name: compiler output}; raises if any build fails."""
    names = list(names) if names is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (subprocess.Popen(
            command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            if os.path.exists(tmp):  # nvcc removes it after a failed link
                os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
        else:
            target.with_suffix(".log").write_text(out)
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def compiler_log(name: str) -> str:
    """nvcc's output (with ptxas's ``-v`` report) from building the
    current ``csrc/<name>.cu``; builds it first if it is not built."""
    build_all([name])
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
