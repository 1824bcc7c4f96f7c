"""Build a shared library from the repo's sources at first use.

Outputs land in ``build/torch_kernels/`` at the root of the checkout (a
directory ``.gitignore`` lists), named by a hash of the sources and the
command, so an edited source is rebuilt and a stale library is never
loaded. The compiler writes to a temporary name that is renamed into
place, so two processes building at once never load a half-written file.
Each build reports its duration, and each reuse of a built library a cache
hit, to the recompile sentinel (``monitoring/jitprof.py``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from selkies_tpu_torch.monitoring import jitprof

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"


def nvcc() -> str:
    """The CUDA compiler: on PATH, else in the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def nvcc_shared_command() -> list[str]:
    """nvcc and its flags for a kernel library with a plain C interface
    (sm_90a; ``-Xptxas -v`` reports registers and spills in the log)."""
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # the compiler's output (e.g. ``-Xptxas -v``), "" when cached


def build_shared(name: str, sources: list[Path], command: list[str],
                 headers: tuple[Path, ...] = (), timeout: float = 600.0) -> BuildResult:
    """Compile ``sources`` with ``command + sources + ['-o', out]``.

    ``command`` is the compiler and its flags; the output path is appended.
    ``headers`` are hashed with the sources (an edited header rebuilds) but
    not passed to the compiler."""
    h = hashlib.sha256(" ".join(command).encode())
    for src in (*sources, *headers):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        jitprof.report_event(jitprof.CACHE_HIT_EVENT)
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*command, *map(str, sources), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=timeout)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name} failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    seconds = time.perf_counter() - t0
    jitprof.report_duration(jitprof.COMPILE_EVENT, seconds)
    return BuildResult(out, seconds, log)
