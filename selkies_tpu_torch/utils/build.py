"""Build a shared library from the repo's sources at first use.

Outputs land in ``build/torch_kernels/`` at the root of the checkout (a
directory ``.gitignore`` lists), named by a hash of the sources and the
command, so an edited source is rebuilt and a stale library is never
loaded. The compiler writes to a temporary name that is renamed into
place, so two processes building at once never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"


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
    return BuildResult(out, time.perf_counter() - t0, log)
