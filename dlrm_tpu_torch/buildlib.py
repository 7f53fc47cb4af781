"""Builds the port's native libraries from the sources in the checkout.

Each library is compiled at first use into BUILD_DIR (git-ignored) under a
name that carries a hash of its sources and command, so an edited source
never loads a stale library. The compiler writes to a private temporary name
that is renamed into place, so concurrent processes (pytest workers) that
build the same library do not see each other's half-written files.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "build")


def build_shared(name: str, sources: Sequence[str], cmd: Sequence[str],
                 timeout: float = 600.0, deps: Sequence[str] = ()) -> str:
    """Compile `sources` (paths relative to the package) into
    BUILD_DIR/lib<name>-<hash>.so and return its path. `cmd` is the compiler
    command without sources and output; it must produce a shared library
    with `-o <out> <sources...>` appended. `deps` are headers the sources
    include: hashed with them, not compiled. Raises RuntimeError with the
    compiler's output if the build fails."""
    paths = [os.path.join(PKG_DIR, s) for s in sources]
    h = hashlib.sha256(" ".join(cmd).encode())
    for p in paths + [os.path.join(PKG_DIR, s) for s in deps]:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(
            [*cmd, "-o", tmp, *paths],
            capture_output=True, text=True, timeout=timeout,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(cmd)}):\n"
                f"{r.stdout}\n{r.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
