"""Registers, spills and shared memory of the port's CUDA kernels, as ptxas reports them.

    PYTHONPATH=src python -m repro_torch.kernels.ptxas [SOURCE ...]

Compiles each source (a path under ``kernels/``; default: every ``csrc/*.cu``)
with the flags ``common.load_cuda`` builds with, plus ``-Xptxas -v``, into a
temporary library that is thrown away, and prints ptxas's line for each
kernel: its name, registers a thread, spill stores and loads, stack frame
and static shared memory. Needs ``nvcc``; exits non-zero when a build fails.
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile

from repro_torch.kernels import common


def report(source: str) -> str:
    """ptxas's verbose output for one source, one line per kernel."""
    nvcc = common.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [nvcc, *common.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/lib.so",
               str(common.KERNELS_DIR / source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    lines, name = [], None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "bytes stack frame" in line):
            lines.append(f"{name}: {line.split('info    :')[-1].strip()}")
    return "\n".join(lines)


def main(argv: list[str]) -> int:
    sources = argv or sorted(str(p.relative_to(common.KERNELS_DIR))
                             for p in common.KERNELS_DIR.glob("*/csrc/*.cu"))
    for s in sources:
        print(f"== {s}")
        print(report(s))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
