"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into its own shared library with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

then loaded with ``ctypes``.  The file name carries a hash of the source,
so an edited kernel (or shared header) is rebuilt and a built one is reused.  ``build_all``
starts one ``nvcc`` per source at once, so the wall time of a cold build is
that of the slowest file.

    python -m repro_torch.kernels.build [--ptxas]

builds every kernel; ``--ptxas`` also compiles each source once more with
``-Xptxas -v`` and prints the assembler's registers, shared memory and
spill counts per kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library is built; returns the
    running process (or None) and the library path."""
    src, out = _target(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(name: str, started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names=None) -> dict[str, Path]:
    """Compile every kernel source (or ``names``) in parallel; returns the
    library paths.  Raises with the compiler's output on failure."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, (started, out) in jobs.items():
            _finish(n, started, out)
    return {n: out for n, (_, out) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code (every source
    exports ``cuda_error_string`` to name it)."""
    if err != 0:
        fn = lib.cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({fn(err).decode()})")


def ptxas_report() -> dict[str, str]:
    """The ``ptxas -v`` lines (registers, shared memory, spills) of each
    kernel source, compiled in parallel into a throwaway library."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {n: subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{n}.so"), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in names}
        logs = {n: p.communicate()[0] for n, p in procs.items()}
    for n, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{logs[n]}")
    keep = ("Compiling entry function", "registers", "spill")
    return {n: "\n".join(line.strip() for line in log.splitlines()
                         if any(k in line for k in keep))
            for n, log in logs.items()}


def tensor_core_counts(name: str) -> dict[str, int]:
    """Tensor-core instructions (SASS ``HMMA`` and ``HGMMA``) in each kernel
    function of the built library of ``csrc/<name>.cu``, by mangled name
    (functions with none are listed with 0)."""
    path = build_all([name])[name]
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    counts: dict[str, int] = {}
    func = None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            counts.setdefault(func, 0)
        elif func is not None and ("HMMA" in line or "HGMMA" in line):
            counts[func] += 1
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description="Build the CUDA kernels.")
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers and spills of every kernel")
    args = ap.parse_args()
    for name, path in build_all().items():
        print(f"{name}: {path.name}")
    if args.ptxas:
        for name, report in ptxas_report().items():
            print(f"--- {name}\n{report}")


if __name__ == "__main__":
    main()
