"""Build the port's CUDA sources into plain-C shared libraries and load
them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so`` at the root of
the checkout, at first use; the hash is of the source and the shared
headers (``csrc/*.cuh``), so an edited source never loads a stale
library.  ``build_all`` starts one ``nvcc``
per source at once and waits for all of them.  Nothing here runs when a
module is imported: the CPU tests import every module and have no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = ROOT / "build" / "repro_torch"
SOURCES = ("tac_probe", "page_gather", "tac_fused", "decode_attention",
           "cms_sketch", "flash_attention", "flash_attention_bwd",
           "flash_attention_wide",
           "mamba2_scan", "mamba2_scan_bwd", "rwkv6_scan", "rwkv6_scan_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of the last build
BUILD_LOG: Dict[str, str] = {}
# wall seconds from the start of the last build_all to each source's end
BUILD_SECONDS: Dict[str, float] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every source whose library is missing, all at once.
    Returns the wall seconds spent; raises with nvcc's output on a
    failed build."""
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = tmp.with_suffix(".log")     # a file: no pipe fills and stalls
        with open(log, "w") as f:
            procs.append((name, out, tmp, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT)))
    running = {name for name, *_ in procs}
    while running:                        # each source's own end time
        for name, *_, proc in procs:
            if name in running and proc.poll() is not None:
                BUILD_SECONDS[name] = time.perf_counter() - t0
                running.discard(name)
        if running:
            time.sleep(0.05)
    failed = []
    for name, out, tmp, log, proc in procs:
        BUILD_LOG[name] = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n"
                          f"{BUILD_LOG[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of ``csrc/<name>.cu``, from the ptxas
    report of this process's build of it: registers, static shared memory
    bytes, stack frame bytes and spill stores and loads.  Empty when this
    process did not build the source."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$.]+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                out[fn][key] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of a CUDA ``device``, asked once."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
