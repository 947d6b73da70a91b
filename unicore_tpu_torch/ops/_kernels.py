"""Build, load and count the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The build happens at first use, never
at import (the CPU tests import every module), into
``<checkout>/build/unicore_tpu_torch/``, keyed on a hash of the sources and
flags.  Each source compiles to an object in its own ``nvcc`` process, all
started together, then one link; the result is written under a temporary
name and ``os.replace``d into place, so two processes building at once
(a smoke script and the server it starts) never see a half-written file.

Each kernel wrapper keeps a plain integer launch count (:class:`LaunchCounter`),
raised by one exactly where the wrapper launches its kernel: a run reads the
counts to show its main path went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "unicore_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
_lib_lock = threading.Lock()


class LaunchCounter:
    """The launch count of one kernel wrapper: a plain integer."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    if name not in COUNTERS:
        COUNTERS[name] = LaunchCounter(name)
    return COUNTERS[name]


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in sorted(COUNTERS.items())}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def sources() -> List[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels of unicore_tpu_torch are built from csrc/ at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libunicore_kernels-{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library;
    returns its path.  A no-op when the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    procs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs)
            )
        tmp = out.with_name(f"{out.name}.{tag}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log_tmp = build_log_path().with_name(f"{build_log_path().name}.{tag}.tmp")
        log_tmp.write_text("\n".join(logs))
        os.replace(log_tmp, build_log_path())
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _bind(lib) -> None:
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    u = ctypes.c_uint
    # csrc/attention_fullrow.cu: tensors (the forward's lse and the
    # backward's o, lse, di scratch among them), then (B, H, Lq, Lk, D,
    # bias_heads), sm_scale, the dropout (on, seed, threshold, scale), dtype,
    # stream
    fr_geom = [i] * 6 + [f, i, i, u, f, i, p]
    lib.unicore_fullrow_attention_fwd.argtypes = [p] * 7 + fr_geom
    lib.unicore_fullrow_attention_bwd.argtypes = [p] * 13 + fr_geom
    lib.unicore_fused_norm_fwd.argtypes = [p, p, p, p, p, p, ll, i, f, i, i, p]
    lib.unicore_fused_norm_dx.argtypes = [p, p, p, p, p, p, ll, i, i, i, p]
    lib.unicore_fused_norm_dwdb.argtypes = [p, p, p, p, p, p, p, ll, i, i, p]
    desc = ctypes.POINTER(ll)  # an extra's index map (csrc/softmax_dropout.cu)
    lib.unicore_softmax_dropout_fwd.argtypes = [
        p, p, desc, p, desc, p, ll, i, i, i, u, u, f, i, p,
    ]
    lib.unicore_softmax_dropout_bwd.argtypes = [
        p, p, desc, p, desc, p, p, ll, i, i, i, u, u, f, i, p,
    ]
    # csrc/flash_attention.cu: tensors, then (B, H, Lq, Lk, D, Bb, Hb),
    # sm_scale, the dropout (on, seed, threshold, scale), dtype, stream
    geom = [i] * 7 + [f, i, i, u, f, i, p]
    lib.unicore_flash_attention_fwd.argtypes = [p] * 7 + geom
    lib.unicore_flash_attention_dq.argtypes = [p] * 9 + geom
    lib.unicore_flash_attention_dkv.argtypes = [p] * 10 + geom
    lib.unicore_flash_attention_db.argtypes = [p] * 10 + geom
    # csrc/decode_attention.cu: tensors, (B, H, L, D), dtype, quant, stream
    lib.unicore_decode_attention.argtypes = [p] * 8 + [i] * 6 + [p]
    # the quantized serving path: csrc/quant_matmul.cu (x, w, scale, bias, y,
    # M, N, K, activation), the int8 LayerNorm of csrc/fused_norm.cu and the
    # int8/int32 softmax of csrc/softmax_dropout.cu
    lib.unicore_quant_matmul.argtypes = [p] * 5 + [ll, i, i, i, p]
    lib.unicore_quant_layer_norm_fwd.argtypes = [p, p, i, p, p, p, ll, i, f, p]
    lib.unicore_quant_softmax_dropout_fwd.argtypes = [
        p, p, p, desc, p, desc, p, ll, i, i, i, u, u, f, i, p,
    ]
    for fn in ("unicore_fullrow_attention_fwd", "unicore_fullrow_attention_bwd",
               "unicore_fused_norm_fwd", "unicore_fused_norm_dx",
               "unicore_fused_norm_dwdb", "unicore_softmax_dropout_fwd",
               "unicore_softmax_dropout_bwd", "unicore_flash_attention_fwd",
               "unicore_flash_attention_dq", "unicore_flash_attention_dkv",
               "unicore_flash_attention_db", "unicore_decode_attention",
               "unicore_quant_matmul", "unicore_quant_layer_norm_fwd",
               "unicore_quant_softmax_dropout_fwd"):
        getattr(lib, fn).restype = i
    lib.unicore_fused_norm_dwdb_scratch.argtypes = [ll, i]
    lib.unicore_fused_norm_dwdb_scratch.restype = ll
    lib.unicore_flash_attention_db_scratch.argtypes = [i] * 5
    lib.unicore_flash_attention_db_scratch.restype = ll
    lib.unicore_cuda_error_string.argtypes = [i]
    lib.unicore_cuda_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().unicore_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> Optional[int]:
    """A tensor's data pointer for a C entry point; None for no tensor."""
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device and contiguous, else raise."""
    dev: Optional[object] = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
