"""A/B of the flash attention backward's design choices on one card.

Builds, beside the tree's kernels, copies of ``csrc/flash_attention.cu``
with one choice undone each, and times the dq and the dk/dv/dbias launches
of the tree and of each copy in turns (tree, copy, copy, tree; device ms
from ``torch.profiler``) at the Evoformer's triangle (256, 4, 256, 32) and
MSA-row (32, 8, 256, 32) attentions with their (1, H, 256, 256) bias and
BERT's (2, 12, 1152, 64), fp32 and bf16, with a key mask:

* ``smem_slab``: each block's dbias slab in shared memory (Lq x 68 fp32,
  so at most Lq = 512) rather than in L2-resident device memory;
* ``rmw_each``: the slab's read-modify-write an element at a time (each
  load after the previous store) rather than every load before any store;
* ``q64``: 64-row q / do tiles in the dk/dv launch at D <= 64, not 32;
* ``no_hints``: no ``__launch_bounds__`` minimum of blocks an SM (the
  tree asks 4 for dq and 3 for dk/dv at D = 32, 1 elsewhere).

Prints one ``flash_bwd_ab`` JSON line per (shape, type, copy) with the card
and its power limit; ``bitwise`` says whether the copy's dq, dk, dv and
dbias equal the tree's (a copy whose occupancy differs may choose another
chunk plan, and then sums dbias in another order).  Run from the root of a
checkout on a machine with one NVIDIA card::

    python -m unicore_tpu_torch.tools.flash_bwd_ab
"""

import ctypes
import json
import shutil
import subprocess
import sys
import threading

from ..ops import _kernels

#: (old, new) source edits that undo one design choice each
_DKV = "__global__ void __launch_bounds__(kBwdThreads, DP == 32 ? 3 : 1)\nflash_dkv_kernel("
_DQ = "__global__ void __launch_bounds__(kBwdThreads, DP == 32 ? 4 : 1)\nflash_dq_kernel("
_SLAB_AT = "      return dbcol + (size_t)(qt0 + n * 8 + 2 * t + (e & 1)) * Lk + 8 * (e >> 1);"
VARIANTS = {
    "smem_slab": [
        ("  float* sDi = sLse + 2 * TQ;", "  float* sDi = sLse + 2 * TQ;\n  float* sDB = sDi + 2 * TQ;"),
        (_SLAB_AT, "      return sDB + (qt0 + n * 8 + 2 * t + (e & 1)) * 68 + (key - k0) + "
                   "8 * (e >> 1);"),
        ("    __syncthreads();  // every warp is done with stage st (and K/V) before refills\n"
         "  }\n}\n",
         "    __syncthreads();  // every warp is done with stage st (and K/V) before refills\n"
         "  }\n  if (dbcol != nullptr) {\n    float* base = dbcol - (key - k0);\n"
         "    for (int c = threadIdx.x; c < Lq * 16; c += kBwdThreads) {\n"
         "      const int row = c >> 4, c4 = (c & 15) * 4;\n"
         "      *reinterpret_cast<float4*>(base + (size_t)row * Lk + c4) =\n"
         "          *reinterpret_cast<const float4*>(sDB + row * 68 + c4);\n    }\n  }\n}\n"),
        ("  const size_t smem = dkv_smem_bytes<T, DP>();\n  cudaError_t err = with_smem",
         "  const size_t smem = dkv_smem_bytes<T, DP>() + (size_t)g.Lq * 68 * 4;\n"
         "  cudaError_t err = with_smem"),
        ("    const size_t smem = dkv_smem_bytes<T, DP>();\n    auto kernel",
         "    const size_t smem = dkv_smem_bytes<T, DP>() + "
         "(db != nullptr ? (size_t)a.g.Lq * 68 * 4 : 0);\n    auto kernel"),
    ],
    "rmw_each": [
        ("        for (int e = 0; e < 4; ++e) dbs[n][e] = *slab_at(n, e);",
         "        for (int e = 0; e < 4; ++e) dbs[n][e] = 0.f;"),
        ("        if (dbcol != nullptr) dbs[n][e] = r == 0 ? ds : dbs[n][e] + ds;",
         "        if (dbcol != nullptr) *slab_at(n, e) = r == 0 ? ds : *slab_at(n, e) + ds;"),
        ("        for (int e = 0; e < 4; ++e) *slab_at(n, e) = dbs[n][e];",
         "        for (int e = 0; e < 4; ++e) (void)dbs[n][e];"),
    ],
    "q64": [("constexpr int kTileQ = 32;", "constexpr int kTileQ = 32;\n"
                                           "template <int DP> __host__ __device__ constexpr int "
                                           "tile_q() "
                                           "{ return DP <= 64 ? 64 : 32; }"),
            ("(4 * kTile + 4 * kTileQ) * tile_ld<T>(DP) +\n         sizeof(float) * 4 * kTileQ",
             "(4 * kTile + 4 * tile_q<DP>()) * tile_ld<T>(DP) +\n"
             "         sizeof(float) * 4 * tile_q<DP>()"),
            ("  constexpr int TQ = kTileQ;", "  constexpr int TQ = tile_q<DP>();")],
    "no_hints": [(_DKV, _DKV.replace(", DP == 32 ? 3 : 1", "")),
                 (_DQ, _DQ.replace(", DP == 32 ? 4 : 1", ""))],
}
SHAPES = [("triangle", (256, 4, 256, 32), (1, 4, 256, 256)),
          ("msa_row", (32, 8, 256, 32), (1, 8, 256, 256)),
          ("bert_router", (2, 12, 1152, 64), (1, 12, 1152, 1152))]


def build_variant(name, edits, out, source="flash_attention.cu"):
    """Compile the copy of ``csrc/<source>`` with ``edits`` applied (and
    fused_norm.cu, for the error strings) into its own library under
    build/; out[name] = its path or the error."""
    d = _kernels.BUILD_DIR.parent / "kernel_ab" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in _kernels.sources():
        if f.suffix == ".cuh" or f.name == "fused_norm.cu":
            shutil.copy(f, d / f.name)
    src = (_kernels.CSRC / source).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            out[name] = f"edit not found once: {old[:60]!r}"
            return
        src = src.replace(old, new)
    (d / source).write_text(src)
    nvcc, objs = _kernels._nvcc(), []
    for cu in dict.fromkeys((source, "fused_norm.cu")):
        obj = d / f"{cu}.o"
        r = subprocess.run([nvcc, *_kernels.NVCC_FLAGS, "-I", str(d), "-c", str(d / cu),
                            "-o", str(obj)], capture_output=True, text=True)
        if r.returncode:
            out[name] = f"nvcc failed: {r.stdout[-2000:]}{r.stderr[-2000:]}"
            return
        objs.append(str(obj))
    lib = d / "lib.so"
    subprocess.run([nvcc, "-shared", *_kernels.NVCC_FLAGS[:2], "-o", str(lib), *objs],
                   check=True)
    out[name] = lib


def load(path):
    lib = ctypes.CDLL(str(path))
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    geom = [i] * 7 + [f, i, i, u, f, i, i, p]
    lib.unicore_flash_attention_dq.argtypes = [p] * 10 + geom
    lib.unicore_flash_attention_dkv.argtypes = [p] * 12 + geom
    lib.unicore_flash_attention_dq.restype = lib.unicore_flash_attention_dkv.restype = i
    lib.unicore_flash_attention_dkv_scratch.argtypes = [i] * 9
    lib.unicore_flash_attention_dkv_scratch.restype = ctypes.c_longlong
    lib.unicore_cuda_error_string.argtypes = [i]
    lib.unicore_cuda_error_string.restype = ctypes.c_char_p
    return lib


def device_ms(torch, fn, iters=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def main():
    import torch

    from ..ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA card", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    built = {}
    threads = [threading.Thread(target=build_variant, args=(n, e, built))
               for n, e in VARIANTS.items()]
    for t in threads:
        t.start()
    tree = _kernels.library()
    for t in threads:
        t.join()
    libs = {n: load(p) if not isinstance(p, str) else p for n, p in built.items()}
    dev = torch.device("cuda", 0)
    for shape_name, (B, H, L, D), bias_shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(3)
            q = (torch.randn(B, H, L, D, generator=g, device=dev) * D ** -0.5).to(dtype)
            k, v, do = (torch.randn(B, H, L, D, generator=g, device=dev).to(dtype)
                        for _ in range(3))
            bias = torch.randn(bias_shape, generator=g, device=dev)
            lens = torch.linspace(L, L // 3, B, device=dev).long()
            lens[-1] = 0
            mask = (torch.arange(L, device=dev)[None] >= lens[:, None]).to(torch.int32)
            _kernels._lib = tree
            out, lse = fa._launch_fwd(q, k, v, bias, mask, 1.0, 0.0, 0)
            _, di = fa._launch_dq(q, k, v, bias, mask, lse, out, do, 1.0, 0.0, 0)

            def dq():
                return fa._launch_dq(q, k, v, bias, mask, lse, out, do, 1.0, 0.0, 0)[0]

            def dkv():
                return fa._launch_dkv(q, k, v, bias, mask, lse, di, do, 1.0, 0.0, 0,
                                      need_db=True)

            ref = (dq(), *dkv())
            for name, lib in libs.items():
                res = {"shape": [B, H, L, D], "bias": list(bias_shape),
                       "dtype": str(dtype)[6:], "variant": name, "card": smi.strip()}
                if isinstance(lib, str) or (name == "smem_slab" and L > 512):
                    res["skipped"] = lib if isinstance(lib, str) else "slab past shared memory"
                    print("flash_bwd_ab " + json.dumps(res), flush=True)
                    continue
                for which in ("tree", name, name, "tree"):
                    _kernels._lib = tree if which == "tree" else lib
                    if which != "tree":
                        got = (dq(), *dkv())
                        res["bitwise"] = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
                    key = "tree" if which == "tree" else "variant"
                    res.setdefault(f"{key}_dq_ms", []).append(device_ms(torch, dq))
                    res.setdefault(f"{key}_dkv_db_ms", []).append(device_ms(torch, dkv))
                print("flash_bwd_ab " + json.dumps(res), flush=True)
            _kernels._lib = tree
            del q, k, v, do, bias, out, lse, di, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
