"""A/B of the W8A8 dense's (#13) and the decode attention's (#12) design
choices on one card.

Times, in turns (tree, copy, copy, tree; device ms of the kernel's own
launches from ``torch.profiler``), the tree's kernel against versions with
one choice undone each, at the int8 serving path's dense sites (BERT-base,
M = 8 x 512 rows: ``in_proj`` 768 -> 2304, ``out_proj`` 768 -> 768, ``fc1``
768 -> 3072 GELU, ``fc2`` 3072 -> 768, the LM head's 768 -> 768 GELU, every
one with its bias) and at the decode step's attention (8, 12, L, 64), every
row live, with the bias row: fp32, bf16 and int8 caches at L = 512, fp32 at
L = 128, and fp32 at L = 512 with the L2 cache flushed before each call,
as the served step finds its freshly gathered caches.  Beside them: one
``torch._int_mm`` plus the epilogue in torch ops, and SDPA over the
(B, H, 1, D) query with the bias row as a float mask.

Variants:

* ``tile128`` (#13): the output tile 128 x 128 at every site, not the
  chooser's width (:func:`~unicore_tpu_torch.ops.quant_matmul.choose_tile_n`);
* ``non_persistent`` (#13): one block an output tile, not one block an SM
  walking the tiles (no epilogue under the next tile's loads);
* ``no_tma_store`` (#13): each staged 64 x 32 box stored by the
  warpgroup's threads (float4 a thread, whole lines), not by one TMA
  store that drains while the warps go on;
* ``two_stages`` (#13): a ring of 2 TMA stages, not 4-6;
* ``fc1_linear`` (a case, not a variant): fc1's shape without its GELU,
  the epilogue's share of fc1;
* ``one_split`` (#12): one block a (b, h), the rows not split across
  blocks (:func:`~unicore_tpu_torch.ops.decode_attention.choose_splits`
  returns 1);
* ``no_bulk`` (#12): the K/V tiles copied by every thread through
  registers, synchronously, not by one bulk asynchronous copy a tile.

A chooser override runs the tree's library; an edited copy of the source
is built into its own library (its anchors must each occur once in the
tree's source; a copy whose anchor is missing is reported as skipped).
Prints one ``dense_decode_ab`` JSON line per (case, variant) with the card
and its power limit; ``bitwise`` says whether the variant's output equals
the tree's; ``host_us`` is the host's time to enqueue one call (#13
encodes its three tensor maps there).  Run from the root of a checkout on a machine with one NVIDIA
card::

    python -m unicore_tpu_torch.tools.dense_decode_ab
"""

import ctypes
import json
import subprocess
import sys
import threading
import time

from ..ops import _kernels
from .flash_bwd_ab import build_variant

_QM, _DA = "quant_matmul.cu", "decode_attention.cu"
#: name -> (kernel, source, [(old, new), ...]) for an edited copy of the
#: source, or (kernel, None, {chooser: replacement}) for a chooser override
VARIANTS = {
    "tile128": ("quant_matmul", None, {"choose_tile_n": lambda M, N, K: 128}),
    "non_persistent": ("quant_matmul", _QM, [
        ("  const long long grid = tiles < sms ? tiles : sms;",
         "  const long long grid = tiles;"),
    ]),
    "no_tma_store": ("quant_matmul", _QM, [
        ("        if (lead) {\n"
         "          tma_store_2d(&tmy, st, n0 + jc * kEpiCols, static_cast<int>(m0) + c * 64);\n"
         "          bulk_commit();\n"
         "        }",
         "        for (int i = threadIdx.x % 128; i < kEpiBox / 4; i += 128) {\n"
         "          const int r = i / 8, q = i % 8;\n"
         "          const long long row = m0 + c * 64 + r;\n"
         "          const int col = n0 + jc * kEpiCols + 4 * q;\n"
         "          if (row < M && col < N)\n"
         "            *reinterpret_cast<float4*>(y + row * N + col) =\n"
         "                *reinterpret_cast<const float4*>(st + r * kEpiCols + ((q ^ (r & 7)) << 2));\n"
         "        }"),
    ]),
    "two_stages": ("quant_matmul", _QM, [
        ("  return s > kMaxStages ? kMaxStages : s;", "  return 2;"),
    ]),
    "one_split": ("decode_attention", None, {"choose_splits": lambda bh, L: 1}),
    "no_bulk": ("decode_attention", _DA, [
        ("  if (threadIdx.x == 0) {\n"
         "    mbar_arrive_expect_tx(bar, (uint32_t)(sk.bytes + sv.bytes + sb.bytes));\n"
         "    bulk_g2s(dst, sk.src, sk.bytes, bar);\n"
         "    bulk_g2s(dst + sk.bytes, sv.src, sv.bytes, bar);\n"
         "    if (sb.bytes) bulk_g2s(dst + sk.bytes + sv.bytes, sb.src, sb.bytes, bar);\n"
         "  }",
         "  for (int i = threadIdx.x; i < sk.bytes / 16; i += blockDim.x)\n"
         "    reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(sk.src) + i);\n"
         "  for (int i = threadIdx.x; i < sv.bytes / 16; i += blockDim.x)\n"
         "    reinterpret_cast<uint4*>(dst + sk.bytes)[i] =\n"
         "        __ldg(reinterpret_cast<const uint4*>(sv.src) + i);\n"
         "  for (int i = threadIdx.x; i < sb.bytes / 16; i += blockDim.x)\n"
         "    reinterpret_cast<uint4*>(dst + sk.bytes + sv.bytes)[i] =\n"
         "        __ldg(reinterpret_cast<const uint4*>(sb.src) + i);\n"
         "  __syncthreads();\n"
         "  if (threadIdx.x == 0) mbar_arrive(bar);"),
    ]),
}
#: (site, M, K, N, activation): every dense of a served int8 BERT-base batch
DENSE_SITES = [("in_proj", 4096, 768, 2304, ""), ("out_proj", 4096, 768, 768, ""),
               ("fc1", 4096, 768, 3072, "gelu"), ("fc1_linear", 4096, 768, 3072, ""),
               ("fc2", 4096, 3072, 768, ""),
               ("lm_head", 4096, 768, 768, "gelu")]
#: (case, (B, H, L, D), dtype, int8 caches, flush L2 before each call)
DECODE_CASES = [("serve", (8, 12, 512, 64), "float32", False, False),
                ("serve_bf16", (8, 12, 512, 64), "bfloat16", False, False),
                ("serve_int8", (8, 12, 512, 64), "float32", True, False),
                ("bucket128", (8, 12, 128, 64), "float32", False, False),
                ("serve_cold", (8, 12, 512, 64), "float32", False, True)]


def load(path):
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(lib, "unicore_quant_matmul"):
        lib.unicore_quant_matmul.argtypes = [p] * 5 + [ll, i, i, i, i, p]
        lib.unicore_quant_matmul.restype = i
    if hasattr(lib, "unicore_decode_attention"):
        lib.unicore_decode_attention.argtypes = [p] * 10 + [i] * 9 + [p]
        lib.unicore_decode_attention.restype = i
    lib.unicore_cuda_error_string.argtypes = [i]
    lib.unicore_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_ms(torch, fn, names, iters=20, before=None):
    """Device ms per call of the CUDA kernels whose name holds one of
    ``names`` (``before``, an L2 flush by a fill, runs ahead of each call;
    fill kernels are not counted).  A window in which the profiler saw
    none of them is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    us = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and any(n in e.key for n in names)
                 and (before is None or "FillFunctor" not in e.key))
        if us > 0:
            break
    return us / iters / 1e3


def host_us(torch, fn, iters=200):
    """The host's time to enqueue one call, microseconds (no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / iters


def main():
    import torch
    import torch.nn.functional as F

    from ..ops import decode_attention as da
    from ..ops import quant_matmul as qm
    from ..utils import get_activation_fn

    if not torch.cuda.is_available():
        print("dense_decode_ab: no CUDA card", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    built = {}
    threads = [threading.Thread(target=build_variant, args=(n, edits, built, src))
               for n, (_, src, edits) in VARIANTS.items() if src is not None]
    for t in threads:
        t.start()
    tree = _kernels.library()
    for t in threads:
        t.join()
    mods = {"quant_matmul": qm, "decode_attention": da}
    dev = torch.device("cuda", 0)
    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB, past L2

    def use(name):
        """Install variant ``name`` ("tree" for none); returns what to undo."""
        _kernels._lib = tree
        if name == "tree":
            return []
        kernel, src, change = VARIANTS[name]
        if src is not None:
            _kernels._lib = load(built[name])
            return []
        undo = [(mods[kernel], attr, getattr(mods[kernel], attr)) for attr in change]
        for attr, fn in change.items():
            setattr(mods[kernel], attr, fn)
        return undo

    def ab(kernel, case, call, names, library, before=None):
        ref = call()
        res = dict(case, kernel=kernel, variant="tree", card=smi)
        res["tree_ms"] = [kernel_ms(torch, call, names, before=before) for _ in range(2)]
        res["tree_host_us"] = host_us(torch, call)
        res["library_ms"] = kernel_ms(torch, library, ("",), before=before)
        print("dense_decode_ab " + json.dumps(res), flush=True)
        for name, (kname, src, change) in VARIANTS.items():
            if kname != kernel:
                continue
            res = dict(case, kernel=kernel, variant=name, card=smi)
            missing = ([a for a in change if not hasattr(mods[kname], a)] if src is None
                       else [] if not isinstance(built.get(name), str) else [built[name]])
            if missing:
                res["skipped"] = f"not in this tree: {missing}"
                print("dense_decode_ab " + json.dumps(res), flush=True)
                continue
            for which in ("tree", name, name, "tree"):
                undo = use(which)
                try:
                    key = "tree" if which == "tree" else "variant"
                    if which != "tree":
                        res["bitwise"] = bool(torch.equal(call(), ref))
                        res["variant_host_us"] = host_us(torch, call)
                    res.setdefault(f"{key}_ms", []).append(
                        kernel_ms(torch, call, names, before=before))
                finally:
                    for mod, attr, fn in undo:
                        setattr(mod, attr, fn)
                    _kernels._lib = tree
            print("dense_decode_ab " + json.dumps(res), flush=True)

    for site, M, K, N, act in DENSE_SITES:
        g = torch.Generator(device=dev).manual_seed(M + K + N)
        x = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        scale = torch.rand(N, generator=g, device=dev) * 2e-5 + 1e-5
        bias = torch.randn(N, generator=g, device=dev)
        fn = get_activation_fn(act) if act else (lambda t: t)

        def library():
            return fn(torch._int_mm(x, w.t()).float() * scale + bias)

        ab("quant_matmul", {"site": site, "shape": [M, K, N], "activation": act},
           lambda: qm.quant_matmul_kernel(x, w, scale, bias, act), ("quant_matmul",),
           library)
    for case, (B, H, L, D), dtype, int8, cold in DECODE_CASES:
        g = torch.Generator(device=dev).manual_seed(5150)
        dt = getattr(torch, dtype)
        q = (torch.randn(B, H, D, generator=g, device=dev) * D ** -0.5).to(dt)
        k = torch.randn(B, H, L, D, generator=g, device=dev)
        v = torch.randn(B, H, L, D, generator=g, device=dev)
        bias = torch.randn(B, H, L, generator=g, device=dev)
        pos = torch.full((B,), L - 1, dtype=torch.int32, device=dev)
        scales = {}
        if int8:
            ks = k.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
            vs = v.abs().amax(dim=(0, 2)) / 127.0 + 1e-8
            k = torch.round(k / ks[None, :, None]).clamp(-127, 127).to(torch.int8)
            v = torch.round(v / vs[None, :, None]).clamp(-127, 127).to(torch.int8)
            scales = {"k_scale": ks.contiguous(), "v_scale": vs.contiguous()}
        else:
            k, v = k.to(dt), v.to(dt)
        mask = bias[:, :, None].to(dt)

        def sdpa():  # the int8 caches dequantized first: no one call fuses it
            kf = (k.float() * scales["k_scale"][None, :, None]).to(dt) if int8 else k
            vf = (v.float() * scales["v_scale"][None, :, None]).to(dt) if int8 else v
            return F.scaled_dot_product_attention(q[:, :, None], kf, vf, attn_mask=mask,
                                                  scale=1.0)

        ab("decode_attention", {"case": case, "shape": [B, H, L, D], "dtype": dtype,
                                "kv": "int8" if int8 else dtype, "cold_l2": cold},
           lambda: da.decode_attention(q, k, v, pos, bias=bias, **scales), ("decode",),
           sdpa, before=(lambda: flush_buf.fill_(1)) if cold else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
