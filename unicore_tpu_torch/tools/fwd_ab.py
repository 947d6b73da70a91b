"""A/B of the softmax(+dropout) forward's and the flash forward's design
choices on one card.

Builds, beside the tree's kernels, copies of ``csrc/softmax_dropout.cu`` or
``csrc/flash_attention.cu`` with one choice undone each, and times the
tree's forward and each copy's in turns (tree, copy, copy, tree; device ms
from ``torch.profiler``):

* the softmax forward at Uni-Mol's micro-batch, fp32 (16 * 64, 128, 128),
  at rate 0 and at rate 0.1, with ``torch.softmax`` (rate 0) beside it,
  and bf16 at rate 0.1;
* the flash forward at the Evoformer's triangle (256, 4, 256, 32) and
  MSA-row (32, 8, 256, 32) attentions with their (1, H, 256, 256) bias and
  a key mask, fp32 and bf16, and BERT's (2, 12, 1152, 64) at dropout 0.1,
  with SDPA's forward beside each.

Variants (each edit's anchor must occur once in the tree's source; a copy
whose anchor is missing is reported as skipped):

* ``scalar_io``: four 4-byte loads and stores a quad (fp32) rather than one
  16-byte vector;
* ``streaming_io``: x and y (fp32) loaded and stored with streaming
  (evict-first) hints rather than the default cache policy;
* ``one_row``: one row a warp at every length, not four (L = 128) or two
  (L = 256);
* ``ieee_div``: ``p / s`` and the dropout's ``y / div`` as IEEE divisions,
  not a reciprocal multiply (and one FMA correction for the dropout);
* ``accurate_exp``: ``expf(v - max)`` rather than ``ex2.approx`` of a
  pre-scaled argument;
* ``fwd_no_hint`` / ``fwd_hint3``: the flash forward without its
  ``__launch_bounds__`` minimum of blocks an SM (4 at D = 32, else 1), or
  with 3 at D = 32.

Prints one ``fwd_ab`` JSON line per (case, copy) with the card and its power
limit; ``bitwise`` says whether the copy's output equals the tree's.  Run
from the root of a checkout on a machine with one NVIDIA card::

    python -m unicore_tpu_torch.tools.fwd_ab
"""

import ctypes
import json
import subprocess
import sys
import threading

from ..ops import _kernels
from .flash_bwd_ab import build_variant, device_ms

_SD, _FA = "softmax_dropout.cu", "flash_attention.cu"
_FWD_HINT = ("__global__ void __launch_bounds__(kFwdThreads, DP == 32 ? 4 : 1)\n"
             "flash_fwd_kernel(")
_LOAD4 = "  const float4 t = *reinterpret_cast<const float4*>(p);"
_STORE4 = "  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);"
#: name -> (source, [(old, new), ...]) source edits that undo one choice each
VARIANTS = {
    "scalar_io": (_SD, [
        (_LOAD4, "  const float4 t = make_float4(p[0], p[1], p[2], p[3]);"),
        (_STORE4, "  p[0] = y[0];\n  p[1] = y[1];\n  p[2] = y[2];\n  p[3] = y[3];"),
    ]),
    "streaming_io": (_SD, [
        (_LOAD4, "  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));"),
        (_STORE4, "  __stcs(reinterpret_cast<float4*>(p), make_float4(y[0], y[1], y[2], y[3]));"),
    ]),
    "one_row": (_SD, [("  return CH <= 2 ? 4 / CH : 1;", "  return 1;")]),
    "ieee_div": (_SD, [
        ("    for (int j = 0; j < 4; ++j) v[q][j] *= rs;",
         "    for (int j = 0; j < 4; ++j) v[q][j] = v[q][j] / s;"),
        ("  const float qt = __fmul_rn(y, rd);\n"
         "  return round_to<T>(__fmaf_rn(__fmaf_rn(-qt, dr.div, y), rd, qt));",
         "  return round_to<T>(y / dr.div);"),
    ]),
    "accurate_exp": (_SD, [
        ("      v[q][j] = ex2(__fmaf_rn(v[q][j], kLog2e, -ml));",
         "      v[q][j] = expf(v[q][j] - mx);"),
    ]),
    "fwd_no_hint": (_FA, [(_FWD_HINT, _FWD_HINT.replace(", DP == 32 ? 4 : 1", ""))]),
    "fwd_hint3": (_FA, [(_FWD_HINT, _FWD_HINT.replace("? 4 : 1", "? 3 : 1"))]),
}
SOFTMAX_CASES = [("unimol", (16 * 64, 128, 128), "float32", 0.0),
                 ("unimol", (16 * 64, 128, 128), "float32", 0.1),
                 ("unimol", (16 * 64, 128, 128), "bfloat16", 0.1)]
FLASH_CASES = [("triangle", (256, 4, 256, 32), (1, 4, 256, 256), 0.0),
               ("msa_row", (32, 8, 256, 32), (1, 8, 256, 256), 0.0),
               ("bert_router", (2, 12, 1152, 64), (1, 12, 1152, 1152), 0.1)]


def load(path):
    lib = ctypes.CDLL(str(path))
    p, i, f, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_longlong
    desc = ctypes.POINTER(ll)
    if hasattr(lib, "unicore_softmax_dropout_fwd"):
        lib.unicore_softmax_dropout_fwd.argtypes = [p, p, desc, p, desc, p, ll, i, i, i, u, u,
                                                    f, i, p]
        lib.unicore_softmax_dropout_fwd.restype = i
    if hasattr(lib, "unicore_flash_attention_fwd"):
        lib.unicore_flash_attention_fwd.argtypes = [p] * 7 + [i] * 7 + [f, i, i, u, f, i, i,
                                                                         p]
        lib.unicore_flash_attention_fwd.restype = i
    lib.unicore_cuda_error_string.argtypes = [i]
    lib.unicore_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main():
    import torch
    import torch.nn.functional as F

    from ..ops import flash_attention as fa
    from ..ops import softmax_dropout as sd

    if not torch.cuda.is_available():
        print("fwd_ab: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    built = {}
    threads = [threading.Thread(target=build_variant, args=(n, e, built, src))
               for n, (src, e) in VARIANTS.items()]
    for t in threads:
        t.start()
    tree = _kernels.library()
    for t in threads:
        t.join()
    libs = {n: load(p) if not isinstance(p, str) else p for n, p in built.items()}
    dev = torch.device("cuda", 0)

    def ab(case, call, source, library):
        """Time ``call`` on the tree and on each copy of ``source``."""
        _kernels._lib = tree
        ref = call()
        res = dict(case, variant="tree", card=smi.strip())
        res["tree_ms"] = [device_ms(torch, call) for _ in range(2)]
        res["library_ms"] = device_ms(torch, library)
        print("fwd_ab " + json.dumps(res), flush=True)
        for name, lib in libs.items():
            if VARIANTS[name][0] != source:
                continue
            res = dict(case, variant=name, card=smi.strip())
            if isinstance(lib, str):
                res["skipped"] = lib
                print("fwd_ab " + json.dumps(res), flush=True)
                continue
            for which in ("tree", name, name, "tree"):
                _kernels._lib = tree if which == "tree" else lib
                if which != "tree":
                    res["bitwise"] = bool(torch.equal(call(), ref))
                key = "tree" if which == "tree" else "variant"
                res.setdefault(f"{key}_ms", []).append(device_ms(torch, call))
            print("fwd_ab " + json.dumps(res), flush=True)
        _kernels._lib = tree

    for name, shape, dtype, rate in SOFTMAX_CASES:
        g = torch.Generator(device=dev).manual_seed(1)
        x = (2 * torch.randn(shape, generator=g, device=dev)).to(getattr(torch, dtype))
        ab({"kernel": "softmax_dropout_fwd", "case": name, "shape": list(shape),
            "dtype": dtype, "rate": rate},
           lambda: sd._launch_fwd(x, None, None, (None, None), rate, 7), _SD,
           lambda: torch.softmax(x, -1))
        del x
    for name, (B, H, L, D), bias_shape, rate in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(3)
            q = (torch.randn(B, H, L, D, generator=g, device=dev) * D ** -0.5).to(dtype)
            k, v = (torch.randn(B, H, L, D, generator=g, device=dev).to(dtype) for _ in range(2))
            bias = torch.randn(bias_shape, generator=g, device=dev)
            lens = torch.linspace(L, L // 3, B, device=dev).long()
            mask = (torch.arange(L, device=dev)[None] >= lens[:, None]).to(torch.int32)
            lib_mask = (torch.where(mask[:, None, None, :] != 0, float("-inf"), 0.0)
                        + bias.repeat_interleave(B // bias.shape[0], dim=0)).to(dtype)
            ab({"kernel": "flash_attention_fwd", "case": name, "shape": [B, H, L, D],
                "bias": list(bias_shape), "dtype": str(dtype)[6:], "rate": rate},
               lambda: fa._launch_fwd(q, k, v, bias, mask, 1.0, rate, 11)[0], _FA,
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=1.0,
                                                      dropout_p=rate))
            del q, k, v, bias, mask, lib_mask
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
