"""Flat buffers and the fused optimizer pass of ``--fused-adam``
(counterpart of ``unicore_tpu/optim/multi_tensor.py``).

:class:`FlatPlan` groups the named parameters by dtype, in parameter
order, once per model.  Each group has one contiguous fp32 buffer for the
master (or the fp32 parameters themselves), ``m``, ``v`` and the gradient
accumulator, and, when the parameters are bf16 or fp16, one buffer of the
parameters; every parameter and every slot is a view into its group's
buffer (``p.data = flat[a:b].view_as(p)``), so the pass runs over
contiguous memory.  Segments start at multiples of four elements (the
kernels load 16 bytes at a time); the few elements between segments are
zeros in every buffer and stay zeros.

Two kernels of ``csrc/multi_tensor.cu`` do the work on the card:

- :func:`multi_tensor_l2norm` (K-a): the global L2 norm of the flat
  gradients, each element divided by a device scalar (the sample size
  times the loss scale) inside the reduction; two stages, no atomics, the
  same bits every run;
- :func:`fused_adam` (K-b): one pass per group -- the clip coefficient
  from K-a's norm (read on the device), decoupled decay per segment, the
  moments, the update and the copy-back into a bf16/fp16 parameter
  (nearest-even, or stochastic under ``--bf16-sr`` with in-kernel Philox
  noise).  A non-finite norm leaves every buffer as it was.

A CUDA tensor runs the kernel or raises; a CPU tensor takes the plain
version (:func:`multi_tensor_l2norm_plain`, :func:`fused_adam_plain`),
the same function in torch ops, each rounded on its own, in the JAX op
order: decay ``where(d, p * (1 - step_size * wd), p)``, then ``m``,
``v``, then ``p - step_size * m / (sqrt(v) + eps)``.  Kernel and plain
version agree bit for bit, SR included (:func:`sr_noise_plain` draws the
kernel's Philox bits), and the plain version on flat buffers is bit for
bit the per-tensor Adam of ``optim/adam.py``.  The norm sums in another
order than the per-tensor ``total_norm`` and may differ from it in the
last ulp, as the JAX package documents for its own.

ZeRO sharding of the flat buffers (the JAX ``_zero_shard``) is not
ported (ROADMAP queue A item 4): under data parallelism every rank keeps
the whole state, and ``parallel/hierarchy.py`` reduces the gradient
buffers whole (:func:`pad_to` pads them for its reduce-scatter).
"""

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops.attention_fullrow import philox4x32_10
from unicore_tpu_torch.ops.rounding import fp32_to_bf16_sr_bits

#: segments start at multiples of this many elements (16-byte loads)
ALIGN = 4
#: elements of one block of the Adam kernel (a chunk lies in one segment)
CHUNK = 8192
#: the clip's epsilon (the JAX ``clip_grad_norm``)
CLIP_EPS = 1e-6
_U32 = 0xFFFFFFFF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 4}

NORM_LAUNCHES = _kernels.counter("multi_tensor_l2norm")
ADAM_LAUNCHES = _kernels.counter("fused_adam")


class Segment(NamedTuple):
    name: str
    start: int
    size: int
    shape: Tuple[int, ...]
    decay: bool


class FlatGroup:
    """One dtype group: its segments in parameter order and the padded
    length of its buffers."""

    def __init__(self, dtype: torch.dtype, segments: Sequence[Segment], numel: int):
        self.dtype = dtype
        self.segments = tuple(segments)
        self.numel = numel
        self._chunks: Dict[torch.device, torch.Tensor] = {}

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each segment of ``buf`` as a view shaped like its parameter."""
        return {s.name: buf[s.start:s.start + s.size].view(s.shape) for s in self.segments}

    def flatten(self, tensors, dtype=None) -> torch.Tensor:
        """A new buffer holding ``tensors`` (name -> tensor) at their
        segments, zeros between them."""
        first = tensors[self.segments[0].name]
        buf = torch.zeros(self.numel, dtype=dtype or first.dtype, device=first.device)
        for s in self.segments:
            buf[s.start:s.start + s.size].copy_(tensors[s.name].reshape(-1))
        return buf

    def chunk_table(self, device) -> torch.Tensor:
        """The Adam kernel's (n_chunks, 2) int64 table on ``device``: each
        chunk's first element and its length * 2 + its decay flag."""
        device = torch.device(device)
        if device not in self._chunks:
            self._chunks[device] = chunk_table(
                [(s.start, s.size, s.decay) for s in self.segments], device)
        return self._chunks[device]


def chunk_table(segments, device) -> torch.Tensor:
    """(start, length, decay) segments cut into chunks of at most CHUNK
    elements, as the Adam kernel reads them."""
    rows = []
    for start, size, decay in segments:
        if start % ALIGN:
            raise ValueError(f"segment start {start} is not a multiple of {ALIGN}")
        for a in range(start, start + size, CHUNK):
            rows.append((a, 2 * min(CHUNK, start + size - a) + int(decay)))
    return torch.tensor(rows, dtype=torch.int64).to(device)


def pad_to(buf: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad a 1-D flat buffer so its length divides ``mult`` (the JAX
    ``pad_to``): ``buf`` itself when it already does."""
    rem = (-buf.numel()) % mult
    if rem == 0:
        return buf
    return torch.cat([buf, buf.new_zeros(rem)])


class FlatPlan:
    """The named parameters grouped by dtype, order-stable within each
    group (the JAX ``build_plan``), each segment aligned to ALIGN."""

    def __init__(self, groups: Sequence[FlatGroup], names: Sequence[str]):
        self.groups = tuple(groups)
        self.names = tuple(names)

    @classmethod
    def build(cls, named: Dict[str, torch.Tensor],
              decay: Optional[Dict[str, bool]] = None) -> "FlatPlan":
        by_dtype: Dict[torch.dtype, List[Segment]] = {}
        ends: Dict[torch.dtype, int] = {}
        for name, t in named.items():
            start = ends.get(t.dtype, 0)
            seg = Segment(name, start, t.numel(), tuple(t.shape),
                          bool(decay[name]) if decay else False)
            by_dtype.setdefault(t.dtype, []).append(seg)
            ends[t.dtype] = -(-(start + t.numel()) // ALIGN) * ALIGN
        groups = [FlatGroup(dt, segs, ends[dt]) for dt, segs in by_dtype.items()]
        return cls(groups, list(named))

    def flatten(self, tensors, dtype=None) -> List[torch.Tensor]:
        return [g.flatten(tensors, dtype) for g in self.groups]

    def unflatten(self, bufs: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """name -> view into ``bufs``, in the parameters' order."""
        views = {}
        for g, buf in zip(self.groups, bufs):
            views.update(g.views(buf))
        return {n: views[n] for n in self.names}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def clip_coef(gnorm: torch.Tensor, max_norm: float, eps: float = CLIP_EPS) -> torch.Tensor:
    """``min(max_norm / (gnorm + eps), 1)`` as a true division (the JAX
    ``clip_grad_norm``), a 0-d tensor beside ``gnorm``."""
    return torch.clamp(torch.full_like(gnorm, max_norm) / (gnorm + eps), max=1.0)


def multi_tensor_l2norm_plain(bufs: Sequence[torch.Tensor],
                              denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt(sum over the buffers of sum((x / denom)^2)), fp32, 0-d.  (A sum
    of squares: torch's CPU ``vector_norm`` loses 1e-4 relative over a few
    million elements, its pairwise ``sum`` does not.)"""
    sq = [(b if denom is None else b / denom).square().sum() for b in bufs]
    return torch.sqrt(sq[0] if len(sq) == 1 else torch.stack(sq).sum())


def clip_grad_norm_plain(bufs: Sequence[torch.Tensor], max_norm: float,
                         eps: float = CLIP_EPS) -> torch.Tensor:
    """The JAX ``multi_tensor.clip_grad_norm`` on flat buffers, in place:
    each scaled by the clip coefficient (no-op for ``max_norm <= 0``);
    returns the norm before clipping."""
    gnorm = multi_tensor_l2norm_plain(bufs)
    if max_norm > 0:
        coef = clip_coef(gnorm, max_norm, eps)
        for b in bufs:
            b.mul_(coef)
    return gnorm


def sr_noise_plain(n: int, k0: int, k1: int, buffer_id: int, device=None) -> torch.Tensor:
    """The Adam kernel's 16 noise bits of elements 0..n-1 (int32): word
    ``e % 4`` of Philox4x32-10 on the counter (e // 4 as two 32-bit words,
    buffer_id, 0) under the key (k0, k1), shifted right by 16."""
    e4 = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    words = philox4x32_10(e4 & _U32, e4 >> 32, torch.full_like(e4, buffer_id),
                          torch.zeros_like(e4), k0 & _U32, k1 & _U32)
    return (torch.stack(words, dim=-1).reshape(-1)[:n] >> 16).to(torch.int32)


class AdamHyper(NamedTuple):
    """One update's scalars, as the kernel takes them (each rounded to
    fp32 once on the host, as torch rounds a Python scalar)."""
    beta1: float
    beta2: float
    eps: float
    step_size: float
    weight_decay: float
    decay_factor: float

    @property
    def omb1(self):
        return 1.0 - self.beta1

    @property
    def omb2(self):
        return 1.0 - self.beta2


def adam_apply(p, m, v, hp: AdamHyper, decay: Sequence[bool]) -> None:
    """Decay, then ``p -= step_size * m / (sqrt(v) + eps)``, on lists of
    fp32 tensors in place, every operation rounded on its own."""
    if hp.weight_decay != 0.0:
        decayed = [t for t, d in zip(p, decay) if d]
        if decayed:
            torch._foreach_mul_(decayed, hp.decay_factor)
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, hp.eps)
    upd = torch._foreach_div(m, denom)
    torch._foreach_mul_(upd, hp.step_size)
    torch._foreach_sub_(p, upd)


def adam_moments(g, m, v, hp: AdamHyper) -> None:
    """``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2`` on lists of
    fp32 tensors in place, every operation rounded on its own."""
    torch._foreach_mul_(m, hp.beta1)
    torch._foreach_add_(m, torch._foreach_mul(g, hp.omb1))
    torch._foreach_mul_(v, hp.beta2)
    gg = torch._foreach_mul(g, g)
    torch._foreach_mul_(gg, hp.omb2)
    torch._foreach_add_(v, gg)


def adam_elementwise(p, g, m, v, hp: AdamHyper, decay: Sequence[bool]) -> None:
    """The Adam(W) update of lists of fp32 tensors in place, in the JAX op
    order up to independent steps (the decay reads only ``p``, the moments
    only ``g``): the arithmetic of the kernel and of the per-tensor Adam
    alike."""
    adam_moments(g, m, v, hp)
    adam_apply(p, m, v, hp, decay)


def fused_adam_plain(master, m, v, g, segments, hp: AdamHyper, param=None, *,
                     denom=None, gnorm=None, max_norm: float = 0.0,
                     sr_key: Optional[Tuple[int, int]] = None, buffer_id: int = 0) -> None:
    """The Adam kernel's function on one group's flat buffers in place:
    skipped when ``gnorm`` is non-finite; ``g / denom * coef``; the update
    of :func:`adam_elementwise` on the segments that ``segments`` ((start,
    size, decay) triples) mark; the copy-back into ``param`` (nearest-even,
    or stochastic from ``sr_key`` = (k0, k1) for bf16)."""
    coef = None
    if gnorm is not None:
        if not bool(torch.isfinite(gnorm)):
            return
        if max_norm > 0:
            coef = clip_coef(gnorm, max_norm)
    if denom is not None:
        g = g / denom
    if coef is not None:
        g = g * coef
    adam_moments([g], [m], [v], hp)
    if hp.weight_decay != 0.0:
        for start, size, d in segments:
            if d:
                master[start:start + size].mul_(hp.decay_factor)
    adam_apply([master], [m], [v], hp._replace(weight_decay=0.0), [False])
    if param is not None:
        if sr_key is not None and param.dtype == torch.bfloat16:
            noise = sr_noise_plain(master.numel(), sr_key[0], sr_key[1], buffer_id,
                                   master.device)
            param.copy_(fp32_to_bf16_sr_bits(master, noise))
        else:
            param.copy_(master)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _require(name, tensors, align=16):
    _kernels.require_cuda(name, *tensors)
    for t in tensors:
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name}: buffers must be {align}-byte aligned")


def multi_tensor_l2norm(bufs: Sequence[torch.Tensor],
                        denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The global L2 norm of fp32 flat buffers, each element divided by
    the 0-d ``denom``; a 0-d fp32 tensor on their device.  K-a on the card
    (stage 1 per buffer, then one stage 2), the plain version on the CPU."""
    bufs = list(bufs)
    if not bufs or any(b.dtype != torch.float32 or b.dim() != 1 for b in bufs):
        raise ValueError("multi_tensor_l2norm: expected 1-d fp32 buffers")
    if bufs[0].device.type == "cpu":
        return multi_tensor_l2norm_plain(bufs, denom)
    name = "multi_tensor_l2norm"
    _require(name, bufs + [denom])
    if denom is not None and (denom.dtype != torch.float32 or denom.numel() != 1):
        raise ValueError(f"{name}: denom must be one fp32 value")
    import ctypes

    lib = _kernels.library()
    dev = bufs[0].device
    n_part = sum(lib.unicore_l2norm_blocks(b.numel()) for b in bufs)
    partial = torch.empty(n_part, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs])
    sizes = (ctypes.c_longlong * len(bufs))(*[b.numel() for b in bufs])
    rc = lib.unicore_multi_tensor_l2norm(
        ptrs, sizes, len(bufs), _kernels.ptr(denom), partial.data_ptr(), out.data_ptr(),
        _kernels.stream_handle(dev))
    _kernels.check(rc, name)
    for _ in bufs:
        NORM_LAUNCHES.add()
    return out


def fused_adam(master, m, v, g, chunks: torch.Tensor, hp: AdamHyper, param=None, *,
               denom=None, gnorm=None, max_norm: float = 0.0,
               sr_key: Optional[Tuple[int, int]] = None, buffer_id: int = 0) -> None:
    """K-b on one group's flat buffers in place (``chunks``: the group's
    :meth:`FlatGroup.chunk_table` on the card).  Only the card: the plain
    version takes the segments (:func:`fused_adam_plain`)."""
    name = "fused_adam"
    tensors = [master, m, v, g]
    if any(t.dtype != torch.float32 or t.dim() != 1 or t.numel() != master.numel()
           for t in tensors):
        raise ValueError(f"{name}: master, m, v, g must be 1-d fp32 of one length")
    if param is not None and (param.dtype not in _DTYPES or param.numel() != master.numel()):
        raise ValueError(f"{name}: param must be fp32, bf16 or fp16 of the master's length")
    sr = sr_key is not None and param is not None and param.dtype == torch.bfloat16
    _require(name, tensors + [chunks, denom, gnorm])
    _require(name, [param], align=8)
    if chunks.dtype != torch.int64 or chunks.dim() != 2 or chunks.shape[1] != 2:
        raise ValueError(f"{name}: chunks must be an (n, 2) int64 table")
    k0, k1 = sr_key if sr else (0, 0)
    rc = _kernels.library().unicore_fused_adam(
        master.data_ptr(), _kernels.ptr(param), _DTYPES[param.dtype] if param is not None else 0,
        m.data_ptr(), v.data_ptr(), g.data_ptr(), chunks.data_ptr(), chunks.shape[0],
        _kernels.ptr(denom), _kernels.ptr(gnorm), hp.beta1, hp.beta2, hp.omb1, hp.omb2, hp.eps,
        hp.step_size, hp.decay_factor, int(hp.weight_decay != 0.0), float(max_norm), CLIP_EPS,
        int(sr), k0 & _U32, k1 & _U32, buffer_id, _kernels.stream_handle(master.device))
    _kernels.check(rc, name)
    ADAM_LAUNCHES.add()


def adam_group(master, m, v, g, group: FlatGroup, hp: AdamHyper, param=None, **kw) -> None:
    """One group's update: the kernel on the card, the plain version on
    the CPU."""
    if master.device.type == "cpu":
        fused_adam_plain(master, m, v, g, [(s.start, s.size, s.decay) for s in group.segments],
                         hp, param, **kw)
    else:
        fused_adam(master, m, v, g, group.chunk_table(master.device), hp, param, **kw)
