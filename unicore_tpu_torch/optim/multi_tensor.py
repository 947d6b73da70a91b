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
  same bits every run.  Stage 1 writes one sum of squares per span of
  :data:`NORM_SPAN` elements, so its sum-of-squares mode
  (:func:`l2norm_partials`) on the segments of a buffer cut at multiples of
  the span, then stage 2 alone (:func:`l2norm_final`) on the partials
  gathered in order, is the whole buffer's norm bit for bit;
- :func:`fused_adam` (K-b): one pass per group -- the clip coefficient
  from K-a's norm (read on the device), decoupled decay per segment, the
  moments, the update and the copy-back into a bf16/fp16 parameter
  (nearest-even, or stochastic under ``--bf16-sr`` with in-kernel Philox
  noise).  A non-finite norm leaves every buffer as it was.  It runs on a
  whole group or on one data-parallel rank's segment of it (``offset``:
  the segment's first element, from which the SR noise counts).

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

Under ``--zero-stage`` >= 1 (``parallel/zero.py``) each group's buffers
are zero-padded to :attr:`FlatGroup.padded`, a multiple of the world size
times :data:`NORM_SPAN`, and rank r owns the contiguous segment ``[r S,
(r + 1) S)``: K-b runs on it with the clipped, rebased chunk table
(:meth:`FlatGroup.chunk_table`), and at stage 2 K-a's sum-of-squares mode
runs on the reduce-scattered gradient segment.  The padding is zeros in
every buffer, lies in no chunk and adds nothing to a norm.
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
#: elements of one stage-1 partial of the L2 norm kernel (its kNormSpan)
NORM_SPAN = 8192
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
    """One dtype group: its segments in parameter order, the length they
    span (``numel``, the last segment's end rounded up to ALIGN) and the
    length of its buffers (``padded``: ``numel`` rounded up to the ZeRO
    layout's multiple, else ``numel``)."""

    def __init__(self, dtype: torch.dtype, segments: Sequence[Segment], numel: int,
                 padded: Optional[int] = None):
        self.dtype = dtype
        self.segments = tuple(segments)
        self.numel = numel
        self.padded = numel if padded is None else padded
        self._chunks: Dict[tuple, torch.Tensor] = {}

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each segment of ``buf`` as a view shaped like its parameter."""
        return {s.name: buf[s.start:s.start + s.size].view(s.shape) for s in self.segments}

    def flatten(self, tensors, dtype=None) -> torch.Tensor:
        """A new buffer holding ``tensors`` (name -> tensor) at their
        segments, zeros between them."""
        first = tensors[self.segments[0].name]
        buf = torch.zeros(self.padded, dtype=dtype or first.dtype, device=first.device)
        for s in self.segments:
            buf[s.start:s.start + s.size].copy_(tensors[s.name].reshape(-1))
        return buf

    def clipped(self, start: int, size: int):
        """The (start, size, decay) segments that lie in ``[start, start +
        size)`` (one rank's segment under ZeRO, or the whole buffer), cut to
        it and counted from ``start``."""
        end = start + size
        out = []
        for s in self.segments:
            a, b = max(s.start, start), min(s.start + s.size, end)
            if a < b:
                out.append((a - start, b - a, s.decay))
        return out

    def chunk_table(self, device, start: int, size: int) -> torch.Tensor:
        """The Adam kernel's (n_chunks, 2) int64 table on ``device`` for the
        segment ``[start, start + size)`` of the buffer: each chunk's first
        element (counted from ``start``) and its length * 2 + its decay
        flag."""
        key = (torch.device(device), start, size)
        if key not in self._chunks:
            self._chunks[key] = chunk_table(self.clipped(start, size), device)
        return self._chunks[key]


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
              decay: Optional[Dict[str, bool]] = None, pad: int = 1) -> "FlatPlan":
        """The plan of ``named``; each group's buffers padded with zeros to a
        multiple of ``pad`` (the ZeRO layout's world size times
        NORM_SPAN)."""
        by_dtype: Dict[torch.dtype, List[Segment]] = {}
        ends: Dict[torch.dtype, int] = {}
        for name, t in named.items():
            start = ends.get(t.dtype, 0)
            seg = Segment(name, start, t.numel(), tuple(t.shape),
                          bool(decay[name]) if decay else False)
            by_dtype.setdefault(t.dtype, []).append(seg)
            ends[t.dtype] = -(-(start + t.numel()) // ALIGN) * ALIGN
        groups = [FlatGroup(dt, segs, ends[dt], -(-ends[dt] // pad) * pad)
                  for dt, segs in by_dtype.items()]
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


def l2norm_partials_plain(bufs: Sequence[torch.Tensor],
                          denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K-a's stage 1: for each buffer in turn, the sum of (x / denom)^2 over
    each span of NORM_SPAN elements (the last one short), fp32, 1-d.  (A sum
    of squares: torch's CPU ``vector_norm`` loses 1e-4 relative over a few
    million elements, its pairwise ``sum`` does not.)"""
    parts = []
    for b in bufs:
        x = b if denom is None else b / denom
        rows = max(1, -(-x.numel() // NORM_SPAN))
        x = pad_to(x, rows * NORM_SPAN) if x.numel() else x.new_zeros(NORM_SPAN)
        parts.append(x.view(rows, NORM_SPAN).square().sum(1))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def l2norm_final_plain(partials: torch.Tensor) -> torch.Tensor:
    """K-a's stage 2: sqrt of the sum of the partials, fp32, 0-d."""
    return torch.sqrt(partials.sum())


def multi_tensor_l2norm_plain(bufs: Sequence[torch.Tensor],
                              denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt(sum over the buffers of sum((x / denom)^2)), fp32, 0-d: the
    per-span partials, then their sum."""
    return l2norm_final_plain(l2norm_partials_plain(bufs, denom))


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


def sr_noise_plain(n: int, k0: int, k1: int, buffer_id: int, device=None,
                   offset: int = 0) -> torch.Tensor:
    """The Adam kernel's 16 noise bits of elements offset..offset+n-1 of a
    group (int32; ``offset`` a multiple of 4): word ``e % 4`` of
    Philox4x32-10 on the counter (e // 4 as two 32-bit words, buffer_id, 0)
    under the key (k0, k1), shifted right by 16."""
    if offset % ALIGN:
        raise ValueError(f"sr_noise_plain: offset {offset} is not a multiple of {ALIGN}")
    e4 = torch.arange(offset // 4, offset // 4 + -(-n // 4), dtype=torch.int64, device=device)
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
                     sr_key: Optional[Tuple[int, int]] = None, buffer_id: int = 0,
                     offset: int = 0) -> None:
    """The Adam kernel's function on one group's flat buffers, or on the
    segment of them that starts at element ``offset``, in place: skipped
    when ``gnorm`` is non-finite; ``g / denom * coef``; the update of
    :func:`adam_elementwise` on the segments that ``segments`` ((start,
    size, decay) triples, counted from ``offset``) mark; the copy-back into
    ``param`` (nearest-even, or stochastic from ``sr_key`` = (k0, k1) for
    bf16, the noise of the group's elements from ``offset`` on)."""
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
                                   master.device, offset)
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


def norm_partials(n: int) -> int:
    """K-a's stage-1 partials of a buffer of ``n`` elements."""
    return max(1, -(-n // NORM_SPAN))


def _l2norm_launch(bufs, denom, final: bool):
    """K-a on the card: stage 1 per buffer into the partials, then (with
    ``final``) stage 2 into the norm; returns (partials, norm or None)."""
    name = "multi_tensor_l2norm"
    _require(name, bufs + [denom])
    if denom is not None and (denom.dtype != torch.float32 or denom.numel() != 1):
        raise ValueError(f"{name}: denom must be one fp32 value")
    import ctypes

    lib = _kernels.library()
    if lib.unicore_l2norm_span() != NORM_SPAN:
        raise RuntimeError(f"{name}: the library's span is {lib.unicore_l2norm_span()}, "
                           f"the wrapper's {NORM_SPAN}: a stale build")
    dev = bufs[0].device
    partial = torch.empty(sum(norm_partials(b.numel()) for b in bufs), dtype=torch.float32,
                          device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev) if final else None
    ptrs = (ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs])
    sizes = (ctypes.c_longlong * len(bufs))(*[b.numel() for b in bufs])
    rc = lib.unicore_multi_tensor_l2norm(
        ptrs, sizes, len(bufs), _kernels.ptr(denom), partial.data_ptr(), _kernels.ptr(out),
        _kernels.stream_handle(dev))
    _kernels.check(rc, name)
    for _ in bufs:
        NORM_LAUNCHES.add()
    return partial, out


def _norm_bufs(bufs):
    bufs = list(bufs)
    if not bufs or any(b.dtype != torch.float32 or b.dim() != 1 for b in bufs):
        raise ValueError("multi_tensor_l2norm: expected 1-d fp32 buffers")
    return bufs


def multi_tensor_l2norm(bufs: Sequence[torch.Tensor],
                        denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The global L2 norm of fp32 flat buffers, each element divided by
    the 0-d ``denom``; a 0-d fp32 tensor on their device.  K-a on the card
    (stage 1 per buffer, then one stage 2), the plain version on the CPU."""
    bufs = _norm_bufs(bufs)
    if bufs[0].device.type == "cpu":
        return multi_tensor_l2norm_plain(bufs, denom)
    return _l2norm_launch(bufs, denom, final=True)[1]


def l2norm_partials(bufs: Sequence[torch.Tensor],
                    denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K-a's sum-of-squares mode: stage 1 alone, the buffers' per-span sums
    of (x / denom)^2 in order (:func:`norm_partials` each), fp32 1-d on
    their device.  The kernel on the card, the plain version on the CPU."""
    bufs = _norm_bufs(bufs)
    if bufs[0].device.type == "cpu":
        return l2norm_partials_plain(bufs, denom)
    return _l2norm_launch(bufs, denom, final=False)[0]


def l2norm_final(partials: torch.Tensor) -> torch.Tensor:
    """K-a's stage 2 alone: sqrt of the sum of ``partials`` (fp32 1-d, in
    the order stage 1 wrote them) in the kernel's order, a 0-d fp32 tensor.
    The kernel on the card, the plain version on the CPU."""
    if partials.dtype != torch.float32 or partials.dim() != 1 or not partials.numel():
        raise ValueError("l2norm_final: expected a 1-d fp32 tensor of partials")
    if partials.device.type == "cpu":
        return l2norm_final_plain(partials)
    name = "multi_tensor_l2norm"
    _require(name, [partials])
    out = torch.empty((), dtype=torch.float32, device=partials.device)
    rc = _kernels.library().unicore_l2norm_final(
        partials.data_ptr(), partials.numel(), out.data_ptr(),
        _kernels.stream_handle(partials.device))
    _kernels.check(rc, name)
    return out


def fused_adam(master, m, v, g, chunks: torch.Tensor, hp: AdamHyper, param=None, *,
               denom=None, gnorm=None, max_norm: float = 0.0,
               sr_key: Optional[Tuple[int, int]] = None, buffer_id: int = 0,
               offset: int = 0) -> None:
    """K-b on one group's flat buffers, or their segment from element
    ``offset`` on, in place (``chunks``: the group's
    :meth:`FlatGroup.chunk_table` on the card, for that segment).  Only the
    card: the plain version takes the segments (:func:`fused_adam_plain`)."""
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
    if offset < 0 or offset % ALIGN:
        raise ValueError(f"{name}: offset {offset} is not a multiple of {ALIGN}")
    k0, k1 = sr_key if sr else (0, 0)
    rc = _kernels.library().unicore_fused_adam(
        master.data_ptr(), _kernels.ptr(param), _DTYPES[param.dtype] if param is not None else 0,
        m.data_ptr(), v.data_ptr(), g.data_ptr(), chunks.data_ptr(), chunks.shape[0],
        _kernels.ptr(denom), _kernels.ptr(gnorm), hp.beta1, hp.beta2, hp.omb1, hp.omb2, hp.eps,
        hp.step_size, hp.decay_factor, int(hp.weight_decay != 0.0), float(max_norm), CLIP_EPS,
        int(sr), k0 & _U32, k1 & _U32, buffer_id, offset, _kernels.stream_handle(master.device))
    _kernels.check(rc, name)
    ADAM_LAUNCHES.add()


def adam_group(master, m, v, g, group: FlatGroup, hp: AdamHyper, param=None,
               offset: int = 0, **kw) -> None:
    """One group's update, or of its segment of ``master.numel()`` elements
    from ``offset`` on (one ZeRO rank's): the kernel on the card, the plain
    version on the CPU."""
    size = master.numel()
    if master.device.type == "cpu":
        fused_adam_plain(master, m, v, g, group.clipped(offset, size), hp, param,
                         offset=offset, **kw)
    else:
        fused_adam(master, m, v, g, group.chunk_table(master.device, offset, size), hp, param,
                   offset=offset, **kw)
