"""Step-level continuous batching: the incremental-decode scheduler
(counterpart of ``unicore_tpu/serve/decode.py``).

The admit -> batch -> dispatch loop of ``serve/engine.py`` generalised to
autoregressive generation:

* **prefill/decode split**: prompts run through their own bucketed
  dispatch (one prompt bucket per cache bucket), so a long-prompt dispatch
  never stalls the decode batch behind it;
* **step-level re-entry**: a sequence re-enters the scheduler's ready list
  after EVERY decode step, and batches re-form per step with bucket = the
  CACHE-LENGTH bucket; a finished sequence frees its batch slot (and its
  cache pages) mid-generation instead of holding the batch until its
  longest neighbour finishes;
* **paged cache accounting**: pages come from :class:`PagedKVCache`'s free
  list; a sequence grows page by page, and page exhaustion preempts the
  YOUNGEST decoding sequence (least sunk cost: its pages free, and it
  re-queues for a re-prefill over prompt + generated-so-far); exhaustion at
  admission sheds ``cache-oom`` at the door instead.

Every dispatch runs eagerly under ``torch.inference_mode()`` entered in the
thread that calls it (the loop thread in service).  Eager PyTorch compiles
nothing per shape, so the JAX engine's recompile-after-warm-up watchdog has
no counterpart.  Every blocking wait is deadline-bounded; deadlines are
enforced at admission, before every decode step, and at response; drain,
readiness and hot reload are the base engine's.  A hot swap applies between
steps: sequences in flight keep their pages (their cached rows came from
the old weights, as in the JAX engine).  Every ``decode_sample_every``-th
step is journalled (``decode-step``), as is each ``cache-oom`` shed
(``serve-shed``).

Dtypes, as the JAX engine's programs: a bf16 (or fp16) model runs its
prefill and step in its own type; the pool stays fp32 (or int8), and the
prefill's K/V and each step's rows are cast into it; the next token is the
argmax of the logits and the score their max in fp32.
"""

import logging
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.checkpoint.emergency import Deadline
from unicore_tpu_torch.distributed import chaos
from unicore_tpu_torch.serve import request as rq
from unicore_tpu_torch.serve.admission import AdmissionQueue
from unicore_tpu_torch.serve.engine import (
    _LATENCY_WINDOW,
    PHASE_DRAINING,
    PHASE_SERVING,
    PHASE_WARMING,
    ServeEngine,
    _report_drain,
    probe_batch,
)
from unicore_tpu_torch.serve.kv_cache import (
    DEFAULT_PAGE_SIZE,
    PagedKVCache,
    bucket_for,
    calibrate_kv_scales,
    gather_pages,
    quantize_kv,
    scatter_prefill,
    scatter_rows,
)
from unicore_tpu_torch.utils import retry

logger = logging.getLogger(__name__)


class DecodeSequence:
    """One in-flight generation: its request, page ownership and decode
    cursor.  ``pending`` is the chosen-but-not-yet-cached token; its row is
    ``next_pos`` (= prompt_len + generated - 1)."""

    __slots__ = ("req", "prompt", "out", "pages", "pending", "next_pos",
                 "bucket", "max_new", "score_sum", "steps", "seq_no")

    def __init__(self, req, prompt, pages, pending, next_pos, bucket,
                 max_new, seq_no):
        self.req = req
        self.prompt = np.asarray(prompt, np.int32)
        self.out: List[int] = []
        self.pages: List[int] = list(pages)
        self.pending = int(pending)
        self.next_pos = int(next_pos)
        self.bucket = int(bucket)
        self.max_new = int(max_new)
        self.score_sum = 0.0
        self.steps = 0
        self.seq_no = int(seq_no)

    def written_stream(self) -> np.ndarray:
        """The tokens whose K/V rows are IN the cache (prompt + every
        processed generated token; ``pending`` is not cached): what a
        re-prefill replays after preemption."""
        if not self.out:
            return self.prompt
        return np.concatenate([self.prompt, np.asarray(self.out, np.int32)])


class DecodeEngine(ServeEngine):
    """Autoregressive serving engine: the outward surface of
    :class:`ServeEngine` (ready/phase/submit/drain/stats), a prefill + decode
    step loop inside.  ``model`` is a ``transformer_lm`` on its device, in
    eval mode."""

    #: the HTTP layer routes POST /v1/generate only to engines that
    #: declare generation support
    supports_generate = True

    def __init__(
        self,
        model,
        *,
        bucket_edges: Sequence[int],
        decode_batch: int = 8,
        prefill_batch: Optional[int] = None,
        pad_idx: int = 0,
        eos_idx: int = 2,
        vocab_size: int = 32,
        num_pages: int = 256,
        page_size: int = DEFAULT_PAGE_SIZE,
        kv_dtype: str = "fp32",
        max_new_tokens: int = 32,
        admission_capacity: int = 256,
        precision: str = "",
        decode_sample_every: int = 64,
        device: str = "",
        swap_hook=None,
    ):
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype must be 'fp32' or 'int8', got {kv_dtype!r}")
        edges = tuple(sorted(int(e) for e in bucket_edges))
        if any(e % page_size for e in edges):
            raise ValueError(
                f"every cache bucket edge must be a page multiple "
                f"(page_size {page_size}), got {edges}"
            )
        prefill_batch = int(prefill_batch or decode_batch)
        queue = AdmissionQueue(
            admission_capacity,
            batch_capacity=prefill_batch,
            max_len=edges[-1],
            bucket_edges=edges,
            precision=precision,
        )
        super().__init__(
            model,
            None,  # the decode dispatches own the forwards
            bucket_edges=edges,
            batch_size=decode_batch,
            pad_idx=pad_idx,
            vocab_size=vocab_size,
            queue=queue,
            precision=precision,
            device=device,
            swap_hook=swap_hook,
        )
        #: where the model's weights, the pools and every dispatch live
        self.torch_device = next(model.parameters()).device
        self.prefill_batch = prefill_batch
        self.eos_idx = int(eos_idx)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.kv_dtype = torch.int8 if kv_dtype == "int8" else torch.float32
        #: the pools' type as /stats names it (the JAX package's names)
        self.kv_dtype_name = "int8" if kv_dtype == "int8" else "float32"
        self.max_new_tokens = int(max_new_tokens)
        self.cache: Optional[PagedKVCache] = None
        self._kv_scales = None  # (k_scale, v_scale), int8 only
        self._decode_ready: deque = deque()
        self._preempted: deque = deque()
        self._seq_counter = 0
        self._active = 0
        # decode-plane counters (all surfaced in /stats)
        self.tokens_generated = 0
        self.preempted_seqs = 0
        self.requeued_steps = 0
        self.prefill_batches = 0
        self.decode_steps = 0
        self._token_ms: List[float] = []
        self._decode_sample_every = max(0, int(decode_sample_every))
        self._serving_since: Optional[float] = None

    # -- warm-up ---------------------------------------------------------

    def warmup(self) -> int:
        """Build the pools (after the int8 calibration prefill), then run a
        prefill and a decode dispatch of every bucket twice (the kernels
        build and load on the first; the second seeds the admission
        queue's service estimate) and the probe forward.  Returns the
        number of (prefill, decode) shapes warmed."""
        if not self.set_ready(False, PHASE_WARMING):
            return 0
        t0 = time.monotonic()
        m = self.model
        n_layers, n_heads = m.decoder_layers, m.decoder_attention_heads
        head_dim = m.decoder_embed_dim // n_heads
        with torch.inference_mode():
            if self.kv_dtype == torch.int8:
                # one calibration prefill over a deterministic token sweep
                # fixes the per-(layer, head, channel) scales for the
                # engine's lifetime
                edge = self.bucket_edges[-1]
                ids = (np.arange(self.prefill_batch * edge, dtype=np.int64)
                       % max(2, self.vocab_size)).reshape(self.prefill_batch, edge)
                _, (k, v) = m.prefill(torch.as_tensor(ids, device=self.torch_device))
                self._kv_scales = calibrate_kv_scales(k, v)
                del k, v
                logger.info(
                    "KV-CACHE int8: calibrated per-(layer, head, channel) "
                    f"scales from one {self.prefill_batch}x{edge} prefill"
                )
            self.cache = PagedKVCache(
                self.num_pages, n_layers, n_heads, head_dim,
                page_size=self.page_size, dtype=self.kv_dtype,
                kv_scales=self._kv_scales, device=self.torch_device,
            )
        sentinel = self.cache.sentinel
        for edge in self.bucket_edges:
            tokens = np.full((self.prefill_batch, edge), self.pad_idx, np.int32)
            lengths = np.ones((self.prefill_batch,), np.int32)
            pages = np.full((self.prefill_batch, edge), sentinel, np.int32)
            slots = np.tile(np.arange(edge, dtype=np.int32) % self.page_size,
                            (self.prefill_batch, 1))
            self._dispatch_prefill_arrays(tokens, lengths, pages, slots)
            tb0 = time.monotonic()
            self._dispatch_prefill_arrays(tokens, lengths, pages, slots)
            self.queue.note_batch_service(time.monotonic() - tb0, bucket=edge)
            dtoks = np.zeros((self.batch_size,), np.int32)
            dpos = np.zeros((self.batch_size,), np.int32)
            table = np.full((self.batch_size, edge // self.page_size), sentinel, np.int32)
            self._dispatch_decode_arrays(dtoks, dpos, table)
            self._dispatch_decode_arrays(dtoks, dpos, table)
        # the reload probe's forward warms too
        self.probe(self.model)
        shapes = 2 * len(self.bucket_edges)
        logger.info(
            f"decode warm-up complete: {shapes} shape(s) (prefill+decode) for "
            f"{len(self.bucket_edges)} cache bucket(s) {list(self.bucket_edges)} "
            f"x decode batch {self.batch_size} (kv {self.kv_dtype_name}, "
            f"{self.num_pages} pages x {self.page_size} rows) in "
            f"{time.monotonic() - t0:.1f}s; readiness -> true"
        )
        if self.set_ready(True, PHASE_SERVING):
            self.queue.set_accepting(True)
            self._serving_since = time.monotonic()
        return shapes

    def _dispatch_prefill_arrays(self, tokens, lengths, pages, slots):
        """One prefill over ``tokens`` (B, Lp): the greedy next token and
        its logit at each row's last real position, and the prompt's K/V
        scattered into the pools (sentinel pages drop)."""
        dev = self.torch_device
        with torch.inference_mode():
            logits, (k, v) = self.model.prefill(
                torch.as_tensor(tokens, dtype=torch.long, device=dev))
            last = torch.as_tensor(np.asarray(lengths, np.int64) - 1, device=dev)
            row = logits[torch.arange(logits.shape[0], device=dev), last]
            nxt = row.argmax(dim=-1).to(torch.int32)
            score = row.float().amax(dim=-1)
            if self._kv_scales is not None:
                k = quantize_kv(k, self._kv_scales[0])
                v = quantize_kv(v, self._kv_scales[1])
            scatter_prefill(self.cache.k_pool, pages, slots, k)
            scatter_prefill(self.cache.v_pool, pages, slots, v)
            return nxt.cpu().numpy(), score.cpu().numpy()

    def _dispatch_decode_arrays(self, tokens, positions, table):
        """One decode step: gather the batch's pages into (n_layers, B, H,
        L, D) caches, run the model's ``decode_step``, scatter the new rows
        back (the page and slot of each row computed on the host, so the
        scatter needs no device sync) and return the greedy next tokens
        and their logits."""
        dev = self.torch_device
        positions = np.asarray(positions, np.int32)
        table = np.asarray(table, np.int32)
        with torch.inference_mode():
            caches = (gather_pages(self.cache.k_pool, table),
                      gather_pages(self.cache.v_pool, table))
            logits, (k_rows, v_rows) = self.model.decode_step(
                torch.as_tensor(tokens, dtype=torch.long, device=dev), caches,
                torch.as_tensor(positions, device=dev), kv_scales=self._kv_scales,
            )
            nxt = logits.argmax(dim=-1).to(torch.int32)
            score = logits.float().amax(dim=-1)
            pages = table[np.arange(len(positions)), positions // self.page_size]
            slots = positions % self.page_size
            scatter_rows(self.cache.k_pool, pages, slots, k_rows)
            scatter_rows(self.cache.v_pool, pages, slots, v_rows)
            return nxt.cpu().numpy(), score.cpu().numpy()

    # -- probe -----------------------------------------------------------

    def _probe_forward(self, model) -> None:
        """Full-forward canary of ``model`` (the served one at warm-up, a
        reload candidate after) on the smallest bucket's
        :func:`~unicore_tpu_torch.serve.engine.probe_batch`: shape and
        finite scores, never touching the pools."""
        edge = self.bucket_edges[0]
        with torch.inference_mode():
            dummy = torch.as_tensor(probe_batch(self.prefill_batch, edge, self.pad_idx),
                                    dtype=torch.long, device=self.torch_device)
            logits = model(dummy)
            ids = logits.argmax(dim=-1)
            score = logits.float().amax(dim=-1).mean(dim=-1)
        if tuple(ids.shape) != (self.prefill_batch, edge):
            raise ValueError(
                f"probe batch produced shape {tuple(ids.shape)}, expected "
                f"{(self.prefill_batch, edge)}"
            )
        if not bool(torch.isfinite(score).all()):
            raise ValueError("probe batch produced non-finite scores (poisoned weights?)")

    # -- submission ------------------------------------------------------

    def submit(self, tokens, deadline_s: float,
               request_id: Optional[str] = None,
               max_new_tokens: Optional[int] = None) -> rq.ServeRequest:
        req = self.make_request(tokens, deadline_s, request_id)
        # the generation budget rides the request (POST /v1/generate); the
        # engine clamps it to its own ceiling
        req.max_new_tokens = min(
            self.max_new_tokens,
            int(max_new_tokens) if max_new_tokens else self.max_new_tokens,
        )
        self.queue.admit(req)
        return req

    # -- the step loop ---------------------------------------------------

    def step(self, timeout: float = 0.05) -> int:
        """One scheduler iteration, decode-first: dispatch one decode step
        batch if any sequence is ready, otherwise one prefill batch
        (preempted sequences first, then admission).  Returns the number of
        sequences FINISHED this iteration."""
        chaos.note_serve_batch(self._batch_seq)
        batch = self._take_decode_batch()
        if batch is not None:
            return self._run_decode_step(*batch)
        return self._run_prefill(timeout)

    # ... decode side ....................................................

    def _expire_seq(self, seq: DecodeSequence) -> None:
        self.queue.note_terminal_reason(rq.EXPIRED_IN_QUEUE)
        seq.req.expire(rq.EXPIRED_IN_QUEUE)
        self._release(seq)

    def _release(self, seq: DecodeSequence) -> None:
        if seq.pages:
            self.cache.free(seq.pages)
            seq.pages = []
        self._active -= 1

    def _shed_oom(self, req) -> None:
        self.queue.note_terminal_reason(rq.SHED_CACHE_OOM)
        req.shed(rq.SHED_CACHE_OOM)
        logger.warning(
            f"SHED request {req.request_id}: {rq.SHED_CACHE_OOM} (page "
            f"occupancy {self.cache.occupancy():.4f})"
        )
        telemetry.emit(
            "serve-shed", reason=rq.SHED_CACHE_OOM,
            request_id=req.request_id,
            occupancy=round(self.cache.occupancy(), 4),
        )

    def _preempt_youngest(self, exclude) -> bool:
        """Free the youngest ready sequence's pages and park it for
        re-prefill; False when nothing outside ``exclude`` can yield."""
        victim = None
        for s in self._decode_ready:
            if s in exclude:
                continue
            if victim is None or s.seq_no > victim.seq_no:
                victim = s
        if victim is None:
            return False
        self._decode_ready.remove(victim)
        self.cache.free(victim.pages)
        victim.pages = []
        self._preempted.append(victim)
        self.preempted_seqs += 1
        logger.warning(
            f"PREEMPT {victim.req.request_id}: cache pages exhausted — "
            f"youngest sequence yields {victim.next_pos} cached row(s) "
            f"and re-queues for re-prefill "
            f"(occupancy {self.cache.occupancy():.2f})"
        )
        return True

    def _grow(self, seq: DecodeSequence, picked) -> bool:
        """Ensure ``seq`` owns pages covering its next row, preempting the
        youngest bystander on exhaustion.  False = seq must shed."""
        needed = self.cache.pages_for(seq.next_pos + 1)
        while len(seq.pages) < needed:
            got = self.cache.alloc(1)
            if got is None:
                if not self._preempt_youngest(exclude=picked):
                    return False
                continue
            seq.pages.extend(got)
        return True

    def _take_decode_batch(self):
        """FIFO bucket-affine batch off the ready list (the admission
        queue's formation rule, re-applied per STEP so batches re-form as
        sequences finish or change cache bucket)."""
        ready = self._decode_ready
        picked: List[DecodeSequence] = []
        bucket = 0
        while ready:
            seq = ready.popleft()
            if seq.req.deadline.exceeded():
                self._expire_seq(seq)
                continue
            picked.append(seq)
            bucket = seq.bucket
            break
        if not picked:
            return None
        keep: List[DecodeSequence] = []
        while ready and len(picked) < self.batch_size:
            seq = ready.popleft()
            if seq.req.deadline.exceeded():
                self._expire_seq(seq)
                continue
            if seq.bucket == bucket:
                picked.append(seq)
            else:
                keep.append(seq)
        for s in reversed(keep):
            ready.appendleft(s)
        # page growth AFTER formation: preemption must never evict a
        # sequence picked for this very step
        live: List[DecodeSequence] = []
        for s in picked:
            if self._grow(s, picked):
                live.append(s)
            else:
                self._shed_oom(s.req)
                self._release(s)
        if not live:
            return None
        return live, bucket

    def _run_decode_step(self, seqs: List[DecodeSequence], bucket: int) -> int:
        width = bucket // self.page_size
        tokens = np.zeros((self.batch_size,), np.int32)
        positions = np.zeros((self.batch_size,), np.int32)
        table = np.full((self.batch_size, width), self.cache.sentinel, np.int32)
        for i, s in enumerate(seqs):
            tokens[i] = s.pending
            positions[i] = s.next_pos
            table[i, : len(s.pages)] = s.pages
        t0 = time.monotonic()
        nxt, score = self._dispatch_decode_arrays(tokens, positions, table)
        step_ms = (time.monotonic() - t0) * 1000.0
        self._batch_seq += 1
        self.decode_steps += 1
        served = 0
        with self._lock:
            self._token_ms.extend([step_ms] * len(seqs))
            if len(self._token_ms) > _LATENCY_WINDOW:
                del self._token_ms[: _LATENCY_WINDOW // 4]
        for i, s in enumerate(seqs):
            tok = int(nxt[i])
            s.out.append(s.pending)  # the processed token is now cached
            s.score_sum += float(score[i])
            s.steps += 1
            self.tokens_generated += 1
            done = (
                tok == self.eos_idx
                or len(s.out) >= s.max_new
                or s.next_pos + 2 > self.bucket_edges[-1]
            )
            if done:
                self._finish(s, final=tok)
                served += 1
            else:
                s.pending = tok
                s.next_pos += 1
                s.bucket = bucket_for(s.next_pos + 1, self.bucket_edges)
                self._decode_ready.append(s)
                self.requeued_steps += 1
        self._maybe_journal_step(bucket, len(seqs), step_ms)
        return served

    def _finish(self, s: DecodeSequence, final: Optional[int]) -> None:
        out = list(s.out)
        if final is not None and final == self.eos_idx:
            out.append(final)
        latency_ms = (time.monotonic() - s.req.arrival) * 1000.0
        if s.req.deadline.exceeded():
            self.expired_at_response += 1
            self.queue.note_terminal_reason(rq.EXPIRED_AT_RESPONSE)
            s.req.expire(rq.EXPIRED_AT_RESPONSE)
        else:
            s.req.respond(rq.ServeResponse(
                s.req.request_id,
                rq.STATUS_OK,
                output=[int(t) for t in out],
                score=(s.score_sum / max(1, s.steps)),
                latency_ms=latency_ms,
                bucket=s.bucket,
            ))
            self.served += 1
            with self._lock:
                self._latencies_ms.append(latency_ms)
                if len(self._latencies_ms) > _LATENCY_WINDOW:
                    del self._latencies_ms[: _LATENCY_WINDOW // 4]
        self._release(s)

    def _maybe_journal_step(self, bucket, live, step_ms) -> None:
        """Every ``decode_sample_every``-th step, a ``decode-step`` event."""
        if (self._decode_sample_every <= 0
                or self.decode_steps % self._decode_sample_every != 0):
            return
        telemetry.emit(
            "decode-step", step=int(self.decode_steps),
            bucket=int(bucket), live=int(live),
            service_ms=round(step_ms, 3),
            occupancy=round(self.cache.occupancy(), 4),
            tokens_generated=int(self.tokens_generated),
            preempted=int(self.preempted_seqs),
        )

    # ... prefill side ...................................................

    def _run_prefill(self, timeout: float) -> int:
        if self._preempted:
            return self._prefill_preempted()
        batch = self.queue.take_batch(
            self.bucket_edges, timeout, max_len=self.bucket_edges[-1]
        )
        if batch is None:
            return 0
        reqs, padded = batch
        try:
            admitted = []
            for r in reqs:
                pages = self.cache.alloc(self.cache.pages_for(len(r)))
                if pages is None:
                    self._shed_oom(r)
                    continue
                admitted.append((r, pages))
            if admitted:
                self._prefill_batch(
                    [(r, np.asarray(r.tokens, np.int32), pages, None)
                     for r, pages in admitted],
                    padded,
                )
        finally:
            self.queue.batch_done()
        return 0

    def _prefill_preempted(self) -> int:
        """Re-prefill preempted sequences (bucket-affine FIFO over their
        cached-stream lengths); they bypass admission, having been
        admitted once."""
        head = self._preempted.popleft()
        stream = head.written_stream()
        padded = bucket_for(len(stream), self.bucket_edges)
        group = [(head, stream)]
        keep = []
        while self._preempted and len(group) < self.prefill_batch:
            s = self._preempted.popleft()
            st = s.written_stream()
            if bucket_for(len(st), self.bucket_edges) == padded:
                group.append((s, st))
            else:
                keep.append(s)
        for s in reversed(keep):
            self._preempted.appendleft(s)
        entries = []
        for s, st in group:
            if s.req.deadline.exceeded():
                self._expire_seq(s)
                continue
            pages = self.cache.alloc(self.cache.pages_for(len(st)))
            if pages is None:
                # still no room even for the resumption: this sequence
                # loses (bounded memory beats livelock)
                self._shed_oom(s.req)
                self._release(s)
                continue
            s.pages = pages
            entries.append((s.req, st, pages, s))
        if entries:
            self._prefill_batch(entries, padded)
        return 0

    def _prefill_batch(self, entries, padded: int) -> None:
        """Dispatch one prefill: ``entries`` is a list of ``(req, stream,
        pages, seq-or-None)`` (seq set = resumption)."""
        B = self.prefill_batch
        tokens = np.full((B, padded), self.pad_idx, np.int32)
        lengths = np.ones((B,), np.int32)
        pages2d = np.full((B, padded), self.cache.sentinel, np.int32)
        slots2d = np.tile(np.arange(padded, dtype=np.int32) % self.page_size, (B, 1))
        for i, (req, stream, pages, _seq) in enumerate(entries):
            n = len(stream)
            tokens[i, :n] = stream
            lengths[i] = n
            pages2d[i, :n] = np.repeat(np.asarray(pages, np.int32), self.page_size)[:n]
        t0 = time.monotonic()
        nxt, score = self._dispatch_prefill_arrays(tokens, lengths, pages2d, slots2d)
        self.queue.note_batch_service(time.monotonic() - t0, bucket=padded)
        self._batch_seq += 1
        self.prefill_batches += 1
        for i, (req, stream, pages, seq) in enumerate(entries):
            if seq is not None:
                # resumption: the pending token was never lost; the
                # prefill's re-chosen head token is discarded (greedy decode
                # would reproduce it anyway)
                self._decode_ready.append(seq)
                self.requeued_steps += 1
                continue
            self._seq_counter += 1
            self._active += 1
            s = DecodeSequence(
                req, stream, pages,
                pending=int(nxt[i]),
                next_pos=len(stream),
                bucket=bucket_for(min(len(stream) + 1, self.bucket_edges[-1]),
                                  self.bucket_edges),
                max_new=req.max_new_tokens or self.max_new_tokens,
                seq_no=self._seq_counter,
            )
            s.score_sum += float(score[i])
            s.steps += 1
            self.tokens_generated += 1
            if (s.pending == self.eos_idx or s.max_new <= 1
                    or s.next_pos + 1 > self.bucket_edges[-1]):
                # degenerate one-token generation: finished at prefill
                s.out.append(s.pending)
                self._finish(s, final=None)
            else:
                self._decode_ready.append(s)

    # -- drain -----------------------------------------------------------

    def _idle(self) -> bool:
        return (self.queue.idle() and not self._decode_ready
                and not self._preempted and self._active == 0)

    def drain(self, deadline: Deadline) -> bool:
        """Like the base engine's drain, but 'flushed' also means every
        in-flight GENERATION ran to completion (the loop keeps stepping
        them while the queue refuses new work)."""
        self.queue.begin_drain()
        self.set_ready(False, PHASE_DRAINING)
        depth = self.queue.depth() + len(self._decode_ready) + len(self._preempted)
        logger.info(
            f"DRAIN started: {depth} queued/decoding sequence(s), budget "
            f"{deadline.budget if deadline.budget is not None else 'inf'}s"
        )
        try:
            retry.bounded_wait(
                self._idle,
                timeout=max(0.0, deadline.remaining()),
                poll_s=0.05,
                describe="decode serve drain",
            )
            drained = True
        except retry.WaitTimeoutError:
            drained = False
        self.stop()
        _report_drain(drained, deadline, depth, self._flush_undrained)
        return drained

    def _flush_undrained(self) -> int:
        n = super()._flush_undrained()
        for s in list(self._decode_ready) + list(self._preempted):
            s.req.shed(rq.SHED_DRAINING)
            self._release(s)
            n += 1
        self._decode_ready.clear()
        self._preempted.clear()
        return n

    # -- stats -----------------------------------------------------------

    def token_latency_percentiles(self) -> dict:
        """Per-token latency: each decode step's service time, once per
        sequence it advanced."""
        with self._lock:
            lat = list(self._token_ms)
        if not lat:
            return {}
        arr = np.asarray(lat)
        return {f"token_p{p}_ms": round(float(np.percentile(arr, p)), 3)
                for p in (50, 90, 99)}

    def stats(self) -> dict:
        base = super().stats()
        elapsed = (time.monotonic() - self._serving_since
                   if self._serving_since else 0.0)
        base.update({
            "mode": "decode",
            "kv_dtype": self.kv_dtype_name,
            "tokens_generated": self.tokens_generated,
            "tokens_per_s": round(self.tokens_generated / elapsed, 3) if elapsed > 0 else 0.0,
            "cache_page_occupancy": round(self.cache.occupancy(), 4) if self.cache else 0.0,
            "cache_pages_free": self.cache.free_pages if self.cache else 0,
            "active_sequences": self._active,
            "preempted": self.preempted_seqs,
            "requeued": self.requeued_steps,
            "prefill_batches": self.prefill_batches,
            "decode_steps": self.decode_steps,
            **self.token_latency_percentiles(),
        })
        return base
