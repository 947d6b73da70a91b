#!/usr/bin/env python3
"""``unicore-tpu-torch-serve``: the serving-plane entry point of the
PyTorch/CUDA port (counterpart of ``unicore_tpu_cli/serve.py``).

Boot sequence, each stage with the JAX server's failure exit code:

0. device: ``--device cuda`` (the default) needs a visible CUDA card; without
   one the server exits **76** naming the missing card — it never carries on
   on the CPU.  ``--device cpu`` is the explicit CPU run (the kernels' plain
   versions);
1. model load from ``--path`` (exit **76** on failure);
2. HTTP bind on ``--host:--port`` (exit **75** on failure) — probes go
   live immediately, readiness stays false;
3. bucket warm-up (the CUDA kernels build and load here); readiness flips
   true only after.  A checkpoint whose model has the decode surface
   (``prefill``/``decode_step``: ``transformer_lm``) is served by the
   incremental-decode engine (``POST /v1/generate``, paged KV cache,
   step-level continuous batching) unless ``--serve-decode off``;
   With ``--serve-quantize int8|fp8`` a calibration pass runs before the
   bind (:func:`setup_quantized_serving`): scales are calibrated, or a
   digest-verified ``<checkpoint>.quant-scales.json`` is reused; the model's
   quantized twin serves, and the grep-able ``QUANT-PATH`` line reports the
   scale source, site count and calibration drift.  A calibration failure,
   or the flag on a decode-plane checkpoint, exits **76**;
4. serve until signalled: SIGTERM/SIGINT drains — admission stops,
   in-flight batches flush under ``--drain-deadline``, exit **0**; a blown
   drain budget exits **77**; a second signal aborts (also 77).  The
   reload and flood planes stop before the drain.

``--reload-interval`` arms hot checkpoint reload (``serve/reload.py``:
verify, probe, swap on a batch boundary, or roll back); ``--fault-inject``
arms the serving chaos kinds (``request-flood``, ``slow-client``,
``corrupt-reload``, and on a fleet replica ``replica-loss`` /
``replica-stall``); the event journal goes to ``--telemetry-dir`` (default
``<dirname(--path)>/telemetry``), as ``events_rank<--replica-index>_serve.jsonl``,
and ``GET /metrics`` exposes the counters.

``--advertise`` joins a serving fleet (:func:`start_fleet_registration`):
the replica registers a heartbeat lease in ``--fleet-kv`` right after the
bind and before warm-up (ready false until warm-up ends), answers ``POST
/v1/reload`` on its own ``--path`` for the router's rolling reload,
publishes ready=false before a drain's flush, and deletes its lease (the
goodbye) on a clean exit or when the engine loop dies.  An unusable
``--fleet-kv`` or an ``--advertise`` address without host:port exits
**78**; a replica never serves unregistered.

Precision: a checkpoint is served in its own dtype, as the JAX server
applies the loaded tree as it is: the weights of a ``--bf16`` or ``--fp16``
run keep their type, and the eval forward, prefill and decode step run in
it (the log names the type); an fp32 checkpoint runs in fp32 with TF32 off
for matmuls and convolutions.  A hot-reload candidate serves in its own
dtype too.  Quantized serving (``--serve-quantize``) calibrates and serves
an fp32 model: a low-precision checkpoint's weights are upcast exactly for
it (the JAX server quantizes the dense sites of the tree as it is and runs
the rest in the tree's type; that difference is listed in ROADMAP.md).
"""

import logging
import os
import signal
import sys
import threading
import time

_LOG_FIELDS = ("asctime", "levelname", "name", "message")
logger = logging.getLogger("unicore_tpu_torch.cli.serve")

EXIT_OK = 0
EXIT_SERVE_BIND = 75            # HTTP bind/port failure at startup
EXIT_SERVE_MODEL_LOAD = 76      # device / model load / warm-up failure
EXIT_SERVE_DRAIN_DEADLINE = 77  # drain budget exceeded (or forced abort)
EXIT_SERVE_FLEET_KV = 78        # --advertise with an unusable --fleet-kv

SERVE_EXIT_CODE_NAMES = {
    EXIT_OK: "ok",
    EXIT_SERVE_BIND: "serve-bind-failure",
    EXIT_SERVE_MODEL_LOAD: "serve-model-load-failure",
    EXIT_SERVE_DRAIN_DEADLINE: "serve-drain-deadline-exceeded",
    EXIT_SERVE_FLEET_KV: "fleet-kv-failure",
}

# signal plumbing: first signal requests a drain, the second aborts
_drain_requested = threading.Event()
_signal_count = 0


def _handle_signal(signum, frame):
    global _signal_count
    _signal_count += 1
    name = signal.Signals(signum).name
    if _signal_count == 1:
        logger.warning(
            f"received {name}: graceful drain — admission stops, in-flight "
            "batches flush under --drain-deadline (second signal aborts)"
        )
        _drain_requested.set()
    else:
        logger.error(f"received second {name}: aborting without drain")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_SERVE_DRAIN_DEADLINE)


def resolve_device(name: str):
    """The torch device for ``--device``; raises RuntimeError naming the
    missing card when ``cuda`` is asked for and none is visible."""
    import torch

    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA card is visible to this process "
                "(torch.cuda.is_available() is false); serve on the CPU "
                "only by asking for it with --device cpu"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def build_serving_model(task, ckpt_args, weights, device, dtype=None):
    """A new model of the checkpoint's arch on ``device`` in eval mode,
    holding ``weights`` in their own types (assigned, not copied into the
    initialised parameters, which would cast them), or cast to ``dtype``
    when one is given."""
    model = task.build_model(ckpt_args)
    if dtype is not None:
        weights = {k: v.to(dtype) if v.is_floating_point() else v
                   for k, v in weights.items()}
    model.load_state_dict(weights, strict=True, assign=True)
    return model.to(device).eval()


def load_serving_model(args, device):
    """Checkpoint load + model/task rebuild from the saved args: ``(model,
    pad_idx, max_seq_len, vocab_size, eos_idx)``, the model in the
    checkpoint's dtype (fp32 under ``--serve-quantize``).  Any failure here
    is exit 76 territory — there is nothing to serve."""
    return open_serving_checkpoint(args, device)[:5]


def open_serving_checkpoint(args, device):
    """:func:`load_serving_model`'s five, and ``make_model``: a reload
    candidate's weights -> a new instance of the arch on the device."""
    import torch

    from unicore_tpu_torch import checkpoint_utils, tasks

    state = checkpoint_utils.load_checkpoint_to_cpu(args.path)
    ckpt_args = state.get("args")
    if ckpt_args is None:
        raise ValueError(
            f"checkpoint {args.path} carries no saved args; cannot rebuild "
            "the model"
        )
    if args.data:
        ckpt_args.data = args.data
    weights = state.get("model")
    if weights is None:
        raise ValueError(f"checkpoint {args.path} holds no model weights")
    task = tasks.setup_task(ckpt_args)
    # quantized serving calibrates an fp32 model: upcast exactly
    dtype = torch.float32 if getattr(args, "serve_quantize", "off") != "off" else None
    model = build_serving_model(task, ckpt_args, weights, device, dtype)

    def dtypes(tensors):
        return ", ".join(sorted({str(t.dtype).replace("torch.", "") for t in tensors
                                 if t.is_floating_point()}))

    logger.info(f"checkpoint weights in {dtypes(weights.values())}: served in "
                f"{dtypes(model.parameters())}")

    def make_model(candidate):
        return build_serving_model(task, ckpt_args, candidate, device, dtype)

    pad_idx = task.dictionary.pad()
    eos_idx = task.dictionary.eos()
    vocab_size = len(task.dictionary)
    max_seq_len = int(getattr(ckpt_args, "max_seq_len", 512) or 512)
    logger.info(
        f"serving model from {args.path} (task {type(task).__name__}, "
        f"arch {getattr(ckpt_args, 'arch', '?')}, max_seq_len {max_seq_len}, "
        f"vocab {vocab_size}, device {device})"
    )
    return model, pad_idx, max_seq_len, vocab_size, eos_idx, make_model


def decode_serving_requested(args, model) -> bool:
    """``--serve-decode`` resolution: 'auto' turns the decode plane on
    exactly when the model has the serving surface (prefill +
    decode_step); 'on' demands it (exit-76 territory otherwise)."""
    mode = args.serve_decode
    has_surface = hasattr(model, "prefill") and hasattr(model, "decode_step")
    if mode == "off":
        return False
    if mode == "on" and not has_surface:
        raise ValueError(
            f"--serve-decode on: {type(model).__name__} has no "
            "prefill/decode_step surface; serve a decoder-only checkpoint "
            "(e.g. transformer_lm) or drop the flag"
        )
    return has_surface


def build_decode_engine(args, model, pad_idx, max_seq_len, vocab_size, eos_idx,
                        device_name):
    """The incremental-decode engine: cache-length buckets in page
    multiples, a paged KV pool of ``--cache-pages`` pages, step-level
    continuous batching."""
    from unicore_tpu_torch.serve import DecodeEngine, cache_bucket_edges

    if args.serve_quantize != "off":
        raise ValueError(
            "--serve-quantize is the encoder-path weight quantization; "
            "the decode plane quantizes its KV cache via --decode-kv int8 "
            "(use --serve-decode off to serve this checkpoint through the "
            "encoder path)"
        )
    edges = cache_bucket_edges(
        max_seq_len, args.serve_buckets, page_size=args.cache_page_size
    )
    if edges[-1] > max_seq_len:
        # a position past the learned ones would index the position
        # embedding out of range, which asserts on the card
        raise ValueError(
            f"max_seq_len {max_seq_len} is not a multiple of --cache-page-size "
            f"{args.cache_page_size}: the top cache bucket {edges[-1]} would "
            "reach positions the model has no embedding for"
        )
    return DecodeEngine(
        model,
        bucket_edges=edges,
        decode_batch=args.decode_batch_size,
        prefill_batch=args.serve_batch_size,
        pad_idx=pad_idx,
        eos_idx=eos_idx,
        vocab_size=vocab_size,
        num_pages=args.cache_pages,
        page_size=args.cache_page_size,
        kv_dtype=args.decode_kv,
        max_new_tokens=args.max_new_tokens,
        admission_capacity=args.admission_capacity,
        precision="int8-kv" if args.decode_kv == "int8" else "",
        decode_sample_every=args.decode_sample_every,
        device=device_name,
    )


def serve_buckets(args, max_seq_len):
    from unicore_tpu_torch.data.data_utils import compute_length_buckets

    return compute_length_buckets(args.serve_buckets, max_seq_len) or (
        max_seq_len,
    )


def setup_quantized_serving(args, model, pad_idx, vocab_size, edges, device):
    """Startup calibration for ``--serve-quantize``: calibrate (or reuse
    digest-verified persisted scales), prepare the quantized twin, build
    the sampled drift probe and the hot-reload preparer.  Returns
    ``(model_q, engine_kwargs, reload_kwargs)``; any failure is exit-76
    territory (nothing safe to serve at the requested precision).  The fp32
    model stays on the device only when ``--quant-drift-sample`` > 0, for
    the probe.

    The probe's (quantized, fp32) pair follows hot swaps: ``preparer``
    stages a candidate's pair, the engine's ``swap_hook`` commits it only
    when THAT twin swaps in, and ``preparer_abort`` releases a
    probe-rejected candidate's pair, so it neither holds device memory nor
    ever re-pairs the probe."""
    import threading

    import numpy as np
    import torch

    from unicore_tpu_torch import telemetry
    from unicore_tpu_torch.quant import calibrate

    mode = args.serve_quantize
    if vocab_size <= 0:
        raise ValueError(
            "--serve-quantize needs a vocabulary to synthesize calibration "
            "batches, but the task has no dictionary"
        )
    if not hasattr(model, "quantize"):
        raise ValueError(
            f"--serve-quantize {mode}: {type(model).__name__} is not "
            "quantize-aware (no 'quantize' attr); only models whose dense "
            "call sites route through QuantDense can serve quantized"
        )
    model_q, info = calibrate.calibrate_for_serving(
        model.clone(quantize=mode), model,
        mode=mode,
        snapshot_path=args.path,
        vocab_size=vocab_size,
        pad_idx=pad_idx,
        bucket_edges=edges,
        batch_size=args.serve_batch_size,
        n_batches=args.calibration_batches,
    )
    logger.info(
        f"QUANT-PATH {info['mode']}: scales {info['source']} for "
        f"{info['sites']} site(s), calibration max |logit drift| "
        f"{info['max_abs_logit_drift']:.5f} (rel {info['rel_drift']:.5f}) "
        f"over {info['batches']} batch(es); scales at {info['scales_path']}"
    )
    public = {k: v for k, v in info.items() if k != "weights_digest"}
    logger.info(f"quant-path calibrated: {public}")
    telemetry.emit("quant-path", event="calibrated", **public)
    # the fp32 model's names and shapes: what a reload candidate must match
    structure = {k: torch.empty(tuple(v.shape), device="meta")
                 for k, v in model.state_dict().items()}

    sampling = args.quant_drift_sample > 0
    oracle = {"q": model_q, "f": model if sampling else None, "staged": []}
    oracle_lock = threading.Lock()
    if not sampling:
        model.to("cpu")  # only the probe needs it on the device

    def drift_probe(tokens):
        """Per-row max |logit_q - logit_f32| over the real (non-pad)
        positions, the only ones a response is cut from."""
        with oracle_lock:
            mq, mf = oracle["q"], oracle["f"]
        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                   device=device)
            d = (mq(toks).float() - mf(toks).float()).abs()
            d = d * (toks != pad_idx)[..., None].to(d.dtype)
            return d.amax(dim=tuple(range(1, d.ndim))).cpu().numpy()

    # filled once the engine exists: the hook pushes a committed
    # candidate's calibration into /stats
    engine_cell = {}

    def swap_hook(swapped, tag):
        committed = None
        with oracle_lock:
            staged = oracle["staged"]
            for i, (q, f, new_info) in enumerate(staged):
                if q is swapped:
                    oracle["q"], oracle["f"] = q, f
                    committed = new_info
                    # pairs staged before the applied one are superseded
                    # (request_swap is latest-wins); later ones stay staged
                    del staged[: i + 1]
                    break
        eng = engine_cell.get("engine")
        if committed is not None and eng is not None:
            eng.update_quant_info({k: v for k, v in committed.items()
                                   if k != "weights_digest"})

    def preparer(candidate):
        """Hot-reload calibration stage: re-verify (digest) or re-derive the
        scales for the candidate's weights on the card while the old twin
        serves; any failure becomes a rejected:calibration rollback."""
        new_q, new_info = calibrate.calibrate_for_serving(
            candidate.clone(quantize=mode), candidate,
            mode=mode,
            snapshot_path=args.path,
            vocab_size=vocab_size,
            pad_idx=pad_idx,
            bucket_edges=edges,
            batch_size=args.serve_batch_size,
            n_batches=args.calibration_batches,
        )
        peak = (f", device memory peak {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB"
                if device.type == "cuda" else "")
        logger.info(
            f"QUANT-PATH {mode}: reload candidate re-calibrated "
            f"(scales {new_info['source']}, max |logit drift| "
            f"{new_info['max_abs_logit_drift']:.5f}){peak}"
        )
        telemetry.emit(
            "quant-path", event="reload-calibrated",
            **{k: v for k, v in new_info.items() if k != "weights_digest"},
        )
        with oracle_lock:
            oracle["staged"].append((new_q, candidate if sampling else None, new_info))
        return new_q

    def preparer_abort():
        """The probe rejected the candidate this preparer just staged: drop
        its pair (the most recent entry)."""
        with oracle_lock:
            if oracle["staged"]:
                oracle["staged"].pop()

    engine_kwargs = {
        "precision": mode,
        "quant_info": public,
        "drift_probe": drift_probe if sampling else None,
        "drift_sample_every": args.quant_drift_sample,
        "swap_hook": swap_hook,
    }
    reload_kwargs = {"preparer": preparer, "preparer_abort": preparer_abort,
                     "structure_ref": structure, "engine_cell": engine_cell}
    return model_q, engine_kwargs, reload_kwargs


def start_fleet_registration(args, server, engine):
    """``--advertise``: register this replica in the fleet's heartbeat
    lease plane.  Raises on an unusable root or address (the caller exits
    78).

    The lease's snapshot digest follows hot swaps: a hook chained onto the
    engine's ``_swap_hook`` (which :func:`setup_quantized_serving` may
    already own) hands the swapped-in model to the registrar, whose thread
    hashes it at its next beat, off the serving loop."""
    import threading

    from unicore_tpu_torch.serve import fleet
    from unicore_tpu_torch.serve.fleet.router import host_port

    if not args.fleet_kv:
        raise ValueError(
            "--advertise requires --fleet-kv DIR (the coordination store the "
            "router reads membership from)"
        )
    client = fleet.open_fleet_kv(args.fleet_kv)
    name = args.replica_name or f"r{args.replica_index}"
    address = args.advertise
    if address == "auto":
        host = args.host if args.host not in ("0.0.0.0", "::") else "127.0.0.1"
        address = f"http://{host}:{server.server_address[1]}"
    try:
        host_port(address)
    except (TypeError, ValueError):
        raise ValueError(
            f"--advertise {address!r} is not a routable address: the router "
            "dials it, so it must carry host:port (or use 'auto')"
        ) from None
    lock = threading.Lock()
    cell = {"digest": fleet.model_digest(engine.model.state_dict()), "swapped": None}
    prev_hook = engine._swap_hook

    def swap_hook(model, tag):
        if prev_hook is not None:
            prev_hook(model, tag)
        with lock:
            cell["swapped"] = model

    def digest():
        with lock:
            swapped, cell["swapped"] = cell["swapped"], None
        if swapped is not None:
            cell["digest"] = fleet.model_digest(swapped.state_dict())
        return cell["digest"]

    engine._swap_hook = swap_hook
    return fleet.ReplicaRegistrar(
        client, name, address,
        interval_s=args.fleet_interval,
        ready_fn=engine.ready,
        est_delay_fn=engine.queue.estimated_delay,
        digest_fn=digest,
        served_fn=lambda: engine.served,
    ).start()


def _start_flood_generator(args, engine, stop_event):
    """Synthetic traffic for the ``request-flood`` chaos kind: offers
    ``chaos.serve_flood_qps()`` requests a second straight into admission
    while the flood window is open (on the decode engine, generations).
    Request lengths cycle the bucket set, so the flood reaches every
    bucket."""
    from unicore_tpu_torch.distributed import chaos

    def run():
        i = 0
        while not stop_event.is_set():
            if not engine.ready():
                # no flood against a warming or reloading server: the chaos
                # proves admission control, not that a cold server sheds
                stop_event.wait(timeout=0.1)
                continue
            qps = chaos.serve_flood_qps()
            if qps <= 0:
                stop_event.wait(timeout=0.1)
                continue
            edge = engine.bucket_edges[i % len(engine.bucket_edges)]
            length = max(1, edge - 1)
            engine.submit([5] * length, args.default_deadline_ms / 1000.0,
                          request_id=f"flood{i}")
            i += 1
            stop_event.wait(timeout=1.0 / qps)

    t = threading.Thread(target=run, name="serve-flood", daemon=True)
    t.start()
    return t


def main(args) -> int:
    import torch

    from unicore_tpu_torch import checkpoint_utils, telemetry
    from unicore_tpu_torch.checkpoint.emergency import Deadline, deadline_scope
    from unicore_tpu_torch.distributed import chaos
    from unicore_tpu_torch.modules import configure_fused_norm
    from unicore_tpu_torch.serve import (
        CheckpointWatcher,
        HotReloader,
        ReloadRunner,
        ServeEngine,
        build_infer_fn,
    )
    from unicore_tpu_torch.serve.engine import PHASE_DRAINING
    from unicore_tpu_torch.serve.http import bind_server

    # an fp32 checkpoint runs in fp32: the JAX server runs at the
    # checkpoint's precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    configure_fused_norm(args.fused_norm)
    try:
        chaos.configure(args)
    except (ValueError, NotImplementedError) as err:
        logger.error(f"FATAL: --fault-inject {args.fault_inject!r}: {err}")
        return EXIT_SERVE_MODEL_LOAD
    chaos.set_replica_index(args.replica_index)
    logger.info(args)

    # the serve plane's event journal (sheds, reload outcomes, drains),
    # beside the served checkpoint unless --telemetry-dir names a place
    if not args.telemetry_dir:
        args.telemetry_dir = os.path.join(
            os.path.dirname(os.path.abspath(args.path)) or ".", "telemetry")
    telemetry.configure(args, rank=args.replica_index, role="serve")

    # 0. device ----------------------------------------------------------
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        logger.error(
            f"FATAL: {err} — exiting {EXIT_SERVE_MODEL_LOAD} "
            f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_MODEL_LOAD]})"
        )
        return EXIT_SERVE_MODEL_LOAD

    # 1. model load ------------------------------------------------------
    reload_kwargs = {}
    try:
        model, pad_idx, max_seq_len, vocab_size, eos_idx, make_model = \
            open_serving_checkpoint(args, device)
        device_name = (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        )
        if decode_serving_requested(args, model):
            engine = build_decode_engine(
                args, model, pad_idx, max_seq_len, vocab_size, eos_idx,
                device_name,
            )
            logger.info(
                f"serving INCREMENTAL DECODE: cache buckets "
                f"{list(engine.bucket_edges)}, "
                f"{args.cache_pages} pages x {args.cache_page_size} rows, "
                f"kv {args.decode_kv}, decode batch "
                f"{args.decode_batch_size}, max_new {args.max_new_tokens}"
            )
        else:
            edges = serve_buckets(args, max_seq_len)
            serve_model, quant_kwargs = model, {}
            if args.serve_quantize != "off":
                serve_model, quant_kwargs, reload_kwargs = setup_quantized_serving(
                    args, model, pad_idx, vocab_size, edges, device
                )
            engine = ServeEngine(
                serve_model,
                build_infer_fn(device),
                bucket_edges=edges,
                batch_size=args.serve_batch_size,
                pad_idx=pad_idx,
                vocab_size=vocab_size,
                admission_capacity=args.admission_capacity,
                device=device_name,
                **quant_kwargs,
            )
            if reload_kwargs:
                reload_kwargs.pop("engine_cell")["engine"] = engine
            del serve_model
        # the engine owns the served model from here: a hot swap must be
        # able to free it
        del model
    except Exception as err:
        logger.error(
            f"FATAL: model load failed ({type(err).__name__}: {err}) — "
            f"exiting {EXIT_SERVE_MODEL_LOAD} "
            f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_MODEL_LOAD]})",
            exc_info=True,
        )
        return EXIT_SERVE_MODEL_LOAD

    # 2. bind (probes live, readiness false) -----------------------------
    try:
        server = bind_server(
            args.host, args.port, engine,
            read_timeout_s=args.request_read_timeout,
            default_deadline_ms=args.default_deadline_ms,
            max_deadline_ms=args.max_deadline_ms,
        )
    except OSError as err:
        logger.error(
            f"FATAL: cannot bind {args.host}:{args.port} ({err}) — exiting "
            f"{EXIT_SERVE_BIND} ({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_BIND]})"
        )
        return EXIT_SERVE_BIND
    server.start()

    # fleet membership: registered BEFORE warm-up, so the router sees the
    # replica registered-but-not-ready while its buckets warm
    registrar = None
    if args.advertise:
        try:
            registrar = start_fleet_registration(args, server, engine)
        except Exception as err:
            logger.error(
                f"FATAL: fleet registration failed ({type(err).__name__}: {err}) — "
                f"exiting {EXIT_SERVE_FLEET_KV} "
                f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_FLEET_KV]})"
            )
            server.shutdown()
            return EXIT_SERVE_FLEET_KV

    # 3. warm-up (readiness flips true inside) ---------------------------
    try:
        engine.warmup()
    except Exception as err:
        logger.error(
            f"FATAL: warm-up failed ({type(err).__name__}: {err}) — exiting "
            f"{EXIT_SERVE_MODEL_LOAD} "
            f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_MODEL_LOAD]})",
            exc_info=True,
        )
        if registrar is not None:
            registrar.stop(goodbye=True)
        server.shutdown()
        return EXIT_SERVE_MODEL_LOAD
    if registrar is not None:
        registrar.publish_now()  # readiness flipped: don't wait for the beat

    # 4. serve -----------------------------------------------------------
    engine.start()
    reloader = None
    if args.reload_interval > 0 or registrar is not None:
        reloader = HotReloader(engine, checkpoint_utils.load_checkpoint_to_cpu,
                               make_model=make_model, **reload_kwargs)
    reload_runner = None
    if args.reload_interval > 0:
        reload_runner = ReloadRunner(CheckpointWatcher(args.path), reloader,
                                     args.reload_interval)
        reload_runner.start()
    if registrar is not None:
        # the router's rolling reload runs this replica's own verify -> probe
        # -> swap through POST /v1/reload, always on its OWN --path
        server.reloader = reloader
        server.reload_path = args.path
    flood_stop = threading.Event()
    flood_thread = _start_flood_generator(args, engine, flood_stop)

    def stop_planes():
        flood_stop.set()
        if reload_runner is not None:
            reload_runner.stop()

    started = time.monotonic()
    while not _drain_requested.is_set():
        if not engine.healthy():
            logger.error(
                f"FATAL: serve engine loop died "
                f"({type(engine.fatal_error).__name__ if engine.fatal_error else 'thread exit'}: "
                f"{engine.fatal_error}) — exiting 1"
            )
            stop_planes()
            if registrar is not None:
                # a goodbye, not a rotting lease: the router drops this
                # replica now instead of waiting for a loss verdict
                registrar.stop(goodbye=True)
            server.shutdown()
            return 1
        if (
            args.serve_max_seconds > 0
            and time.monotonic() - started >= args.serve_max_seconds
        ):
            logger.info(
                f"--serve-max-seconds ({args.serve_max_seconds:g}s) "
                "reached: starting the graceful drain"
            )
            break
        _drain_requested.wait(timeout=0.2)

    # 5. drain -----------------------------------------------------------
    # the reload and flood planes stop first: a reload landing mid-drain
    # would race the readiness state, a flood would fight the flush for the
    # drain budget
    stop_planes()
    if registrar is not None:
        # the drain handshake: the lease says ready=false BEFORE the flush,
        # so the router stops routing here within one beat (and at the
        # first 503)
        engine.set_ready(False, PHASE_DRAINING)
        registrar.publish_now()
    deadline = Deadline(args.drain_deadline)
    with deadline_scope(deadline):
        drained = engine.drain(deadline)
    if registrar is not None:
        registrar.stop(goodbye=True)  # deregistered, not lost
    server.shutdown()
    flood_thread.join(timeout=2.0)
    logger.info(f"final serve stats: {engine.stats()}")
    if not drained:
        logger.error(
            f"exiting {EXIT_SERVE_DRAIN_DEADLINE} "
            f"({SERVE_EXIT_CODE_NAMES[EXIT_SERVE_DRAIN_DEADLINE]})"
        )
        return EXIT_SERVE_DRAIN_DEADLINE
    logger.info("serve shutdown clean: drained in-flight work, exiting 0")
    return EXIT_OK


def cli_main() -> None:
    logging.basicConfig(
        stream=sys.stdout,
        level=os.environ.get("LOGLEVEL", "INFO").upper(),
        format=" | ".join(f"%({f})s" for f in _LOG_FIELDS),
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    from unicore_tpu_torch import options

    args = options.get_serving_parser().parse_args()
    try:
        signal.signal(signal.SIGTERM, _handle_signal)
        signal.signal(signal.SIGINT, _handle_signal)
    except ValueError:
        logger.warning(
            "could not install signal handlers (not the main thread); "
            "graceful drain is unavailable"
        )
    sys.exit(main(args))


if __name__ == "__main__":
    cli_main()
