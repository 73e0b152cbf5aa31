"""Environment knobs of the port (parity: mxnet_tpu/config.py).

Only the knobs the ported modules read are here, with the JAX package's
names, defaults and parsing; the rest arrive with their users, so every
flag's disposition is "honored".  The ``enable_*`` helpers switch the
observability layer and the compile cache after import, as the JAX
package's do.
"""
from __future__ import annotations

import os
import warnings

__all__ = ["get", "FLAGS", "describe", "markdown_table", "warn_unknown",
           "fusion_cost_table", "enable_telemetry", "enable_events",
           "enable_tracing", "enable_flight_recorder",
           "enable_compile_cache", "disable_compile_cache"]


def _pint(v):
    return int(v)


def _pbool(v):
    return str(v).lower() in ("1", "true", "yes", "on")


def _pfloat(v):
    return float(v)


# name -> (default, parser, note)
FLAGS = {
    "MXNET_CPU_WORKER_NTHREADS": (
        "4", _pint,
        "default preprocess_threads of io.ImageRecordIter: the decode "
        "and augment thread pool, and the native decoder's C++ threads"),
    "MXNET_DEVICE_PREFETCH": (
        "2", _pint,
        "default depth of io.DevicePrefetcher: batches whose host-to-card "
        "copy is staged ahead of the consuming train step; 0 makes the "
        "wrapper a passthrough that copies inline"),
    "MXNET_ENGINE_TYPE": (
        "ThreadedEnginePerDevice", str,
        "NaiveEngine synchronizes the card after every op (the reference's "
        "race-free oracle); anything else leaves torch's asynchronous "
        "dispatch (engine.py)"),
    "MXNET_GLUON_REPO": (
        "", str,
        "base URL of the gluon model zoo's weight mirror (file:// works "
        "offline); '' disables fetching (model_store.get_model_file)"),
    "MXNET_FUSION": (
        "", str,
        "default graph-fusion policy of Executor, CachedOp, Module and "
        "ShardedTrainer: '' = the identical-math patterns plus cost-table "
        "upgrades, 'off', 'all', or a list of pattern names "
        "(symbol.fusion.list_patterns())"),
    "MXNET_REMAT_POLICY": (
        "", str,
        "default activation-remat policy of Executor, CachedOp, Module and "
        "ShardedTrainer ('' = off; see remat.list_policies())"),
    "MXNET_COMPILE_CACHE": (
        "1", _pbool,
        "persistent compile cache: inductor's FX-graph cache and "
        "AOTAutograd's cache on disk, so a second process compiling the "
        "same graph loads it (config.enable_compile_cache, at import)"),
    "MXNET_COMPILE_CACHE_DIR": (
        os.path.join(os.path.expanduser("~"), ".cache", "mxnet_tpu_torch",
                     "compile"), str,
        "directory of the persistent compile cache (inductor's cache dir, "
        "Triton's cache under it)"),
    "MXNET_SAFE_ACCUMULATION": (
        "0", _pbool,
        "accumulate f16 / bf16 sum, mean, prod, max, min, nansum and "
        "nanprod in f32 (ops/tensor.py)"),
    "MXNET_HOME": (
        os.path.join("~", ".mxnet"), str,
        "data and cache root of the gluon contrib dataset downloads "
        "(gluon/contrib/data.py)"),
    "MXNET_FUSION_TUNE": (
        "", str,
        "path of a measured shape-keyed fusion cost table ('' = no table: "
        "only the default-on patterns fire); config.fusion_cost_table "
        "installs one from code"),
    "MXNET_DTYPE_POLICY": (
        "", str,
        "default mixed-precision dtype policy of ShardedTrainer: '' or "
        "'f32' = f32, 'bf16_mixed', 'bf16_pure', or a "
        "dtype_policy.register_policy addition"),
    "MXNET_LOSS_SCALE": (
        "65536", _pfloat,
        "initial dynamic loss scale of loss-scaling policies (bf16_mixed)"),
    "MXNET_LOSS_SCALE_GROWTH_INTERVAL": (
        "2000", _pint,
        "consecutive finite steps before the loss scale doubles"),
    "MXNET_LOSS_SCALE_BACKOFF": (
        "0.5", _pfloat,
        "multiplier of the loss scale on an overflowed (skipped) step"),
    "MXNET_LOSS_SCALE_MAX": (
        "16777216", _pfloat, "upper bound of the loss scale (2^24)"),
    "MXNET_ASYNC_METRICS": (
        "0", _pbool,
        "non-blocking train-step metrics: step() never reads the loss on "
        "the host; a background thread fetches the accumulator"),
    "MXNET_STEPS_PER_CALL": (
        "1", _pint, "steps per ShardedTrainer.step_many call"),
    "MXNET_NONFINITE_POLICY": (
        "warn", str,
        "step guard for NaN/Inf losses: off|warn|skip|raise"),
    "MXNET_CHECKPOINT_KEEP": (
        "3", _pint, "CheckpointManager keep-last-N retention default"),
    "MXNET_CHECKPOINT_ASYNC": (
        "1", _pbool,
        "CheckpointManager default save mode: snapshot to host, then "
        "serialize/fsync in a background thread (wait() is the barrier)"),
    "MXNET_CKPT_SHARDED": (
        "0", _pbool,
        "CheckpointManager default for sharded=: every process writes "
        "only the chunks it owns (shard-<host>.npz + digest sidecar), "
        "process 0 commits the global manifest last after the "
        "cross-process durability barrier"),
    "MXNET_AOT": (
        "0", _pbool,
        "ahead-of-time executable store: not ported yet; a set value "
        "makes serving.Predictor raise instead of serving without it"),
    "MXNET_SERVING_QUEUE": (
        "64", _pint,
        "AsyncPredictor bounded request-queue depth (serving_async.py); "
        "a full queue rejects non-blocking submits with a typed "
        "Overloaded error instead of growing latency without bound"),
    "MXNET_SERVING_DEADLINE_MS": (
        "0", _pfloat,
        "AsyncPredictor default per-request deadline in milliseconds "
        "(0 = none): expired requests fail with DeadlineExceeded — in "
        "the queue via the sweep, at dispatch pickup, or on late "
        "completion — instead of silently blowing the client timeout"),
    "MXNET_SERVING_MAX_INFLIGHT": (
        "0", _pint,
        "AsyncPredictor cap on admitted-but-uncompleted requests, "
        "queued + claimed (0 = auto: queue depth + 2 x chain x B x "
        "replicas — pipeline capacity in requests, so it binds when "
        "dispatches are stuck, not before the queue); past it submits "
        "shed with Overloaded(reason='inflight') or block when "
        "backpressure is requested"),
    "MXNET_SERVING_WARM_POOL": (
        "0", _pint,
        "AsyncPredictor default warm-pool size: N spare Predictor "
        "replicas pre-built so a replica ejection swaps a "
        "canary-verified spare in automatically instead of waiting for "
        "operator heal()"),
    "MXNET_SERVING_HEAL_PROBE": (
        "0", _pfloat,
        "seconds between auto-heal canary probes of ejected "
        "AsyncPredictor replicas (0 = no probing): a probe dispatches "
        "one known-good batch and re-admits the replica on success"),
    "MXNET_GATEWAY_PORT": (
        "0", _pint,
        "HTTP serving gateway listen port (gateway.py; 0 = ephemeral, "
        "the bound port is on Gateway.port).  The gateway also serves "
        "the scrape routes (/metrics /healthz /statusz /varz "
        "/requestz) on the same listener"),
    "MXNET_GATEWAY_MAX_BODY": (
        "1048576", _pint,
        "gateway request-body byte cap: a Content-Length above it is "
        "refused 413 before reading a byte, so oversized bodies can "
        "never hold a handler thread or its memory"),
    "MXNET_GATEWAY_READ_TIMEOUT_S": (
        "5", _pfloat,
        "gateway socket read timeout while receiving a request body: "
        "a slow-loris client trickling bytes slower than this is cut "
        "with 408 instead of pinning a handler thread"),
    "MXNET_GATEWAY_QUOTA_QPS": (
        "0", _pfloat,
        "per-tenant token-bucket refill rate in requests/second "
        "(0 = quotas off): a tenant over its bucket gets 429 with "
        "Retry-After sized to the refill wait"),
    "MXNET_GATEWAY_QUOTA_BURST": (
        "8", _pint,
        "per-tenant token-bucket capacity: how many requests a tenant "
        "may burst above its steady MXNET_GATEWAY_QUOTA_QPS rate"),
    "MXNET_GATEWAY_QUEUE": (
        "16", _pint,
        "gateway per-tenant fair-queue depth: a tenant with this many "
        "requests already waiting for a dispatch permit sheds the "
        "next one typed (Overloaded('queue') -> 429)"),
    "MXNET_GATEWAY_CONCURRENCY": (
        "8", _pint,
        "gateway dispatch permits shared across tenants: concurrent "
        "backend requests; freed permits go to the queued tenant with "
        "the smallest weighted-fair virtual finish time"),
    "MXNET_GATEWAY_DRAIN_S": (
        "10", _pfloat,
        "gateway close()/SIGTERM drain budget in seconds: /healthz "
        "flips 503 first, new requests shed 503, open streams get "
        "this long to finish before the listener stops"),
    "MXNET_GATEWAY_MAX_TENANTS": (
        "256", _pint,
        "cap on distinct X-Tenant values tracked by the gateway: "
        "tenants past the cap collapse onto one shared overflow "
        "key (bucket/queue/metric label), so minting unique tenant "
        "headers cannot grow per-tenant state without bound"),
    "MXNET_DECODE_SLOTS": (
        "8", _pint,
        "generate.GenerationEngine default decode slots: the fixed batch "
        "width of the decode step (one KV-cache lane per slot)"),
    "MXNET_DECODE_CACHE_LEN": (
        "256", _pint,
        "default KV-cache ring length per slot (capped at the model's "
        "max_len); generation past the ring attends over a sliding "
        "window"),
    "MXNET_DECODE_BUCKETS": (
        "32,64,128,256", str,
        "comma list of prefill length buckets: a prompt pads up to the "
        "smallest bucket >= its length"),
    "MXNET_DECODE_QUEUE": (
        "64", _pint,
        "generate.TokenServer admission-queue depth: a full queue rejects "
        "with the typed Overloaded('queue') error"),
    "MXNET_DECODE_DEADLINE_MS": (
        "0", _pfloat,
        "default per-request decode deadline (0 = none): an expired "
        "request fails with DeadlineExceeded(stage='prefill'|'decode') "
        "and its cache slot is evicted (reason 'deadline')"),
    "MXNET_DECODE_MAX_NEW": (
        "128", _pint,
        "default cap on generated tokens per request (finish_reason "
        "'length'); submit's max_new_tokens= overrides"),
    "MXNET_DECODE_PAGE_SIZE": (
        "16", _pint,
        "positions per KV page in the paged engine's pool; a slot holds "
        "ceil(cache_len/page_size) pages and prefix sharing is "
        "page-aligned"),
    "MXNET_DECODE_PAGES": (
        "0", _pint,
        "total pages in the paged engine's pool, incl. the reserved trash "
        "page (0 = auto: slots x pages_per_slot + 1, the floor at which "
        "admission-time allocation can never starve a decode)"),
    "MXNET_DECODE_PREFILL_CHUNK": (
        "32", _pint,
        "chunked-prefill chunk length: prompts stream into the paged "
        "engine this many positions per dispatch, one chunk per "
        "TokenServer loop tick"),
    "MXNET_DECODE_SPEC_K": (
        "0", _pint,
        "n-gram speculative decoding draft length for the paged engine "
        "(0 = off); exact-match acceptance keeps the output equal to "
        "non-speculative sampling"),
    "MXNET_DECODE_SPEC_NGRAM": (
        "2", _pint,
        "suffix length the n-gram speculator matches against the "
        "sequence's own history to source drafts"),
    "MXNET_DECODE_PREFIX_SHARE": (
        "1", _pint,
        "paged-engine prefix sharing: full prompt pages are content-"
        "hashed and later prompts with the same page-aligned prefix "
        "attach to them refcounted (0 disables)"),
    "MXNET_QUANTIZE_TOPK": (
        "5", _pint,
        "k of the int8 accuracy gate (contrib.quantization."
        "quantize_serving_artifact): fp32-of-record against int8 top-k "
        "agreement on the recorded calibration batch"),
    "MXNET_QUANTIZE_MAX_DELTA": (
        "0.02", _pfloat,
        "largest tolerated top-k accuracy delta (1 - agreement) of the "
        "int8 gate; a larger measured delta refuses the artifact"),
    "MXNET_UPDATE_ON_KVSTORE": (
        "1", _pbool,
        "a Module over a dist* kvstore runs the optimizer on the "
        "parameter server (0: the server sums, each worker updates)"),
    "MXTPU_PS_ASYNC": (
        "0", _pbool,
        "run_server in async mode: each push applies at once instead of "
        "after NumWorkers pushes of its key"),
    "MXTPU_PS_LISTEN_FD": (
        "-1", _pint,
        "a listening socket the launcher opened for run_server (-1: bind "
        "DMLC_PS_ROOT_PORT)"),
    "MXNET_PROFILER_AUTOSTART": (
        "0", _pbool, "start the torch.profiler trace at import"),
    "MXNET_PROFILER_MODE": (
        "0", _pint, "recognized; the facade is configured through "
        "profiler.set_config"),
    "MXNET_TRACE": (
        "0", _pbool,
        "hierarchical span tracing (tracing.py): step/request spans with "
        "trace/span/parent IDs into a bounded ring buffer, exportable as "
        "one Chrome/Perfetto trace.json; off = one branch per call site"),
    "MXNET_TRACE_BUFFER": (
        "4096", _pint,
        "span ring-buffer capacity (oldest spans evicted first; evictions "
        "counted in mxnet_tpu_trace_spans_dropped_total)"),
    "MXNET_FLIGHT_RECORDER": (
        "0", _pbool,
        "black-box postmortem bundles (trace + telemetry + thread stacks "
        "+ env/device info) on unhandled step/fit exceptions "
        "(tracing.record_crash)"),
    "MXNET_FLIGHT_RECORDER_DIR": (
        "", str, "flight-recorder bundle directory ('' = ./flight_recorder)"),
    "MXNET_TELEMETRY": (
        "0", _pbool,
        "runtime metrics registry (telemetry.py): step/decode/compile "
        "series, Prometheus scrape() + JSON dump(); off = one flag-check "
        "per call site"),
    "MXNET_TELEMETRY_INTERVAL": (
        "30", _pfloat,
        "TelemetryReporter default snapshot interval in seconds"),
    "MXNET_TELEMETRY_PORT": (
        "0", _pint,
        "Prometheus HTTP scrape endpoint: serve telemetry.scrape() at "
        "http://0.0.0.0:PORT/metrics with /healthz, /statusz, /requestz, "
        "/varz, /fleetz and /goodputz for the process lifetime "
        "(telemetry.serve_scrape; 0 = off)"),
    "MXNET_EVENTS": (
        "0", _pbool,
        "wide-event observability (events.py): one structured JSONL "
        "record per unit of work (TokenServer generation, train-step "
        "window) with typed outcome, stage latency split, trace id and "
        "perf_ledger provenance; off = one branch per call site"),
    "MXNET_EVENTS_PATH": (
        "", str,
        "JSONL file the bounded background event writer appends kept "
        "wide events to ('' = in-memory ring only)"),
    "MXNET_EVENTS_SAMPLE": (
        "1.0", _pfloat,
        "keep probability for ok-outcome wide events below the tail "
        "threshold (head sampling); non-ok outcomes and the slow tail "
        "are always kept"),
    "MXNET_PERF_LEDGER": (
        "", str,
        "append-only JSONL run ledger perf_ledger.emit appends its "
        "schema-versioned BENCH records to ('' = records print but "
        "nothing persists)"),
    "MXNET_PEAK_TFLOPS": (
        "", str,
        "accelerator peak TFLOP/s for the MFU gauge ('' = no MFU unless "
        "telemetry.set_peak_flops is given one)"),
    "MXNET_FLEET_SPOOL": (
        "", str,
        "fleet-observatory spool directory (fleet.py): each rank "
        "publishes atomic metric/breakdown/trace snapshots here and "
        "fleet.fleetz merges them into a pod view with straggler "
        "attribution; '' = observatory off"),
    "MXNET_FLEET_INTERVAL": (
        "5", _pfloat,
        "seconds between background fleet snapshot publishes"),
    "MXNET_FLEET_STALE": (
        "30", _pfloat,
        "fleet collector staleness cut in seconds: an older rank is "
        "marked stale and left out of straggler scoring"),
    "MXNET_FLEET_CLOCK_OFFSET": (
        "0", _pfloat,
        "wall-clock offset in seconds added to every timestamp this "
        "rank's FleetPublisher records (skew injection for drills; keep "
        "0 in production)"),
    "MXNET_GOODPUT_DIR": (
        "", str,
        "goodput-ledger job directory (goodput.py): each process "
        "incarnation appends typed wall-clock segments here and "
        "goodput.goodputz merges every incarnation of every rank into "
        "one job-lifetime report; '' = ledger off"),
    "MXNET_GOODPUT_FLUSH_EVERY": (
        "16", _pint,
        "goodput-ledger sidecar cadence: records appended between "
        "prefix-digest sidecar commits"),
    "MXNET_DIST_PROC_ID": (
        "-1", _pint,
        "this process's rank for the fleet spool, the goodput ledger and "
        "wide events (-1 = unset: rank 0)"),
    "MXNET_DIST_NUM_PROCS": (
        "0", _pint,
        "process count for the same rank identity (<=1: single-process)"),
    "MXNET_DIST_BARRIER_TIMEOUT": (
        "120", _pfloat,
        "seconds FleetPublisher.attach's spool rendezvous, and a sharded "
        "checkpoint save's durability barrier, wait for every rank's "
        "file before giving up on a dead peer"),
    "MXNET_DIST_PREEMPT_GATE": (
        "1", _pint,
        "coordinated preemption commit: step-boundaries of headroom "
        "between the signalled process's committed step and the "
        "pod-wide final-checkpoint step (bounds dispatch drift between "
        "processes)"),
    "DMLC_ROLE": ("worker", str, "dist kvstore role"),
    "DMLC_PS_ROOT_URI": ("", str, "dist kvstore server host"),
    "DMLC_PS_ROOT_PORT": ("9091", _pint, "dist kvstore server port"),
    "DMLC_WORKER_RANK": ("0", _pint, "dist worker rank"),
    "DMLC_RANK": ("0", _pint, "dist rank (fallback name)"),
    "DMLC_NUM_WORKER": ("1", _pint, "dist worker count"),
    "DMLC_NUM_SERVER": ("1", _pint, "dist server count"),
}

_warned = set()


def warn_unknown():
    """One-time warning for unrecognized MXNET_* environment variables
    (called at import)."""
    for name in os.environ:
        if name.startswith("MXNET_") and name not in FLAGS and \
                name not in _warned:
            _warned.add(name)
            warnings.warn("environment variable %s is not recognized by "
                          "mxnet_tpu_torch (see mxnet_tpu_torch.config.FLAGS)"
                          % name)


def describe():
    """Human-readable flag table, one row a flag: name, disposition,
    default, note (the JAX package's layout)."""
    rows = ["%-36s %-9s default=%-10s %s" % (n, "honored", d[0], d[2])
            for n, d in sorted(FLAGS.items())]
    return "\n".join(rows)


def markdown_table():
    """The flag table as markdown (returned, not written anywhere)."""
    rows = ["| `%s` | %s | `%s` | %s |"
            % (n, "honored", d[0] if d[0] != "" else "''",
               d[2].replace("|", "\\|"))
            for n, d in sorted(FLAGS.items())]
    return "\n".join(["| knob | disposition | default | notes |",
                      "| --- | --- | --- | --- |"] + rows)


def get(name):
    """Parsed value of a registered flag (env overrides default)."""
    default, parser, _note = FLAGS[name]
    raw = os.environ.get(name, default)
    try:
        return parser(raw)
    except (TypeError, ValueError):
        if name not in _warned:
            _warned.add(name)
            warnings.warn("invalid value %r for %s; using default %r"
                          % (raw, name, default))
        return parser(default)


def fusion_cost_table(table):
    """Install the process-wide fusion cost table (the switch
    ``MXNET_FUSION_TUNE`` sets, callable after import): a JSON path, a
    ``fusion_cost.CostTable`` or dict, or None for no table."""
    from . import fusion_cost

    fusion_cost.set_cost_table(table)


def enable_telemetry(on=True):
    """Toggle the runtime metrics registry (same switch as the
    ``MXNET_TELEMETRY`` env flag, callable after import)."""
    from . import telemetry

    if on:
        telemetry.enable()
    else:
        telemetry.disable()


def enable_events(on=True, path=None, sample=None):
    """Toggle wide-event emission (same switch as ``MXNET_EVENTS``;
    ``path``/``sample`` override ``MXNET_EVENTS_PATH`` /
    ``MXNET_EVENTS_SAMPLE``)."""
    from . import events

    if on:
        events.enable(path=path, sample=sample)
    else:
        events.disable()


def enable_tracing(on=True):
    """Toggle hierarchical span tracing (same switch as ``MXNET_TRACE``,
    callable after import)."""
    from . import tracing

    if on:
        tracing.enable()
    else:
        tracing.disable()


def enable_flight_recorder(on=True, directory=None):
    """Toggle the crash flight recorder (same switch as
    ``MXNET_FLIGHT_RECORDER``; ``directory`` overrides
    ``MXNET_FLIGHT_RECORDER_DIR``)."""
    from . import tracing

    if on:
        tracing.enable_flight_recorder(directory)
    else:
        tracing.disable_flight_recorder()


def enable_compile_cache(cache_dir=None):
    """Point torch's persistent compile caches at ``cache_dir`` (else
    ``MXNET_COMPILE_CACHE_DIR``) and turn them on: inductor's FX-graph
    cache and AOTAutograd's cache live in inductor's cache directory
    (``TORCHINDUCTOR_CACHE_DIR``), Triton's under it
    (``TRITON_CACHE_DIR``), so a second process that compiles the same
    graph loads it instead of compiling.  Called at import when
    ``MXNET_COMPILE_CACHE`` is on (the default).  Inductor reads the
    directory at its first use, so call this before the first compile to
    move it.  Returns the directory, or None when it cannot be made (a
    warning says why; the caches then stay off)."""
    cache_dir = os.path.abspath(os.path.expanduser(
        cache_dir or get("MXNET_COMPILE_CACHE_DIR")))
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:
        warnings.warn("persistent compile cache disabled: %s" % e)
        return None
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache_dir
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache_dir, "triton")
    import torch._functorch.config as _functorch_config
    import torch._inductor.config as _inductor_config

    _inductor_config.fx_graph_cache = True
    _functorch_config.enable_autograd_cache = True
    return cache_dir


def disable_compile_cache():
    """Turn torch's persistent compile caches off (``MXNET_COMPILE_CACHE=0``
    at import): no compile reads or writes a cache entry."""
    import torch._functorch.config as _functorch_config
    import torch._inductor.config as _inductor_config

    _inductor_config.fx_graph_cache = False
    _functorch_config.enable_autograd_cache = False
