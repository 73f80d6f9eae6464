"""Pass 2 — the AST repo-lint over ``protocol_tpu_torch/``: hazards
mypy/ruff don't model, each an implicit host sync or an import-cost
hazard that the runtime step leg (``analysis/step.py``) sees only for
the registered backends.

**Traced functions.**  The reference calls a function traced when a
``jit`` or ``shard_map`` decorator makes its body run once at trace
time.  The port has no such decorator: its counterpart is
:data:`TRACED_FUNCTIONS`, a table of ``file::qualname`` entries naming
the functions that run inside a converge's loop (every backend's step
function, ``damp``, ``run_power_iteration``, the converge entries and
the sharded steps).  A function nested in a traced one is traced too.
Every entry must resolve to a function in the tree; a stale entry is an
error (``stale-traced-entry``).  Where the reference's trace-time lie
is a host read, the port's is a host sync once per step.

- ``host-op-in-jit`` (error): ``np.*`` calls, ``.item()``, ``.cpu()``,
  ``.numpy()``, ``.tolist()``, or ``float()``/``int()``/``bool()`` on a
  non-literal inside a traced function: each forces a device-to-host
  copy and a sync per call.
- ``import-time-jnp`` (error, hot trees only): ``jnp.*`` array
  construction at module scope in ``ops/``, ``trust/``, ``parallel/``,
  ``node/``, ``obs/`` (kept from the reference; the port imports no
  ``jnp``, so it guards against one creeping in).
- ``bare-sync`` (error): a bare ``jax.device_get(...)``,
  ``x.block_until_ready()`` or ``torch.cuda.synchronize()`` expression
  statement whose result is discarded — a synchronization point that
  belongs in ``bench/`` (exempt) or ``tests/``, not in library code.

Pass 3 — the observability-boundary rules (the obs subsystem's
"spans only at host boundaries" doctrine, enforced structurally):

- ``host-clock-in-jit`` (error): ``time.time()``/``perf_counter()``/
  ``monotonic()`` (or an obs span) inside a traced function (a
  :data:`TRACED_FUNCTIONS` entry, or any function nested in one).  A
  clock read there runs once a step, between kernel launches, and reads
  the host's launch time, not the device's; per-iteration data belongs
  in the device-side residual history
  (``ops.sparse.run_power_iteration``), host timing at the converge
  boundary.
- ``logging-in-jit`` (error): ``logging``/``logger.*``/``log.*`` or
  ``print`` calls inside a traced function — host work once a step in
  the hot loop, and a formatted tensor is a host sync.
- ``clock-in-kernel-tree`` (error): any use of the ``time`` or
  ``logging`` modules (or ``print``) anywhere in the device-kernel
  trees ``ops/`` and ``parallel/`` — instrumentation wraps kernels
  from the outside (``trust/backend.py``, ``node/``); the kernel
  modules themselves stay clock- and logger-free so no refactor can
  quietly move a host boundary inside one.

Pass 4 — the epoch-pipeline boundary rule:

- ``plan-mutation-in-converge`` (error): a ``WindowPlan`` mutation
  entry point (``apply_delta``/``replace_rows``) called inside a
  traced function.  Delta application is host-side layout surgery
  (numpy repacks, counting sorts) and must run strictly pre-dispatch
  — in ``Manager.prepare_epoch`` or the backend's plan-resolution
  step — never from the device-facing converge path, where it would
  trace host arrays into the kernel (or silently run once at trace
  time and serve a stale layout forever after).

Pass 5 — the flight-recorder boundary rule:

- ``journal-write-in-jit`` (error): a flight-recorder write
  (``JOURNAL.record``/``dump``/``flush`` or any
  ``record``/``dump``/``flush`` on a journal-named receiver) inside a
  traced function: one event a step floods the ring, and recording a
  tensor syncs the host with the device every iteration.  Journal
  writes happen at host boundaries (epoch tick, ingest, pipeline),
  exactly like spans and metrics.

Pass 6 — the admission-plane boundary rule:

- ``blocking-ingest-in-epoch-loop`` (error): synchronous signature
  verification (``verify_sig``/``eddsa_verify_batch``/
  ``verify_batch`` or the Manager ingest entry points
  ``add_attestation``/``add_attestations_bulk``), or a potentially
  unbounded blocking queue ``put()`` (no ``block=False``, no
  ``timeout=``), inside the epoch-loop code paths
  (``node/epoch.py`` / ``node/pipeline.py``).  Admission work
  belongs in the ingest plane (``protocol_tpu_torch/ingest/``) behind its
  bounded queues; a signature check or an unbounded enqueue on the
  epoch path would re-couple the convergence cadence to ingest load
  — exactly the contention the admission tier exists to remove.

Pass 10 — the queue-observability rule:

- ``unobserved-queue`` (error): a bounded ``queue.Queue(maxsize=...)``
  constructed in a file with no queue-depth gauge write (a
  ``*QUEUE_DEPTH*.set(...)`` call, or a gauge registration whose
  metric name contains ``queue_depth``).  Every bounded queue is a
  backpressure point: when it fills, something sheds, coalesces, or
  blocks — and if its depth is not a first-class gauge, "the tier is
  saturated" degrades from a scrape to a guess.  The rule is
  file-scoped (the depth write lives next to the queue it observes);
  rings (``deque(maxlen=...)``) are excluded — they overwrite, never
  exert backpressure.

Pass 11 — the durability rules:

- ``non-atomic-state-write`` (error): a state-file write in ``node/``
  outside the sanctioned shapes — ``open()``/``os.fdopen()`` with a
  write/append mode, ``.write_text()``, or ``.write_bytes()`` in a
  function that is neither the checkpoint store's ``_atomic_write``
  helper (tmp + fsync + rename) nor fsync-disciplined (no ``fsync``
  call in the same function, the WAL's append path shape).  A bare
  ``open(path, "w")`` can be torn by a crash mid-write and the next
  boot reads garbage; durable node state goes through the atomic
  helper or carries its own fsync.
- ``fault-point-in-jit`` (error): a chaos hook (``chaos.fire`` /
  ``chaos.corrupt`` / ``chaos.wrap_file`` or any chaos-named
  receiver) inside a traced function: it would fire between the
  kernel launches of one step, a point no fault schedule covers, and
  a hook that reads a tensor syncs the host every step.  Fault points
  live at host boundaries, the same doctrine as spans (pass 3) and
  journal writes (pass 5).

Pass 12 — the memory-wall rules (evaluated by the memory pass,
``python -m protocol_tpu_torch.analysis --pass memory``, against the
long-lived node trees, with findings routed through the enumerated
``analysis/memory/waivers.py`` table):

- ``host-materialization-of-edges`` (error): ``np.asarray`` /
  ``np.array`` / ``jax.device_get`` on an edge-scale array (or an
  edge-scale ``.tolist()``, ``.cpu()`` or ``.numpy()``) on the epoch
  loop's critical path
  (``node/epoch.py`` / ``node/pipeline.py``).  An edge table is
  hundreds of MB at the 50M-edge shape; materializing one on the host
  per tick doubles the footprint and serializes a device->host copy
  into the epoch cadence.  Edge-scale host work is plan build
  (``Manager.prepare_epoch``), never the loop.
- ``unbounded-cache-growth`` (error): a cache-named dict/list
  attribute (``*cache*``) of a long-lived class in ``node/`` or
  ``ingest/`` that grows (subscript store / ``append`` / ``add`` /
  ``update`` / ``setdefault``) with no eviction anywhere in the class
  — no ``pop``/``popitem``/``clear``, no ``del``, no generation
  rotation (reassignment outside ``__init__``).  The ingest dedup
  cache's two-generation rotation and the pipeline's outcome ring set
  the precedent for what "bounded" looks like; an epoch-keyed cache
  without eviction leaks with uptime (a cached f32[N] score vector
  per epoch is 4 MB/epoch at 1M peers — 34 GB/day at a 10 s cadence).

Pass 9 — the proving-plane boundary rule:

- ``blocking-prove-in-epoch-loop`` (error): a synchronous prover
  entry point (``plonk.prove`` / ``prover.prove`` /
  ``calculate_proofs`` / ``prove_epoch_statement`` /
  ``aggregate_proofs`` or the aggregator's ``accumulate``) inside
  the epoch-loop code paths (``node/epoch.py`` /
  ``node/pipeline.py``).  A SNARK is seconds of whole-core native
  work; on the epoch path it re-serializes proving into the epoch
  cadence — the exact coupling the async proving plane
  (``protocol_tpu_torch/prover/``) exists to remove.  Epoch-loop code
  enqueues a :class:`~protocol_tpu_torch.prover.jobs.ProofJob` and moves
  on; proving belongs in the plane's worker pool.

Findings on the port's own tree that a later item removes are entered
in :data:`AST_WAIVERS`, each with its reason and that item; the table
is enumerated and stale-tested like the other passes' (a waiver that
matches no live finding is itself an error).
"""

from __future__ import annotations

import ast
from pathlib import Path

from .concurrency.waivers import Waiver, apply_waivers
from .report import Finding

#: Trees where import-time device work is a hard error (the modules the
#: node imports on its boot path).
HOT_TREES = ("ops", "trust", "parallel", "node", "obs")

#: Device-kernel trees: no clock, no logging, no print anywhere — the
#: obs instrumentation layer wraps these modules from the outside
#: (trust/backend.py, node/), never from within.
KERNEL_TREES = ("ops", "parallel")

#: The epoch loop's critical path: no synchronous signature
#: verification, no unbounded blocking queue puts (pass 6) — ingest
#: work stays in the admission plane behind its bounded queues.
EPOCH_LOOP_FILES = (
    "protocol_tpu_torch/node/epoch.py",
    "protocol_tpu_torch/node/pipeline.py",
)

#: jnp attributes that are plain dtypes/constants, not array factories.
_JNP_DTYPE_NAMES = frozenset(
    {
        "bfloat16",
        "bool_",
        "complex64",
        "complex128",
        "dtype",
        "finfo",
        "float16",
        "float32",
        "float64",
        "iinfo",
        "inf",
        "int8",
        "int16",
        "int32",
        "int64",
        "nan",
        "newaxis",
        "pi",
        "uint8",
        "uint16",
        "uint32",
        "uint64",
    }
)

_NUMPY_ALIASES = frozenset({"np", "numpy"})
_JNP_ALIASES = frozenset({"jnp"})


def _dotted(node: ast.expr) -> str | None:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


#: The port's traced functions, ``file::qualname`` (a qualname is the
#: dotted chain of enclosing classes and functions): the functions that
#: run inside a converge's loop, the counterpart of the reference's
#: ``jit``- and ``shard_map``-decorated ones.  A function nested in one
#: is traced too.  ``row_run_ptr`` runs in ``converge_windowed``'s entry
#: on every call, where the reference derives its counterpart inside the
#: jit'd converge.
TRACED_FUNCTIONS: tuple[str, ...] = (
    "protocol_tpu_torch/ops/sparse.py::damp",
    "protocol_tpu_torch/ops/sparse.py::gathered_rowsum",
    "protocol_tpu_torch/ops/sparse.py::power_step_csr",
    "protocol_tpu_torch/ops/sparse.py::power_step_coo",
    "protocol_tpu_torch/ops/sparse.py::run_power_iteration",
    "protocol_tpu_torch/ops/sparse.py::converge_csr",
    "protocol_tpu_torch/ops/sparse.py::converge_sparse",
    "protocol_tpu_torch/ops/gather_window.py::row_run_ptr",
    "protocol_tpu_torch/ops/gather_window.py::windowed_ct",
    "protocol_tpu_torch/ops/gather_window.py::power_step_windowed",
    "protocol_tpu_torch/ops/gather_window.py::converge_windowed",
    "protocol_tpu_torch/ops/dense.py::converge_dense",
    "protocol_tpu_torch/ops/dense.py::filter_and_normalize",
    "protocol_tpu_torch/ops/dense.py::set_converge_dense",
    "protocol_tpu_torch/parallel/sharded.py::all_reduce_sum",
    "protocol_tpu_torch/parallel/sharded.py::ShardedTrustProblem.partial_ct",
    "protocol_tpu_torch/parallel/sharded.py::ShardedWindowPlan.partial_ct",
    "protocol_tpu_torch/parallel/sharded.py::sharded_step.step",
)


def traced_table(rel_path: str, table: tuple[str, ...] = TRACED_FUNCTIONS) -> frozenset[str]:
    """The qualnames ``table`` marks traced in the file ``rel_path``."""
    out = set()
    for entry in table:
        path, _, qualname = entry.partition("::")
        if path == rel_path:
            out.add(qualname)
    return frozenset(out)


def _qualnames(tree: ast.Module) -> set[str]:
    """Every function's qualname in a parsed module."""
    out: set[str] = set()

    def walk(node: ast.AST, prefix: tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                name = prefix + (child.name,)
                if not isinstance(child, ast.ClassDef):
                    out.add(".".join(name))
                walk(child, name)
            else:
                walk(child, prefix)

    walk(tree, ())
    return out


def stale_traced_entries(
    root: str | Path | None = None, table: tuple[str, ...] = TRACED_FUNCTIONS
) -> list[Finding]:
    """One ``stale-traced-entry`` error for each table entry that names
    no file or no function of the tree under ``root``."""
    root = Path(root) if root is not None else Path(__file__).resolve().parents[2]
    findings = []
    parsed: dict[str, set[str] | None] = {}
    for entry in table:
        path, _, qualname = entry.partition("::")
        if path not in parsed:
            file = root / path
            parsed[path] = _qualnames(ast.parse(file.read_text())) if file.is_file() else None
        names = parsed[path]
        if names is None or qualname not in names:
            findings.append(
                Finding(
                    pass_name="ast",
                    rule="stale-traced-entry",
                    severity="error",
                    message=f"TRACED_FUNCTIONS entry {entry!r} names no function in the "
                    "tree; a renamed or removed step must take its entry with it",
                    file=path,
                )
            )
    return findings


#: Tensor methods that copy device values to the host (``host-op-in-jit``).
_HOST_READ_METHODS = frozenset({"item", "cpu", "numpy", "tolist"})
#: Builtins that read a tensor's value on the host (``host-op-in-jit``).
_HOST_READ_CASTS = frozenset({"float", "int", "bool"})
#: Whole-device synchronizations whose result a statement discards
#: (``bare-sync``).
_BARE_SYNC_CALLS = frozenset({"jax.device_get", "torch.cuda.synchronize"})


def _is_literal(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) or (
        isinstance(node, ast.UnaryOp) and isinstance(node.operand, ast.Constant)
    )


#: Host clock reads (module-qualified and ``from time import ...`` bare
#: forms) — pass-3 hazards inside traced functions and kernel trees.
_CLOCK_CALLS = frozenset(
    {
        "time.time",
        "time.time_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "time.monotonic",
        "time.monotonic_ns",
        "time.process_time",
        "perf_counter",
        "perf_counter_ns",
        "monotonic",
        "monotonic_ns",
    }
)
_LOGGING_METHODS = frozenset(
    {"debug", "info", "warning", "warn", "error", "exception", "critical", "log"}
)


def _is_clock_call(name: str | None) -> bool:
    return name is not None and name in _CLOCK_CALLS


def _is_logging_call(name: str | None) -> bool:
    """``logging.*``, ``log.<level>``/``logger.<level>``/``self.log.*``
    receivers, and bare ``print``."""
    if name is None:
        return False
    if name == "print":
        return True
    root, _, rest = name.partition(".")
    if root == "logging":
        return True
    leaf = name.rsplit(".", 1)[-1]
    receiver = name.rsplit(".", 2)[-2] if "." in name else ""
    return leaf in _LOGGING_METHODS and receiver in ("log", "logger")


#: WindowPlan mutation entry points — host-side layout surgery that
#: must never run under a trace (pass 4).
_PLAN_MUTATION_METHODS = frozenset({"apply_delta", "replace_rows"})


def _is_plan_mutation_call(name: str | None) -> bool:
    """``<anything>.apply_delta(...)`` / ``<anything>.replace_rows(...)``
    — the delta surface is small and uniquely named, so matching the
    method leaf is precise enough for a lint."""
    return name is not None and name.rsplit(".", 1)[-1] in _PLAN_MUTATION_METHODS


#: Flight-recorder write entry points (pass 5).
_JOURNAL_METHODS = frozenset({"record", "dump", "flush"})


def _is_journal_call(name: str | None) -> bool:
    """``JOURNAL.<write>(...)`` or ``<journalish>.<write>(...)`` where
    the receiver names a journal/flight recorder — matching the method
    leaf alone would catch unrelated ``.record()`` APIs, so the
    receiver must look like the recorder."""
    if name is None or "." not in name:
        return False
    receiver, leaf = name.rsplit(".", 1)
    if leaf not in _JOURNAL_METHODS:
        return False
    tail = receiver.rsplit(".", 1)[-1].lower()
    return "journal" in tail or "flight" in tail or tail == "recorder"


#: Synchronous signature-verification entry points (pass 6): the
#: crypto verifiers and the Manager ingest methods that call them.
_SYNC_VERIFY_LEAVES = frozenset(
    {
        "verify_sig",
        "eddsa_verify_batch",
        "verify_batch",
        "add_attestation",
        "add_attestations_bulk",
    }
)


def _is_sync_verify_call(name: str | None) -> bool:
    return name is not None and name.rsplit(".", 1)[-1] in _SYNC_VERIFY_LEAVES


#: Synchronous proving entry points (pass 9): the PLONK/commitment
#: prove surface, the statement synthesizer, and the aggregator —
#: seconds of whole-core native work that must never run on the epoch
#: loop's critical path (the proving plane's job queue is the only
#: sanctioned hand-off).  ``submit``/``prove_job`` via the plane pass.
_SYNC_PROVE_LEAVES = frozenset(
    {
        "prove",
        "calculate_proofs",
        "prove_epoch_statement",
        "aggregate_proofs",
        "accumulate",
    }
)


def _is_sync_prove_call(name: str | None) -> bool:
    return name is not None and name.rsplit(".", 1)[-1] in _SYNC_PROVE_LEAVES


def _is_unbounded_put(node: ast.Call, name: str | None) -> bool:
    """``<q>.put(item)`` with neither ``block=False`` nor a
    ``timeout=`` — a potentially unbounded block.  ``put_nowait`` and
    explicitly-bounded puts pass."""
    if name is None or name.rsplit(".", 1)[-1] != "put":
        return False
    if not isinstance(node.func, ast.Attribute):
        return False
    if len(node.args) >= 2:  # explicit positional block arg
        return False
    for kw in node.keywords:
        if kw.arg in ("block", "timeout"):
            return False
    return True


#: Bounded-queue constructors the unobserved-queue rule tracks
#: (pass 10).  Rings (deque(maxlen=...)) are excluded by design: they
#: overwrite instead of backing pressure up, so depth is not a
#: saturation signal there.
_QUEUE_CONSTRUCTORS = frozenset({"queue.Queue", "Queue", "queue.PriorityQueue", "queue.LifoQueue"})


def _is_bounded_queue_ctor(node: ast.Call, name: str | None) -> bool:
    """``queue.Queue(maxsize=N)`` (or positional) with a bound that is
    not literally 0/None — an unbounded queue has no depth-saturation
    semantics to observe."""
    if name not in _QUEUE_CONSTRUCTORS:
        return False
    bound: ast.expr | None = None
    if node.args:
        bound = node.args[0]
    for kw in node.keywords:
        if kw.arg == "maxsize":
            bound = kw.value
    if bound is None:
        return False
    if isinstance(bound, ast.Constant) and not bound.value:
        return False  # maxsize=0/None = unbounded
    if (
        isinstance(bound, ast.UnaryOp)
        and isinstance(bound.operand, ast.Constant)
    ):
        return False  # maxsize=-1 = unbounded
    return True


def _is_depth_gauge_write(node: ast.Call, name: str | None) -> bool:
    """A queue-depth observation: ``<...QUEUE_DEPTH...>.set(...)`` on
    the metric registry, or a ``.gauge("...queue_depth...")``
    registration."""
    if name is None:
        return False
    receiver, _, leaf = name.rpartition(".")
    if leaf == "set" and "queue_depth" in receiver.lower():
        return True
    if leaf == "gauge" and node.args:
        first = node.args[0]
        return (
            isinstance(first, ast.Constant)
            and isinstance(first.value, str)
            and "queue_depth" in first.value.lower()
        )
    return False


#: Pass-12 host-materialization entry points: calls that force a full
#: device->host copy of their operand.
_MATERIALIZE_CALLS = frozenset(
    {"np.asarray", "np.array", "numpy.asarray", "numpy.array", "jax.device_get"}
)

#: Tensor methods that copy their receiver to the host.
_HOST_COPY_METHODS = frozenset({"tolist", "cpu", "numpy"})

#: Identifier tokens that mark an array as edge-scale (the O(E) data:
#: edge endpoints/weights, window-plan rows/slots, segment tables).
_EDGE_NAME_TOKENS = frozenset(
    {"src", "dst", "edge", "edges", "weight", "weights", "wid", "seg",
     "segs", "local"}
)


def _is_edge_name(name: str | None) -> bool:
    """True when a dotted name's leaf looks like an edge-scale array
    (``plan.seg_dst``, ``graph.src``, ``self._edge_weights``)."""
    if name is None:
        return False
    leaf = name.rsplit(".", 1)[-1].lower()
    return any(tok in _EDGE_NAME_TOKENS for tok in leaf.split("_") if tok)


def _materialized_edge_name(node: ast.Call, name: str | None) -> str | None:
    """The edge-scale dotted name a pass-12 materialization call moves
    to the host, or None: ``np.asarray(<edge>)`` / ``jax.device_get(
    <edge>)`` by first argument, ``<edge>.tolist()`` by receiver."""
    if name is None:
        return None
    if name in _MATERIALIZE_CALLS and node.args:
        arg = _dotted(node.args[0])
        if _is_edge_name(arg):
            return f"{name}({arg})"
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _HOST_COPY_METHODS and "." in name:
        receiver = name.rsplit(".", 1)[0]
        if _is_edge_name(receiver):
            return f"{receiver}.{leaf}()"
    return None


#: Pass-12 cache-growth bookkeeping: cache-named attributes, the calls
#: that grow them, and the calls that count as eviction.
_CACHE_GROW_LEAVES = frozenset({"append", "add", "update", "setdefault"})
_CACHE_EVICT_LEAVES = frozenset({"pop", "popitem", "clear"})


def _is_cache_attr_name(attr: str) -> bool:
    return "cache" in attr.lower()


def _empty_container_ctor(value: ast.expr) -> bool:
    """``{}`` / ``[]`` / ``dict(...)`` / ``list()`` / ``defaultdict(...)``
    — the shapes a growable cache starts from."""
    if isinstance(value, (ast.Dict, ast.List)):
        return True
    if isinstance(value, ast.Call):
        ctor = _dotted(value.func)
        return ctor is not None and ctor.rsplit(".", 1)[-1] in (
            "dict", "list", "defaultdict", "OrderedDict",
        )
    return False


def _self_attr(node: ast.expr) -> str | None:
    """``self.<attr>`` -> attr name, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


#: Chaos hook entry points (pass 11): host-boundary-only, like spans.
_CHAOS_LEAVES = frozenset({"fire", "corrupt", "wrap_file"})


def _is_chaos_call(name: str | None) -> bool:
    """``chaos.fire(...)`` / ``CHAOS.corrupt(...)`` / any
    chaos-named receiver calling a hook leaf."""
    if name is None or "." not in name:
        return False
    receiver, leaf = name.rsplit(".", 1)
    if leaf not in _CHAOS_LEAVES:
        return False
    return "chaos" in receiver.rsplit(".", 1)[-1].lower()


#: File-write entry points the non-atomic-state-write rule tracks
#: (pass 11).  ``.write()`` on an already-open handle is exempt — the
#: open is the decision point.
_WRITE_OPENERS = frozenset({"open", "os.fdopen", "io.open", "gzip.open"})
_WRITE_METHOD_LEAVES = frozenset({"write_text", "write_bytes"})
_WRITE_MODES = frozenset("wax+")


def _is_state_write_call(node: ast.Call, name: str | None) -> bool:
    """An ``open()``-family call with a write/append/create mode, or a
    pathlib ``.write_text()``/``.write_bytes()``."""
    if name is None:
        return False
    if name.rsplit(".", 1)[-1] in _WRITE_METHOD_LEAVES and isinstance(
        node.func, ast.Attribute
    ):
        return True
    if name not in _WRITE_OPENERS:
        return False
    mode: ast.expr | None = node.args[1] if len(node.args) >= 2 else None
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    return (
        isinstance(mode, ast.Constant)
        and isinstance(mode.value, str)
        and bool(set(mode.value) & _WRITE_MODES)
    )


def _is_fsync_call(name: str | None) -> bool:
    return name is not None and name.rsplit(".", 1)[-1] == "fsync"


def _is_span_call(name: str | None) -> bool:
    """obs span entry points (``TRACER.span``/``TRACER.epoch`` or any
    ``*.span(...)``) — host boundaries by definition, so inside a
    traced function they are always a bug."""
    if name is None:
        return False
    return name.endswith(".span") or name in ("TRACER.epoch", "TRACER.span")


class _Visitor(ast.NodeVisitor):
    def __init__(
        self,
        rel_path: str,
        hot: bool,
        kernel_tree: bool = False,
        epoch_loop: bool = False,
        node_tree: bool = False,
        mem_rules: bool = False,
        traced: frozenset[str] = frozenset(),
        bench_tree: bool = False,
    ) -> None:
        self.rel_path = rel_path
        #: Qualnames of this file's traced functions (``TRACED_FUNCTIONS``).
        self.traced = traced
        #: ``bench/`` may synchronize: timing is what it is for.
        self.bench_tree = bench_tree
        #: Enclosing class and function names, for qualnames.
        self._scope: list[str] = []
        self.hot = hot
        self.kernel_tree = kernel_tree
        self.epoch_loop = epoch_loop
        self.node_tree = node_tree
        #: Pass-12 rules armed (the memory pass scans the long-lived
        #: trees with these on; the plain AST pass leaves them off so
        #: findings are never double-reported across passes).
        self.mem_rules = mem_rules
        #: Pass-12 per-class state: cache-named container attrs
        #: initialized in __init__ vs growth/eviction evidence,
        #: resolved when the ClassDef closes.
        self._class_frames: list[dict] = []
        #: Pass-11 per-function state: write sites collected until the
        #: function closes, when the _atomic_write/fsync exemptions
        #: resolve (the discipline lives in the same function as the
        #: open, by doctrine).
        self._fn_frames: list[dict] = []
        #: Depth inside traced functions (a table entry or nested in one).
        self.traced_depth = 0
        self.fn_depth = 0
        self.findings: list[Finding] = []
        #: Pass-10 file-level state: bounded-queue construction sites
        #: vs whether any queue-depth gauge write exists in this file
        #: (resolved after the walk, in scan_source).
        self.bounded_queue_sites: list[ast.AST] = []
        self.has_depth_gauge = False

    def _where(self) -> str:
        """The qualname of the function being visited."""
        return ".".join(self._scope)

    def _emit(self, rule: str, message: str, node: ast.AST) -> None:
        self.findings.append(
            Finding(
                pass_name="ast",
                rule=rule,
                severity="error",
                message=message,
                file=self.rel_path,
                line=getattr(node, "lineno", None),
            )
        )

    # -- function scope tracking ---------------------------------------

    def _visit_function(self, node: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        self._scope.append(node.name)
        traced = ".".join(self._scope) in self.traced
        self.fn_depth += 1
        self.traced_depth += 1 if traced else 0
        self._fn_frames.append({"name": node.name, "writes": [], "fsync": False})
        self.generic_visit(node)
        frame = self._fn_frames.pop()
        if (
            frame["writes"]
            and not frame["name"].startswith("_atomic_write")
            and not frame["fsync"]
        ):
            for site in frame["writes"]:
                self._emit_state_write(site)
        self.traced_depth -= 1 if traced else 0
        self.fn_depth -= 1
        self._scope.pop()

    def _emit_state_write(self, site: ast.AST) -> None:
        self._emit(
            "non-atomic-state-write",
            "state-file write in node/ outside the _atomic_write helper "
            "and without fsync discipline in the same function — a crash "
            "mid-write tears the file and the next boot reads garbage; "
            "route durable state through CheckpointStore._atomic_write "
            "(tmp + fsync + rename) or fsync what you append "
            "(node/wal.py)",
            site,
        )

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- pass 12: unbounded cache growth (class-scoped) ------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        try:
            self._visit_class(node)
        finally:
            self._scope.pop()

    def _visit_class(self, node: ast.ClassDef) -> None:
        if not self.mem_rules:
            self.generic_visit(node)
            return
        self._class_frames.append(
            {"inits": {}, "grows": set(), "evicts": set()}
        )
        self.generic_visit(node)
        frame = self._class_frames.pop()
        for attr, site in frame["inits"].items():
            if attr in frame["grows"] and attr not in frame["evicts"]:
                self._emit(
                    "unbounded-cache-growth",
                    f"cache attribute {node.name}.{attr} of a long-lived "
                    f"class grows with no eviction, size bound, or "
                    f"epoch rotation anywhere in the class — an "
                    f"epoch-keyed cache without eviction leaks with "
                    f"uptime (the ingest dedup cache's generation "
                    f"rotation and the pipeline's outcome ring are the "
                    f"sanctioned shapes)",
                    site,
                )

    def _in_init(self) -> bool:
        return bool(self._fn_frames) and self._fn_frames[-1]["name"] == "__init__"

    def _note_cache_assign(self, target: ast.expr, value: ast.expr | None,
                           node: ast.stmt) -> None:
        """Pass-12 bookkeeping for one assignment statement."""
        if not self._class_frames:
            return
        frame = self._class_frames[-1]
        if isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
            if attr is not None and _is_cache_attr_name(attr):
                frame["grows"].add(attr)
            return
        attr = _self_attr(target)
        if attr is None or not _is_cache_attr_name(attr):
            return
        if self._in_init():
            if value is not None and _empty_container_ctor(value):
                frame["inits"][attr] = node
        else:
            # Reassignment outside __init__ is generation rotation —
            # the dedup-cache shape — and counts as eviction.
            frame["evicts"].add(attr)

    def visit_Assign(self, node: ast.Assign) -> None:
        if self.mem_rules:
            for target in node.targets:
                self._note_cache_assign(target, node.value, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if self.mem_rules:
            self._note_cache_assign(node.target, node.value, node)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        if self.mem_rules and self._class_frames:
            for target in node.targets:
                if isinstance(target, ast.Subscript):
                    attr = _self_attr(target.value)
                    if attr is not None and _is_cache_attr_name(attr):
                        self._class_frames[-1]["evicts"].add(attr)
        self.generic_visit(node)

    # -- rules ----------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        # Pass 10 bookkeeping: bounded-queue constructions vs depth-
        # gauge writes, resolved per-file after the walk.
        if _is_bounded_queue_ctor(node, name):
            self.bounded_queue_sites.append(node)
        elif _is_depth_gauge_write(node, name):
            self.has_depth_gauge = True
        if self.mem_rules and self._class_frames and isinstance(
            node.func, ast.Attribute
        ):
            # Pass-12 bookkeeping: self.<cache>.append/add/update grows,
            # self.<cache>.pop/popitem/clear evicts.
            attr = _self_attr(node.func.value)
            if attr is not None and _is_cache_attr_name(attr):
                if node.func.attr in _CACHE_GROW_LEAVES:
                    self._class_frames[-1]["grows"].add(attr)
                elif node.func.attr in _CACHE_EVICT_LEAVES:
                    self._class_frames[-1]["evicts"].add(attr)
        if self.mem_rules and self.epoch_loop:
            # Pass 12: no edge-scale host materialization on the epoch
            # loop's critical path — an edge table is hundreds of MB at
            # the 50M-edge shape, and the copy serializes into the tick.
            offender = _materialized_edge_name(node, name)
            if offender is not None:
                self._emit(
                    "host-materialization-of-edges",
                    f"{offender} on an epoch-loop code path materializes "
                    "an edge-scale array on the host: O(E) bytes copied "
                    "device->host per tick, doubling the footprint the "
                    "memory budgets pin — edge-scale host work belongs "
                    "in plan build (Manager.prepare_epoch), never the "
                    "loop",
                    node,
                )
        if self.node_tree:
            # Pass 11 bookkeeping: write sites vs the enclosing
            # function's fsync discipline (resolved at function close;
            # module-scope writes have no exemption to wait for).
            if _is_fsync_call(name) and self._fn_frames:
                self._fn_frames[-1]["fsync"] = True
            elif _is_state_write_call(node, name):
                if self._fn_frames:
                    self._fn_frames[-1]["writes"].append(node)
                else:
                    self._emit_state_write(node)
        if self.traced_depth > 0:
            if name is not None:
                root = name.split(".", 1)[0]
                if root in _NUMPY_ALIASES:
                    self._emit(
                        "host-op-in-jit",
                        f"{name}() inside traced {self._where()} materializes "
                        "device values on the host",
                        node,
                    )
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_READ_METHODS
                and not node.args
            ):
                self._emit(
                    "host-op-in-jit",
                    f".{node.func.attr}() inside traced {self._where()} forces a "
                    "host sync",
                    node,
                )
            if (
                name in _HOST_READ_CASTS
                and node.args
                and not _is_literal(node.args[0])
            ):
                self._emit(
                    "host-op-in-jit",
                    f"{name}() on a non-literal inside traced {self._where()} "
                    "reads a device value on the host",
                    node,
                )
        if self.traced_depth > 0:
            # Pass 3: the obs boundary doctrine — no clocks, spans, or
            # logging inside traced code (jit or shard_map bodies).
            if _is_clock_call(name) or _is_span_call(name):
                self._emit(
                    "host-clock-in-jit",
                    f"{name}() inside traced {self._where()} reads the host "
                    "clock at trace time (spans/timing belong at the "
                    "jit boundary; per-iteration data in the loop carry)",
                    node,
                )
            elif _is_logging_call(name):
                self._emit(
                    "logging-in-jit",
                    f"{name}() inside traced {self._where()} executes once "
                    "at trace time, not per call — log at the host "
                    "boundary instead",
                    node,
                )
            elif _is_journal_call(name):
                self._emit(
                    "journal-write-in-jit",
                    f"{name}() inside traced {self._where()} records once at "
                    "trace time and never again — flight-recorder writes "
                    "belong at host boundaries (epoch tick, ingest, "
                    "pipeline), never in traced code",
                    node,
                )
            elif _is_chaos_call(name):
                self._emit(
                    "fault-point-in-jit",
                    f"{name}() inside traced {self._where()} fires once at "
                    "trace time and never again — the chaos schedule "
                    "silently stops covering this point, and a callback "
                    "rewrite would smuggle a host sync into the kernel; "
                    "fault points live at host boundaries (pass 3/5 "
                    "doctrine)",
                    node,
                )
            elif _is_plan_mutation_call(name):
                self._emit(
                    "plan-mutation-in-converge",
                    f"{name}() inside traced {self._where()}: WindowPlan "
                    "delta application is host-side layout surgery and "
                    "must run pre-dispatch (Manager.prepare_epoch / the "
                    "backend's plan resolution), never from the "
                    "device-facing converge path",
                    node,
                )
        elif self.kernel_tree and (
            _is_clock_call(name) or _is_logging_call(name)
        ):
            self._emit(
                "clock-in-kernel-tree",
                f"{name}() in a device-kernel tree ({'/'.join(KERNEL_TREES)}): "
                "instrumentation wraps kernels from trust/ and node/, "
                "never from inside ops/ or parallel/",
                node,
            )
        if self.epoch_loop:
            # Pass 6: the epoch loop must never verify signatures or
            # block on an unbounded enqueue — admission work lives in
            # the ingest plane behind bounded queues.
            if _is_sync_verify_call(name):
                self._emit(
                    "blocking-ingest-in-epoch-loop",
                    f"{name}() on an epoch-loop code path: signature "
                    "verification belongs in the admission plane "
                    "(protocol_tpu_torch/ingest/), not in node/epoch.py or "
                    "node/pipeline.py where it re-couples convergence "
                    "cadence to ingest load",
                    node,
                )
            elif _is_unbounded_put(node, name):
                self._emit(
                    "blocking-ingest-in-epoch-loop",
                    f"{name}() without block=False or timeout= on an "
                    "epoch-loop code path: an unbounded blocking "
                    "enqueue can stall the epoch loop indefinitely — "
                    "use put_nowait (coalescing backpressure) or a "
                    "bounded timeout",
                    node,
                )
            elif _is_sync_prove_call(name):
                # Pass 9: the epoch loop never proves synchronously —
                # a SNARK is seconds of whole-core work; enqueue a
                # ProofJob on the proving plane instead.
                self._emit(
                    "blocking-prove-in-epoch-loop",
                    f"{name}() on an epoch-loop code path: synchronous "
                    "proving re-serializes the SNARK into the epoch "
                    "cadence — enqueue a ProofJob on the proving plane "
                    "(protocol_tpu_torch/prover/) and let the worker pool "
                    "prove it off the critical path",
                    node,
                )
        if (
            self.fn_depth == 0
            and self.hot
            and name is not None
            and name.split(".", 1)[0] in _JNP_ALIASES
        ):
            attr = name.split(".", 1)[1] if "." in name else ""
            if attr not in _JNP_DTYPE_NAMES:
                self._emit(
                    "import-time-jnp",
                    f"{name}() at module import time in a hot module "
                    "initializes the device backend as an import side "
                    "effect",
                    node,
                )
        self.generic_visit(node)

    def _check_kernel_import(self, node: ast.stmt, module: str | None) -> None:
        if self.kernel_tree and module is not None and module.split(".")[0] in (
            "time",
            "logging",
        ):
            self._emit(
                "clock-in-kernel-tree",
                f"import of {module!r} in a device-kernel tree — clocks "
                "and loggers stay outside ops/ and parallel/ (spans at "
                "host boundaries only)",
                node,
            )

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_kernel_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        self._check_kernel_import(node, node.module)
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr) -> None:
        if isinstance(node.value, ast.Call) and not self.bench_tree:
            name = _dotted(node.value.func)
            bare_sync = name in _BARE_SYNC_CALLS or (
                isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "block_until_ready"
            )
            if bare_sync:
                self._emit(
                    "bare-sync",
                    "bare device sync (result discarded) outside bench/ "
                    "and tests/",
                    node,
                )
        self.generic_visit(node)


def _in_tree(rel_path: str, trees: tuple[str, ...]) -> bool:
    parts = Path(rel_path).parts
    return len(parts) >= 2 and parts[0] == "protocol_tpu_torch" and parts[1] in trees


def _is_hot(rel_path: str) -> bool:
    return _in_tree(rel_path, HOT_TREES)


def scan_source(
    source: str,
    rel_path: str,
    mem_rules: bool = False,
    traced: frozenset[str] | set[str] | None = None,
) -> list[Finding]:
    """Run the AST ruleset over in-memory source (seeded violation
    fixtures use this; ``scan_file`` is the on-disk wrapper).
    ``mem_rules`` arms the pass-12 rules — the memory pass's AST leg;
    the plain AST pass leaves them off so the two passes never
    double-report.  ``traced`` names the file's traced functions by
    qualname; None takes them from :data:`TRACED_FUNCTIONS`."""
    try:
        tree = ast.parse(source, filename=rel_path)
    except SyntaxError as exc:
        return [
            Finding(
                pass_name="ast",
                rule="syntax-error",
                severity="error",
                message=str(exc),
                file=rel_path,
                line=exc.lineno,
            )
        ]
    visitor = _Visitor(
        rel_path,
        hot=_is_hot(rel_path),
        kernel_tree=_in_tree(rel_path, KERNEL_TREES),
        epoch_loop=rel_path in EPOCH_LOOP_FILES,
        node_tree=_in_tree(rel_path, ("node",)),
        mem_rules=mem_rules,
        traced=frozenset(traced_table(rel_path) if traced is None else traced),
        bench_tree=_in_tree(rel_path, ("bench",)),
    )
    visitor.visit(tree)
    if visitor.bounded_queue_sites and not visitor.has_depth_gauge:
        # Pass 10: every bounded queue is a backpressure point; its
        # depth must be a registered gauge in the same file, or
        # saturation is a guess instead of a scrape.
        for site in visitor.bounded_queue_sites:
            visitor._emit(
                "unobserved-queue",
                "bounded queue constructed with no queue-depth gauge "
                "write in this file — register a "
                "*_queue_depth gauge (obs/metrics.py) and .set() it "
                "where the queue's depth changes, so backpressure is "
                "scrapeable",
                site,
            )
    return visitor.findings


def scan_file(path: Path, root: Path) -> list[Finding]:
    rel = str(path.relative_to(root))
    return scan_source(path.read_text(), rel)


def run_ast_pass(
    root: str | Path | None = None,
    waivers: tuple[Waiver, ...] | None = None,
) -> tuple[list[Finding], dict]:
    """Scan ``protocol_tpu_torch/`` under ``root`` (default: the repo this
    package was imported from), check :data:`TRACED_FUNCTIONS` against
    the tree and apply the waiver table (default :data:`AST_WAIVERS`).
    Returns ``(live findings, ast section)``: the section holds the
    files scanned, the traced table, the waived findings and the stale
    waivers (each stale waiver is also a live ``stale-waiver`` error)."""
    if root is None:
        root = Path(__file__).resolve().parent.parent.parent
    root = Path(root)
    findings: list[Finding] = []
    files = sorted((root / "protocol_tpu_torch").rglob("*.py"))
    for path in files:
        findings.extend(scan_file(path, root))
    findings.extend(stale_traced_entries(root))
    live, waived, stale = apply_waivers(
        findings, AST_WAIVERS if waivers is None else waivers, "ast"
    )
    return live, {
        "files_scanned": len(files),
        "traced_functions": list(TRACED_FUNCTIONS),
        "waived": waived,
        "stale_waivers": stale,
    }


#: Enumerated findings on the port's own tree that a later item removes
#: (``Waiver``: rule, file substring, message substring, reason).
AST_WAIVERS: tuple[Waiver, ...] = (
    Waiver(
        rule="host-op-in-jit",
        file="protocol_tpu_torch/ops/sparse.py",
        symbol=".item() inside traced run_power_iteration",
        reason=(
            "The loop's exit test reads the residual on the host once an "
            "iteration at tol > 0, where the reference's while_loop keeps "
            "it on the device.  ROADMAP B7 removes it: k steps captured in "
            "a CUDA graph with the residual test on the device."
        ),
    ),
    Waiver(
        rule="host-op-in-jit",
        file="protocol_tpu_torch/ops/gather_window.py",
        symbol="traced row_run_ptr",
        reason=(
            "converge_windowed derives the rows' run pointers on every "
            "call and checks three of their values on the host, before "
            "its loop (one sync a converge, none a step).  ROADMAP A4c "
            "removes it: the pointers cached with the plan's device "
            "tensors, keyed by its fingerprint."
        ),
    ),
    Waiver(
        rule="clock-in-kernel-tree",
        file="protocol_tpu_torch/parallel/dryrun.py",
        symbol="device-kernel tree",
        reason=(
            "The sharded dry run is a tool (its rank programs time the "
            "converge and print one JSON line), placed in parallel/ "
            "beside the ranks it drives; no kernel or step calls it.  "
            "ROADMAP A13 moves the tools out of the kernel trees."
        ),
    ),
    Waiver(
        rule="bare-sync",
        file="protocol_tpu_torch/parallel/dryrun.py",
        symbol="bare device sync",
        reason=(
            "The dry run's rank programs synchronize the card before "
            "reading a clock (``_sync``): timing is the tool's job.  "
            "ROADMAP A13 moves the tools out of the kernel trees."
        ),
    ),
    Waiver(
        rule="clock-in-kernel-tree",
        file="protocol_tpu_torch/parallel/dryrun_pod.py",
        symbol="device-kernel tree",
        reason=(
            "The pod dry run is a tool (host-loss timings, its JSON "
            "line), placed in parallel/ beside the pod it drives; no "
            "kernel or step calls it.  ROADMAP A13 moves the tools out "
            "of the kernel trees."
        ),
    ),
    Waiver(
        rule="clock-in-kernel-tree",
        file="protocol_tpu_torch/parallel/launch.py",
        symbol="device-kernel tree",
        reason=(
            "run_ranks reads a monotonic clock for its launch deadline "
            "(ranks still running at timeout_s are killed) and sleeps "
            "stagger_s between two rank starts when a caller's schedule "
            "asks for it; neither times a kernel.  It spawns processes "
            "and runs in no step.  "
            "ROADMAP A13 moves the launcher out of the kernel trees with "
            "the dry runs."
        ),
    ),
)


#: Rules the memory pass's AST leg reports (everything else the armed
#: visitor would emit is the plain AST pass's job — filtering here
#: keeps ``--pass all`` from reporting the same finding twice).
MEM_AST_RULES = frozenset(
    {"host-materialization-of-edges", "unbounded-cache-growth"}
)

#: Long-lived trees the pass-12 AST rules police: the node (epoch loop,
#: manager, checkpoint) and admission-plane classes live for the
#: process, so an unevicted cache there leaks with uptime.
MEM_AST_TREES = ("node", "ingest")


def run_mem_ast_pass(root: str | Path | None = None) -> tuple[list[Finding], int]:
    """Pass 12's AST leg: scan the long-lived trees with the memory
    rules armed; returns ``(mem-rule findings, files scanned)``."""
    if root is None:
        root = Path(__file__).resolve().parent.parent.parent
    root = Path(root)
    findings: list[Finding] = []
    files = [
        path
        for tree in MEM_AST_TREES
        for path in sorted((root / "protocol_tpu_torch" / tree).rglob("*.py"))
    ]
    for path in files:
        rel = str(path.relative_to(root))
        found = scan_source(path.read_text(), rel, mem_rules=True)
        findings.extend(f for f in found if f.rule in MEM_AST_RULES)
    return findings, len(files)


__all__ = [
    "AST_WAIVERS",
    "EPOCH_LOOP_FILES",
    "HOT_TREES",
    "KERNEL_TREES",
    "MEM_AST_RULES",
    "MEM_AST_TREES",
    "run_ast_pass",
    "run_mem_ast_pass",
    "TRACED_FUNCTIONS",
    "scan_file",
    "scan_source",
    "stale_traced_entries",
    "traced_table",
]
