"""Pass 13's AST leg: divergence-feasible sources reaching bit-identity
sinks.

The pod substrate stakes correctness on *bit-identical* state across
hosts (per-epoch score digests before a manifest seals, WAL replay to a
control-identical fixed point, pooled proofs byte-equal to in-process
ones).  Every one of those invariants dies the same way: a Python-level
ordering or randomness source that is legal *within one process* leaks
into serialized state and differs *between* processes.  This walker
polices the source side over the trees that feed the sinks
(:data:`DET_TREES` — node/, parallel/, ingest/, prover/, models/):

- ``set-order-to-state`` — a set/frozenset iterated in hash order and
  materialized into a sequence, array, or accumulated float
  (``list(s)``, ``np.asarray(s)``, ``sum(s)``, a list comprehension or
  accumulating ``for`` over it).  CPython string hashes are salted per
  process (``PYTHONHASHSEED``), so set order is the canonical
  divergence source.  ``sorted(s)`` (or any order-insensitive consumer:
  ``len``/``min``/``max``/``any``/``all``/``set``) is the fix and stays
  quiet.
- ``unsorted-dirscan`` — ``os.listdir``/``os.scandir``/``glob.glob``/
  ``Path.glob``/``iterdir``/``rglob`` results consumed without a
  ``sorted(...)`` wrapper: directory scan order is filesystem- and
  history-dependent, so any state derived from it differs across hosts
  (and across reboots of the same host).
- ``hash-ordering`` — builtin ``hash()``/``id()`` influencing a key,
  index, or ordering.  ``hash(str)`` is salted per process; ``id()`` is
  an allocation address.  Even the currently-stable cases (tuples of
  ints) are CPython implementation details a bit-identity plane must
  not stand on.
- ``unseeded-rng`` — module-level ``random.*`` draws, ``random.Random()``
  with no seed, global ``np.random.*`` draws, or
  ``np.random.default_rng()`` with no seed: every draw diverges across
  hosts by construction.  Seeded constructors
  (``np.random.default_rng(seed)``) are the doctrine and stay quiet.
- ``clock-in-digest`` — a wall-clock / pid / uuid value flowing into a
  digest, a seed, or a name that will be treated as one (function-local
  taint: names assigned from ``time.time()``-family calls,
  ``os.getpid()``, or ``uuid.*`` are tainted; the finding fires when a
  tainted value reaches ``hashlib.*``, ``.update(...)``, an RNG
  constructor/seed, or a ``*seed``/``*digest``/``*nonce`` binding).
  Timing *measurement* (deltas into metrics) never reaches a sink and
  stays quiet.

The walker is deliberately source-side and tree-scoped rather than
whole-program: the trees it covers are exactly the ones whose values
reach the bit-identity sinks (WAL record bytes, checkpoint columns,
pod shard stamps + manifest seal, ProofJob ``job_seed`` fields, churn
draws, partition keys), so a source finding here is a sink finding by
construction — the runtime leg (``checker.py``: each backend's
converge replayed in this process and in a fresh one) closes the loop
end to end.
"""

from __future__ import annotations

import ast
from pathlib import Path

from ..report import Finding

#: Trees whose values reach a bit-identity sink: the node state plane
#: (WAL/checkpoint/pod manifests), the partitioner and pod plan, the
#: admission plane (shard keys, dedup verdicts), the proving plane
#: (job seeds, statement bytes), and the deterministic stream models.
DET_TREES = ("node", "parallel", "ingest", "prover", "models")

#: Rules this leg reports (the pass-12 filtering doctrine: a scoped
#: pass only reports its own rules, so ``--pass all`` never doubles).
DET_AST_RULES = frozenset(
    {
        "set-order-to-state",
        "unsorted-dirscan",
        "hash-ordering",
        "unseeded-rng",
        "clock-in-digest",
    }
)

# -- name helpers -----------------------------------------------------------


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


#: Order-insensitive consumers: feeding a set or a dirscan through one
#: of these launders the ordering dependence away.
_ORDER_INSENSITIVE = frozenset(
    {"sorted", "len", "min", "max", "any", "all", "set", "frozenset"}
)

#: Materializers that freeze an iterable's order into state.
_SEQ_MATERIALIZERS = frozenset({"list", "tuple", "enumerate"})
_NP_MATERIALIZERS = frozenset(
    {"array", "asarray", "fromiter", "stack", "concatenate"}
)

#: Dotted call names that scan a directory in filesystem order.
_DIRSCAN_DOTTED = frozenset(
    {"os.listdir", "os.scandir", "glob.glob", "glob.iglob"}
)
#: Attribute methods (on Path-likes) that do the same.
_DIRSCAN_METHODS = frozenset({"glob", "iglob", "rglob", "iterdir"})

#: Wall-clock / process-identity sources for the clock taint.
_CLOCK_DOTTED = frozenset(
    {
        "time.time",
        "time.time_ns",
        "time.monotonic",
        "time.monotonic_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "os.getpid",
        "uuid.uuid1",
        "uuid.uuid4",
        "datetime.now",
        "datetime.utcnow",
        "datetime.datetime.now",
        "datetime.datetime.utcnow",
    }
)

#: Module-level RNG draws (process-global state, never seeded per use).
_RANDOM_MODULE_FNS = frozenset(
    {
        "random.random",
        "random.randint",
        "random.randrange",
        "random.choice",
        "random.choices",
        "random.shuffle",
        "random.sample",
        "random.uniform",
        "random.gauss",
        "random.getrandbits",
    }
)
_NP_RANDOM_FNS = frozenset(
    {
        "rand",
        "randn",
        "randint",
        "random",
        "choice",
        "permutation",
        "shuffle",
        "random_sample",
        "standard_normal",
        "exponential",
        "integers",
    }
)

#: Digest-ish callables a tainted clock value must not reach.
_DIGEST_CALLS = frozenset(
    {
        "hashlib.sha256",
        "hashlib.sha1",
        "hashlib.sha512",
        "hashlib.sha3_256",
        "hashlib.blake2b",
        "hashlib.blake2s",
        "hashlib.md5",
        "hashlib.new",
    }
)
#: Seed-consuming constructors (a clock-derived seed is divergence).
_SEED_CALLS = frozenset(
    {"random.Random", "random.seed", "np.random.default_rng",
     "numpy.random.default_rng", "np.random.seed", "numpy.random.seed"}
)


def _is_np_random(dotted: str) -> bool:
    for prefix in ("np.random.", "numpy.random.", "jnp.random."):
        if dotted.startswith(prefix):
            return dotted[len(prefix):] in _NP_RANDOM_FNS
    return False


def _seedish_name(name: str) -> bool:
    low = name.rsplit(".", 1)[-1].lower()
    return low.endswith(("seed", "digest", "nonce")) or low in (
        "seed", "digest", "nonce"
    )


class _DetVisitor(ast.NodeVisitor):
    """One file's walk.  Scoping is function-local for taint and
    set-ness (module-level constants are walked in the module 'frame'):
    the rules are source-side, so a cross-function flow is the *next*
    function's finding when it materializes there."""

    def __init__(self, rel_path: str):
        self.rel_path = rel_path
        self.findings: list[Finding] = []
        #: Names (and ``self.x`` dotted attrs) known to hold sets.
        self._setish: set[str] = set()
        #: Names holding clock/pid/uuid-derived values.
        self._clock_tainted: set[str] = set()
        #: Enclosing order-insensitive consumer calls (sorted & co).
        self._insensitive_depth = 0

    # -- emit -------------------------------------------------------------

    def _emit(self, rule: str, message: str, node: ast.AST) -> None:
        self.findings.append(
            Finding(
                pass_name="determinism",
                rule=rule,
                severity="error",
                message=message,
                file=self.rel_path,
                line=getattr(node, "lineno", None),
            )
        )

    # -- set-ness ---------------------------------------------------------

    def _is_setish(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted in ("set", "frozenset"):
                return True
            # s.union(t), s.difference(t), ... on a known set.
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "union", "difference", "intersection", "symmetric_difference",
                "copy",
            ):
                return self._is_setish(node.func.value)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
        ):
            return self._is_setish(node.left) or self._is_setish(node.right)
        dotted = _dotted(node)
        return dotted is not None and dotted in self._setish

    def _set_annotation(self, ann: ast.AST | None) -> bool:
        if ann is None:
            return False
        base = ann.value if isinstance(ann, ast.Subscript) else ann
        dotted = _dotted(base)
        return dotted in ("set", "frozenset", "Set", "FrozenSet")

    # -- clock taint ------------------------------------------------------

    def _contains_clock(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                dotted = _dotted(sub.func)
                if dotted in _CLOCK_DOTTED:
                    return True
            dotted = _dotted(sub)
            if dotted is not None and dotted in self._clock_tainted:
                return True
        return False

    # -- assignments: track set-ness and taint ----------------------------

    def _record_target(self, target: ast.AST, value: ast.AST) -> None:
        dotted = _dotted(target)
        if dotted is None:
            return
        if self._is_setish(value):
            self._setish.add(dotted)
        else:
            self._setish.discard(dotted)
        if self._contains_clock(value):
            self._clock_tainted.add(dotted)
            if _seedish_name(dotted):
                self._emit(
                    "clock-in-digest",
                    f"wall-clock/pid-derived value bound to {dotted!r} — a "
                    "clock-derived seed/digest/nonce differs on every host "
                    "and replay; derive it from the statement or epoch "
                    "instead",
                    value,
                )
        else:
            self._clock_tainted.discard(dotted)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._record_target(target, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        dotted = _dotted(node.target)
        if dotted is not None and self._set_annotation(node.annotation):
            self._setish.add(dotted)
        if node.value is not None:
            self._record_target(node.target, node.value)
        self.generic_visit(node)

    # -- fresh scopes -----------------------------------------------------

    def _scoped_visit(self, node: ast.AST) -> None:
        saved_set, saved_taint = set(self._setish), set(self._clock_tainted)
        self.generic_visit(node)
        self._setish, self._clock_tainted = saved_set, saved_taint

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._scoped_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._scoped_visit(node)

    # -- calls: the rule dispatch -----------------------------------------

    def _is_dirscan(self, node: ast.Call) -> bool:
        dotted = _dotted(node.func)
        if dotted is not None and dotted in _DIRSCAN_DOTTED:
            return True
        return (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _DIRSCAN_METHODS
        )

    def _check_materialization(self, node: ast.Call) -> None:
        dotted = _dotted(node.func) or ""
        tail = dotted.rsplit(".", 1)[-1]
        is_join = isinstance(node.func, ast.Attribute) and node.func.attr == "join"
        is_mat = (
            dotted in _SEQ_MATERIALIZERS
            or tail in _NP_MATERIALIZERS
            or dotted in ("json.dumps",)
            or dotted == "sum"
            or is_join
        )
        if not is_mat:
            return
        for arg in node.args:
            probe = arg
            if isinstance(arg, ast.GeneratorExp):
                probe = arg.generators[0].iter
            if self._is_setish(probe):
                what = "sum() over" if dotted == "sum" else f"{tail or 'join'}() of"
                self._emit(
                    "set-order-to-state",
                    f"{what} a set iterates in per-process hash order "
                    "(PYTHONHASHSEED) before freezing it into state — wrap "
                    "the set in sorted(...) so every host materializes the "
                    "same sequence",
                    node,
                )
                return

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)

        # unsorted-dirscan: scan order consumed without sorted(...).
        if self._is_dirscan(node) and self._insensitive_depth == 0:
            self._emit(
                "unsorted-dirscan",
                "directory scan consumed in filesystem order — wrap it in "
                "sorted(...): scan order is inode-history-dependent, so "
                "state derived from it differs across hosts and reboots",
                node,
            )

        # hash-ordering: builtin hash()/id().
        if dotted in ("hash", "id") and node.args:
            self._emit(
                "hash-ordering",
                f"builtin {dotted}() influencing a key or ordering — "
                "hash(str) is salted per process (PYTHONHASHSEED) and id() "
                "is an allocation address; derive keys from a stable mix "
                "(splitmix/sha256) of the value instead",
                node,
            )

        # unseeded-rng.
        if dotted is not None:
            if dotted in _RANDOM_MODULE_FNS or _is_np_random(dotted):
                self._emit(
                    "unseeded-rng",
                    f"module-level RNG draw {dotted}() uses process-global "
                    "state — every host draws a different value; thread a "
                    "seeded np.random.default_rng(seed) through instead",
                    node,
                )
            elif dotted in (
                "random.Random",
                "np.random.default_rng",
                "numpy.random.default_rng",
            ) and not node.args and not node.keywords:
                self._emit(
                    "unseeded-rng",
                    f"{dotted}() constructed without a seed draws from OS "
                    "entropy — a bit-identity plane needs every stream "
                    "derived from the shared protocol seed",
                    node,
                )

        # clock-in-digest: a tainted value reaching a digest/seed sink.
        sink = None
        if dotted is not None and (
            dotted in _DIGEST_CALLS or dotted in _SEED_CALLS
        ):
            sink = dotted
        elif isinstance(node.func, ast.Attribute) and node.func.attr == "update":
            sink = f"{_dotted(node.func) or '.update'}"
        if sink is not None:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if self._contains_clock(arg):
                    self._emit(
                        "clock-in-digest",
                        f"wall-clock/pid value flows into {sink}(...) — the "
                        "digest/seed differs on every host and every "
                        "replay, so nothing downstream can be bit-identical",
                        node,
                    )
                    break

        # set-order-to-state: materializers freezing set order.
        if self._insensitive_depth == 0:
            self._check_materialization(node)

        # Descend; order-insensitive consumers launder their arguments.
        if dotted in _ORDER_INSENSITIVE:
            self._insensitive_depth += 1
            self.generic_visit(node)
            self._insensitive_depth -= 1
        else:
            self.generic_visit(node)

    # -- comprehensions and accumulation loops ----------------------------

    def _iterates_setish(self, comp: ast.ListComp | ast.DictComp | ast.GeneratorExp) -> bool:
        return any(self._is_setish(g.iter) for g in comp.generators)

    def visit_ListComp(self, node: ast.ListComp) -> None:
        if self._insensitive_depth == 0 and self._iterates_setish(node):
            self._emit(
                "set-order-to-state",
                "list comprehension over a set freezes per-process hash "
                "order into a sequence — iterate sorted(...) instead",
                node,
            )
        self.generic_visit(node)

    def visit_DictComp(self, node: ast.DictComp) -> None:
        if self._insensitive_depth == 0 and self._iterates_setish(node):
            self._emit(
                "set-order-to-state",
                "dict comprehension over a set inherits per-process hash "
                "order as insertion order — anything serializing this dict "
                "diverges; iterate sorted(...) instead",
                node,
            )
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if self._insensitive_depth == 0 and self._is_setish(node.iter):
            # Only accumulation bodies freeze the order into state:
            # .append/.add-to-list, augmented assignment, subscript
            # stores.  A pure membership/side-effect loop is quiet.
            accumulates = False
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute
                ) and sub.func.attr in ("append", "extend", "write"):
                    accumulates = True
                    break
                if isinstance(sub, ast.AugAssign):
                    accumulates = True
                    break
            if accumulates:
                self._emit(
                    "set-order-to-state",
                    "loop over a set accumulates in per-process hash order "
                    "— float sums and appended sequences inherit "
                    "PYTHONHASHSEED; iterate sorted(...) instead",
                    node,
                )
        self.generic_visit(node)


def scan_det_source(source: str, rel_path: str) -> list[Finding]:
    """Scan one file's source with the pass-13 rules; ``rel_path`` is
    repo-relative (it anchors findings and scopes nothing — tree scope
    is the pass walker's job, mirroring pass 12)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [
            Finding(
                pass_name="determinism",
                rule="syntax-error",
                severity="error",
                message=f"unparseable source: {exc.msg}",
                file=rel_path,
                line=exc.lineno,
            )
        ]
    visitor = _DetVisitor(rel_path)
    visitor.visit(tree)
    return visitor.findings


def run_det_ast_pass(root: str | Path | None = None) -> tuple[list[Finding], int]:
    """Pass 13's AST leg over :data:`DET_TREES`; returns
    ``(findings, files scanned)`` — the pass-12 walker shape."""
    if root is None:
        root = Path(__file__).resolve().parent.parent.parent.parent
    root = Path(root)
    findings: list[Finding] = []
    files = [
        path
        for tree in DET_TREES
        for path in sorted((root / "protocol_tpu_torch" / tree).rglob("*.py"))
    ]
    for path in files:
        rel = str(path.relative_to(root))
        found = scan_det_source(path.read_text(), rel)
        findings.extend(f for f in found if f.rule in DET_AST_RULES)
    return findings, len(files)


__all__ = [
    "DET_AST_RULES",
    "DET_TREES",
    "run_det_ast_pass",
    "scan_det_source",
]
