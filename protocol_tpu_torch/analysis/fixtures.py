"""Seeded violation fixtures — code that deliberately breaks one
invariant each, so the analyzer itself is testable.

Every fixture pairs a violation with the pass that must catch it, and
``run_fixture`` checks it exactly as that pass checks the real tree:
the violating lines carry ``# VIOLATION: <name>`` markers, against which
the tests resolve each finding's ``file:line``.  The CLI exposes them as
``python -m protocol_tpu_torch.analysis --fixture <name>``, which must
exit non-zero: the gate's self-check.

- **Source fixtures** (``ast``, ``concurrency``, ``mem-ast``,
  ``det-ast``, ``det-atomics``): the reference's violating sources as
  strings, so the repo-wide passes never see them.  A source that used
  ``jax.jit`` names its traced function in the fixture's own table
  (``traced``) instead, as the port's ``TRACED_FUNCTIONS`` does.
- **Runtime fixtures** run on a device: a step with a float64 tensor, a
  host read, a scatter, or an extra kernel launch (``step``); a converge
  holding an O(E) temporary (``mem``); a converge whose bits depend on
  run order (``det``); a sharded step with two all-reduces, one
  all-reduce of E bytes, or an all-reduce over a sub-group (``comm``,
  on two ranks); and for the graft leg (``--zk``), a graft entry that
  reads ``.item()`` or downloads twice (``step``), a kernel recipe that
  holds an extra O(n) buffer past its ``MemBudget`` (``mem``) and one
  whose output depends on an unseeded generator (``det``).  A fixture
  whose rule only the card can judge
  (``card_only``) is not run on the CPU: ``run_fixture`` returns None.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .report import Finding


@dataclass(frozen=True)
class Fixture:
    name: str
    rule: str  # the finding rule this fixture must trigger
    #: Source fixtures return ``(source, rel_path)``; runtime fixtures
    #: run on the device given to them and return their findings.
    build: Callable
    #: Marker suffix of the ``# VIOLATION:`` comment anchoring the
    #: expected finding line; None when the finding has no source site.
    marker: str | None
    #: Which analyzer pass evaluates this fixture.
    kind: str = "ast"
    #: Traced qualnames of an ``ast`` fixture's source.
    traced: tuple[str, ...] = ()
    #: The rule needs the card (a kernel launch, an allocator peak).
    card_only: bool = False


# -- pass 2/3/4/5/6/9/10/11: the AST rules ------------------------------------

_TIME_IN_JIT_SRC = '''\
import time


def step(t):
    t0 = time.perf_counter()  # VIOLATION: time-in-jit
    return t * 2.0, t0
'''


def _time_in_jit() -> tuple[str, str]:
    return _TIME_IN_JIT_SRC, "protocol_tpu_torch/trust/_fixture_time_in_jit.py"


_LOGGING_IN_JIT_SRC = '''\
import logging

log = logging.getLogger(__name__)


def step(t):
    log.info("converged to %s", t)  # VIOLATION: logging-in-jit
    return t * 2.0
'''


def _logging_in_jit() -> tuple[str, str]:
    return _LOGGING_IN_JIT_SRC, "protocol_tpu_torch/trust/_fixture_logging_in_jit.py"


_CLOCK_IN_KERNEL_SRC = '''\
import time  # VIOLATION: clock-in-kernel-tree


def rowsum_probe(x):
    return time.monotonic(), x
'''


def _clock_in_kernel_tree() -> tuple[str, str]:
    return _CLOCK_IN_KERNEL_SRC, "protocol_tpu_torch/ops/_fixture_clock_in_kernel.py"


_PLAN_MUTATION_SRC = '''\
def make_step(plan, fingerprint):
    def step(t, inserts, deletes):
        # Delta application belongs in the host stage, before the
        # converge; inside the loop it repacks the plan every step.
        new_plan = plan.apply_delta(inserts, deletes, fingerprint=fingerprint)  # VIOLATION: plan-mutation-in-converge
        return t * 2.0, new_plan

    return step
'''


def _plan_mutation_in_converge() -> tuple[str, str]:
    return _PLAN_MUTATION_SRC, "protocol_tpu_torch/trust/_fixture_plan_mutation.py"


_JOURNAL_IN_JIT_SRC = '''\
from protocol_tpu_torch.obs.journal import JOURNAL


def step(t):
    # One event a step floods the flight recorder's ring, and recording
    # a tensor reads it on the host.
    JOURNAL.record("iteration", residual=t)  # VIOLATION: journal-write-in-jit
    return t * 2.0
'''


def _journal_write_in_jit() -> tuple[str, str]:
    return _JOURNAL_IN_JIT_SRC, "protocol_tpu_torch/trust/_fixture_journal_in_jit.py"


_BLOCKING_INGEST_SRC = '''\
import queue

from protocol_tpu_torch.obs import metrics as obs_metrics

PENDING = queue.Queue(maxsize=4)


def observe_depth():
    # Keeps this fixture single-purpose: pass 10's unobserved-queue
    # rule is satisfied so only the pass-6 rules below fire.
    obs_metrics.PIPELINE_QUEUE_DEPTH.set(PENDING.qsize())


def device_stage(manager, atts, prepared):
    # The epoch loop verifying signatures re-couples convergence
    # cadence to ingest load — admission belongs in the ingest plane.
    results = manager.add_attestations_bulk(atts)  # VIOLATION: blocking-ingest-in-epoch-loop
    # An unbounded blocking put can park the epoch loop forever when
    # the consumer stalls; put_nowait (coalescing) or timeout= are the
    # sanctioned shapes.
    PENDING.put(prepared)
    return results
'''


def _blocking_ingest_in_epoch_loop() -> tuple[str, str]:
    # The fake path lands on an epoch-loop file so the file-scoped
    # pass-6 rule applies exactly as it would to the real module.
    return _BLOCKING_INGEST_SRC, "protocol_tpu_torch/node/pipeline.py"


_BLOCKING_PROVE_SRC = '''\
def device_stage(manager, prepared):
    # A synchronous SNARK on the epoch path re-serializes seconds of
    # whole-core proving into the epoch cadence — the coupling the
    # async proving plane (protocol_tpu_torch/prover/) exists to remove.
    manager.calculate_proofs(prepared.epoch)  # VIOLATION: blocking-prove-in-epoch-loop
    return prepared
'''


def _blocking_prove_in_epoch_loop() -> tuple[str, str]:
    return _BLOCKING_PROVE_SRC, "protocol_tpu_torch/node/pipeline.py"


_UNOBSERVED_QUEUE_SRC = '''\
import queue


class Stage:
    def __init__(self):
        # A bounded queue is a backpressure point; without a depth
        # gauge in this file, "the stage is saturated" is a guess
        # instead of a scrape.
        self._queue = queue.Queue(maxsize=8)  # VIOLATION: unobserved-queue

    def push(self, item):
        self._queue.put_nowait(item)
'''


def _unobserved_queue() -> tuple[str, str]:
    return _UNOBSERVED_QUEUE_SRC, "protocol_tpu_torch/ingest/_fixture_unobserved_queue.py"


_NON_ATOMIC_STATE_WRITE_SRC = '''\
import json


def persist_cursor(path, cursor):
    # Durable node state through a bare open(): a crash mid-write tears
    # the file and the next boot reads garbage — the checkpoint store's
    # _atomic_write (tmp + fsync + rename) is the sanctioned shape, or
    # an append path that fsyncs what it wrote (node/wal.py).
    with open(path, "w") as f:  # VIOLATION: non-atomic-state-write
        json.dump({"cursor": cursor}, f)
'''


def _non_atomic_state_write() -> tuple[str, str]:
    return _NON_ATOMIC_STATE_WRITE_SRC, "protocol_tpu_torch/node/_fixture_state_write.py"


_FAULT_POINT_IN_JIT_SRC = '''\
from protocol_tpu_torch import chaos


def step(t):
    # A fault point inside the loop fires between one step's kernel
    # launches, a point no fault schedule covers; fault points live at
    # host boundaries, like spans and journal writes.
    chaos.fire("epoch.post_converge")  # VIOLATION: fault-point-in-jit
    return t * 2.0
'''


def _fault_point_in_jit() -> tuple[str, str]:
    return _FAULT_POINT_IN_JIT_SRC, "protocol_tpu_torch/trust/_fixture_chaos_in_jit.py"


_HOST_READ_IN_STEP_SRC = '''\
def run(step, t, tol):
    while True:
        t_new = step(t)
        resid = (t_new - t).abs().sum()
        t = t_new
        if not resid.item() > tol:  # VIOLATION: host-read-in-step
            return t
'''


def _host_read_in_step() -> tuple[str, str]:
    return _HOST_READ_IN_STEP_SRC, "protocol_tpu_torch/ops/_fixture_host_read.py"


_BARE_CUDA_SYNC_SRC = '''\
import torch


def converge(step, t):
    t = step(t)
    torch.cuda.synchronize()  # VIOLATION: bare-cuda-sync
    return t
'''


def _bare_cuda_sync() -> tuple[str, str]:
    return _BARE_CUDA_SYNC_SRC, "protocol_tpu_torch/trust/_fixture_bare_sync.py"


# -- pass 7: whole-program concurrency ----------------------------------------

_UNGUARDED_SHARED_ATTR_SRC = '''\
import threading


class Tally:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self):
        with self._lock:
            self.count += 1

    def read(self):
        return self.count  # VIOLATION: unguarded-shared-attr


def run():
    t = Tally()
    threading.Thread(target=t.bump).start()
    threading.Thread(target=t.read).start()
'''


def _unguarded_shared_attr() -> tuple[str, str]:
    return _UNGUARDED_SHARED_ATTR_SRC, "protocol_tpu_torch/node/_fixture_shared_attr.py"


_UNGUARDED_RMW_SRC = '''\
import threading


class Hits:
    def __init__(self):
        self.n = 0

    def work(self):
        self.n += 1  # VIOLATION: unguarded-rmw


def run():
    h = Hits()
    threading.Thread(target=h.work, name="w1").start()
    threading.Thread(target=h.work, name="w2").start()
'''


def _unguarded_rmw() -> tuple[str, str]:
    return _UNGUARDED_RMW_SRC, "protocol_tpu_torch/obs/_fixture_rmw.py"


_CHECK_THEN_ACT_SRC = '''\
import threading


class Once:
    def __init__(self):
        self.started = False

    def boot(self):
        if not self.started:
            self.started = True  # VIOLATION: check-then-act


def run():
    o = Once()
    threading.Thread(target=o.boot, name="a").start()
    threading.Thread(target=o.boot, name="b").start()
'''


def _check_then_act() -> tuple[str, str]:
    return _CHECK_THEN_ACT_SRC, "protocol_tpu_torch/ingest/_fixture_check_act.py"


_LOCK_ORDER_CYCLE_SRC = '''\
import threading


class Transfer:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:  # VIOLATION: lock-order-cycle
                pass

    def ba(self):
        with self._b:
            with self._a:
                pass
'''


def _lock_order_cycle() -> tuple[str, str]:
    return _LOCK_ORDER_CYCLE_SRC, "protocol_tpu_torch/node/_fixture_lock_order.py"


_BLOCKING_UNDER_LOCK_SRC = '''\
import queue
import threading


class Stage:
    def __init__(self):
        self._lock = threading.Lock()
        self._queue = queue.Queue(maxsize=4)

    def push(self, item):
        with self._lock:
            self._queue.put(item)  # VIOLATION: blocking-call-under-lock
'''


def _blocking_call_under_lock() -> tuple[str, str]:
    return _BLOCKING_UNDER_LOCK_SRC, "protocol_tpu_torch/ingest/_fixture_block_lock.py"


_NATIVE_UNDER_LOCK_SRC = '''\
import threading

from protocol_tpu_torch.crypto import native as cnative


class Verifier:
    def __init__(self):
        self._lock = threading.Lock()

    def check(self, sigs):
        with self._lock:
            return cnative.eddsa_verify_batch(sigs)  # VIOLATION: native-call-under-lock
'''


def _native_call_under_lock() -> tuple[str, str]:
    return _NATIVE_UNDER_LOCK_SRC, "protocol_tpu_torch/node/_fixture_native_lock.py"


# -- pass 12: the memory AST rules --------------------------------------------

_HOST_MATERIALIZATION_SRC = '''\
def device_stage(manager, prepared, plan):
    # Copying an edge-scale plan column to the host per tick: O(E) bytes
    # device->host inside the epoch cadence — edge host work belongs in
    # plan build (Manager.prepare_epoch).
    seg_dst = plan.seg_dst.cpu()  # VIOLATION: host-materialization-of-edges
    return seg_dst.shape[0]
'''


def _host_materialization_of_edges() -> tuple[str, str]:
    return _HOST_MATERIALIZATION_SRC, "protocol_tpu_torch/node/pipeline.py"


_UNBOUNDED_CACHE_SRC = '''\
class ScoreServer:
    """A long-lived node class with an epoch-keyed cache that only
    ever grows — the leak the ring-eviction doctrine exists to stop
    (4 MB of f32[N] scores per epoch at 1M peers)."""

    def __init__(self):
        self._score_cache = {}  # VIOLATION: unbounded-cache-growth

    def publish(self, epoch, scores):
        self._score_cache[epoch] = scores

    def serve(self, epoch):
        return self._score_cache.get(epoch)
'''


def _unbounded_cache_growth() -> tuple[str, str]:
    return _UNBOUNDED_CACHE_SRC, "protocol_tpu_torch/node/_fixture_cache_growth.py"


# -- pass 13: determinism (AST and the kernels' sources) ----------------------

_SET_ORDER_TO_STATE_SRC = '''\
import numpy as np


def stamp_columns(peers, scores):
    # A peer *set* flattened straight into a checkpoint column: the
    # array inherits per-process hash order, so two hosts digest
    # different bytes from identical peer sets.
    live = {p for p in peers if p >= 0}
    column = np.asarray(list(live))  # VIOLATION: set-order-to-state
    return column, scores[column]
'''


def _set_order_to_state() -> tuple[str, str]:
    return _SET_ORDER_TO_STATE_SRC, "protocol_tpu_torch/node/_fixture_set_order.py"


_UNSORTED_DIRSCAN_SRC = '''\
import os


def replay_segments(wal_dir):
    # WAL segments replayed in directory-scan order: inode history
    # decides the replay sequence, so two hosts reconverge through
    # different intermediate states.
    names = os.listdir(wal_dir)  # VIOLATION: unsorted-dirscan
    return [os.path.join(wal_dir, n) for n in names]
'''


def _unsorted_dirscan() -> tuple[str, str]:
    return _UNSORTED_DIRSCAN_SRC, "protocol_tpu_torch/node/_fixture_dirscan.py"


_HASH_ORDERING_SRC = '''\
def partition_key(sender_pk, n_partitions):
    # Builtin hash() as a partition key: hash(str) is salted per
    # process (PYTHONHASHSEED), so the same sender lands on different
    # partitions on different hosts.
    return hash(sender_pk) % n_partitions  # VIOLATION: hash-ordering
'''


def _hash_ordering() -> tuple[str, str]:
    return _HASH_ORDERING_SRC, "protocol_tpu_torch/ingest/_fixture_hash_key.py"


_UNSEEDED_RNG_SRC = '''\
import numpy as np


def churn_draw(n_peers):
    # A churn-stream draw from the process-global RNG: every host
    # samples a different peer set, so the epoch graphs diverge
    # before the first step.
    return np.random.permutation(n_peers)  # VIOLATION: unseeded-rng
'''


def _unseeded_rng() -> tuple[str, str]:
    return _UNSEEDED_RNG_SRC, "protocol_tpu_torch/models/_fixture_churn_rng.py"


_CLOCK_IN_DIGEST_SRC = '''\
import hashlib
import time


def seal_manifest(columns):
    # Wall clock folded into the manifest digest: the seal differs on
    # every host and every replay, so bit-identity verification can
    # never pass.
    stamp = time.time()
    h = hashlib.sha256(str(columns).encode())
    h.update(str(stamp).encode())  # VIOLATION: clock-in-digest
    return h.hexdigest()
'''


def _clock_in_digest() -> tuple[str, str]:
    return _CLOCK_IN_DIGEST_SRC, "protocol_tpu_torch/node/_fixture_clock_seal.py"


_FLOAT_ATOMIC_SRC = '''\
__global__ void scatter_sum(const float* __restrict__ w, const int* dst, float* out, int e) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < e) atomicAdd(&out[dst[i]], w[i]);  // VIOLATION: float-atomic
}
'''


def _float_atomic() -> tuple[str, str]:
    return _FLOAT_ATOMIC_SRC, "protocol_tpu_torch/ops/csrc/_fixture_scatter_sum.cu"


# -- runtime fixtures: the step leg --------------------------------------------


def _f64_step(t):
    import torch

    wide = t.to(dtype=torch.float64)  # VIOLATION: step-f64
    return (wide * 2.0).float()


def _host_read_step(t):
    s = float(t.sum())  # VIOLATION: step-host-read
    return t / s


def _scatter_step(t):
    import torch

    out = torch.zeros_like(t)
    idx = torch.arange(t.shape[0], device=t.device).flip(0)
    out[idx] = t  # VIOLATION: step-scatter
    return out


def _small_csr(device):
    from .cases import build_case, step_graph

    return build_case("cuda-csr", step_graph(256, 2048, seed=1), device)


def _step_fixture(step_fn, device, budget=None):
    import torch

    from .budget import KernelBudget
    from .step import check_step, run_step

    t = torch.full((1024,), 1.0 / 1024, dtype=torch.float32, device=device)
    res = run_step("fixture", step_fn, t)
    return check_step(budget or KernelBudget("fixture"), res)


def _step_f64(device) -> list[Finding]:
    return _step_fixture(_f64_step, device)


def _step_host_read(device) -> list[Finding]:
    return _step_fixture(_host_read_step, device)


def _step_scatter(device) -> list[Finding]:
    return _step_fixture(_scatter_step, device)


def _step_extra_launch(device) -> list[Finding]:
    """The CSR step with its row sums run twice: K9, K6 and K8 launch
    twice a step against the CSR budget's once."""
    import torch

    from ..ops import sparse as sp
    from .budget import KERNEL_INVARIANTS
    from .step import check_step, run_step

    case = _small_csr(device)
    src, row_ptr, w, _, p, dangling = case.args
    alpha = torch.tensor(0.1, device=case.t.device)

    def step(t):
        sp.gathered_rowsum(w, t, src, row_ptr)  # VIOLATION: step-extra-launch
        return sp.power_step_csr(src, row_ptr, w, t, p, dangling, alpha)

    return check_step(KERNEL_INVARIANTS["cuda-csr"], run_step("fixture", step, case.t))


# -- runtime fixtures: memory, determinism, comm --------------------------------


def _o_e_temporary(w, t, src):
    contrib = w * t[src]  # VIOLATION: mem-o-e-temporary
    return contrib.sum() + (contrib * contrib).sum()


def _mem_o_e_temporary(device) -> list[Finding]:
    """A converge holding an edge-sized product live across two
    reductions, measured on the card against a budget whose transient
    has no edge term."""
    import torch

    from .budget import MemBudget
    from .cases import BackendCase
    from .memory.checker import check_mem_case, measure_case

    n, e = 65536, 1 << 22
    gen = torch.Generator().manual_seed(0)
    src = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32).to(device)
    w = torch.rand(e, generator=gen).to(device)
    t = torch.full((n,), 1.0 / n, device=device)

    def converge(steps, tol):
        return (_o_e_temporary(w, t, src),)

    case = BackendCase("fixture", {"n": n, "edges": e, "n_shards": 1}, (w, t, src), t,
                       lambda x: x, converge)
    budget = MemBudget("fixture", resident_edge_bytes=8.0, resident_n=4.0,
                       resident_const=4096.0, transient_n=8.0, transient_const=65536.0)
    return check_mem_case(budget, measure_case(case))[0]


_RUN_ORDER = [0]


def _run_order_converge(t):
    import torch

    _RUN_ORDER[0] += 1
    big = torch.tensor([1e8, -1e8, 1.0], dtype=torch.float32, device=t.device)
    order = (0, 1, 2) if _RUN_ORDER[0] % 2 else (0, 2, 1)
    s = big[order[0]] + big[order[1]] + big[order[2]]  # VIOLATION: det-run-order
    return t * s, 1, s


def _det_run_order(device) -> list[Finding]:
    """A converge that adds the same three floats in an order that
    changes from one call to the next."""
    import torch

    from .determinism.checker import check_replays, replay_in_process

    t = torch.ones(8, device=device)
    return check_replays("fixture", replay_in_process(lambda: _run_order_converge(t)), None)


def comm_fixture_rank(mesh, which: str, n: int, e: int) -> dict:
    """A rank program (``run_ranks``) for the comm fixtures: one step
    whose collectives break one rule each against a budget of one
    all-reduce of 4 n bytes a step — two all-reduces of n/2 floats
    (``two``), one of e floats (``edges``), one of n floats over a
    group of this rank alone (``subgroup``)."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import ShardGroup
    from ..parallel.sharded import all_reduce_sum
    from .comm.checker import counted

    groups = [dist.new_group([r]) for r in range(mesh.size)] if which == "subgroup" else []

    def step():
        if which == "two":
            half = torch.ones(n // 2, device=mesh.device)
            all_reduce_sum(half, mesh)
            all_reduce_sum(half, mesh)  # VIOLATION: comm-two-all-reduces
        elif which == "edges":
            all_reduce_sum(torch.ones(e, device=mesh.device), mesh)  # VIOLATION: comm-edge-bytes
        elif which == "subgroup":
            mine = ShardGroup(groups[mesh.rank], 0, 1, mesh.device, mesh.backend)
            all_reduce_sum(torch.ones(n, device=mesh.device), mine)  # VIOLATION: comm-subgroup

    return counted("fixture", {"n": n, "edges": e, "n_shards": mesh.size}, 1, mesh.rank,
                   step).__dict__


def _comm_fixture(which: str):
    def run(device, ranks: int = 2) -> list[Finding]:
        from ..parallel.launch import run_ranks
        from ..parallel.mesh import default_mesh
        from .budget import CommBudget
        from .cases import single_rank_group
        from .comm.checker import CommCase, check_comm_case

        n, e = 1024, 16384
        if ranks == 1:
            with single_rank_group(device):
                per_rank = [comm_fixture_rank(default_mesh(device=device), which, n, e)]
        else:
            per_rank = run_ranks(ranks, comm_fixture_rank, which, n, e, backend="gloo",
                                 device=str(device), timeout_s=300)
        budget = CommBudget("fixture", {"all_reduce_sum": 1}, bytes_n=4.0)
        return [f for fields in per_rank for f in check_comm_case(budget, CommCase(**fields))[0]]

    return run


# -- runtime fixtures: the graft leg -------------------------------------------


def _zk_operands(device, n: int = 1024):
    """Two canonical Fr operands and an NTT's input and plan at ``n``
    lanes, from ``zk_lowering``'s seed."""
    from .zk_lowering import kernel_recipes

    mulmod, ntt_stage = kernel_recipes(device, n)[:2]
    return mulmod.args, ntt_stage.args


def _zk_step_fixture(device, label, call, entry=None, **size):
    """``call`` judged by the step leg's graft rules as a recipe of the
    mulmod's budget, or of graft entry ``entry`` at ``size``."""
    from .budget import expected_zk_host_copies, expected_zk_launches
    from .step import check_zk, record_zk
    from .zk_lowering import ZkRecipe

    if entry is None:
        recipe = ZkRecipe(label, ("zk-graft-mulmod",), None, 1024, (), call, {"field_op": 1})
    else:
        recipe = ZkRecipe(label, (), entry, size["n"], (), call,
                          expected_zk_launches(entry, **size),
                          expected_zk_host_copies(entry, **size))
    return check_zk(recipe, *record_zk(recipe, device))


def _zk_item_read(device) -> list[Finding]:
    """A multiply whose caller reads one limb of the product on the host."""
    from ..zk.graft import field

    (a, b), _ = _zk_operands(device)

    def call():
        out = field.mulmod_fr(a, b)
        return out, out[0, 0].item()  # VIOLATION: zk-item-read

    return _zk_step_fixture(device, "fixture", call)


def _zk_second_download(device) -> list[Finding]:
    """``ntt_limbs``'s work with its result downloaded twice, against the
    entry's one declared download of 32 n bytes."""
    from ..zk.graft import ntt
    from ..zk.graft.field import tensor_to_u64

    _, (x, plan) = _zk_operands(device)

    def call():
        y = ntt.ntt_device(x, plan, False)
        first = tensor_to_u64(y)
        second = y.cpu()  # VIOLATION: zk-second-download
        return first, second

    return _zk_step_fixture(device, "fixture", call, "ntt_limbs", n=x.shape[0], inverse=False)


def _zk_extra_buffer(device) -> list[Finding]:
    """The multiply with both operands copied into a live buffer of
    64 B a lane, measured on the card against the mulmod's budget, whose
    transient holds the product's 32 B a lane."""
    import torch

    from ..zk.graft import field
    from .budget import MEM_INVARIANTS
    from .memory.checker import check_mem_case, measure_zk
    from .zk_lowering import ZkRecipe

    (a, b), _ = _zk_operands(device)

    def call():
        both = torch.cat([a, b])  # VIOLATION: zk-extra-buffer
        return field.mulmod_fr(a, b), both

    recipe = ZkRecipe("fixture", ("zk-graft-mulmod",), None, a.shape[0], (a, b), call)
    return check_mem_case(MEM_INVARIANTS["zk-graft-mulmod"], measure_zk(recipe))[0]


def _zk_unseeded(device) -> list[Finding]:
    """A multiply over its operand permuted by the process's global
    generator, which no seed fixes: each run draws another order."""
    import torch

    from ..zk.graft import field
    from .determinism.checker import check_replays
    from .zk_lowering import digest_output

    (a, b), _ = _zk_operands(device)

    def call():
        order = torch.randperm(a.shape[0], device=a.device)  # VIOLATION: zk-unseeded
        return field.mulmod_fr(a[order], b)

    return check_replays("fixture", [digest_output(call()) for _ in range(2)], None, what="run")


FIXTURES: dict[str, Fixture] = {
    f.name: f
    for f in (
        Fixture("time-in-jit", "host-clock-in-jit", _time_in_jit, "time-in-jit",
                traced=("step",)),
        Fixture("logging-in-jit", "logging-in-jit", _logging_in_jit, "logging-in-jit",
                traced=("step",)),
        Fixture("clock-in-kernel-tree", "clock-in-kernel-tree", _clock_in_kernel_tree,
                "clock-in-kernel-tree"),
        Fixture("plan-mutation-in-converge", "plan-mutation-in-converge",
                _plan_mutation_in_converge, "plan-mutation-in-converge",
                traced=("make_step.step",)),
        Fixture("journal-write-in-jit", "journal-write-in-jit", _journal_write_in_jit,
                "journal-write-in-jit", traced=("step",)),
        Fixture("blocking-ingest-in-epoch-loop", "blocking-ingest-in-epoch-loop",
                _blocking_ingest_in_epoch_loop, "blocking-ingest-in-epoch-loop"),
        Fixture("blocking-prove-in-epoch-loop", "blocking-prove-in-epoch-loop",
                _blocking_prove_in_epoch_loop, "blocking-prove-in-epoch-loop"),
        Fixture("unobserved-queue", "unobserved-queue", _unobserved_queue, "unobserved-queue"),
        Fixture("non-atomic-state-write", "non-atomic-state-write", _non_atomic_state_write,
                "non-atomic-state-write"),
        Fixture("fault-point-in-jit", "fault-point-in-jit", _fault_point_in_jit,
                "fault-point-in-jit", traced=("step",)),
        Fixture("host-read-in-step", "host-op-in-jit", _host_read_in_step,
                "host-read-in-step", traced=("run",)),
        Fixture("bare-cuda-sync", "bare-sync", _bare_cuda_sync, "bare-cuda-sync"),
        Fixture("unguarded-shared-attr", "unguarded-shared-attr", _unguarded_shared_attr,
                "unguarded-shared-attr", kind="concurrency"),
        Fixture("unguarded-rmw", "unguarded-rmw", _unguarded_rmw, "unguarded-rmw",
                kind="concurrency"),
        Fixture("check-then-act", "check-then-act", _check_then_act, "check-then-act",
                kind="concurrency"),
        Fixture("lock-order-cycle", "lock-order-cycle", _lock_order_cycle, "lock-order-cycle",
                kind="concurrency"),
        Fixture("blocking-call-under-lock", "blocking-call-under-lock",
                _blocking_call_under_lock, "blocking-call-under-lock", kind="concurrency"),
        Fixture("native-call-under-lock", "native-call-under-lock", _native_call_under_lock,
                "native-call-under-lock", kind="concurrency"),
        Fixture("host-materialization-of-edges", "host-materialization-of-edges",
                _host_materialization_of_edges, "host-materialization-of-edges",
                kind="mem-ast"),
        Fixture("unbounded-cache-growth", "unbounded-cache-growth", _unbounded_cache_growth,
                "unbounded-cache-growth", kind="mem-ast"),
        Fixture("set-order-to-state", "set-order-to-state", _set_order_to_state,
                "set-order-to-state", kind="det-ast"),
        Fixture("unsorted-dirscan", "unsorted-dirscan", _unsorted_dirscan, "unsorted-dirscan",
                kind="det-ast"),
        Fixture("hash-ordering", "hash-ordering", _hash_ordering, "hash-ordering",
                kind="det-ast"),
        Fixture("unseeded-rng", "unseeded-rng", _unseeded_rng, "unseeded-rng", kind="det-ast"),
        Fixture("clock-in-digest", "clock-in-digest", _clock_in_digest, "clock-in-digest",
                kind="det-ast"),
        Fixture("float-atomic", "float-atomic", _float_atomic, "float-atomic",
                kind="det-atomics"),
        Fixture("step-f64", "f64-dtype", _step_f64, "step-f64", kind="step"),
        Fixture("step-host-read", "host-sync-in-step", _step_host_read, "step-host-read",
                kind="step"),
        Fixture("step-scatter", "scatter-budget", _step_scatter, "step-scatter", kind="step"),
        Fixture("step-extra-launch", "launch-budget", _step_extra_launch, None, kind="step",
                card_only=True),
        Fixture("mem-o-e-temporary", "o-e-live-temporary", _mem_o_e_temporary,
                "mem-o-e-temporary", kind="mem", card_only=True),
        Fixture("det-run-order", "nondeterministic-converge", _det_run_order, None,
                kind="det"),
        Fixture("comm-two-all-reduces", "collective-count", _comm_fixture("two"), None,
                kind="comm"),
        Fixture("comm-edge-bytes", "comm-bytes-budget", _comm_fixture("edges"), None,
                kind="comm"),
        Fixture("comm-subgroup", "replica-group-coverage", _comm_fixture("subgroup"), None,
                kind="comm"),
        Fixture("zk-item-read", "zk-host-read", _zk_item_read, "zk-item-read", kind="step"),
        Fixture("zk-second-download", "zk-host-copy", _zk_second_download,
                "zk-second-download", kind="step", card_only=True),
        Fixture("zk-extra-buffer", "o-e-live-temporary", _zk_extra_buffer, "zk-extra-buffer",
                kind="mem", card_only=True),
        Fixture("zk-unseeded", "nondeterministic-converge", _zk_unseeded, None, kind="det"),
    )
}

#: Fixtures that run on a device.
RUNTIME_KINDS = frozenset({"step", "mem", "det", "comm"})


def run_fixture(name: str, device="cpu", **kwargs) -> list[Finding] | None:
    """Check one seeded violation as its pass checks the real tree;
    raises KeyError on an unknown name (the CLI lists valid ones).  A
    runtime fixture runs on ``device``; a card-only one returns None on
    the CPU (not run).  ``kwargs`` reach a comm fixture (``ranks=1``
    runs it in this process)."""
    fixture = FIXTURES[name]
    if fixture.kind in RUNTIME_KINDS:
        import torch

        dev = torch.device(device)
        if fixture.card_only and dev.type != "cuda":
            return None
        return fixture.build(dev, **kwargs)
    source, rel_path = fixture.build()
    if fixture.kind == "ast":
        from .ast_rules import scan_source

        return scan_source(source, rel_path, traced=set(fixture.traced))
    if fixture.kind == "concurrency":
        from .concurrency import analyze_sources

        return analyze_sources({rel_path: source})
    if fixture.kind == "mem-ast":
        from .ast_rules import scan_source

        return scan_source(source, rel_path, mem_rules=True, traced=set(fixture.traced))
    if fixture.kind == "det-ast":
        from .determinism.ast_walk import scan_det_source

        return scan_det_source(source, rel_path)
    if fixture.kind == "det-atomics":
        from .determinism.checker import scan_atomics_source

        return scan_atomics_source(source, rel_path)
    raise ValueError(f"fixture {name!r} has an unknown kind {fixture.kind!r}")


__all__ = ["FIXTURES", "Fixture", "RUNTIME_KINDS", "run_fixture"]
