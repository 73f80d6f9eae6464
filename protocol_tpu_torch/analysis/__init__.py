"""protocol_tpu_torch.analysis — graftlint for the port, and the budget
registry the node consults.

The invariants that make the trust backends fast — one random gather a
windowed step, no host sync or float64 in the loop, one all-reduce of
O(N) bytes a sharded step, a peak with no O(E) temporary, replay-stable
bits, the threading contract — are contracts that neither the type
checker nor the tests see.  The reference checks them on its jaxprs and
compiled HLO; the port has neither, so its legs run the code instead:

- **step** (``step``): one step of every card backend on the
  reference's synthetic graph, its aten ops recorded (``record``): no
  float64, no host sync, gathers and scatters outside the kernels within
  ``KERNEL_INVARIANTS``; on the card, the step captured in a CUDA graph
  with its kernel launches on budget and one replay bit-equal.  Also the
  registry gate: every backend's budgets declared.
- **ast** (``ast_rules``): the reference's AST rules over
  ``protocol_tpu_torch/``, its ``jit`` decorators replaced by the
  ``TRACED_FUNCTIONS`` table.
- **concurrency** (``concurrency``): the whole-program threading
  contract, with its enumerated, stale-tested waiver table.
- **comm** (``comm``): both sharded composites on ``run_ranks`` ranks
  at two scales (E x4, N x2), held to ``COMM_INVARIANTS``.
- **memory** (``memory``): each converge's resident and transient bytes
  measured on the card at two scales, held to ``MEM_INVARIANTS``; the
  memory AST rules.
- **determinism** (``determinism``): each converge replayed in this
  process and a fresh one, bit for bit; no floating-point atomic in the
  kernels' sources; the divergence AST rules.

Run as ``python -m protocol_tpu_torch.analysis``: writes
``ANALYSIS.json`` and prints the findings; any unwaived error exits
non-zero.  The runtime legs run on the card unless ``--device cpu`` is
given, and a rule the CPU cannot judge is reported as not run.

This ``__init__`` stays dependency-light: the kernel modules import
``.budget`` at their own import time, and the legs load torch only when
they run.
"""

from .budget import (
    COMM_INVARIANTS,
    HOST_BACKENDS,
    KERNEL_INVARIANTS,
    MEM_INVARIANTS,
    ZK_INVARIANTS,
    CommBudget,
    KernelBudget,
    MemBudget,
    ZkKernelBudget,
    declare,
    declare_comm,
    declare_mem,
    declare_zk,
)
from .report import Finding, Report

__all__ = [
    "COMM_INVARIANTS",
    "CommBudget",
    "Finding",
    "HOST_BACKENDS",
    "KERNEL_INVARIANTS",
    "KernelBudget",
    "MEM_INVARIANTS",
    "MemBudget",
    "Report",
    "ZK_INVARIANTS",
    "ZkKernelBudget",
    "declare",
    "declare_comm",
    "declare_mem",
    "declare_zk",
]
