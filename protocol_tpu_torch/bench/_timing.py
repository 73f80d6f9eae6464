"""Device time of one call on the card, and a kernel held against its
plain version.

``time_ms`` is the counterpart of the reference probes' ``timed_chain``
and ``timed``.  Those ran the op ``REPS`` times inside one jitted
``fori_loop`` with a data dependence on the loop carry, so that XLA
could neither hoist nor delete it.  Eager PyTorch launches every call
for real, so here each call is timed on its own between CUDA events and
the median is taken.
"""

from __future__ import annotations

import statistics

import torch

#: H100 SXM device-memory rate (NVIDIA data sheet), for byte bounds.
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, for operation bounds.
F32_OPS_PER_S = 67e12

#: Untimed calls before the timed ones (kernel load, allocator, caches).
WARMUP = 3
#: Timed calls; the result is their median.
REPS = 20
#: Cycles of ``torch.cuda._sleep`` queued ahead of each timed call, about
#: 0.1 ms at Hopper's clock: the card spins while the host enqueues the
#: start event, the call and the end event, so the events bracket the
#: call's device time and not the host's launch overhead.
SPIN_CYCLES = 200_000


def time_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median device time in ms of ``fn()`` over ``reps`` calls, each
    between two CUDA events on the current stream, after ``warmup``
    untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int = 0) -> float:
    """The least time in ms the card takes to move ``nbytes`` through
    device memory and do ``ops`` float32 operations: the larger of the
    two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def kernel_vs_plain(kernel, plain, *, wrapper, nbytes: int, ops: int = 0, library=None) -> dict:
    """Call ``kernel()``, a call of the kernel's ``wrapper``, once and
    require it to equal ``plain()`` and, where given, ``library()`` bit
    for bit (a difference raises); then time all three.  Returns the
    times, the bound, the max abs error and ``launches``, the growth of
    ``wrapper.launches`` over the call: ``1 + WARMUP + REPS``."""
    before = wrapper.launches
    out = kernel()
    ref = plain()
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    if not torch.equal(out, ref):
        raise RuntimeError(f"{wrapper.__name__} differs from its plain version (max abs err {err})")
    if library is not None and not torch.equal(out, library()):
        raise RuntimeError(f"{wrapper.__name__} differs from its library call")
    del out, ref
    return dict(
        max_abs_err=err,
        ms=time_ms(kernel),
        plain_ms=time_ms(plain),
        library_ms=None if library is None else time_ms(library),
        bound_ms=bound_ms(nbytes, ops),
        bytes=nbytes,
        launches=wrapper.launches - before,
    )
