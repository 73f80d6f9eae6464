"""What a function runs, op by op: the runtime legs' counterpart of the
reference's jaxpr walk (``protocol_tpu/analysis/jaxpr_walk.py``).

``record_ops(fn)`` runs ``fn`` under a ``TorchDispatchMode`` and keeps,
for every aten op it dispatches, the op's name, the dtypes and devices
of its tensors, the bytes of a fresh output, and the port's innermost
source line that called it.  Nothing of a tensor is kept, so recording
changes neither the result nor what is alive.  Ops dispatched under a
kernel wrapper (``cases.kernel_wrappers``: its operand checks, or its
plain version on the CPU) are marked ``in_kernel``: on the card they
run inside the kernel, as the reference's gathers inside a
``pallas_call`` do, so the gather and scatter budgets leave them out.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: The package's root directory; sites are reported relative to its parent.
_PACKAGE = Path(__file__).resolve().parents[1]
_REPO = _PACKAGE.parent
_ANALYSIS = Path(__file__).resolve().parent
#: The analyzers' seeded violations anchor at their own lines.
_FIXTURES = str(_ANALYSIS / "fixtures.py")

#: Ops that read a device value on the host (a sync), whatever the device.
HOST_SYNC_OPS = frozenset(
    {"_local_scalar_dense", "item", "nonzero", "masked_select", "_unique", "_unique2",
     "unique_dim", "unique_consecutive", "unique_dim_consecutive"}
)
#: Ops that take an index list, which may hold a boolean mask: a mask's
#: lanes are counted on the host (a ``nonzero`` inside the op), a sync on
#: the card.
MASK_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})
#: Copies whose destination may be the host.
COPY_OPS = frozenset({"_to_copy", "to", "copy_", "_copy_from", "_copy_from_and_resize"})
#: The gather family (random reads through an index tensor).
GATHER_OPS = frozenset(
    {"index_select", "gather", "index", "take", "take_along_dim", "embedding",
     "_unsafe_index", "_embedding_bag", "embedding_bag"}
)
#: The scatter family (writes through an index tensor).
SCATTER_OPS = frozenset(
    {"scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
     "scatter_reduce_", "index_put", "index_put_", "_index_put_impl_", "_unsafe_index_put",
     "index_add", "index_add_", "index_copy", "index_copy_", "index_fill", "index_fill_",
     "index_reduce", "index_reduce_", "masked_scatter", "masked_scatter_", "put", "put_",
     "bincount", "histc", "embedding_dense_backward"}
)


@dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op."""

    op: str  # overload packet name, e.g. "index_select"
    dtypes: tuple[str, ...]  # of every tensor argument and output
    devices: tuple[str, ...]  # of the tensor arguments
    out_devices: tuple[str, ...]
    out_bytes: int  # bytes of fresh (non-view, non-in-place) outputs
    moved_bytes: int  # bytes a copy or a scalar read moves
    file: str | None  # repo-relative path of the port's calling line
    line: int | None
    function: str | None
    in_kernel: str | None  # the kernel wrapper this op ran under, if any
    bool_index: bool = False  # an ``index`` or ``index_put`` through a boolean mask

    @property
    def wide(self) -> bool:
        return any(d in ("torch.float64", "torch.complex128") for d in self.dtypes)

    @property
    def host_sync(self) -> bool:
        """A read of device data on the host: a scalar read, a data-
        dependent shape, or a copy from a device to the CPU."""
        if self.op in HOST_SYNC_OPS or self.bool_index:
            return True
        return (
            self.op in COPY_OPS
            and "cpu" in self.out_devices
            and any(d != "cpu" for d in self.devices)
        )

    @property
    def host_bytes(self) -> int:
        """Bytes this op moves to the host (0 unless ``host_sync``)."""
        return max(self.moved_bytes, 1) if self.host_sync else 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "op": self.op, "out_bytes": self.out_bytes, "file": self.file,
            "line": self.line, "function": self.function, "in_kernel": self.in_kernel,
        }


@dataclass
class Recording:
    """The ops a call dispatched, in order."""

    ops: list[OpRecord] = field(default_factory=list)

    def outside_kernels(self, names: frozenset[str]) -> list[OpRecord]:
        return [r for r in self.ops if r.op in names and r.in_kernel is None]

    @property
    def gathers(self) -> list[OpRecord]:
        return self.outside_kernels(GATHER_OPS)

    @property
    def scatters(self) -> list[OpRecord]:
        return self.outside_kernels(SCATTER_OPS)

    @property
    def wide(self) -> list[OpRecord]:
        return [r for r in self.ops if r.wide]

    @property
    def host_syncs(self) -> list[OpRecord]:
        return [r for r in self.ops if r.host_sync]

    def largest(self) -> OpRecord | None:
        """The op with the largest fresh output."""
        return max(self.ops, key=lambda r: r.out_bytes, default=None)


_RELATIVE: dict[str, str | None] = {}


def _port_path(path: str) -> str | None:
    """``path`` relative to the repository if it is a port source outside
    this subpackage (or its fixtures), else None; memoized by path."""
    try:
        return _RELATIVE[path]
    except KeyError:
        pass
    rel = None
    if path.startswith(str(_PACKAGE)) and (not path.startswith(str(_ANALYSIS)) or path == _FIXTURES):
        rel = str(Path(path).relative_to(_REPO))
    _RELATIVE[path] = rel
    return rel


def _site(kernels: frozenset[str]) -> tuple[str | None, int | None, str | None, str | None]:
    """The innermost calling frame in the port outside this subpackage
    (but its fixtures), and the outermost kernel wrapper on the stack,
    if any."""
    frame = sys._getframe(2)
    site = None
    kernel = None
    while frame is not None:
        code = frame.f_code
        rel = _port_path(code.co_filename)
        if rel is not None:
            if site is None:
                site = (rel, frame.f_lineno, code.co_name)
            if code.co_name in kernels:
                kernel = code.co_name
        frame = frame.f_back
    if site is None:
        return None, None, None, kernel
    return (*site, kernel)


def _aliases(out: torch.Tensor, inputs: list[torch.Tensor]) -> bool:
    ptr = out.untyped_storage().data_ptr()
    return any(ptr == a.untyped_storage().data_ptr() for a in inputs)


class _Recorder(TorchDispatchMode):
    def __init__(self, kernels: frozenset[str]):
        super().__init__()
        self.kernels = kernels
        self.recording = Recording()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        outputs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        name = func.overloadpacket.__name__
        fresh = 0
        if not getattr(func, "is_view", False) and not func._schema.is_mutable:
            fresh = sum(
                o.untyped_storage().nbytes() for o in outputs if not _aliases(o, inputs)
            )
        bool_index = name in MASK_INDEX_OPS and any(
            isinstance(t, torch.Tensor) and t.dtype == torch.bool
            for t in tree_leaves(args[1] if len(args) > 1 else ()))
        moved = fresh
        if name in COPY_OPS and outputs:
            moved = outputs[0].numel() * outputs[0].element_size()
        elif name == "_local_scalar_dense" and inputs:
            moved = inputs[0].element_size()
        elif name in HOST_SYNC_OPS or bool_index:
            moved = 8  # the data-dependent size read on the host; the output stays
        file, line, function, kernel = _site(self.kernels)
        self.recording.ops.append(
            OpRecord(
                op=name,
                dtypes=tuple(str(t.dtype) for t in inputs + outputs),
                devices=tuple(t.device.type for t in inputs),
                out_devices=tuple(t.device.type for t in outputs),
                out_bytes=int(fresh),
                moved_bytes=int(moved),
                file=file,
                line=line,
                function=function,
                in_kernel=kernel,
                bool_index=bool_index,
            )
        )
        return out


def record_ops(fn: Callable, *args, **kwargs):
    """``(fn(*args, **kwargs), Recording)``: the result, and every aten
    op the call dispatched, each marked with the kernel wrapper
    (``cases.kernel_wrappers``) it ran under, if any."""
    from .cases import kernel_wrappers

    mode = _Recorder(frozenset(kernel_wrappers()))
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.recording


__all__ = [
    "COPY_OPS",
    "GATHER_OPS",
    "HOST_SYNC_OPS",
    "MASK_INDEX_OPS",
    "OpRecord",
    "Recording",
    "SCATTER_OPS",
    "record_ops",
]
