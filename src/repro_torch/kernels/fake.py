"""The dry-run's ledger of kernel calls on fake tensors.

Under ``torch._subclasses.fake_tensor.FakeTensorMode`` no kernel runs:
``kernels/ops.py`` sends a ``FakeTensor`` to the kernel's ``*_fake``
function, which returns unwritten outputs of the CUDA wrapper's shapes
and dtypes and charges the call here. ``launch/dryrun.py`` opens a
``KernelLedger`` with ``recording`` around a cell's step and reads it
after: calls per kernel, and the operations and bytes of PERF.md §6's
bound formulas. A fake call counts nothing in ``ops.launch_counts()``,
and with no ledger open it charges nothing.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Iterator, Optional


class KernelLedger:
    """Calls, operations and bytes of the kernels charged while it is open."""

    def __init__(self):
        self.calls: Counter = Counter()
        self.flops = 0.0
        self.bytes = 0.0

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        self.calls[name] += 1
        self.flops += flops
        self.bytes += nbytes


_OPEN: Optional[KernelLedger] = None


@contextlib.contextmanager
def recording(ledger: KernelLedger) -> Iterator[KernelLedger]:
    """Charge every fake kernel call made inside to ``ledger``; one ledger
    is open at a time."""
    global _OPEN
    if _OPEN is not None:
        raise RuntimeError("a kernel ledger is already open")
    _OPEN = ledger
    try:
        yield ledger
    finally:
        _OPEN = None


def charge(name: str, flops: float, nbytes: float) -> None:
    """Charge one call of kernel ``name`` to the open ledger, if any."""
    if _OPEN is not None:
        _OPEN.charge(name, flops, nbytes)
