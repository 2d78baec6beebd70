"""Runtime sanitizer switches — the part of ``kubeflow_tpu/runtime/
sanitize.py`` the port's page allocator reads: ``KFTPU_SANITIZE`` mode
parsing (``enabled``) and the ``file:line`` owner stamp (``call_site``).

``KFTPU_SANITIZE=refcount`` makes ``serve/paged.PageAllocator`` stamp every
page reference with its owner (a request id, else the allocating call
site), so ``assert_quiescent`` names who leaked. The JAX package's other
modes (transfer guard, lock-order and thread watchdogs, the recompile and
contract auditors) have no counterpart here yet; their names still parse,
so one setting serves both packages.
"""

from __future__ import annotations

import os
import sys

_KNOWN_MODES = frozenset({"transfer", "refcount", "lockorder",
                          "recompile", "contract", "threads"})


def sanitize_modes() -> frozenset:
    """The active sanitizer modes from ``KFTPU_SANITIZE``. Legacy truthy
    values (``1``/``on``/anything unrecognized) mean ``transfer``."""
    raw = os.environ.get("KFTPU_SANITIZE", "")
    if raw.strip() in ("", "0"):
        return frozenset()
    out: set[str] = set()
    for tok in raw.split(","):
        t = tok.strip().lower()
        if not t:
            continue
        if t == "all":
            out |= _KNOWN_MODES
        elif t in _KNOWN_MODES:
            out.add(t)
        else:
            out.add("transfer")
    return frozenset(out)


def enabled(mode: str) -> bool:
    return mode in sanitize_modes()


def call_site(skip_files: tuple = ()) -> str:
    """``file:line`` of the nearest caller frame outside this module and
    ``skip_files`` — the owner stamp for refcount mode."""
    skip = (__file__,) + tuple(skip_files)
    frame = sys._getframe(1)
    for _ in range(32):
        if frame is None:
            break
        fname = frame.f_code.co_filename
        if fname not in skip and "threading" not in os.path.basename(fname):
            return f"{os.path.basename(fname)}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"
