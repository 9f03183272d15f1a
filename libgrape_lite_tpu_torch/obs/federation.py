"""Stats federation: one registry for every ``*_STATS`` surface.

Counterpart of `libgrape_lite_tpu/obs/federation.py`.  Each stats surface
registers under a namespace at import of the module that owns it; the
federation gives them one namespace-keyed `snapshot()` / `reset()`, and
`self_check()` imports every owner named in `EXPECTED` and demands a
live, JSON-serializable registration, so a namespace declared and never
wired fails loudly.  The federation imports nothing outside the standard
library, so any module can register without an import cycle.

`FederatedStats` is a `dict` that registers itself: hot paths keep the
plain ``STATS["k"] += 1`` idiom, and snapshots copy lists and dicts
under the federation lock.

`EXPECTED` holds the namespaces this package registers, each scraped by
the live exporter (obs/exporter.py) and copied into every postmortem
bundle (obs/recorder.py): the JAX package's namespaces but `gang` (its
owner, `obs/gang.py`, waits for the multi-process runtime), its
`calibration` (registered by the rate profile, not listed in the JAX
`EXPECTED`), and `guarded_batch`
(serve/batch.py's counters, which the JAX package does not keep).
grape-lint's R8 (analysis/astlint.py) makes a module-level ``*_STATS``
surface outside the federation a finding.
"""

from __future__ import annotations

import copy
import json
import threading
from typing import Any, Callable, Dict, List, Optional

# namespace -> {"snapshot": fn, "reset": fn | None, "module": str}
_REGISTRY: Dict[str, Dict[str, Any]] = {}
_LOCK = threading.Lock()

#: every namespace the package must register, and the module whose
#: import registers it
EXPECTED: Dict[str, str] = {
    "plan": "libgrape_lite_tpu_torch.ops.spmv",
    "spgemm": "libgrape_lite_tpu_torch.ops.spgemm_pack",
    "partition": "libgrape_lite_tpu_torch.fragment.partition",
    "pump": "libgrape_lite_tpu_torch.serve.pipeline",
    "fleet": "libgrape_lite_tpu_torch.fleet.budget",
    "slo": "libgrape_lite_tpu_torch.obs.slo",
    "recorder": "libgrape_lite_tpu_torch.obs.recorder",
    "autopilot": "libgrape_lite_tpu_torch.autopilot.signals",
    "vc_tiles": "libgrape_lite_tpu_torch.fragment.vertexcut",
    "calibration": "libgrape_lite_tpu_torch.ops.calibration",
    "guarded_batch": "libgrape_lite_tpu_torch.serve.batch",
    "pipeline": "libgrape_lite_tpu_torch.parallel.pipeline",
}


def register(
    namespace: str,
    snapshot: Callable[[], Dict[str, Any]],
    reset: Optional[Callable[[], None]] = None,
    module: str = "",
) -> None:
    """Register one stats surface under `namespace`.  Registering the
    same namespace again overwrites (a reloaded module); two different
    modules claiming one namespace raises."""
    if not namespace or not namespace.replace("_", "").isalnum():
        raise ValueError(f"bad federation namespace: {namespace!r}")
    with _LOCK:
        prev = _REGISTRY.get(namespace)
        if (prev is not None and module and prev["module"]
                and prev["module"] != module):
            raise ValueError(
                f"federation namespace {namespace!r} already registered "
                f"by {prev['module']} (now: {module})")
        _REGISTRY[namespace] = {
            "snapshot": snapshot, "reset": reset, "module": module,
        }


def registered() -> List[str]:
    """The registered namespaces, sorted."""
    with _LOCK:
        return sorted(_REGISTRY)


def _entry(namespace: str) -> Dict[str, Any]:
    ent = _REGISTRY.get(namespace)
    if ent is None:
        raise KeyError(f"unregistered federation namespace: {namespace!r}")
    return ent


def snapshot(namespace: Optional[str] = None) -> Dict[str, Any]:
    """One read of every registered surface, ``{namespace: {field:
    value}}``; with a namespace, that namespace's fields."""
    with _LOCK:
        if namespace is not None:
            return dict(_entry(namespace)["snapshot"]())
        return {ns: dict(ent["snapshot"]())
                for ns, ent in sorted(_REGISTRY.items())}


def reset(namespace: Optional[str] = None) -> None:
    """Reset one namespace, or every namespace that supports it."""
    with _LOCK:
        ents = ([_entry(namespace)] if namespace is not None
                else list(_REGISTRY.values()))
    for ent in ents:
        if ent["reset"] is not None:
            ent["reset"]()


def self_check() -> List[str]:
    """The wiring errors, [] when clean: imports every `EXPECTED` owner,
    then demands that its namespace is registered, by that module, with
    a snapshot that is a JSON-serializable dict."""
    import importlib

    errors: List[str] = []
    for ns, owner in sorted(EXPECTED.items()):
        try:
            importlib.import_module(owner)
        except Exception as e:  # a partial checkout
            errors.append(f"{ns}: owner module {owner} failed to import: "
                          f"{type(e).__name__}: {e}")
            continue
        with _LOCK:
            ent = _REGISTRY.get(ns)
        if ent is None:
            errors.append(f"{ns}: declared in federation.EXPECTED but never "
                          f"registered by {owner}")
            continue
        if ent["module"] and ent["module"] != owner:
            errors.append(f"{ns}: registered by {ent['module']}, declared "
                          f"owner is {owner}")
        try:
            snap = ent["snapshot"]()
        except Exception as e:
            errors.append(f"{ns}: snapshot() raised {type(e).__name__}: {e}")
            continue
        if not isinstance(snap, dict):
            errors.append(f"{ns}: snapshot() returned "
                          f"{type(snap).__name__}, want dict")
            continue
        try:
            json.dumps(snap)
        except (TypeError, ValueError) as e:
            errors.append(f"{ns}: snapshot() not JSON-serializable: {e}")
    return errors


class FederatedStats(dict):
    """A module-level stats dict that registers itself at construction:
    mutation sites keep ``STATS["k"] += 1``; `snapshot()` copies lists
    and dicts, `reset()` restores the initial state."""

    def __init__(self, namespace: str, initial: Dict[str, Any]):
        super().__init__(copy.deepcopy(initial))
        self.namespace = namespace
        self._initial = copy.deepcopy(initial)
        register(namespace, self.snapshot, self.reset,
                 module=(self.__class__.__module__
                         if type(self) is not FederatedStats
                         else _caller_module()))

    def snapshot(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            if isinstance(v, list):
                out[k] = list(v)
            elif isinstance(v, dict):
                out[k] = dict(v)
            else:
                out[k] = v
        return out

    def reset(self) -> None:
        self.clear()
        self.update(copy.deepcopy(self._initial))


def _caller_module() -> str:
    """The module whose body constructs a FederatedStats: its owner."""
    import inspect

    frame = inspect.currentframe()
    try:
        f = frame.f_back.f_back  # _caller_module <- __init__ <- owner
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod != __name__:
                return mod
            f = f.f_back
        return ""
    finally:
        del frame
