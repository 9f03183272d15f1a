"""Query identity fingerprint for checkpoint validation.

Counterpart of `libgrape_lite_tpu/ft/fingerprint.py`, field for field.
A checkpoint is resumable only against the same computation: the same
app, fragment content, mesh shape, query arguments and numeric
configuration (the float width and the SpMV route change reduction
types or order, which would break the byte-identical resume).  Process
-local identities (cache keys, plan uids) are left out: they differ
between the killed process and the resuming one.

Two fields read the JAX package's config there and the app here:
`x64` is whether the app's float carry is 64-bit (the JAX package's
`jax_enable_x64`), `spmv_mode` the app's SpMV mode (the JAX package's
GRAPE_SPMV, default "auto").  `fragment_content_hash` hashes the same
arrays in the same order and dtypes as the JAX package, so one fragment
hashes equal in both and a lineage crosses between them.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

import numpy as np

FINGERPRINT_FORMAT = 1

# the dtypes the JAX package's host CSR keeps: a port array in another
# dtype is cast to these before hashing
_CSR_DTYPES = {"indptr": np.int32, "edge_nbr": np.int32,
               "edge_mask": np.bool_}


def stable_config_digest(obj: Any) -> str:
    """sha256 hex of a canonical-JSON rendering of `obj` (non-JSON
    leaves fall back to str())."""
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()
    ).hexdigest()


def app_registry_name(app) -> str:
    """The APP_REGISTRY name of this app instance (the first of its
    aliases, sorted), else the class name (tests, user subclasses)."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY

    names = sorted(k for k, v in APP_REGISTRY.items() if v is type(app))
    return names[0] if names else type(app).__name__


def _hash_array(h, a, dtype=None) -> None:
    a = np.asarray(a)
    if a.dtype == object:  # string oids
        for s in a.tolist():
            h.update(str(s).encode("utf-8"))
            h.update(b"\x00")
        return
    if dtype is not None and a.dtype != dtype:
        a = a.astype(dtype)
    h.update(np.ascontiguousarray(a).tobytes())


def fragment_content_hash(frag) -> str:
    """sha256 over the fragment's host CSR content (topology, weights,
    oid assignment) and shape metadata; cached on the fragment, whose
    host arrays never change after the build."""
    cached = getattr(frag, "_ft_content_hash", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    h.update(json.dumps({
        "fnum": frag.fnum,
        "vp": frag.vp,
        "directed": bool(frag.directed),
        "weighted": bool(frag.weighted),
    }, sort_keys=True).encode())
    aliased = frag.host_ie is frag.host_oe
    sides = [frag.host_oe] if aliased else [frag.host_oe, frag.host_ie]
    for f in range(frag.fnum):
        _hash_array(h, frag.inner_oids(f))
        for csrs in sides:
            c = csrs[f]
            for name in ("indptr", "edge_nbr", "edge_mask"):
                _hash_array(h, getattr(c, name), _CSR_DTYPES[name])
            if c.edge_w is not None:
                _hash_array(h, c.edge_w)
    digest = h.hexdigest()
    frag._ft_content_hash = digest
    return digest


def canonical_query_args(query_args: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-roundtrippable form of the query kwargs: numpy scalars become
    Python numbers; anything else must already be a JSON primitive (a
    resume replays these through `init_state`)."""
    out = {}
    for k, v in sorted(query_args.items()):
        if isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        elif isinstance(v, np.bool_):
            v = bool(v)
        if not isinstance(v, (int, float, str, bool, type(None))):
            raise TypeError(
                f"query arg {k!r}={v!r} is not checkpointable (must be a "
                "JSON primitive so resume can replay it through init_state)"
            )
        out[k] = v
    return out


def float_carry_is_64bit(carry: Optional[Dict[str, Any]]) -> bool:
    """True when a float leaf of the carry is 64-bit (the port's
    counterpart of the JAX package's x64 switch)."""
    for v in (carry or {}).values():
        dt = getattr(v, "dtype", None)
        if dt is None:
            continue
        if hasattr(dt, "is_floating_point"):  # a torch dtype
            if dt.is_floating_point and dt.itemsize == 8:
                return True
        elif np.dtype(dt).kind == "f" and np.dtype(dt).itemsize == 8:
            return True
    return False


def processes() -> int:
    """`torch.distributed`'s world size when a group is up, else 1."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:
        pass
    return 1


def compute_fingerprint(app, frag, query_args: Dict[str, Any], *,
                        carry: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """The identity a checkpoint must match to be resumed.  `carry` is
    the query's initial carry (its float width fills `x64`)."""
    return {
        "format": FINGERPRINT_FORMAT,
        "app": app_registry_name(app),
        "app_class": type(app).__name__,
        "fragment_hash": fragment_content_hash(frag),
        "fnum": frag.fnum,
        "vp": frag.vp,
        "query_args": canonical_query_args(query_args),
        "x64": float_carry_is_64bit(carry),
        "spmv_mode": str(getattr(app, "spmv_mode", "auto")),
        # the partition layout (GRAPE_PARTITION, as the JAX package
        # reads it): a 2-D snapshot never restores into a 1-D worker
        # silently
        "partition_mode": _partition_mode(),
        "processes": processes(),
    }


def _partition_mode() -> str:
    # local import: the fingerprint module imports standalone
    from libgrape_lite_tpu_torch.fragment.partition import partition_mode

    return partition_mode()


def fingerprint_mismatch(expected: Dict, found: Dict) -> list[str]:
    """Human-readable list of differing fingerprint fields."""
    keys = sorted(set(expected) | set(found))
    return [
        f"{k}: checkpoint has {found.get(k)!r}, query has {expected.get(k)!r}"
        for k in keys
        if expected.get(k) != found.get(k)
    ]
