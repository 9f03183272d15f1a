"""The rate profile: the port's one source of pricing rates, fitted on the card.

Counterpart of `libgrape_lite_tpu/ops/calibration.py`.  Every priced
decision of the port reads one :class:`RateProfile`: the spgemm / intersect
choice of ``GRAPE_LCC_BACKEND=auto`` (`ops/spgemm_pack.py`), the 1-D / 2-D
partition ledger (`fragment/partition.py`), the autopilot's wall price of
a query (`autopilot/admission.py`) and the bound column of `chip_smoke.py`.

* :func:`default_profile` -- ``"h100-sxm-datasheet"``: one H100 SXM's
  data-sheet rates (67 T float32 operations a second outside the tensor
  cores, gather rows at the same rate, 3.35 TB/s of HBM3, 80 GB), the
  constants the port priced with before it had a profile.  With no
  profile configured every decision is what it was, bit for bit.  Every
  rate of it is listed in ``unfitted``: none was measured.
* :func:`active_profile` -- ``GRAPE_RATE_PROFILE=<path>`` loads a
  schema-checked profile file; a bad file raises (:class:`CalibrationError`)
  and never falls back to the data sheet.
* :func:`fit_rates` -- weighted least squares of measured walls over
  exact column counts (``const``, ``ops``, ``gather_rows``,
  ``hbm_bytes``), rows weighted by 1/wall so the fit minimises relative
  error, columns normalised, the design's condition capped at
  :data:`COND_LIMIT`.  Underdetermined, rank-deficient, ill-conditioned or
  non-positive fits raise; a negative intercept refits without ``const``;
  inherited rates are recorded in ``unfitted``.
  :func:`fit_rates_auto` walks :data:`REGRESSOR_FALLBACK` from the richest
  column set to the poorest and notes every refused step.
* :func:`microbench_samples` -- the seeded sweep: the port's own kernels
  timed on the card with CUDA events (warm-up first, best of `repeats`,
  a synchronize before the read) over RMAT graphs of several scales and
  edge factors: K1 (`gather_reduce`) as a float sum, a float min with
  weights and an int32 min; K2 (`spmv_strict`); K3 (the two
  `row_and_popcount_indexed` calls of a bitmap LCC); the spgemm credit
  pass.  Each sample's columns are counted from its geometry (and K3's
  bytes from its pairs) by the functions below, which the consumers price
  with.  The spgemm pass is HELD_OUT: measured and reported, neither
  fitted nor gated.
* :func:`harvest_from_worker` -- the live harvest, armed by
  ``GRAPE_CALIBRATE_HARVEST=1`` (disarmed: one environment read).  The
  port's serving session times a query's execution on the host, ended by
  the last round's vote read (its ``device_us`` stage is 0: one loop
  enqueues and waits in turns), so the harvest joins that wall to the
  worker's K1 columns a round times its rounds (times the lanes of a
  batch).  :func:`harvest_overlap` adds the overlap truth meter's rows
  (obs/truth.py): a pipelined query's measured rounds against its plan's
  edge and exchange-byte columns.
* :func:`drift_report` -- modelled against measured seconds per surface;
  `calibrate --check` exits 2 past :data:`DRIFT_TOLERANCE`.

The wall model is additive, linear in the columns and so exactly fittable:

    wall = dispatch_overhead_s * const + ops / ops_per_s
         + gather_rows / gather_per_s + hbm_bytes / hbm_bps

``exchange_bps`` (keyed by exchange mode as the JAX package's) prices the
partition ledger's exchange bytes.  On one card nothing crosses a link
(`StepContext.gather_state` is a reshape), so no sweep measures it and it
stays unfitted.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PROFILE_ENV = "GRAPE_RATE_PROFILE"
HARVEST_ENV = "GRAPE_CALIBRATE_HARVEST"
PROFILE_SCHEMA_VERSION = 1
SAMPLES_SCHEMA_VERSION = 1

#: modelled-vs-measured drift past this fraction fails the gate
DRIFT_TOLERANCE = 0.05

#: column-normalised design matrices worse than this are refused: the
#: samples cannot separate the requested rates
COND_LIMIT = 1e6

#: the regressor columns a sample may carry, in fit order
REGRESSORS = ("const", "ops", "gather_rows", "hbm_bytes")

#: the rate field each non-constant column prices
RATE_OF = {"ops": "ops_per_s", "gather_rows": "gather_per_s",
           "hbm_bytes": "hbm_bps"}

#: every rate field a profile may leave unmeasured
RATE_FIELDS = ("exchange_bps", "gather_per_s", "hbm_bps", "ops_per_s")

EXCHANGE_MODES = ("gather", "mirror", "vc2d")

#: one H100 SXM's data sheet: float32 outside the tensor cores, HBM3,
#: NVLink 4 (900 GB/s), 80 GB of device memory
H100_FP32_OPS_PER_S = 67e12
H100_HBM_BPS = 3.35e12
H100_NVLINK_BPS = 900e9
H100_HBM_CAPACITY_BYTES = 80 * 10**9


class CalibrationError(RuntimeError):
    """A sample set that cannot identify the requested rates
    (underdetermined, rank-deficient, ill-conditioned or a non-positive
    rate), or a profile or samples file that fails its schema."""


@dataclass(frozen=True)
class RateProfile:
    """The pricing rates.  The default instance is the H100 data sheet; a
    fitted one carries the device it was measured on (`fingerprint`), how
    (`source`), its RMS relative error (`residual`) and the rate fields it
    inherited instead of measuring (`unfitted`)."""

    name: str = "h100-sxm-datasheet"
    ops_per_s: float = H100_FP32_OPS_PER_S
    # gather rows at the op rate: the data sheet gives no gather rate
    gather_per_s: float = H100_FP32_OPS_PER_S
    hbm_bps: float = H100_HBM_BPS
    exchange_bps: Dict[str, float] = field(default_factory=lambda: {
        m: H100_NVLINK_BPS for m in EXCHANGE_MODES})
    hbm_capacity_bytes: int = H100_HBM_CAPACITY_BYTES
    dispatch_overhead_s: float = 0.0
    fingerprint: str = "datasheet"
    fitted: bool = False
    source: str = "datasheet"
    residual: float = 0.0
    unfitted: Tuple[str, ...] = RATE_FIELDS

    def coefficient(self, reg: str) -> float:
        """Seconds a unit of column `reg` costs under this profile."""
        if reg == "const":
            return self.dispatch_overhead_s
        return 1.0 / getattr(self, RATE_OF[reg])

    def with_coefficient(self, reg: str, coeff: float) -> "RateProfile":
        if reg == "const":
            return replace(self, dispatch_overhead_s=coeff)
        return replace(self, **{RATE_OF[reg]: 1.0 / coeff})

    def wall_s(self, sample: dict) -> float:
        """The additive wall model for one sample's columns (an absent
        column prices as zero, an absent `const` as one dispatch)."""
        return (self.dispatch_overhead_s * float(sample.get("const", 1))
                + float(sample.get("ops", 0)) / self.ops_per_s
                + float(sample.get("gather_rows", 0)) / self.gather_per_s
                + float(sample.get("hbm_bytes", 0)) / self.hbm_bps)

    def measured(self, rate: str) -> bool:
        """True when the fit identified `rate` from samples."""
        return self.fitted and rate not in self.unfitted

    def label(self) -> str:
        """What decision records carry: a decision made under a stale
        profile is attributable."""
        return f"{self.name}@{self.fingerprint}"

    def as_dict(self) -> dict:
        return {
            "schema": PROFILE_SCHEMA_VERSION,
            "name": self.name,
            "ops_per_s": self.ops_per_s,
            "gather_per_s": self.gather_per_s,
            "hbm_bps": self.hbm_bps,
            "exchange_bps": dict(self.exchange_bps),
            "hbm_capacity_bytes": int(self.hbm_capacity_bytes),
            "dispatch_overhead_s": self.dispatch_overhead_s,
            "fingerprint": self.fingerprint,
            "fitted": self.fitted,
            "source": self.source,
            "residual": self.residual,
            "unfitted": list(self.unfitted),
        }

    @staticmethod
    def from_dict(d: dict) -> "RateProfile":
        errors = validate_profile(d)
        if errors:
            raise CalibrationError("invalid rate profile: "
                                   + "; ".join(errors))
        return RateProfile(
            name=d["name"],
            ops_per_s=float(d["ops_per_s"]),
            gather_per_s=float(d["gather_per_s"]),
            hbm_bps=float(d["hbm_bps"]),
            exchange_bps={k: float(v) for k, v in d["exchange_bps"].items()},
            hbm_capacity_bytes=int(d["hbm_capacity_bytes"]),
            dispatch_overhead_s=float(d["dispatch_overhead_s"]),
            fingerprint=d["fingerprint"],
            fitted=d["fitted"],
            source=d["source"],
            residual=float(d["residual"]),
            unfitted=tuple(d["unfitted"]),
        )


#: profile schema: field -> (types, must be positive).  bool is an int
#: subclass and is rejected in every numeric field
_NUM = (int, float)
_PROFILE_FIELDS = {
    "schema": (int, False),
    "name": (str, False),
    "ops_per_s": (_NUM, True),
    "gather_per_s": (_NUM, True),
    "hbm_bps": (_NUM, True),
    "exchange_bps": (dict, False),
    "hbm_capacity_bytes": (_NUM, True),
    "dispatch_overhead_s": (_NUM, False),  # zero is legal
    "fingerprint": (str, False),
    "fitted": (bool, False),
    "source": (str, False),
    "residual": (_NUM, False),
    "unfitted": (list, False),
}


def _positive(v) -> bool:
    return (not isinstance(v, bool) and isinstance(v, _NUM) and v > 0
            and bool(np.isfinite(v)))


def validate_profile(d) -> List[str]:
    """Schema errors of one profile dict (empty: valid): required fields,
    numeric types with bool rejected, positive finite rates, a finite
    non-negative overhead, the exchange modes, known `unfitted` names;
    unknown keys are errors."""
    if not isinstance(d, dict):
        return [f"profile must be a dict, got {type(d).__name__}"]
    errors: List[str] = []
    for key, (typ, positive) in _PROFILE_FIELDS.items():
        if key not in d:
            errors.append(f"missing field {key!r}")
            continue
        v = d[key]
        if typ is not bool and isinstance(v, bool):
            errors.append(f"{key}: bool is not a number")
            continue
        if not isinstance(v, typ):
            want = getattr(typ, "__name__", "number")
            errors.append(f"{key}: expected {want}, got {type(v).__name__}")
            continue
        if positive and not _positive(v):
            errors.append(f"{key}: must be a positive finite number")
    errors += [f"unknown field {key!r}" for key in d
               if key not in _PROFILE_FIELDS]
    schema = d.get("schema")
    if (isinstance(schema, int) and not isinstance(schema, bool)
            and schema != PROFILE_SCHEMA_VERSION):
        errors.append(f"schema {schema} != {PROFILE_SCHEMA_VERSION}")
    over = d.get("dispatch_overhead_s")
    if (isinstance(over, _NUM) and not isinstance(over, bool)
            and not (over >= 0 and np.isfinite(over))):
        errors.append("dispatch_overhead_s: must be finite and >= 0")
    ex = d.get("exchange_bps")
    if isinstance(ex, dict):
        errors += [f"exchange_bps[{k!r}]: must be a positive finite number"
                   for k, v in ex.items() if not _positive(v)]
        errors += [f"exchange_bps: unknown mode {k!r}" for k in ex
                   if k not in EXCHANGE_MODES]
        errors += [f"exchange_bps missing mode {m!r}"
                   for m in EXCHANGE_MODES if m not in ex]
    uf = d.get("unfitted")
    if isinstance(uf, list):
        errors += [f"unfitted: {x!r} is not a rate field" for x in uf
                   if x not in RATE_FIELDS]
    return errors


_DEFAULT = RateProfile()


def default_profile() -> RateProfile:
    """The H100 SXM data-sheet profile: the rates every consumer priced
    with before the port had a profile."""
    return _DEFAULT


def _device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def backend_fingerprint(device=None) -> str:
    """``cuda:<card name>`` or ``cpu:cpu``: the device a persisted
    profile or sample set was measured on."""
    dev = _device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


def device_capacity_bytes(device=None) -> Optional[int]:
    """The card's memory (`total_memory`), None off the card."""
    dev = _device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def _write_json(doc: dict, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def save_profile(profile: RateProfile, path: str) -> str:
    """Write one schema-checked profile file (atomic replace)."""
    d = profile.as_dict()
    errors = validate_profile(d)
    if errors:
        raise CalibrationError("refusing to save an invalid profile: "
                               + "; ".join(errors))
    return _write_json(d, path)


def load_profile(path: str) -> RateProfile:
    """Load and schema-check one profile file; every failure raises
    CalibrationError."""
    try:
        with open(path) as f:
            d = json.load(f)
    except OSError as e:
        raise CalibrationError(f"cannot read rate profile {path!r}: {e}") \
            from e
    except json.JSONDecodeError as e:
        raise CalibrationError(
            f"rate profile {path!r} is not valid JSON: {e}") from e
    return RateProfile.from_dict(d)


_ACTIVE_CACHE: Dict[Tuple[str, float], RateProfile] = {}


def active_profile() -> RateProfile:
    """The profile every consumer prices from: the file named by
    GRAPE_RATE_PROFILE (memoised by path and mtime), else the data sheet.
    Read at every call, so installing or swapping a profile takes effect
    at the next decision."""
    path = os.environ.get(PROFILE_ENV, "")
    if not path:
        return _DEFAULT
    try:
        key = (os.path.abspath(path), os.path.getmtime(path))
    except OSError as e:
        raise CalibrationError(
            f"{PROFILE_ENV}={path!r} is not readable: {e}") from e
    prof = _ACTIVE_CACHE.get(key)
    if prof is None:
        prof = load_profile(path)
        _ACTIVE_CACHE.clear()  # one live file; older mtimes are stale
        _ACTIVE_CACHE[key] = prof
    return prof


def profile_label(profile: Optional[RateProfile] = None) -> str:
    return (profile or active_profile()).label()


# ---- the columns, counted from the geometry ------------------------------

def k1_columns_geom(fnum: int, vp: int, edges: int, weighted: bool) -> dict:
    """One K1 call (`gather_reduce`) over a stacked in-CSR of `edges` real
    edges: one gathered row and one (+) an edge, one (*) more with
    weights; bytes (4 each: x is float32 or int32): nbr (and w) once an
    edge, indptr once a row, x read once and y written once (K1 stops at
    indptr[vp] and reads no pad)."""
    per_edge = 2 if weighted else 1
    rows = fnum * vp
    return {"ops": edges * per_edge, "gather_rows": edges,
            "hbm_bytes": 4 * edges * per_edge + 4 * (rows + fnum) + 8 * rows}


def k1_columns(fragment, weighted: Optional[bool] = None) -> Optional[dict]:
    """`k1_columns_geom` of one pull over `fragment`'s in-CSR (with its
    weights when `weighted` is None and it carries them); None for a
    fragment without a stacked in-CSR (the vertex cut)."""
    host_ie = getattr(fragment, "host_ie", None)
    if not host_ie:
        return None
    edges = int(sum(int(c.num_edges) for c in host_ie))
    if weighted is None:
        weighted = bool(getattr(fragment, "weighted", False))
    return k1_columns_geom(fragment.fnum, fragment.vp, edges, weighted)


def strict_columns_geom(fnum: int, vp: int, ep: int, tiles: int) -> dict:
    """One K2 call (`spmv_strict`): an add a slot of the [fnum, Ep]
    values, each of values, edge_src and the tiles' row_lo read once, y
    written once; nothing gathered."""
    return {"ops": fnum * ep, "gather_rows": 0,
            "hbm_bytes": 8 * fnum * ep + 4 * fnum * tiles + 4 * fnum * vp}


def intersect_columns(ledger: dict) -> dict:
    """Intersect (K3) as `GRAPE_LCC_BACKEND=auto` prices it before any
    bitmap exists (`intersect_ledger`: every bitmap row read)."""
    return {"ops": int(ledger["word_ops"]), "gather_rows": 0,
            "hbm_bytes": int(ledger["hbm_bytes"])}


def intersect_call_columns(ledger: dict, calls) -> dict:
    """The K3 calls of one bitmap LCC as the sweep times them: the
    ledger's `word_ops`, the column `auto` prices intersect by; the bytes
    the calls read, counted as chip_smoke.py's K3 bound counts them: each
    call's distinct rows once (its occupancy summary reads them whole)
    and 12 bytes a pair (two row indices, one count).  `calls`: (distinct
    rows, pairs, words) a call."""
    return {"ops": int(ledger["word_ops"]), "gather_rows": 0,
            "hbm_bytes": sum(4 * rows * words + 12 * pairs
                             for rows, pairs, words in calls)}


def spgemm_columns(ledger: dict) -> dict:
    """The spgemm credit pass as `auto` prices it: its ledger's op
    columns summed, its gather rows and its bytes."""
    t = ledger["totals"]
    return {"ops": int(t["vpu_ops"]) + int(t["mxu_ops"]),
            "gather_rows": int(t["gather_rows"]),
            "hbm_bytes": int(t["hbm_bytes"])}


# ---- fitting --------------------------------------------------------------

@dataclass(frozen=True)
class FitResult:
    profile: RateProfile
    regressors: Tuple[str, ...]
    coefficients: Dict[str, float]
    residual: float  # RMS relative error over the samples
    cond: float  # condition of the weighted, column-normalised design
    samples: int


def fit_rates(samples: Sequence[dict],
              regressors: Sequence[str] = REGRESSORS,
              base: Optional[RateProfile] = None,
              name: str = "fitted", source: str = "microbench",
              device=None) -> FitResult:
    """Weighted least squares of measured walls over the samples' columns.

    Each sample: ``{"wall_s": seconds, "surface": str, <columns>}``.  Rows
    are weighted by 1/wall, so the fit minimises relative error.  Columns
    not in `regressors` that the samples carry are priced at `base`'s
    rates and subtracted from the walls first; their rates, and those of
    requested columns the samples never vary, are inherited and listed in
    ``unfitted``, as is ``exchange_bps``.

    Raises CalibrationError when the samples cannot identify the rates:
    fewer samples than live columns, a condition past COND_LIMIT, rank
    deficiency, or a non-positive rate.  A negative intercept refits
    without ``const``.  The profile records `device`'s fingerprint and,
    on a card, its memory."""
    base = base or default_profile()
    for r in regressors:
        if r not in REGRESSORS:
            raise ValueError(f"unknown regressor {r!r}")
    samples = list(samples)
    if not samples:
        raise CalibrationError("no samples to fit")
    y = np.array([float(s["wall_s"]) for s in samples])
    if not np.all(np.isfinite(y)) or np.any(y <= 0):
        raise CalibrationError("measured walls must be positive finite "
                               "seconds")

    def col(reg: str) -> np.ndarray:
        if reg == "const":
            return np.ones(len(samples))
        return np.array([float(s.get(reg, 0)) for s in samples])

    live = [r for r in regressors if np.any(col(r) != 0)]
    inherited = [r for r in REGRESSORS
                 if r not in live and np.any(col(r) != 0)]
    if not live:
        raise CalibrationError("every requested column is zero")
    if len(samples) < len(live):
        raise CalibrationError(
            f"{len(samples)} samples cannot identify {len(live)} rates "
            f"({', '.join(live)}): extend the sweep")
    y_adj = y.copy()
    for r in inherited:
        y_adj -= col(r) * base.coefficient(r)
    if np.any(y_adj <= 0):
        raise CalibrationError(
            "inherited-rate contributions exceed the measured walls "
            f"(inherited: {', '.join(inherited)}): the base profile "
            "overprices these samples; fit those columns too")
    a = np.stack([col(r) for r in live], axis=1)
    w = 1.0 / y  # relative-error weighting
    aw = a * w[:, None]
    yw = y_adj * w
    norms = np.linalg.norm(aw, axis=0)
    if np.any(norms == 0):
        raise CalibrationError("degenerate design column")
    cond = float(np.linalg.cond(aw / norms))
    if not np.isfinite(cond) or cond > COND_LIMIT:
        raise CalibrationError(
            f"design matrix condition {cond:.3g} past {COND_LIMIT:g}: the "
            f"samples cannot separate ({', '.join(live)}); vary the "
            "geometry (weights, edge factor, types, K3 and spgemm)")
    coef_n, _, rank, _ = np.linalg.lstsq(aw / norms, yw, rcond=None)
    if rank < len(live):
        raise CalibrationError(f"rank-deficient design ({rank} < "
                               f"{len(live)})")
    coef = coef_n / norms
    for r, c in zip(live, coef):
        if r != "const" and c <= 0:
            raise CalibrationError(
                f"fitted coefficient for {r} is non-positive ({c:.3g}): "
                f"collinear samples; extend the sweep or drop {r}")
    if "const" in live and coef[live.index("const")] <= 0:
        # a negative overhead must not ship, and clamping it to zero
        # would leave the other rates fitted against an intercept that
        # no longer exists: refit without the const column
        return fit_rates(samples, [r for r in regressors if r != "const"],
                         base=base, name=name, source=source, device=device)
    profile = base
    coeffs = {}
    for r, c in zip(live, coef):
        coeffs[r] = float(c)
        profile = profile.with_coefficient(r, float(c))
    modeled = np.array([profile.wall_s(s) for s in samples])
    residual = float(np.sqrt(np.mean(((modeled - y) / y) ** 2)))
    measured = {RATE_OF[r] for r in live if r != "const"}
    capacity = device_capacity_bytes(device)
    profile = replace(
        profile, name=name, source=source, fitted=True,
        fingerprint=backend_fingerprint(device), residual=residual,
        hbm_capacity_bytes=(capacity if capacity is not None
                            else profile.hbm_capacity_bytes),
        unfitted=tuple(sorted(set(RATE_FIELDS) - measured)))
    return FitResult(profile=profile, regressors=tuple(live),
                     coefficients=coeffs, residual=residual, cond=cond,
                     samples=len(samples))


#: the fit chain: the richest column set first; each step drops the
#: column the samples most often cannot separate (gather rows move with
#: K1's bytes, then bytes with its operations).  Dropped columns are
#: inherited and recorded, never silent.
REGRESSOR_FALLBACK: Tuple[Tuple[str, ...], ...] = (
    ("const", "ops", "gather_rows", "hbm_bytes"),
    ("const", "ops", "hbm_bytes"),
    ("const", "ops"),
)


def fit_rates_auto(samples: Sequence[dict],
                   base: Optional[RateProfile] = None,
                   name: str = "fitted", source: str = "microbench",
                   device=None) -> Tuple[FitResult, List[str]]:
    """`fit_rates` down REGRESSOR_FALLBACK: the richest set the samples
    identify wins.  Returns (fit, notes), a note for every refused step;
    raises the last step's CalibrationError when none fits."""
    notes: List[str] = []
    last: Optional[CalibrationError] = None
    for regs in REGRESSOR_FALLBACK:
        try:
            return fit_rates(samples, regs, base=base, name=name,
                             source=source, device=device), notes
        except CalibrationError as e:
            notes.append(f"{'+'.join(regs)}: {e}")
            last = e
    raise last  # type: ignore[misc]


def default_min_wall_s(device=None) -> float:
    """Samples under this wall are left out of a fit: on the CPU a call
    under 20 ms is scheduler noise; CUDA events time the card to the
    microsecond, so nothing is dropped there."""
    return 0.0 if _device(device).type == "cuda" else 0.020


def save_samples(samples: Sequence[dict], path: str, device=None) -> str:
    """Persist one measured sample set: `calibrate --check --samples`
    gates against the recorded measurement."""
    return _write_json({"schema": SAMPLES_SCHEMA_VERSION,
                        "fingerprint": backend_fingerprint(device),
                        "samples": [dict(s) for s in samples]}, path)


def load_samples(path: str) -> List[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CalibrationError(
            f"cannot read calibration samples {path!r}: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("samples"), list):
        raise CalibrationError(
            f"calibration samples {path!r}: expected "
            "{schema, fingerprint, samples: [...]}")
    out = []
    for i, s in enumerate(doc["samples"]):
        if not isinstance(s, dict) or "wall_s" not in s:
            raise CalibrationError(
                f"calibration samples {path!r}: entry {i} has no wall_s")
        if not _positive(s["wall_s"]):
            raise CalibrationError(
                f"calibration samples {path!r}: entry {i} wall_s must be a "
                "positive number")
        out.append(dict(s))
    return out


def drift_report(profile: RateProfile, samples: Sequence[dict]) -> dict:
    """Modelled against measured seconds of `profile` over `samples`, per
    surface (the `surface` tag) and overall.  A surface's drift is the
    aggregate ``|sum(modelled) - sum(measured)| / sum(measured)``, the bias
    a priced decision would see; the gate reads the worst surface, and
    the worst single sample is reported beside it."""
    by: Dict[str, Dict[str, float]] = {}
    worst_sample = 0.0
    for s in samples:
        m = profile.wall_s(s)
        t = float(s["wall_s"])
        e = by.setdefault(s.get("surface", "unknown"),
                          {"modeled_s": 0.0, "measured_s": 0.0,
                           "samples": 0})
        e["modeled_s"] += m
        e["measured_s"] += t
        e["samples"] += 1
        worst_sample = max(worst_sample, abs(m - t) / t)
    max_drift = 0.0
    for e in by.values():
        drift = abs(e["modeled_s"] - e["measured_s"]) / max(
            e["measured_s"], 1e-12)
        e["drift_pct"] = round(drift * 100.0, 3)
        max_drift = max(max_drift, drift)
    return {
        "profile": profile.label(),
        "surfaces": by,
        "drift_pct": round(max_drift * 100.0, 3),
        "max_sample_drift_pct": round(worst_sample * 100.0, 3),
        "drift_ok": bool(max_drift <= DRIFT_TOLERANCE),
        "tolerance_pct": DRIFT_TOLERANCE * 100.0,
    }


# ---- the seeded sweep ------------------------------------------------------

SURFACES = ("k1_sum", "k1_min_w", "k1_i32_min", "k2_strict", "k3_intersect",
            "spgemm")
#: measured and reported under the fitted profile, neither fitted nor
#: gated: the spgemm credit pass is torch ops over [items, 128] planes
#: whose cost per ledger op is two orders of magnitude above K3's per
#: word op on an H100, so no one `ops_per_s` prices both (PERF.md)
HELD_OUT = ("spgemm",)
#: K3 runs at the largest sweep scale up to this one: the bitmap LCC's
#: scale on the main path (two (2^18)^2-bit bitmaps, 8 GiB each), where
#: the host work of its two calls (a bounds check that reads the card
#: each) is a small part of their wall
K3_MAX_SCALE = 18
#: spgemm runs at the smallest sweep scale up to this one: its plan is
#: host numpy whose seconds grow fast with the scale
SPGEMM_MAX_SCALE = 14


def split_held_out(samples: Sequence[dict]) -> Tuple[List[dict], List[dict]]:
    """(samples a fit and its gate read, samples of HELD_OUT surfaces)."""
    fit = [s for s in samples if s.get("surface") not in HELD_OUT]
    held = [s for s in samples if s.get("surface") in HELD_OUT]
    return fit, held


def sweep_plan(scales: Sequence[int], efs: Sequence[int]) -> List[tuple]:
    """[(scale, edge factor, surfaces)] in (scale, edge factor) order: K1
    and K2 at every scale, K3 at the largest scale up to K3_MAX_SCALE,
    spgemm at the smallest scale capped at SPGEMM_MAX_SCALE, each at
    every edge factor."""
    plan: Dict[tuple, List[str]] = {(sc, ef): list(SURFACES[:4])
                                    for sc in scales for ef in efs}
    k3 = max((sc for sc in scales if sc <= K3_MAX_SCALE), default=None)
    sg = min(min(scales), SPGEMM_MAX_SCALE)
    for ef in efs:
        if k3 is not None:
            plan[k3, ef].append("k3_intersect")
        plan.setdefault((sg, ef), []).append("spgemm")
    return [(sc, ef, tuple(plan[sc, ef])) for sc, ef in sorted(plan)]


def rmat_edges(scale: int, edge_factor: int, seed: int):
    """A vectorised RMAT draw (a = 0.57, b = c = 0.19): 2^scale vertices,
    2^scale * edge_factor directed edges."""
    n = 1 << scale
    e = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(e, dtype=np.int64)
    dst = np.zeros(e, dtype=np.int64)
    a, b, c = 0.57, 0.19, 0.19
    for _ in range(scale):
        r = rng.random(e)
        src = (src << 1) | (r >= a + b)
        dst = (dst << 1) | (((r >= a) & (r < a + b)) | (r >= a + b + c))
    return n, src, dst


def bench_fragment(scale: int, edge_factor: int, seed: int, device):
    """An undirected fnum 1 RMAT fragment with uniform(0.1, 10) float32
    weights (from seed + 1) through `ShardedEdgecutFragment.build`."""
    from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.utils.id_parser import IdParser
    from libgrape_lite_tpu_torch.vertex_map.idxer import HashMapIdxer
    from libgrape_lite_tpu_torch.vertex_map.partitioner import (
        SegmentedPartitioner,
    )
    from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

    n, src, dst = rmat_edges(scale, edge_factor, seed)
    oids = np.arange(n, dtype=np.int64)
    vm = VertexMap(SegmentedPartitioner(1, oids), [HashMapIdxer(oids)],
                   IdParser(1, n))
    w = np.random.default_rng(seed + 1).uniform(0.1, 10.0, len(src)).astype(
        np.float32)
    return ShardedEdgecutFragment.build(CommSpec(fnum=1, device=device), vm,
                                        src, dst, w, directed=False)


def timed_wall_s(fn, device, repeats: int) -> float:
    """Best of `repeats` walls of one call after a warm-up call: on the
    card CUDA events around the call and a synchronize before the read,
    each repeat behind a write of twice the L2 cache (so a small graph's
    operands come from HBM, as a large one's do) and a GPU busy-wait (so
    the events time the card, not the host's dispatch of the call: a call
    that waits on the card inside, as K3's bounds check does, still pays
    its dispatch); the host clock on the CPU."""
    from libgrape_lite_tpu_torch.utils.timing import BUSY_WAIT_CYCLES

    dev = torch.device(device)
    fn()
    best = float("inf")
    if dev.type != "cuda":
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 << 20)
    flush = torch.empty(max(l2, 1 << 20) // 2, dtype=torch.int32, device=dev)
    torch.cuda.synchronize(dev)
    for _ in range(max(1, repeats)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(BUSY_WAIT_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _surface_calls(frag, surfaces, seed: int, device) -> dict:
    """surface -> (the call to time, its columns) on one fragment."""
    from libgrape_lite_tpu_torch.ops import spmv

    ie = frag.dev.ie
    fnum, vp = frag.fnum, frag.vp
    n = fnum * vp
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.rand(n, generator=gen).to(device)
    xi = torch.randint(0, n, (n,), generator=gen, dtype=torch.int32).to(device)
    calls = {}
    if "k1_sum" in surfaces:
        calls["k1_sum"] = (
            lambda: spmv.gather_reduce(ie.indptr, ie.edge_nbr, None, x, "sum"),
            k1_columns(frag, weighted=False))
    if "k1_min_w" in surfaces:
        calls["k1_min_w"] = (
            lambda: spmv.gather_reduce(ie.indptr, ie.edge_nbr, ie.edge_w, x,
                                       "min"),
            k1_columns(frag, weighted=True))
    if "k1_i32_min" in surfaces:
        calls["k1_i32_min"] = (
            lambda: spmv.gather_reduce(ie.indptr, ie.edge_nbr, None, xi,
                                       "min"),
            k1_columns(frag, weighted=False))
    if "k2_strict" in surfaces:
        plan = spmv.plan_for_app(frag, vp, torch.float32, mode="strict")
        row_lo = torch.from_numpy(plan[0]).to(device)
        tile, rmax = plan[1], plan[2]
        values = torch.where(ie.edge_mask, x[ie.edge_nbr.long()],
                             torch.zeros((), device=device))
        calls["k2_strict"] = (
            lambda: spmv.spmv_strict(values, ie.edge_src, row_lo, vp, tile,
                                     rmax),
            strict_columns_geom(fnum, vp, values.shape[1], row_lo.shape[1]))
    return calls


def _k3_call(frag):
    from libgrape_lite_tpu_torch.models import LCC
    from libgrape_lite_tpu_torch.ops import intersect
    from libgrape_lite_tpu_torch.ops.spgemm_pack import intersect_ledger

    bplus, bminus, (v, u), (w, t) = LCC().pair_operands(frag.dev)

    def call():
        intersect.row_and_popcount_indexed(bplus, u, bplus, v)
        intersect.row_and_popcount_indexed(bplus, t, bminus, w)

    def distinct(*idx):
        return int(torch.unique(torch.cat(idx)).numel())

    words = bplus.shape[1]
    calls = [(distinct(u, v), u.numel(), words),  # one bitmap, both sides
             (distinct(t) + distinct(w), t.numel(), words)]
    return call, intersect_call_columns(intersect_ledger(frag, 4096), calls)


def _spgemm_call(frag, device):
    from libgrape_lite_tpu_torch.ops import spgemm_pack as sp

    disp = sp.resolve_spgemm_dispatch(frag)
    if not disp.plan.items:
        return None
    streams = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in disp.state_entries().items()}
    return (lambda: disp.credits(streams)), spgemm_columns(disp.plan.ledger)


def microbench_samples(scales: Sequence[int] = (16, 18),
                       efs: Sequence[int] = (4, 16), seed: int = 7,
                       repeats: int = 3, device="cuda",
                       log=None) -> List[dict]:
    """The seeded sweep over `sweep_plan`: one RMAT fragment a geometry
    (seed + 13 i for the i-th), each of its surfaces timed once.
    Weights on and off, the edge factor, float32 and int32 and the
    operation-heavy K3 separate the columns.  `log`, when given, takes
    one line a geometry."""
    dev = torch.device(device)
    samples: List[dict] = []
    for i, (scale, ef, surfs) in enumerate(sweep_plan(scales, efs)):
        t0 = time.perf_counter()
        frag = bench_fragment(scale, ef, seed + 13 * i, dev)
        calls = _surface_calls(frag, surfs, seed + 13 * i + 2, dev)
        if "k3_intersect" in surfs:
            calls["k3_intersect"] = _k3_call(frag)
        if "spgemm" in surfs:
            sg = _spgemm_call(frag, dev)
            if sg is not None:
                calls["spgemm"] = sg
        for surface in surfs:
            if surface not in calls:
                continue
            fn, cols = calls[surface]
            samples.append({"surface": surface, "geometry": f"s{scale}ef{ef}",
                            "wall_s": timed_wall_s(fn, dev, repeats),
                            **cols})
        del calls, frag
        if log is not None:
            log(f"calibrate: s{scale}ef{ef} {len(samples)} samples, "
                f"{time.perf_counter() - t0:.2f} s")
    return samples


# ---- the live harvest -------------------------------------------------------

_HARVEST: List[dict] = []
_HARVEST_MAX = 4096


def harvest_armed() -> bool:
    return os.environ.get(HARVEST_ENV, "") in ("1", "true", "on")


def harvest_dispatch(wall_s: float, columns: Optional[dict],
                     rounds: int) -> Optional[dict]:
    """One sample from one execution: `columns` are a round's, the wall
    covers `rounds` of them.  Appended to the harvest buffer and returned;
    None without a positive wall, columns or rounds."""
    if not columns or rounds <= 0 or not wall_s or wall_s <= 0:
        return None
    sample = {"surface": "harvest", "wall_s": float(wall_s),
              **{k: int(columns.get(k, 0)) * rounds
                 for k in ("ops", "gather_rows", "hbm_bytes")}}
    if sample["ops"] == 0 and sample["hbm_bytes"] == 0:
        return None
    _HARVEST.append(sample)
    if len(_HARVEST) > _HARVEST_MAX:
        del _HARVEST[: _HARVEST_MAX // 2]
    return sample


def harvest_from_worker(worker, wall_s: float, rounds: int,
                        lanes: int = 1) -> Optional[dict]:
    """The serving session's hook: the execution wall it measured, joined
    to one K1 pull a round of the worker's app (`AppBase.k1_pull`: None
    for an app whose rounds are not one pull over the in-CSR) times
    `rounds` times `lanes`."""
    pull = getattr(worker.app, "k1_pull", None)
    if pull is None:
        return None
    cols = k1_columns(worker.fragment, weighted=pull == "weighted")
    return harvest_dispatch(wall_s, cols, rounds * lanes)


def harvest_overlap(plan_brief: Optional[dict], measured_round_us: float,
                    rounds: int) -> Optional[dict]:
    """The overlap truth meter's row (obs/truth.py, JAX
    `harvest_overlap`): the measured wall of `rounds` pipelined rounds
    joined to the plan brief's columns -- the edges of both pulls as ops,
    the exchange bytes as bytes -- under surface
    "overlap", with the plan uid and the modeled hidden µs a round it
    was joined against.  Appended to the harvest buffer and returned;
    None without a brief, a positive wall and rounds, or columns."""
    if not plan_brief or rounds <= 0:
        return None
    if not measured_round_us or measured_round_us <= 0:
        return None
    edges = (int(plan_brief.get("boundary_edges", 0))
             + int(plan_brief.get("interior_edges", 0)))
    sample = {
        "surface": "overlap",
        "plan_uid": plan_brief.get("plan_uid") or "-",
        "wall_s": measured_round_us * rounds / 1e6,
        "ops": edges * rounds,
        "gather_rows": 0,
        "hbm_bytes": int(plan_brief.get("exchange_bytes", 0)) * rounds,
        "modeled_hidden_us_per_round": float(
            plan_brief.get("hidden_us_per_round") or 0.0),
    }
    if sample["ops"] == 0 and sample["hbm_bytes"] == 0:
        return None
    _HARVEST.append(sample)
    if len(_HARVEST) > _HARVEST_MAX:
        del _HARVEST[: _HARVEST_MAX // 2]
    return sample


def harvested_samples() -> List[dict]:
    return list(_HARVEST)


def reset_harvest() -> None:
    del _HARVEST[:]


# federated as "calibration" (obs/federation.py) with the JAX keys: the
# harvest's depth, whether it is armed, and the installed profile
from libgrape_lite_tpu_torch.obs import federation as _federation  # noqa: E402


def _calibration_snapshot() -> dict:
    return {
        "harvested": len(_HARVEST),
        "armed": harvest_armed(),
        "profile": os.environ.get(PROFILE_ENV, "") or _DEFAULT.name,
    }


_federation.register("calibration", _calibration_snapshot, reset_harvest,
                     module=__name__)
