"""The port's rate profile (`libgrape_lite_tpu_torch/ops/calibration.py`)
against the JAX package's `ops/calibration.py`, on the CPU.

* `fit_rates` on the same seeded samples gives the JAX module's
  coefficients, condition and residual within 1e-9 relative (the port's
  `ops` column is JAX's `vpu_ops`; JAX gets no `mxu_ops`); the same inputs
  raise CalibrationError in both (underdetermined, ill-conditioned,
  non-positive, all-zero); both refit without `const` after a negative
  intercept; `drift_report` gives JAX's percentages under equal per-column
  coefficients;
* the port alone: validate / save / load round trips and their loud
  errors, `active_profile` under GRAPE_RATE_PROFILE, the samples round
  trip, the fit chain's notes, the columns counted from the geometry, the
  sweep at `--device cpu`, the live harvest (scaled by rounds and lanes,
  and more than 0 samples from a CPU session), spgemm's `auto` unchanged
  under the data sheet and flipped under a swapped profile, the
  partition and admission records carrying the label, the `calibrate`
  exit codes, and no port module holding the v5e constants or importing
  `jax` / `libgrape_lite_tpu`.
"""

import ast
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from libgrape_lite_tpu.ops import calibration as jcal
from libgrape_lite_tpu_torch.cli import calibrate_main
from libgrape_lite_tpu_torch.ops import calibration as cal

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "libgrape_lite_tpu_torch"
REL = 1e-9  # port against JAX: the same float64 linear algebra
#: the port's columns -> the JAX module's
JAX_COL = {"const": "const", "ops": "vpu_ops", "gather_rows": "gather_rows",
           "hbm_bytes": "hbm_bytes"}


@pytest.fixture(autouse=True)
def _no_profile_env(monkeypatch):
    monkeypatch.delenv(cal.PROFILE_ENV, raising=False)
    monkeypatch.delenv(cal.HARVEST_ENV, raising=False)
    cal.reset_harvest()
    yield
    cal.reset_harvest()


def truth() -> cal.RateProfile:
    """Rates unlike the data sheet's in every fitted field, slower than
    it, so that data-sheet priced columns never exceed a wall."""
    return replace(cal.default_profile(), name="truth", ops_per_s=2.0e11,
                   gather_per_s=5.0e9, hbm_bps=4.0e11,
                   dispatch_overhead_s=2.0e-4)


def synthetic(profile, n=14, seed=5, noise=0.03, surface="k1"):
    """Seeded samples: independently drawn columns, walls the profile's
    model times seeded noise of `noise` relative."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = {"surface": surface,
             "ops": int(rng.integers(1 << 20, 1 << 29)),
             "gather_rows": int(rng.integers(1 << 14, 1 << 22)),
             "hbm_bytes": int(rng.integers(1 << 22, 1 << 30))}
        s["wall_s"] = profile.wall_s(s) * float(1 + noise * rng.normal())
        out.append(s)
    return out


def to_jax(samples):
    return [{JAX_COL.get(k, k): v for k, v in s.items()} for s in samples]


def jax_base(p: cal.RateProfile):
    """A JAX profile whose per-column coefficients equal `p`'s (clock
    1 Hz: a rate a cycle is a rate a second)."""
    return replace(jcal.default_profile(), clock_hz=1.0,
                   vpu_lanes_per_cycle=p.ops_per_s,
                   gather_rows_per_cycle=p.gather_per_s, hbm_bps=p.hbm_bps,
                   dispatch_overhead_s=p.dispatch_overhead_s)


def jax_coef(fit, reg):
    return fit.coefficients[JAX_COL[reg]]


# ---- the fit against the JAX module ---------------------------------------

@pytest.mark.parametrize("regs", cal.REGRESSOR_FALLBACK,
                         ids=["+".join(r) for r in cal.REGRESSOR_FALLBACK])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fit_rates_equals_jax(seed, regs):
    samples = synthetic(truth(), seed=seed)
    base = cal.default_profile()
    got = cal.fit_rates(samples, regs, base=base)
    want = jcal.fit_rates(to_jax(samples), [JAX_COL[r] for r in regs],
                          base=jax_base(base))
    assert got.regressors == tuple(r for r in regs)
    assert [JAX_COL[r] for r in got.regressors] == list(want.regressors)
    for r in got.regressors:
        assert got.coefficients[r] == pytest.approx(jax_coef(want, r),
                                                    rel=REL)
    assert got.cond == pytest.approx(want.cond, rel=REL)
    assert got.residual == pytest.approx(want.residual, rel=REL)
    assert got.samples == want.samples == len(samples)
    # the columns JAX inherits are unfitted here too (the port also lists
    # every rate it did not measure)
    inv = {v: k for k, v in JAX_COL.items()}
    assert {cal.RATE_OF[inv[r]] for r in want.profile.unfitted} <= set(
        got.profile.unfitted)
    assert "exchange_bps" in got.profile.unfitted
    p = got.profile
    assert p.fitted and p.source == "microbench"
    assert p.fingerprint == "cpu:cpu" and p.label() == "fitted@cpu:cpu"
    for r in got.regressors:
        if r != "const":
            assert p.measured(cal.RATE_OF[r])
            assert p.coefficient(r) == pytest.approx(got.coefficients[r],
                                                     rel=1e-12)


def _underdetermined():
    return synthetic(truth(), n=2), ("const", "ops", "gather_rows",
                                     "hbm_bytes")


def _ill_conditioned():
    rng = np.random.default_rng(2)
    out = []
    for _ in range(8):
        v = int(rng.integers(1 << 20, 1 << 28))
        out.append({"surface": "x", "ops": v, "gather_rows": 3 * v,
                    "wall_s": v * 1e-12 + 1e-3})
    return out, ("ops", "gather_rows")


def _non_positive():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(10):
        o = int(rng.integers(1 << 26, 1 << 29))
        h = int(rng.integers(1 << 20, 1 << 24))
        out.append({"surface": "x", "ops": o, "hbm_bytes": h,
                    "wall_s": 1e-12 * o - 1e-14 * h + 1e-3})
    return out, ("const", "ops", "hbm_bytes")


def _all_zero():
    return ([{"surface": "x", "ops": 0, "gather_rows": 0, "wall_s": 1e-3}
             for _ in range(4)], ("ops", "gather_rows"))


def _bad_wall():
    return [{"surface": "x", "ops": 10, "wall_s": -1.0}], ("ops",)


@pytest.mark.parametrize("case,match", [
    (_underdetermined, "cannot identify"),
    (_ill_conditioned, "condition|rank"),
    (_non_positive, "non-positive"),
    (_all_zero, "zero"),
    (_bad_wall, "positive finite"),
], ids=["underdetermined", "ill-conditioned", "non-positive", "all-zero",
        "bad-wall"])
def test_fit_refusals_equal_jax(case, match):
    samples, regs = case()
    with pytest.raises(cal.CalibrationError, match=match):
        cal.fit_rates(samples, regs)
    with pytest.raises(jcal.CalibrationError, match=match):
        jcal.fit_rates(to_jax(samples), [JAX_COL[r] for r in regs],
                       base=jax_base(cal.default_profile()))
    with pytest.raises(cal.CalibrationError, match="no samples"):
        cal.fit_rates([])


def test_negative_intercept_refits_without_const_as_jax():
    rng = np.random.default_rng(4)
    coeff = 2.0e-12
    samples = []
    for _ in range(10):
        v = int(rng.integers(1 << 28, 1 << 31))
        samples.append({"surface": "x", "ops": v,
                        "wall_s": coeff * v - 2e-5})
    got = cal.fit_rates(samples, ("const", "ops"))
    want = jcal.fit_rates(to_jax(samples), ("const", "vpu_ops"),
                          base=jax_base(cal.default_profile()))
    assert got.regressors == ("ops",) and want.regressors == ("vpu_ops",)
    assert got.profile.dispatch_overhead_s == 0.0
    assert got.coefficients["ops"] == pytest.approx(
        want.coefficients["vpu_ops"], rel=REL)
    assert got.coefficients["ops"] == pytest.approx(coeff, rel=0.01)
    assert got.residual == pytest.approx(want.residual, rel=REL)
    assert cal.drift_report(got.profile, samples)["drift_ok"]


@pytest.mark.parametrize("seed", [6, 7])
def test_drift_report_equals_jax(seed):
    fit = cal.fit_rates(synthetic(truth(), seed=seed)).profile
    held = (synthetic(truth(), n=5, seed=seed + 50, noise=0.1, surface="a")
            + synthetic(truth(), n=3, seed=seed + 60, noise=0.2,
                        surface="b"))
    got = cal.drift_report(fit, held)
    want = jcal.drift_report(jax_base(fit), to_jax(held))
    assert got["drift_pct"] == pytest.approx(want["drift_pct"], abs=1e-9)
    assert got["max_sample_drift_pct"] == pytest.approx(
        want["max_sample_drift_pct"], abs=1e-9)
    assert got["drift_ok"] == want["drift_ok"]
    assert set(got["surfaces"]) == set(want["surfaces"]) == {"a", "b"}
    for surf, e in want["surfaces"].items():
        assert got["surfaces"][surf]["drift_pct"] == pytest.approx(
            e["drift_pct"], abs=1e-9)
        assert got["surfaces"][surf]["samples"] == e["samples"]
    assert got["profile"] == "fitted@cpu:cpu"


def test_fit_round_trip_and_drift_gate():
    samples = synthetic(truth(), noise=0.0)
    fit = cal.fit_rates(samples)
    for r in fit.regressors:
        assert fit.coefficients[r] == pytest.approx(truth().coefficient(r),
                                                    rel=1e-6)
    assert fit.residual < 1e-9
    assert cal.drift_report(fit.profile, samples)["drift_ok"]
    slow = replace(fit.profile, ops_per_s=fit.profile.ops_per_s / 20)
    rep = cal.drift_report(slow, samples)
    assert not rep["drift_ok"] and rep["drift_pct"] > 5.0


def test_fit_chain_notes_and_unfitted():
    """K1 alone: gather rows and bytes move together, so the chain drops
    gather rows with a note and records its rate as unfitted."""
    rng = np.random.default_rng(8)
    base = cal.default_profile()
    samples = []
    for _ in range(12):
        e = int(rng.integers(1 << 20, 1 << 26))
        w = bool(rng.integers(0, 2))
        s = cal.k1_columns_geom(1, 1 << 20, e, w)
        s["surface"] = "k1"
        s["wall_s"] = truth().wall_s({**s, "gather_rows": 0}) + (
            s["gather_rows"] / base.gather_per_s)
        samples.append(s)
    fit, notes = cal.fit_rates_auto(samples, base=base)
    assert notes and notes[0].startswith("const+ops+gather_rows+hbm_bytes")
    assert "gather_rows" not in fit.regressors
    assert "gather_per_s" in fit.profile.unfitted
    assert fit.profile.gather_per_s == base.gather_per_s
    assert cal.drift_report(fit.profile, samples)["drift_ok"]
    with pytest.raises(cal.CalibrationError, match="cannot identify"):
        cal.fit_rates_auto(synthetic(truth(), n=1))


# ---- the profile, its file and the environment ----------------------------

def test_default_profile_is_the_data_sheet():
    p = cal.default_profile()
    assert p.name == "h100-sxm-datasheet"
    assert (p.ops_per_s, p.gather_per_s, p.hbm_bps) == (67e12, 67e12,
                                                        3.35e12)
    assert p.hbm_capacity_bytes == 80 * 10**9
    assert not p.fitted and set(p.unfitted) == set(cal.RATE_FIELDS)
    assert not any(p.measured(r) for r in cal.RATE_FIELDS)
    assert set(p.exchange_bps) == set(cal.EXCHANGE_MODES)
    assert cal.active_profile() is p
    assert cal.validate_profile(p.as_dict()) == []
    from libgrape_lite_tpu_torch.fragment.edgecut import device_budget_bytes
    from libgrape_lite_tpu_torch.ops import spgemm_pack as sp

    assert sp.H100_RATES == {"label": p.label(), "ops_per_s": p.ops_per_s,
                             "bytes_per_s": p.hbm_bps}
    assert device_budget_bytes("cpu") == p.hbm_capacity_bytes
    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S == p.hbm_bps
    assert chip_smoke.FP32_OPS_PER_S == p.ops_per_s


def test_profile_save_load_round_trip(tmp_path):
    fit = cal.fit_rates(synthetic(truth())).profile
    path = cal.save_profile(fit, str(tmp_path / "sub" / "rates.json"))
    back = cal.load_profile(path)
    assert back == fit
    assert back.as_dict() == json.loads(Path(path).read_text())


@pytest.mark.parametrize("field,value,match", [
    ("ops_per_s", True, "bool"),
    ("ops_per_s", -1.0, "positive"),
    ("hbm_bps", float("inf"), "positive"),
    ("dispatch_overhead_s", -1e-6, ">= 0"),
    ("fitted", 1, "expected bool"),
    ("schema", 2, "schema 2"),
    ("exchange_bps", {"gather": 1.0, "mirror": 1.0}, "missing mode"),
    ("exchange_bps", {"gather": 1.0, "mirror": 1.0, "vc2d": 1.0,
                      "ici": 1.0}, "unknown mode"),
    ("unfitted", ["vpu_ops"], "not a rate field"),
    ("bogus", 1, "unknown field"),
    (None, None, "missing field"),
])
def test_validate_profile_rejections(tmp_path, field, value, match):
    d = cal.default_profile().as_dict()
    if field is None:
        del d["hbm_bps"]
    else:
        d[field] = value
    errors = cal.validate_profile(d)
    assert any(match in e for e in errors), errors
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(d))
    with pytest.raises(cal.CalibrationError, match="invalid rate profile"):
        cal.load_profile(str(path))
    assert cal.validate_profile([1]) != []


def test_load_errors_are_loud(tmp_path):
    with pytest.raises(cal.CalibrationError, match="cannot read"):
        cal.load_profile(str(tmp_path / "absent.json"))
    (tmp_path / "x.json").write_text("{not json")
    with pytest.raises(cal.CalibrationError, match="not valid JSON"):
        cal.load_profile(str(tmp_path / "x.json"))
    with pytest.raises(cal.CalibrationError, match="refusing"):
        cal.save_profile(replace(cal.default_profile(), hbm_bps=0.0),
                         str(tmp_path / "y.json"))


def test_active_profile_env(tmp_path, monkeypatch):
    path = str(tmp_path / "rates.json")
    fit = cal.fit_rates(synthetic(truth())).profile
    cal.save_profile(fit, path)
    monkeypatch.setenv(cal.PROFILE_ENV, path)
    assert cal.active_profile() == fit
    assert cal.profile_label() == "fitted@cpu:cpu"
    other = replace(fit, name="other")
    cal.save_profile(other, path)
    os.utime(path, (1, 1))  # a new mtime: the memo reloads
    assert cal.active_profile().name == "other"
    Path(path).write_text("{broken")
    os.utime(path, (2, 2))
    with pytest.raises(cal.CalibrationError):
        cal.active_profile()
    monkeypatch.setenv(cal.PROFILE_ENV, str(tmp_path / "absent.json"))
    with pytest.raises(cal.CalibrationError, match="not readable"):
        cal.active_profile()


def test_samples_round_trip(tmp_path):
    samples = synthetic(truth(), n=5)
    path = cal.save_samples(samples, str(tmp_path / "s.json"), "cpu")
    assert cal.load_samples(path) == samples
    doc = json.loads(Path(path).read_text())
    assert doc["fingerprint"] == "cpu:cpu" and doc["schema"] == 1
    bad = tmp_path / "bad.json"
    for body in ('{"samples": 3}', '{"samples": [{"ops": 1}]}',
                 '{"samples": [{"wall_s": 0}]}',
                 '{"samples": [{"wall_s": true}]}', "["):
        bad.write_text(body)
        with pytest.raises(cal.CalibrationError):
            cal.load_samples(str(bad))


# ---- the columns and the sweep --------------------------------------------

def test_columns_from_geometry():
    frag = cal.bench_fragment(8, 4, 3, "cpu")
    ie = frag.dev.ie
    edges = int(ie.indptr[:, -1].sum())
    assert edges == sum(c.num_edges for c in frag.host_ie) > 0
    n = frag.fnum * frag.vp
    plain = cal.k1_columns(frag, weighted=False)
    assert plain == {"ops": edges, "gather_rows": edges,
                     "hbm_bytes": 4 * edges + 4 * (n + 1) + 8 * n}
    assert cal.k1_columns(frag) == cal.k1_columns(frag, weighted=True) == {
        "ops": 2 * edges, "gather_rows": edges,
        "hbm_bytes": 8 * edges + 4 * (n + 1) + 8 * n}
    assert cal.k1_columns(SimpleNamespace()) is None
    ep = ie.edge_nbr.shape[1]
    assert cal.strict_columns_geom(1, frag.vp, ep, 3) == {
        "ops": ep, "gather_rows": 0, "hbm_bytes": 8 * ep + 12 + 4 * n}


def test_sweep_plan():
    assert cal.sweep_plan((16, 18), (4, 16)) == [
        (14, 4, ("spgemm",)), (14, 16, ("spgemm",)),
        (16, 4, cal.SURFACES[:4]), (16, 16, cal.SURFACES[:4]),
        (18, 4, cal.SURFACES[:5]), (18, 16, cal.SURFACES[:5])]
    assert cal.sweep_plan((20,), (16,)) == [  # no scale up to K3_MAX_SCALE
        (14, 16, ("spgemm",)), (20, 16, cal.SURFACES[:4])]
    assert cal.sweep_plan((8,), (2,)) == [(8, 2, cal.SURFACES)]
    fit, held = cal.split_held_out(
        [{"surface": s, "wall_s": 1.0} for s in cal.SURFACES])
    assert [s["surface"] for s in held] == list(cal.HELD_OUT) == ["spgemm"]
    assert len(fit) == len(cal.SURFACES) - 1


def test_sweep_on_the_cpu_counts_every_surface():
    from libgrape_lite_tpu_torch.models import LCC
    from libgrape_lite_tpu_torch.ops import spgemm_pack as sp

    samples = cal.microbench_samples(scales=(8,), efs=(2, 8), seed=3,
                                     repeats=1, device="cpu")
    assert [s["surface"] for s in samples] == list(cal.SURFACES) * 2
    by = {(s["geometry"], s["surface"]): s for s in samples}
    frag = cal.bench_fragment(8, 2, 3, "cpu")  # the sweep's first draw

    def cols(surface):
        return {k: by["s8ef2", surface][k] for k in ("ops", "gather_rows",
                                                     "hbm_bytes")}

    assert cols("k1_min_w") == cal.k1_columns(frag, weighted=True)
    assert cols("k1_i32_min") == cal.k1_columns(frag, weighted=False)
    # K3: the ledger's word ops; the distinct rows of each call and its
    # pairs, counted here on the host
    bplus, _, (v, u), (w, t) = LCC().pair_operands(frag.dev)
    words = bplus.shape[1]
    rows = (len(set(u.tolist()) | set(v.tolist()))
            + len(set(t.tolist())) + len(set(w.tolist())))
    ledger = sp.intersect_ledger(frag, 4096)
    assert cols("k3_intersect") == {
        "ops": ledger["word_ops"], "gather_rows": 0,
        "hbm_bytes": 4 * words * rows + 12 * (u.numel() + t.numel())}
    assert cal.intersect_columns(ledger)["ops"] == ledger["word_ops"]
    assert cols("spgemm") == cal.spgemm_columns(
        sp.resolve_spgemm_dispatch(frag).plan.ledger)
    assert all(s["wall_s"] > 0 for s in samples)


# ---- the live harvest -------------------------------------------------------

def test_harvest_scales_by_rounds():
    assert not cal.harvest_armed()
    cols = {"ops": 100, "gather_rows": 4, "hbm_bytes": 2048}
    assert cal.harvest_dispatch(0.0, cols, 5) is None
    assert cal.harvest_dispatch(1e-3, None, 5) is None
    assert cal.harvest_dispatch(1e-3, cols, 0) is None
    s = cal.harvest_dispatch(1.5e-3, cols, 5)
    assert s == {"surface": "harvest", "wall_s": 1.5e-3, "ops": 500,
                 "gather_rows": 20, "hbm_bytes": 10240}
    assert cal.harvested_samples() == [s]
    frag = cal.bench_fragment(7, 4, 5, "cpu")
    w = SimpleNamespace(app=SimpleNamespace(k1_pull="weighted"),
                        fragment=frag)
    got = cal.harvest_from_worker(w, 2e-3, 3, lanes=4)
    one = cal.k1_columns(frag, weighted=True)
    assert got["ops"] == one["ops"] * 12
    assert got["hbm_bytes"] == one["hbm_bytes"] * 12
    assert cal.harvest_from_worker(
        SimpleNamespace(app=SimpleNamespace(), fragment=frag), 1.0, 1) is None
    cal.reset_harvest()
    assert cal.harvested_samples() == []


def test_harvest_from_a_cpu_session(monkeypatch):
    """The session's hook reads the execution wall it measures (its
    device_us stage is 0): disarmed it harvests nothing; armed, every
    query and batch of a K1 app is one sample."""
    from libgrape_lite_tpu_torch.models import APP_REGISTRY
    from libgrape_lite_tpu_torch.serve.policy import BatchPolicy
    from libgrape_lite_tpu_torch.serve.session import ServeSession

    frag = cal.bench_fragment(8, 4, 9, "cpu")
    apps = {k: APP_REGISTRY[k] for k in ("sssp", "bfs", "pagerank", "wcc")}

    def serve(max_batch):
        sess = ServeSession(frag, apps=apps,
                            policy=BatchPolicy(max_batch=max_batch))
        stream = [("sssp", {"source": s}) for s in (0, 1, 2)]
        stream += [("bfs", {"source": 3}), ("pagerank", {}), ("wcc", {})]
        return sess.serve(stream)

    res = serve(1)
    assert cal.harvested_samples() == []
    assert all(r.stages["device_us"] == 0 for r in res)
    monkeypatch.setenv(cal.HARVEST_ENV, "1")
    res = serve(1)
    got = cal.harvested_samples()
    assert len(got) == 5  # wcc has no k1_pull
    by_id = {r.request_id: r for r in res}
    assert sorted(s["wall_s"] for s in got) == sorted(
        s["wall_s"] for s in got if s["wall_s"] > 0)
    sssp = [r for r in by_id.values() if r.app_key == "sssp"]
    one = cal.k1_columns(frag, weighted=True)
    for r, s in zip(sssp, got[:3]):
        assert s["ops"] == one["ops"] * r.rounds
        assert s["wall_s"] * 1e6 >= r.stages["dispatch_us"]
    cal.reset_harvest()
    res = serve(8)  # the three sssp queries: one batch of 3 lanes
    got = cal.harvested_samples()
    assert len(got) == 3
    rounds = max(r.rounds for r in res if r.app_key == "sssp")
    assert got[0]["ops"] == one["ops"] * rounds * 3
    assert got[0]["hbm_bytes"] == one["hbm_bytes"] * rounds * 3


# ---- the consumers ---------------------------------------------------------

def _edge_frag(src, dst, n):
    from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
    from libgrape_lite_tpu_torch.parallel.comm_spec import CommSpec
    from libgrape_lite_tpu_torch.utils.id_parser import IdParser
    from libgrape_lite_tpu_torch.vertex_map.idxer import HashMapIdxer
    from libgrape_lite_tpu_torch.vertex_map.partitioner import (
        SegmentedPartitioner,
    )
    from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

    oids = np.arange(n, dtype=np.int64)
    vm = VertexMap(SegmentedPartitioner(1, oids), [HashMapIdxer(oids)],
                   IdParser(1, n))
    return ShardedEdgecutFragment.build(CommSpec(fnum=1, device="cpu"), vm,
                                        np.asarray(src), np.asarray(dst),
                                        None, directed=False)


def _ring_frag(n, chords=64, seed=3):
    """JAX's test geometry: a ring and a few chords, where the intersect
    sweep pays for every bitmap word and spgemm touches few tiles."""
    src = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    s = np.concatenate([src, rng.integers(0, n, chords)])
    d = np.concatenate([(src + 1) % n, rng.integers(0, n, chords)])
    return _edge_frag(s, d, n)


def test_spgemm_auto_unchanged_then_flipped(tmp_path, monkeypatch):
    from libgrape_lite_tpu_torch.ops import spgemm_pack as sp

    frag = _ring_frag(4096)
    plan = sp.plan_spgemm(frag, 0, plan_only=True)
    it = sp.intersect_ledger(frag, 4096)
    base = sp.price_backends(plan.ledger, it)
    t, r = plan.ledger["totals"], sp.H100_RATES
    # the formula priced before profiles existed, bit for bit
    assert base["t_spgemm_s"] == max(
        (t["vpu_ops"] + t["mxu_ops"] + t["gather_rows"]) / r["ops_per_s"],
        t["hbm_bytes"] / r["bytes_per_s"])
    assert base["t_intersect_s"] == max(it["word_ops"] / r["ops_per_s"],
                                        it["hbm_bytes"] / r["bytes_per_s"])
    assert base["spgemm_wins"], "the ring must favour spgemm"
    assert base["profile"] == "h100-sxm-datasheet@datasheet"
    slow = replace(cal.default_profile(), name="slow-gather",
                   gather_per_s=67e12 / 1e6, fitted=True,
                   unfitted=("exchange_bps",))
    swapped = sp.price_backends(plan.ledger, it, profile=slow)
    assert not swapped["spgemm_wins"]
    assert swapped["t_intersect_s"] == base["t_intersect_s"]

    monkeypatch.setenv("GRAPE_LCC_BACKEND", "auto")
    assert sp.resolve_lcc_backend("lcc", frag) == "spgemm"
    dec = sp.SPGEMM_STATS["decisions"][-1]
    assert dec["profile"] == "h100-sxm-datasheet@datasheet"
    path = str(tmp_path / "slow.json")
    cal.save_profile(slow, path)
    monkeypatch.setenv(cal.PROFILE_ENV, path)
    assert sp.resolve_lcc_backend("lcc", frag) == "intersect"
    dec = sp.SPGEMM_STATS["decisions"][-1]
    assert dec["backend"] == "intersect"
    assert dec["profile"] == "slow-gather@datasheet"


def test_partition_records_carry_the_label(tmp_path, monkeypatch):
    from libgrape_lite_tpu_torch.fragment.partition import resolve_partition

    rng = np.random.default_rng(1)
    n = 256
    src, dst = rng.integers(0, n, 2048), rng.integers(0, n, 2048)
    oids = np.arange(n, dtype=np.int64)
    dec = resolve_partition("sssp", 4, src, dst, oids, mode="auto")
    assert dec["profile"] == "h100-sxm-datasheet@datasheet"
    assert "t_compute_s" not in dec["costs"]["1d"]
    if not dec["engaged"]:
        assert "no measured ops_per_s or exchange_bps" in dec["reason"]
    # a fitted compute rate adds the compute seconds; the link stays
    # unmeasured on one card, so the both-terms rule still decides
    fit = replace(cal.fit_rates(synthetic(truth())).profile, name="fit")
    cal.save_profile(fit, str(tmp_path / "p.json"))
    monkeypatch.setenv(cal.PROFILE_ENV, str(tmp_path / "p.json"))
    dec2 = resolve_partition("sssp", 4, src, dst, oids, mode="auto")
    assert dec2["profile"] == "fit@cpu:cpu"
    assert dec2["engaged"] == dec["engaged"]
    for lay in ("1d", "2d"):
        c = dec2["costs"][lay]
        assert c["t_compute_s"] == pytest.approx(
            c["padded_edge_ops"] / fit.ops_per_s, rel=1e-12)
        assert "t_round_s" not in c
    if not dec2["engaged"]:
        assert "no measured exchange_bps" in dec2["reason"]


def test_admission_prices_through_the_profile(tmp_path, monkeypatch):
    from libgrape_lite_tpu_torch.autopilot.admission import (
        AdmissionConfig,
        AdmissionController,
        query_wall_s,
    )
    from libgrape_lite_tpu_torch.autopilot.signals import AUTOPILOT_STATS
    from libgrape_lite_tpu_torch.obs.slo import SLO_STATS

    frag = cal.bench_fragment(8, 4, 4, "cpu")
    wall = query_wall_s(frag, max_rounds=8)
    assert wall == cal.default_profile().wall_s(cal.k1_columns(frag)) * 8
    assert query_wall_s(frag, 8, weighted=False) < wall
    monkeypatch.setitem(SLO_STATS, "burn_by_key", {"tenant:t9": 1.5})
    req = SimpleNamespace(tenant="t9", app_key="sssp", max_rounds=8)
    ctl = AdmissionController(config=AdmissionConfig(max_cost_s=wall / 2),
                              fragment=frag)
    assert ctl.review(req) == "shed"
    rec = AUTOPILOT_STATS["decisions"][-1]
    assert rec["kind"] == "shed"
    assert rec["profile"] == "h100-sxm-datasheet@datasheet"
    # an installed profile re-prices the same pull
    slow = replace(cal.default_profile(), name="slow", hbm_bps=3.35e6)
    assert query_wall_s(frag, 8, profile=slow) > 100 * wall
    cal.save_profile(slow, str(tmp_path / "slow.json"))
    monkeypatch.setenv(cal.PROFILE_ENV, str(tmp_path / "slow.json"))
    slow_wall = query_wall_s(frag, 8)
    assert slow_wall == slow.wall_s(cal.k1_columns(frag)) * 8
    ctl = AdmissionController(
        config=AdmissionConfig(max_cost_s=slow_wall / 2), fragment=frag)
    assert ctl.review(req) == "shed"
    rec = AUTOPILOT_STATS["decisions"][-1]
    assert rec["cost_s"] == round(slow_wall, 6) > 0
    assert rec["profile"] == "slow@datasheet"


# ---- the calibrate command --------------------------------------------------

def test_calibrate_cli_fit_check_corrupt_absent(tmp_path, capsys):
    sp = str(tmp_path / "samples.json")
    cal.save_samples(synthetic(truth(), noise=0.01), sp, "cpu")
    out = str(tmp_path / "rates.json")
    assert calibrate_main(["--device", "cpu", "--samples", sp, "--out", out,
                           "--json"]) == 0
    rec = json.loads(capsys.readouterr().out)
    blk = rec["calibration"]
    assert blk["fitted"] and blk["drift_ok"] and blk["source"] == "samples"
    assert rec["out"] == out
    assert blk["regressors"] == list(cal.REGRESSORS)
    assert blk["cond"] < cal.COND_LIMIT and blk["fallback_notes"] == []
    fitted = cal.load_profile(out)
    assert blk["rates"]["ops_per_s"] == fitted.ops_per_s
    assert blk["unfitted"] == ["exchange_bps"]
    assert calibrate_main(["--device", "cpu", "--check", "--samples", sp,
                           "--profile", out, "--json"]) == 0
    capsys.readouterr()
    d = json.loads(Path(out).read_text())
    d["ops_per_s"] *= 20.0
    bad = tmp_path / "rates_bad.json"
    bad.write_text(json.dumps(d))
    assert calibrate_main(["--device", "cpu", "--check", "--samples", sp,
                           "--profile", str(bad), "--json"]) == 2
    assert not json.loads(capsys.readouterr().out)["calibration"]["drift_ok"]
    d["ops_per_s"] = True
    bad.write_text(json.dumps(d))
    assert calibrate_main(["--device", "cpu", "--check", "--samples", sp,
                           "--profile", str(bad)]) == 2
    assert "bool" in capsys.readouterr().err
    assert calibrate_main(["--device", "cpu", "--samples",
                           str(tmp_path / "absent.json")]) == 2
    # the table form of a passing check
    assert calibrate_main(["--device", "cpu", "--check", "--samples", sp,
                           "--profile", out]) == 0
    assert "OK: drift" in capsys.readouterr().out


def test_calibrate_cli_sweep_on_the_cpu(tmp_path, capsys):
    """A measured sweep at --device cpu: the plain versions on the host
    clock fit no card's rates, so the gate may pass or trip; the record
    and the samples file are what is checked."""
    sp = str(tmp_path / "s.json")
    rc = calibrate_main(["--device", "cpu", "--scales", "7", "--ef", "2,8",
                         "--repeats", "1", "--min-wall-s", "0",
                         "--samples-out", sp, "--json"])
    blk = json.loads(capsys.readouterr().out)["calibration"]
    assert rc == (0 if blk["drift_ok"] else 2)
    assert blk["samples"] == 2 * len(cal.SURFACES)
    assert blk["fingerprint"] == "cpu:cpu"
    # the held-out spgemm pass is reported, neither fitted nor gated
    assert set(blk["held_out"]) == {"spgemm"}
    assert "spgemm" not in blk["surfaces"]
    assert sum(e["samples"] for e in blk["surfaces"].values()) == 2 * (
        len(cal.SURFACES) - 1)
    assert len(cal.load_samples(sp)) == blk["samples"]
    assert calibrate_main(["--device", "cpu", "--scales", "7", "--ef", "2",
                           "--repeats", "1", "--min-wall-s", "100"]) == 2


def test_calibrate_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="cuda"):
        calibrate_main(["--samples", "x.json"])


def test_calibrate_script_and_subcommand(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for mod in (["libgrape_lite_tpu_torch.scripts.calibrate"],
                ["libgrape_lite_tpu_torch.cli", "calibrate"]):
        r = subprocess.run(
            [sys.executable, "-m", *mod, "--device", "cpu", "--samples",
             str(tmp_path / "absent.json")], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 2, r.stderr
        assert "cannot read calibration samples" in r.stderr


# ---- what the port's modules hold --------------------------------------------

#: the JAX module's v5e rates and names, none of which the port carries
V5E_TOKENS = ("940e6", "819e9", "9e10", "16 << 30", "v5e-pinned",
              "vpu_lanes_per_cycle", "mxu_cyc_per_elem", "ici_bps",
              "clock_hz")


def _port_sources():
    files = sorted(PORT.rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("name", ["calibration", "cli", "scripts_calibrate",
                                  "every_module"])
def test_no_v5e_constant_and_no_jax_import(name):
    files = {"calibration": [PORT / "ops" / "calibration.py"],
             "cli": [PORT / "cli.py"],
             "scripts_calibrate": [PORT / "scripts" / "calibrate.py"],
             "every_module": _port_sources()}[name]
    for f in files:
        text = f.read_text()
        for tok in V5E_TOKENS:
            assert tok not in text, f"{f}: holds {tok!r}"
        assert not any(re_v5e(line) for line in text.splitlines()), f
        for node in ast.walk(ast.parse(text)):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "libgrape_lite_tpu"), \
                    f"{f}: imports {m}"


def re_v5e(line: str) -> bool:
    """A rate or size literal of the v5e profile written another way."""
    compact = line.replace("_", "").replace(" ", "")
    return any(t in compact for t in ("940000000", "819000000000",
                                      "90000000000.0", "17179869184"))
