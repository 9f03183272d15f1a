"""Repeat `chip_smoke.py`'s autopilot drill on RMAT-20 and report its load.

    python -m libgrape_lite_tpu_torch.scripts.autopilot_drill \
        --steps 4,8 --drills 3

Run from the repository root (it imports `chip_smoke`).  It builds the
kernels and the RMAT-20 fragment once, then for each drill (the step
factors in turn, `--drills` rounds) measures the max_batch 8 session's
qps as `chip_smoke.py`'s `[serve]` phase does, and runs the `[autopilot]`
drill at half that qps stepped by the factor.  One JSON line a drill:
the session's qps, whether a scale-up came, the deepest queue a replica
and the longest run of reads over the scaler's `up_queue_depth` -- the
hysteresis window of reads in a row is what a scale-up needs.
"""

from __future__ import annotations

import argparse
import json
import time


def session_qps(frag, device) -> float:
    """The max_batch SERVE_BATCH session's qps over SERVE_QUERIES sssp
    sources, its second pass (as `chip_smoke.serve_session_phase`)."""
    import chip_smoke as cs
    from libgrape_lite_tpu_torch.serve import BatchPolicy, ServeSession

    stream = [("sssp", {"source": s})
              for s in cs.serve_sources(frag, cs.SERVE_QUERIES)]
    sess = ServeSession(frag, policy=BatchPolicy(max_batch=cs.SERVE_BATCH))
    for app, args in stream:
        sess.submit(app, args)
    sess.drain()
    cs.sync(device)
    t0 = time.perf_counter()
    for app, args in stream:
        sess.submit(app, args)
    done = sess.drain()
    cs.sync(device)
    return len(done) / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default="8",
                    help="comma-separated step factors, drilled in turn")
    ap.add_argument("--drills", type=int, default=3,
                    help="rounds over the step factors")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=None,
                    help="RMAT scale (default chip_smoke's, 20)")
    ns = ap.parse_args(argv)

    import chip_smoke as cs
    from libgrape_lite_tpu_torch.ops import _build

    steps = [int(x) for x in ns.steps.split(",")]
    if ns.device == "cuda":
        _build.build_all()
    frag, _ = cs.rmat_fragment(ns.scale or cs.SCALE, ns.device,
                               retain=True)
    failed = 0
    for i in range(ns.drills):
        for step in steps:
            qps = session_qps(frag, ns.device)
            cs.AUTOPILOT_STEP_X = step
            rec = {"drill": i, "step_x": step, "session_qps": qps}
            try:
                got = cs.autopilot_phase(frag, qps, ns.device)["autopilot"]
                rec.update({k: got[k] for k in (
                    "scale_ups", "ticks", "max_depth", "over_depth_run",
                    "qps", "p99_ms")}, ok=True)
            except RuntimeError as e:
                failed += 1
                rec.update(ok=False, error=str(e))
            print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
