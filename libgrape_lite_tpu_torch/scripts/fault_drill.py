"""Kill/resume and self-heal fault drills through the port's CLI.

Counterpart of the JAX package's `scripts/fault_drill.py`: the
end-to-end proof that checkpoint recovery works, as a smoke check.  Run
from the repository root:

    python -m libgrape_lite_tpu_torch.scripts.fault_drill [--device cpu]
    python -m libgrape_lite_tpu_torch.scripts.fault_drill --apps sssp \
        --corrupt
    python -m libgrape_lite_tpu_torch.scripts.fault_drill --self-heal

**kill/resume** (default; apps sssp, pagerank, cdlp on dataset/p2p-31):

  1. **reference** -- an uninterrupted checkpointed run writes its
     per-fragment result files;
  2. **kill** -- the same run in a child process armed with
     `GRAPE_FT_FAULTS=kill@K` dies (os._exit) right after superstep K's
     checkpoint is durable: exit code 17, no output files;
  3. **corrupt** (`--corrupt`) -- the newest checkpoint shard is
     byte-flipped, so the resume falls back to the previous superstep;
  4. **resume** -- `--resume` continues from the last usable checkpoint;
  5. **verify** -- the resumed files are byte-identical to the reference.

**self-heal** (`--self-heal`; apps sssp, pagerank, wcc): the same run
armed with `GRAPE_FT_FAULTS=corrupt_carry@K` and `--guard rollback` must
detect the corruption within one cadence, roll back, replay, exit 0 and
write files byte-identical to the reference.

**postmortem** (`--postmortem`): the flight-recorder loop through the
`serve` CLI under the fleet.  A 2-replica, 2-tenant run of a 24-query
sssp / bfs stream armed with `GRAPE_FT_FAULTS=corrupt_carry@K` and
`--guard halt` must fail every poisoned query alone (exit 1, all 24
failed), each breach dumping a bundle into `GRAPE_POSTMORTEM`; the newest
bundle must carry the guard forensics and `serve_query` rows, and `cli
postmortem <bundle> --trace <trace.json>` must find every row byte for
byte in the trace.

**kill_rank** (`--kill_rank`, default app sssp; sssp, bfs, wcc,
pagerank or cdlp): the resilience drill across ranks.

  1. **reference** -- a fault-free one-process run on the reduced fnum-2
     mesh the survivor restores onto (legs 1-3 run at once);
  2. **gang** -- two CLI ranks at fnum 4 with sharded two-phase
     checkpoints (`ckpt_<K>/rank_<r>.npz`); `GRAPE_FT_FAULTS=
     kill_rank@K:1` kills rank 1 right after superstep K's commit is
     durable (exit 17), stranding rank 0 in the next collective, which
     fails it (at the latest after the gang's GRAPE_DIST_TIMEOUT_S, 60);
  3. **gang telemetry** -- the same gang with GRAPE_TRACE and
     GRAPE_POSTMORTEM armed and a raise-mode kill: the fault travels the
     breach vote, both ranks halt, their trace sidecars merge into one
     timeline (both ranks' superstep spans, a vote flow across the rank
     tracks, monotonic aligned timestamps), and both postmortem shards
     land under one `incident_<id>/` with a byte-verified `gang.json`;
  4. **reshard restore** -- one survivor process resumes the two-rank
     snapshot onto fnum 2 (`restore_resharded`);
  5. **verify** -- the resumed files equal the fault-free run's byte for
     byte (PageRank within 1e-4: its carry at K came from fnum-4 sums);
     an `ft_drill` JSON record is printed.  Exit 2 iff they diverge.

With `--device cuda` the two ranks share the card, so the drill names
gloo for them (GRAPE_DIST_BACKEND=gloo: each collective staged through
host memory; NCCL refuses two ranks on one card).

Exit code 0 iff every app passes.  `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
import filecmp
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

APP_FLAGS = {
    "sssp": ["--sssp_source", "6"],
    "bfs": ["--bfs_source", "6"],
    "pagerank": ["--pr_mr", "10"],
    "cdlp": ["--cdlp_mr", "10"],
}


def cli_env(env_overrides=None) -> dict:
    """A CLI child's environment: no ambient fault, guard, bundle sink or
    trace, the repository on the path."""
    env = dict(os.environ)
    for k in ("GRAPE_FT_FAULTS", "GRAPE_GUARD", "GRAPE_POSTMORTEM",
              "GRAPE_TRACE"):
        env.pop(k, None)
    env.update(env_overrides or {})
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def run_cli(extra, env_overrides=None, timeout=600):
    """(exit code, merged stdout and stderr) of the port's CLI in a child
    process (`cli_env`)."""
    cmd = [sys.executable, "-m", "libgrape_lite_tpu_torch.cli"] + extra
    proc = subprocess.run(cmd, cwd=REPO, env=cli_env(env_overrides),
                          timeout=timeout, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    return proc.returncode, proc.stdout.decode(errors="replace")


def compare_outputs(ref_dir: str, res_dir: str) -> list[str]:
    ref_files = sorted(os.listdir(ref_dir))
    res_files = sorted(os.listdir(res_dir))
    if ref_files != res_files:
        return [f"file sets differ: {ref_files} vs {res_files}"]
    problems = [f"{name} differs byte-for-byte" for name in ref_files
                if not filecmp.cmp(os.path.join(ref_dir, name),
                                   os.path.join(res_dir, name),
                                   shallow=False)]
    if not ref_files:
        problems.append("reference run produced no output files")
    return problems


def base_args(app: str, args) -> list:
    return [
        "--application", app, "--efile", args.efile, "--vfile", args.vfile,
        "--fnum", str(args.fnum), "--device", args.device,
        "--checkpoint_every", str(args.checkpoint_every),
    ] + APP_FLAGS.get(app, [])


def reference(app: str, base: list, wd: str):
    out_ref = os.path.join(wd, "out_ref")
    rc, log = run_cli(base + ["--checkpoint_dir", os.path.join(wd, "ck_ref"),
                              "--out_prefix", out_ref])
    if rc != 0:
        print(f"[{app}] FAIL: reference run rc={rc}\n{log}")
        return None
    return out_ref


def drill(app: str, args, workdir: str) -> bool:
    from libgrape_lite_tpu_torch.ft.checkpoint import list_checkpoints
    from libgrape_lite_tpu_torch.ft.faults import (
        DEFAULT_KILL_EXIT_CODE,
        corrupt_file,
    )

    wd = os.path.join(workdir, app)
    os.makedirs(wd, exist_ok=True)
    base = base_args(app, args)
    out_ref = reference(app, base, wd)
    if out_ref is None:
        return False

    ck = os.path.join(wd, "ck")
    out_kill = os.path.join(wd, "out_kill")
    rc, log = run_cli(base + ["--checkpoint_dir", ck,
                              "--out_prefix", out_kill],
                      env_overrides={"GRAPE_FT_FAULTS":
                                     f"kill@{args.kill_at}"})
    if rc != DEFAULT_KILL_EXIT_CODE:
        print(f"[{app}] FAIL: killed run rc={rc} "
              f"(expected {DEFAULT_KILL_EXIT_CODE})\n{log}")
        return False
    if os.path.exists(out_kill) and os.listdir(out_kill):
        print(f"[{app}] FAIL: killed run wrote output")
        return False
    steps = list_checkpoints(ck)
    if not steps:
        print(f"[{app}] FAIL: killed run left no complete checkpoint")
        return False
    if args.corrupt:
        shard = os.path.join(steps[-1][1], "state.npz")
        corrupt_file(shard)
        print(f"[{app}] corrupted newest shard {shard}")

    out_res = os.path.join(wd, "out_res")
    rc, log = run_cli(base + ["--resume", "--checkpoint_dir", ck,
                              "--out_prefix", out_res])
    if rc != 0:
        print(f"[{app}] FAIL: resume rc={rc}\n{log}")
        return False
    problems = compare_outputs(out_ref, out_res)
    if problems:
        print(f"[{app}] FAIL: " + "; ".join(problems))
        return False
    print(f"[{app}] PASS: killed at superstep {args.kill_at} (exit "
          f"{DEFAULT_KILL_EXIT_CODE}; last checkpoint {steps[-1][0]}"
          f"{', corrupted' if args.corrupt else ''}), resumed run is "
          f"byte-identical to the uninterrupted one")
    return True


def self_heal_drill(app: str, args, workdir: str) -> bool:
    """corrupt_carry@K under --guard rollback heals to byte-identical
    files through the CLI."""
    wd = os.path.join(workdir, f"heal_{app}")
    os.makedirs(wd, exist_ok=True)
    base = base_args(app, args)
    out_ref = reference(app, base, wd)
    if out_ref is None:
        return False
    out_heal = os.path.join(wd, "out_heal")
    rc, log = run_cli(
        base + ["--checkpoint_dir", os.path.join(wd, "ck_heal"),
                "--out_prefix", out_heal, "--guard", "rollback"],
        env_overrides={"GRAPE_FT_FAULTS":
                       f"corrupt_carry@{args.corrupt_carry_at}"})
    if rc != 0:
        print(f"[{app}] FAIL: self-heal run rc={rc}\n{log}")
        return False
    m = re.search(r"invariant breach at superstep (\d+)", log)
    if not m:
        print(f"[{app}] FAIL: injected corruption was never detected\n{log}")
        return False
    breach_at = int(m.group(1))
    if breach_at - args.corrupt_carry_at > args.checkpoint_every:
        print(f"[{app}] FAIL: breach detected at superstep {breach_at}, "
              f"more than one cadence after the injection at "
              f"{args.corrupt_carry_at}")
        return False
    if "rolled back to superstep" not in log:
        print(f"[{app}] FAIL: breach detected but no rollback ran\n{log}")
        return False
    problems = compare_outputs(out_ref, out_heal)
    if problems:
        print(f"[{app}] FAIL: " + "; ".join(problems))
        return False
    print(f"[{app}] PASS: corrupt_carry@{args.corrupt_carry_at} detected at "
          f"superstep {breach_at}, rolled back, replayed; healed run is "
          f"byte-identical to the fault-free one")
    return True


def postmortem_drill(args, workdir: str) -> bool:
    """Guard breaches under the fleet dump flight-recorder bundles whose
    serve_query rows equal the Chrome trace's (JAX `scripts/
    fault_drill.py::postmortem_drill`)."""
    import glob
    import json

    wd = os.path.join(workdir, "postmortem")
    os.makedirs(wd, exist_ok=True)
    stream = os.path.join(wd, "stream.txt")
    with open(stream, "w") as fh:
        for i in range(16):
            fh.write(f"sssp {6 + i}\n")
        for i in range(8):
            fh.write(f"bfs {6 + i}\n")
    pm = os.path.join(wd, "pm")
    trace = os.path.join(wd, "trace.json")
    # --max_batch 1 runs each query through Worker.query's guard (the
    # corrupt_carry hook's path); halt isolates every poisoned query, so
    # the stream still completes
    rc, log = run_cli(
        ["serve", "--efile", args.efile, "--vfile", args.vfile,
         "--device", args.device, "--fnum", str(args.fnum),
         "--stream", stream, "--max_batch", "1", "--guard", "halt",
         "--replicas", "2", "--tenants", "by_app", "--trace", trace],
        env_overrides={
            "GRAPE_FT_FAULTS": f"corrupt_carry@{args.corrupt_carry_at}",
            "GRAPE_POSTMORTEM": pm,
        })
    if rc != 1:
        print(f"[postmortem] FAIL: poisoned serve rc={rc} (expected 1: "
              f"every lane breaches, the stream completes)\n{log}")
        return False
    if "invariant breach at superstep" not in log:
        print(f"[postmortem] FAIL: no breach was ever detected\n{log}")
        return False
    try:
        rec = json.loads(
            [ln for ln in log.splitlines() if ln.startswith("{")][-1])
    except (IndexError, ValueError):
        print(f"[postmortem] FAIL: serve wrote no summary record\n{log}")
        return False
    if rec["queries"] != 24 or rec["failed"] != 24:
        print(f"[postmortem] FAIL: expected all 24 poisoned lanes to fail "
              f"alone, got {rec['failed']}/{rec['queries']}")
        return False
    bundles = sorted(glob.glob(os.path.join(pm, "postmortem_*.json")))
    if len(bundles) < 2:
        print(f"[postmortem] FAIL: {len(bundles)} bundle(s) dumped, "
              f"expected one per breach")
        return False
    newest = bundles[-1]
    with open(newest) as fh:
        bundle = json.load(fh)
    sq = [sp for sp in bundle.get("spans", [])
          if sp.get("name") == "serve_query"]
    if not sq or not bundle.get("guard") or not bundle.get("federation"):
        print(f"[postmortem] FAIL: newest bundle lacks serve_query spans / "
              f"guard forensics / federation snapshot ({len(sq)} spans)")
        return False
    rc, log = run_cli(["postmortem", newest, "--trace", trace])
    if rc != 0:
        print(f"[postmortem] FAIL: postmortem --trace rc={rc}\n{log}")
        return False
    if "0 mismatched, 0 absent" not in log:
        print(f"[postmortem] FAIL: bundle span rows drifted from the "
              f"Chrome trace\n{log}")
        return False
    print(f"[postmortem] PASS: {len(bundles)} breach bundle(s) dumped "
          f"under the 2-replica fleet; newest carries {len(sq)} "
          f"serve_query row(s), every one byte-identical to the Chrome "
          f"trace's row for the same query id")
    return True


#: the apps of runner.DIST_APP_NAMES the kill-rank drill drives (the LCCs
#: and bc finish in PEval; the K1 library apps run across ranks but the
#: drill keeps its LDBC set; the vertex-cut names run across ranks too,
#: but the drill reshards onto fnum 2, which a vertex-cut lineage
#: refuses)
KILL_RANK_APPS = ("sssp", "bfs", "wcc", "pagerank", "cdlp")
PR_RTOL = 1e-4  # the verifier's relative tolerance for PageRank
GANG_DIST_TIMEOUT_S = 60  # a gang's GRAPE_DIST_TIMEOUT_S
GANG_TIMEOUT_S = 300  # seconds a gang's ranks may run


def _free_coordinator() -> str:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def gang_env(args, extra) -> dict:
    """The environment of a gang's ranks (`cli_env`): the drill's group
    timeout, gloo named on a card."""
    env = {"GRAPE_DIST_TIMEOUT_S": str(GANG_DIST_TIMEOUT_S), **extra}
    if args.device == "cuda":
        env["GRAPE_DIST_BACKEND"] = "gloo"
    return cli_env(env)


def start_cli(flags, env):
    return subprocess.Popen(
        [sys.executable, "-m", "libgrape_lite_tpu_torch.cli", *flags],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def start_gang(flags, env, world=2):
    coord = _free_coordinator()
    return [start_cli(flags + ["--coordinator", coord, "--num_processes",
                               str(world), "--process_id", str(r)], env)
            for r in range(world)]


def finish(procs, timeout):
    """Every rank's (exit code, output); a rank past `timeout` seconds is
    killed with the rest (rc None)."""
    import time

    deadline = time.monotonic() + timeout
    outs = []
    for q in procs:
        try:
            out, _ = q.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((q.returncode, out.decode(errors="replace")))
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            out, _ = q.communicate()
            outs.append((None, out.decode(errors="replace")))
    return outs


def _ranks_log(outs) -> str:
    return "".join(f"\n--- rank {r} (rc {rc}) ---\n{log}"
                   for r, (rc, log) in enumerate(outs))


def compare_within(ref_dir: str, res_dir: str, rtol: float) -> tuple:
    """(problems, max relative error) of PageRank files compared by oid
    within `rtol` (the verifier's rule)."""
    def values(d):
        out = {}
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name)) as fh:
                for line in fh:
                    if line.strip():
                        oid, v = line.split()
                        out[oid] = float(v)
        return out

    ref, res = values(ref_dir), values(res_dir)
    if ref.keys() != res.keys():
        return ["vertex sets differ"], float("inf")
    worst = max((abs(res[k] - v) / max(abs(v), 1e-300)
                 for k, v in ref.items() if v != 0), default=0.0)
    return ([] if worst <= rtol else
            [f"max relative error {worst:.3e} > {rtol:g}"]), worst


def start_telemetry_gang(args, wd: str, common):
    """The raise-mode gang, GRAPE_TRACE and GRAPE_POSTMORTEM armed."""
    return start_gang(common + [
        "--fnum", "4", "--checkpoint_dir", os.path.join(wd, "ck_gangtrace"),
        "--out_prefix", os.path.join(wd, "out_gangtrace")], gang_env(args, {
            "GRAPE_FT_FAULTS": f"kill_rank@{args.kill_at}:1,mode=raise",
            "GRAPE_TRACE": os.path.join(wd, "gang_trace.json"),
            "GRAPE_POSTMORTEM": os.path.join(wd, "gang_pm")}))


def _gang_telemetry_leg(app: str, wd: str, outs):
    """The raise-mode gang's checks (`outs`: its ranks' exit codes and
    logs): the kill travelled the breach vote, both ranks halted and
    landed their telemetry -- sidecars merged by `obs.gang.assemble` (both
    ranks' superstep spans, a vote flow across the rank tracks, monotonic
    timestamps) and one `incident_<id>/` with every rank's shard and rank
    0's byte-verified `gang.json`.  Returns the gang fields of the
    ft_drill record, or None on a failed check."""
    import glob
    import json

    from libgrape_lite_tpu_torch.obs import gang

    trace = os.path.join(wd, "gang_trace.json")
    pm = os.path.join(wd, "gang_pm")
    if any(rc in (0, None) for rc, _ in outs):
        print(f"[{app}] FAIL: the raise-mode gang must halt both ranks "
              f"through the vote (rcs {[rc for rc, _ in outs]})"
              + _ranks_log(outs))
        return None
    problems = []
    if "RemoteBreachError" not in outs[0][1] or "rank 1" not in outs[0][1]:
        problems.append("rank 0 did not halt on a RemoteBreachError "
                        "naming rank 1")
    summary = gang.assemble(os.path.splitext(trace)[0] + ".gang",
                            out_path=os.path.join(wd, "gang_merged.json"))
    if not summary["complete"]:
        problems.append(f"merged gang trace incomplete: ranks="
                        f"{summary['ranks']} missing={summary['missing']} "
                        f"aligned={summary['aligned']}")
    if any(int(summary["supersteps_by_rank"].get(str(r), 0)) < 1
           for r in range(2)):
        problems.append("a rank contributed no superstep spans: "
                        f"{summary['supersteps_by_rank']}")
    if summary["cross_rank_flows"] < 1:
        problems.append(f"no vote flow crosses the rank tracks "
                        f"({summary['flow_events']} leg(s))")
    if not summary["monotonic"]:
        problems.append("post-alignment timestamps are not monotonic")
    incident_dirs = sorted(glob.glob(os.path.join(pm, "incident_*")))
    manifest = {}
    if len(incident_dirs) != 1:
        problems.append("expected one shared incident dir, found "
                        f"{[os.path.basename(d) for d in incident_dirs]}")
    else:
        inc = incident_dirs[0]
        problems += [f"incident lacks rank_{r}.json" for r in range(2)
                     if not os.path.exists(os.path.join(inc,
                                                        f"rank_{r}.json"))]
        mpath = os.path.join(inc, "gang.json")
        if not os.path.exists(mpath):
            problems.append("rank 0 wrote no gang.json manifest")
        else:
            with open(mpath) as fh:
                manifest = json.load(fh)
            if not manifest.get("complete"):
                problems.append("gang manifest not byte-verified: "
                                f"{manifest.get('shards')}")
    if problems:
        print(f"[{app}] FAIL (gang telemetry): " + "; ".join(problems)
              + _ranks_log(outs))
        return None
    print(f"[{app}] gang telemetry: merged trace complete "
          f"({summary['events']} events, supersteps "
          f"{summary['supersteps_by_rank']}, {summary['cross_rank_flows']} "
          f"cross-rank flow(s)); incident {manifest.get('incident')} "
          f"byte-verified across {manifest.get('nprocs')} rank(s)")
    return {"gang_trace_events": int(summary["events"]),
            "gang_trace_complete": bool(summary["complete"]),
            "gang_cross_rank_flows": int(summary["cross_rank_flows"]),
            "gang_incident": str(manifest.get("incident", "")),
            "gang_bundle_verified": bool(manifest.get("complete", False))}


def kill_rank_drill(app: str, args, workdir: str) -> int:
    """Two CLI ranks at fnum 4 with sharded two-phase checkpoints; rank 1
    killed at superstep K; the snapshot restored by one process onto
    fnum 2 must equal a fault-free fnum-2 run.  0 on a pass, 2 on
    diverging files, 1 on any other failure."""
    import json
    import time

    from libgrape_lite_tpu_torch.ft.checkpoint import (
        list_checkpoints,
        read_meta,
    )
    from libgrape_lite_tpu_torch.ft.faults import DEFAULT_KILL_EXIT_CODE

    wd = os.path.join(workdir, f"killrank_{app}")
    os.makedirs(wd, exist_ok=True)
    common = ["--application", app, "--efile", args.efile, "--vfile",
              args.vfile, "--device", args.device, "--checkpoint_every",
              str(args.checkpoint_every)] + APP_FLAGS.get(app, [])
    # three independent legs at once: the fault-free reference on the
    # reduced mesh (fnum 2, one process); the gang at fnum 4 whose rank 1
    # is killed after superstep K's commit; the raise-mode gang (its
    # telemetry)
    out_ref = os.path.join(wd, "out_ref")
    ck = os.path.join(wd, "ck")
    ref = start_cli(common + ["--fnum", "2", "--checkpoint_dir",
                              os.path.join(wd, "ck_ref"), "--out_prefix",
                              out_ref], cli_env())
    procs = start_gang(common + ["--fnum", "4", "--checkpoint_dir", ck,
                                 "--out_prefix", os.path.join(wd,
                                                              "out_gang")],
                       gang_env(args, {"GRAPE_FT_FAULTS":
                                       f"kill_rank@{args.kill_at}:1"}))
    tele = start_telemetry_gang(args, wd, common)
    try:
        (rc, log), = finish([ref], GANG_TIMEOUT_S)
        outs = finish(procs[1:], GANG_TIMEOUT_S)
        # rank 0 is stranded in the next collective once rank 1 is gone:
        # that is the loss; the group's error (or its timeout) ends it
        outs = finish(procs[:1], GANG_DIST_TIMEOUT_S + 30) + outs
        tele_outs = finish(tele, GANG_TIMEOUT_S)
    finally:
        for q in [ref, *procs, *tele]:
            if q.poll() is None:
                q.kill()
                q.communicate()
    if rc != 0:
        print(f"[{app}] FAIL: fnum-2 reference run rc={rc}\n{log}")
        return 1
    if outs[1][0] != DEFAULT_KILL_EXIT_CODE or outs[0][0] == 0:
        print(f"[{app}] FAIL: killed rank rc={outs[1][0]} (expected "
              f"{DEFAULT_KILL_EXIT_CODE}), rank 0 rc={outs[0][0]} "
              "(expected a failure)" + _ranks_log(outs))
        return 1
    steps = list_checkpoints(ck)
    if not steps:
        print(f"[{app}] FAIL: the gang left no complete sharded "
              "checkpoint" + _ranks_log(outs))
        return 1
    meta = read_meta(steps[-1][1])
    if meta.get("layout") != "sharded" or meta.get("ranks") != 2:
        print(f"[{app}] FAIL: the newest checkpoint is not a 2-rank "
              f"sharded snapshot: layout={meta.get('layout')!r} "
              f"ranks={meta.get('ranks')!r}")
        return 1
    if int(meta["rounds"]) != args.kill_at:
        print(f"[{app}] FAIL: the newest durable snapshot is superstep "
              f"{meta['rounds']}, not the kill round {args.kill_at} (the "
              "kill fires after the commit)")
        return 1
    gang_fields = _gang_telemetry_leg(app, wd, tele_outs)
    if gang_fields is None:
        return 1
    # 4. one survivor process reshards the snapshot onto fnum 2
    out_res = os.path.join(wd, "out_res")
    t0 = time.monotonic()
    rc, log = run_cli(common + ["--fnum", "2", "--resume",
                                "--checkpoint_dir", ck,
                                "--out_prefix", out_res])
    wall = time.monotonic() - t0
    if rc != 0:
        print(f"[{app}] FAIL: reshard resume rc={rc}\n{log}")
        return 1
    if "resharded checkpoint" not in log:
        print(f"[{app}] FAIL: the resume did not reshard\n{log}")
        return 1
    # 5. verify and print the ft_drill record
    problems = compare_outputs(out_ref, out_res)
    identical = not problems
    err = 0.0
    if app == "pagerank" and problems:
        problems, err = compare_within(out_ref, out_res, PR_RTOL)
    rec = {
        "metric": "ft_drill_restore_wall",
        "value": round(wall, 3), "unit": "s", "vs_baseline": 1.0,
        "ft_drill": {
            "ranks": 2, "kill_round": args.kill_at, "kill_rank": 1,
            "old_fnum": 4, "new_fnum": 2,
            "checkpoint_rounds": int(meta["rounds"]),
            "restore_wall_s": round(wall, 3),
            "byte_identical": identical,
            **({"max_rel_err": err} if app == "pagerank" else {}),
            **gang_fields,
        },
    }
    print(json.dumps(rec))
    if problems:
        print(f"[{app}] FAIL: " + "; ".join(problems))
        return 2
    print(f"[{app}] PASS: rank 1 of 2 killed at superstep {args.kill_at}; "
          f"the {meta['fnum']}-fragment snapshot resharded onto fnum 2 and "
          + ("resumed byte-identical to" if identical else
             f"resumed within {PR_RTOL:g} (max {err:.3e}) of")
          + f" the fault-free run ({wall:.1f}s restore wall)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--apps", default="",
                   help="comma-separated app list (default: "
                        "sssp,pagerank,cdlp -- or sssp,pagerank,wcc "
                        "with --self-heal)")
    p.add_argument("--efile",
                   default=os.path.join(REPO, "dataset", "p2p-31.e"))
    p.add_argument("--vfile",
                   default=os.path.join(REPO, "dataset", "p2p-31.v"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--fnum", type=int, default=2)
    p.add_argument("--kill_at", type=int, default=4,
                   help="superstep to kill the child at")
    p.add_argument("--checkpoint_every", type=int, default=2)
    p.add_argument("--corrupt", action="store_true",
                   help="also corrupt the newest shard before resuming "
                        "(the fallback to the previous superstep)")
    p.add_argument("--self-heal", dest="self_heal", action="store_true",
                   help="guard/ drill: corrupt_carry@K under --guard "
                        "rollback, detection, rollback-replay, "
                        "byte-identical files")
    p.add_argument("--corrupt_carry_at", type=int, default=4,
                   help="superstep of the corrupt_carry injection")
    p.add_argument("--postmortem", action="store_true",
                   help="the guarded fleet's flight-recorder drill: "
                        "breach bundles joined to the trace")
    p.add_argument("--kill_rank", action="store_true",
                   help="the resilience drill across ranks: a 2-rank gang "
                        "at fnum 4 with sharded checkpoints, rank 1 killed "
                        "at --kill_at, the snapshot resharded onto one "
                        "fnum-2 process (default app sssp; exit 2 iff the "
                        "files diverge)")
    p.add_argument("--workdir", default="",
                   help="working directory (default: a fresh temp dir, "
                        "removed on success)")
    args = p.parse_args(argv)

    if not args.apps:
        args.apps = ("sssp" if args.kill_rank else "sssp,pagerank,wcc"
                     if args.self_heal else "sssp,pagerank,cdlp")
    apps = [a.strip() for a in args.apps.split(",") if a.strip()]
    if args.kill_rank:
        off = [a for a in apps if a not in KILL_RANK_APPS]
        if off:
            print(f"fault_drill: --kill_rank drills "
                  f"{', '.join(KILL_RANK_APPS)}; {off} run across "
                  "processes but are not among its apps", file=sys.stderr)
            return 2
    workdir = args.workdir or tempfile.mkdtemp(prefix="grape-fault-drill-")
    rc = 0
    if args.postmortem:
        rc = 0 if postmortem_drill(args, workdir) else 1
    elif args.kill_rank:
        for app in apps:
            rc = max(rc, kill_rank_drill(app, args, workdir))
    else:
        run_one = self_heal_drill if args.self_heal else drill
        for app in filter(None, args.apps.split(",")):
            if not run_one(app.strip(), args, workdir):
                rc = 1
    if rc == 0 and not args.workdir:
        shutil.rmtree(workdir, ignore_errors=True)
    else:
        print(f"artifacts kept under {workdir}")
    print("fault_drill:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
