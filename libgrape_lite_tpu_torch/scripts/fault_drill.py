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

`--kill_rank` (the multi-process reshard drill) exits 2: it waits for
sharded checkpoints across processes (ROADMAP Queue A item 8b).

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
    "pagerank": ["--pr_mr", "10"],
    "cdlp": ["--cdlp_mr", "10"],
}


def run_cli(extra, env_overrides=None, timeout=600):
    """(exit code, merged stdout and stderr) of the port's CLI in a child
    process, with no ambient fault, guard or bundle sink."""
    env = dict(os.environ)
    for k in ("GRAPE_FT_FAULTS", "GRAPE_GUARD", "GRAPE_POSTMORTEM"):
        env.pop(k, None)
    env.update(env_overrides or {})
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "libgrape_lite_tpu_torch.cli"] + extra
    proc = subprocess.run(cmd, cwd=REPO, env=env, timeout=timeout,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
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
                   help="the multi-process reshard drill: not ported "
                        "(exit 2)")
    p.add_argument("--workdir", default="",
                   help="working directory (default: a fresh temp dir, "
                        "removed on success)")
    args = p.parse_args(argv)

    if args.kill_rank:
        print("fault_drill: --kill_rank needs sharded checkpoints across "
              "processes (ft/distributed.py): ROADMAP Queue A item 8b",
              file=sys.stderr)
        return 2
    if not args.apps:
        args.apps = "sssp,pagerank,wcc" if args.self_heal else (
            "sssp,pagerank,cdlp")
    workdir = args.workdir or tempfile.mkdtemp(prefix="grape-fault-drill-")
    rc = 0
    if args.postmortem:
        rc = 0 if postmortem_drill(args, workdir) else 1
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
