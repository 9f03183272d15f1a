"""grape-lint over the PyTorch/CUDA package: a static contract linter and
a run-time build audit.

Counterpart of `libgrape_lite_tpu/analysis/`.  Layer 1, the AST rules
(analysis/astlint.py: R4 dyn-view parity, R5 eager logs and bool-blind
schemas, R7 host syncs on the pump's dispatch stage, R8 stats outside the
federation, R9 incomplete result-cache keys, R10 pinned rates, R11 raw
mesh axis names in models/, R12 unkeyed modeled claims), makes defect
classes the JAX package shipped once un-shippable here.  Layer 2, A3 (analysis/artifact.py), runs the warm query
matrix and pins zero rebuilds.  analysis/rules.py says which JAX rules are
not carried and why.  Intentional exceptions are named in
analysis/baseline.json.

Surfaces: `python -m libgrape_lite_tpu_torch.cli lint`,
`python -m libgrape_lite_tpu_torch.scripts.grape_lint`, and
`analysis.build_events()` for zero-rebuild pins.
"""

from libgrape_lite_tpu_torch.analysis.artifact import (
    BuildEvents,
    build_events,
    run_artifact_audit,
    warm_matrix_audit,
)
from libgrape_lite_tpu_torch.analysis.astlint import (
    lint_paths,
    lint_source,
    repo_root,
)
from libgrape_lite_tpu_torch.analysis.report import (
    DEFAULT_BASELINE,
    Baseline,
    Finding,
    build_report,
    render_text,
    split_by_baseline,
    stale_suppressions,
    validate_lint_report,
)
from libgrape_lite_tpu_torch.analysis.rules import RULES

__all__ = [
    "Baseline",
    "BuildEvents",
    "DEFAULT_BASELINE",
    "Finding",
    "RULES",
    "build_events",
    "build_report",
    "lint_paths",
    "lint_source",
    "render_text",
    "repo_root",
    "run_artifact_audit",
    "run_lint",
    "split_by_baseline",
    "stale_suppressions",
    "validate_lint_report",
    "warm_matrix_audit",
]


def run_lint(paths=None, *, baseline_path=None, artifact: bool = False,
             root=None, device="cuda"):
    """One linter run: (report dict, exit code).  The default scope is
    this package's tree; the code is 1 when an unsuppressed finding
    survives the baseline.  `artifact` adds A3 on `device`."""
    import os

    if root is None:
        root = repo_root()
    default_scope = not paths
    if default_scope:
        paths = [os.path.join(root, "libgrape_lite_tpu_torch")]
    findings = lint_paths(paths, root=root)
    baseline = Baseline.load(baseline_path)
    art = None
    art_findings = []
    if artifact:
        art_findings, art = run_artifact_audit(device=device)
        findings = list(findings) + art_findings
    live, quiet = split_by_baseline(findings, baseline)
    if art is not None:
        # the artifact block's verdicts follow the same baseline split:
        # one defect never reads live in one half and suppressed in the
        # other
        quiet_fps = {f.fingerprint for f in quiet}
        art["findings"] = [f.to_dict(f.fingerprint in quiet_fps)
                           for f in art_findings]
    # staleness is provable only on the full default scope (a one-file
    # run matches almost no entry): there an entry, or a budget unit,
    # that no finding used fails the gate, so a retired defect retires
    # its exception
    stale = stale_suppressions(
        baseline, quiet, include_artifact=artifact,
    ) if default_scope else []
    report = build_report(
        live, quiet, root=root,
        baseline_path=baseline.path or DEFAULT_BASELINE,
        artifact=art, stale=stale,
    )
    return report, (0 if report["ok"] else 1)
