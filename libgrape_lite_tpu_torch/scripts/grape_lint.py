"""grape-lint over the port's tree, under a stable script path.

Counterpart of the JAX package's `scripts/grape_lint.py`: the `lint`
subcommand of the port's CLI (`cli.py::lint_main`, analysis/):

    python -m libgrape_lite_tpu_torch.scripts.grape_lint          # text
    python -m libgrape_lite_tpu_torch.scripts.grape_lint --json   # record
    python -m libgrape_lite_tpu_torch.scripts.grape_lint --artifact \\
        --device cpu                                   # + A3 on the CPU

`--artifact` on the default `--device cuda` runs the warm query matrix on
the card (`chip_smoke.py`'s `[lint]` phase does).  Exit 0 clean (baseline
suppressions allowed), 1 on an unsuppressed or stale finding, 2 on a
missing path or an empty `--update-baseline` reason, 3 when the `--json`
record fails its schema (analysis/report.py::validate_lint_report).
"""

import sys

from libgrape_lite_tpu_torch.cli import lint_main

if __name__ == "__main__":
    sys.exit(lint_main(sys.argv[1:]))
