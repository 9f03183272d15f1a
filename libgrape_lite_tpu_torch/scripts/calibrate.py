"""Fit the rate profile on the card, or gate one against measured walls.

Counterpart of the JAX package's `scripts/calibrate.py`: the
`calibrate` subcommand of the port's CLI (`cli.py::calibrate_main`,
`ops/calibration.py`) under a stable script path:

    python -m libgrape_lite_tpu_torch.scripts.calibrate \\
        --out rates.json --samples-out samples.json
    python -m libgrape_lite_tpu_torch.scripts.calibrate --check \\
        --samples samples.json --profile rates.json
    GRAPE_RATE_PROFILE=rates.json python -m libgrape_lite_tpu_torch.cli ...

`--device cuda` (the default) raises without CUDA; `--device cpu` runs the
kernels' plain versions on the host clock, for tests at small
`--scales`: such a profile is no rate of a card.  Exit 0 when the fit or
the gate holds, 2 when the fit is infeasible, the drift passes 5% or a
samples or profile file is unreadable.
"""

import sys

from libgrape_lite_tpu_torch.cli import calibrate_main

if __name__ == "__main__":
    sys.exit(calibrate_main(sys.argv[1:]))
