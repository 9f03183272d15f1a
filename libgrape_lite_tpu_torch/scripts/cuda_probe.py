"""Rates of the card's primitives that a gather SpMV is built from.

Counterpart of the JAX package's `scripts/pallas_probe.py`, with its
flags, defaults, input check and case names, in its order:

  vpu_stream             out = a * 2 + 1
  lane_gather_t128       out[i, j] = tab[idx[i, j]], a 128-entry table
  sublane_gather_S{S}    out[i, j] = tab[idx[i, j], j], S = 8, 64, 512, 8192
  cumsum_lanes           prefix sum along each 128-wide row
  dense_matvec_8192_f32  torch.mv of an [8192, 8192] f32 matrix (full f32:
                         TF32 matmuls are switched off)

over E = 2^e_log float32 elements held as [E / 128, 128], with int32
indices.  The first four are the CUDA kernels of `ops/probe.py`.

    python -m libgrape_lite_tpu_torch.scripts.cuda_probe [--e_log 22] \\
        [--block 512] [--iters 5] [--device cuda]

Prints one JSON line per case: `case`, `ms` and `gelem_s` as the JAX
script prints them, plus `device` (the card's name, or "cpu"), `gb_s`
(the bytes each input is read and each output written once, over the
time), `working_set_mb` and `fits_l2` (those bytes fit the card's 50 MB
L2, so back-to-back calls are served from L2, not device memory: at the
default e_log 22 every plane is 16 MiB), and `placement` for the sublane
gathers (`shared`: the table is staged whole in shared memory; `sliced`:
a column slice of it a block).  `--block` is the
JAX script's sublane rows per program: it gates the input shape as there
(E / 128 rows must be a multiple of it);
the CUDA kernels size their own grid from the SM count.

A time is the median of `--iters` samples of the port's timer
(`utils/timing.py`): a sample is a batch of calls between two CUDA
events, queued behind a GPU busy-wait so that the events time the
device and not the host's dispatch.  `--device cuda`
(the default) raises without CUDA; `--device cpu` runs the plain
versions on the host clock, for tests at a small `--e_log` only: its
lines say `"device": "cpu"` and are no measurement of a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from libgrape_lite_tpu_torch.ops import probe
from libgrape_lite_tpu_torch.parallel.comm_spec import resolve_device
from libgrape_lite_tpu_torch.utils.timing import time_ms

SUBLANE_S = (8, 64, 512, 8192)
CASES = ("vpu_stream", "lane_gather_t128",
         *(f"sublane_gather_S{s}" for s in SUBLANE_S),
         "cumsum_lanes", "dense_matvec_8192_f32")
MATVEC_N = 8192
L2_BYTES = 50e6  # H100 L2 (data sheet)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m libgrape_lite_tpu_torch.scripts.cuda_probe",
        description="Rates of the card's gather, stream and scan "
                    "primitives (one JSON line per case).")
    ap.add_argument("--e_log", type=int, default=22)
    ap.add_argument("--block", type=int, default=512)  # sublane rows / block
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = (1 << args.e_log) // probe.LANES
    if not (args.block > 0 and rows % args.block == 0 and rows >= args.block):
        ap.error(f"E=2^{args.e_log} gives {rows} sublane rows; --block "
                 "must divide it")
    return args


def make_inputs(e_log: int, device) -> dict:
    """Every case's inputs, drawn from numpy's default_rng(0) in the JAX
    script's order (so both probes see the same numbers), on `device`."""
    rows = (1 << e_log) // probe.LANES
    rng = np.random.default_rng(0)
    lanes = (rows, probe.LANES)
    a = rng.random(lanes).astype(np.float32)
    idx = rng.integers(0, probe.LANES, size=lanes).astype(np.int32)
    tab128 = rng.random((8, probe.LANES)).astype(np.float32)
    sub = {}
    for s in SUBLANE_S:
        idxs = rng.integers(0, s, size=lanes).astype(np.int32)
        tabs = rng.random((s, probe.LANES)).astype(np.float32)
        sub[s] = (torch.from_numpy(tabs).to(device),
                  torch.from_numpy(idxs).to(device))
    m = rng.random((MATVEC_N, MATVEC_N)).astype(np.float32)
    v = rng.random((MATVEC_N,)).astype(np.float32)
    return {
        "a": torch.from_numpy(a).to(device),
        "idx": torch.from_numpy(idx).to(device),
        # the JAX kernel reads row 0 of its [8, 128] table block
        "tab128": torch.from_numpy(tab128[0].copy()).to(device),
        "sublane": sub,
        "m": torch.from_numpy(m).to(device),
        "v": torch.from_numpy(v).to(device),
    }


def case_table(inp: dict) -> list[tuple]:
    """(case, call, elements, bytes read once and written once) for each
    case, in the JAX script's order."""
    a, idx, tab128 = inp["a"], inp["idx"], inp["tab128"]
    e = a.numel()
    plane = 4 * e
    out = [("vpu_stream", lambda: probe.stream(a), e, 2 * plane),
           ("lane_gather_t128", lambda: probe.lane_gather_t128(tab128, idx),
            e, 2 * plane + tab128.numel() * 4)]
    for s, (tab, ix) in inp["sublane"].items():
        out.append((f"sublane_gather_S{s}",
                    lambda tab=tab, ix=ix: probe.sublane_gather(tab, ix),
                    e, 2 * plane + tab.numel() * 4))
    out.append(("cumsum_lanes", lambda: probe.cumsum_lanes(a), e, 2 * plane))
    m, v = inp["m"], inp["v"]
    out.append(("dense_matvec_8192_f32", lambda: torch.mv(m, v),
                MATVEC_N * MATVEC_N, 4 * m.numel() + 8 * MATVEC_N))
    return out


def run(args: argparse.Namespace) -> list[dict]:
    """Time every case; print one JSON line each and return the records
    (with `ms` unrounded)."""
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the matvec in full f32
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rows = (1 << args.e_log) // probe.LANES
    print(f"E={1 << args.e_log} grid={rows // args.block} "
          f"block=({args.block},{probe.LANES}) device={name}",
          file=sys.stderr)
    records = []
    for case, call, elements, nbytes in case_table(make_inputs(args.e_log,
                                                               dev)):
        ms = time_ms(call, dev, args.iters)
        rec = {"case": case, "ms": round(ms, 3),
               "gelem_s": round(elements / ms / 1e6, 2), "device": name,
               "gb_s": nbytes / ms / 1e6, "working_set_mb": nbytes / 1e6,
               "fits_l2": nbytes <= L2_BYTES}
        if case.startswith("sublane_gather"):
            rec["placement"] = call()[1]
        print(json.dumps(rec), flush=True)
        records.append(dict(rec, ms=ms, gelem_s=elements / ms / 1e6,
                            elements=elements, bytes=nbytes))
    return records


def main(argv=None) -> list[dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
