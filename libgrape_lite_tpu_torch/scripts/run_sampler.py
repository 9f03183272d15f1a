"""The streaming GNN sampler's command line (the reference's
`examples/gnn_sampler/run_sampler.cc` and `misc/sampler_test.sh`; the
JAX package's `scripts/run_sampler.py`, same flags with `--device` in
place of `--platform`).

Static mode samples every vertex once and writes `result_frag_0` lines
`vid: n1 n2 ...` (hops flattened):

    python -m libgrape_lite_tpu_torch.scripts.run_sampler \\
        --efile dataset/p2p-31.e --vfile dataset/p2p-31.v \\
        --sampling_strategy random --hop_and_num 4-5 \\
        --out_prefix /tmp/output_sampling [--device cpu]

Streaming mode consumes the interleaved line protocol (`e src dst [w]`
graph updates, `q vid` sample queries), extends the append-only fragment
and emits sampled neighbourhoods to the sink as they are produced:

    python -m libgrape_lite_tpu_torch.scripts.run_sampler ... \\
        --input_stream updates.txt --output_stream samples.txt

With --enable_kafka (and confluent_kafka importable) the same loop binds
to Kafka topics instead of files.  `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from contextlib import contextmanager


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--efile", required=True)
    p.add_argument("--vfile", default="")
    p.add_argument("--out_prefix", default="")
    p.add_argument("--sampling_strategy", default="random",
                   choices=("random", "edge_weight", "top_k"))
    p.add_argument("--hop_and_num", default="4-5",
                   help="'-'-separated per-hop fanouts (e.g. 4-5)")
    p.add_argument("--weighted", action="store_true",
                   help="efile has a weight column")
    p.add_argument("--directed", action="store_true",
                   help="stream updates are directed edges (pass this when "
                        "the stream already carries both orientations)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=512,
                   help="streaming query batch size")
    p.add_argument("--input_stream", default="",
                   help="update/query line file (`e src dst [w]` / `q vid`)")
    p.add_argument("--output_stream", default="",
                   help="sample sink file (default: stdout)")
    p.add_argument("--enable_kafka", action="store_true")
    p.add_argument("--broker_list", default="localhost:9092")
    p.add_argument("--input_topic", default="")
    p.add_argument("--output_topic", default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[run_sampler] {name}: {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)


class _StdoutSink:
    def emit(self, line: str) -> None:
        print(line)

    def close(self) -> None:
        pass


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np

    from libgrape_lite_tpu_torch.io.line_parser import (
        read_edge_file,
        read_vertex_file,
    )
    from libgrape_lite_tpu_torch.sampler.append_only_fragment import (
        AppendOnlyEdgecutFragment,
    )
    from libgrape_lite_tpu_torch.sampler.sampler import GraphSampler
    from libgrape_lite_tpu_torch.sampler.stream import (
        AsyncSink,
        FileSink,
        FileSource,
        kafka_available,
        run_pipeline,
    )

    fanouts = tuple(int(x) for x in args.hop_and_num.split("-") if x)
    if not fanouts:
        raise SystemExit("--hop_and_num must name at least one fanout")

    with phase("load graph"):
        src, dst, w = read_edge_file(args.efile, weighted=args.weighted)
        if args.vfile:
            oids = read_vertex_file(args.vfile)
        else:
            oids = np.unique(np.concatenate([src, dst]))
        n = int(oids.max()) + 1 if len(oids) else 0
        # undirected, as the reference loads it (directed=false)
        frag = AppendOnlyEdgecutFragment(
            n, np.concatenate([src, dst]), np.concatenate([dst, src]),
            None if w is None else np.concatenate([w, w]),
            device=args.device)
    sampler = GraphSampler(frag, args.sampling_strategy)

    if args.input_stream or args.enable_kafka:
        if args.enable_kafka:
            if not kafka_available():
                raise SystemExit(
                    "--enable_kafka needs confluent_kafka, which does not "
                    "import here; use --input_stream/--output_stream")
            from libgrape_lite_tpu_torch.sampler.stream import (
                KafkaSink,
                KafkaSource,
            )

            source = KafkaSource(args.broker_list, args.input_topic)
            sink = KafkaSink(args.broker_list, args.output_topic)
        else:
            source = FileSource(args.input_stream)
            sink = AsyncSink(FileSink(args.output_stream)
                             if args.output_stream else _StdoutSink())
        with phase("stream pipeline"):
            emitted = run_pipeline(frag, sampler, source, sink,
                                   fanouts=fanouts, batch=args.batch,
                                   seed=args.seed, directed=args.directed)
        sink.close()
        print(f"[run_sampler] emitted {emitted} samples; graph now "
              f"{frag.num_edges} edges over {frag.n} vertices",
              file=sys.stderr)
        return 0

    # static mode: every vertex once, through the same pipeline fed an
    # all-vertices query stream
    os.makedirs(args.out_prefix or ".", exist_ok=True)
    out_path = os.path.join(args.out_prefix or ".", "result_frag_0")
    sink = FileSink(out_path)
    with phase("sample"):
        emitted = run_pipeline(frag, sampler,
                               (f"q {o}" for o in oids.tolist()), sink,
                               fanouts=fanouts, batch=args.batch,
                               seed=args.seed)
    sink.close()
    print(f"[run_sampler] wrote {emitted} lines to {out_path}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
