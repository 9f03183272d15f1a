"""Streaming sources and sinks of the sampler pipeline.

Counterpart of `libgrape_lite_tpu/sampler/stream.py` (reference
`examples/gnn_sampler/kafka_{consumer,producer}.h`, `run_sampler.cc`):
the reference consumes graph-update and query streams from Kafka and
emits sampled neighbourhoods back.  The transport is pluggable:
`FileSource` / `FileSink` replay and record the same line protocol
(`e src dst [w]` updates, `q vid` queries), and `KafkaSource` /
`KafkaSink` bind to confluent_kafka where it imports.
"""

from __future__ import annotations

from typing import Iterable, Iterator


class FileSource:
    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[str]:
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line and line[0] != "#":
                    yield line


class FileSink:
    def __init__(self, path: str):
        self._f = open(path, "w")

    def emit(self, line: str) -> None:
        self._f.write(line + "\n")

    def close(self) -> None:
        self._f.close()


class AsyncSink:
    """Sample emission on a writer thread, off the query loop (the
    reference's pending output job, `run_sampler.cc:86-131`).  Lines
    flow through a producer-counting BlockingQueue
    (`utils/thread_pool.py`); `close()` drains and joins.  A writer
    failure is raised by the next `emit` or `close`."""

    def __init__(self, inner, maxsize: int = 8192):
        import threading

        from libgrape_lite_tpu_torch.utils.thread_pool import BlockingQueue

        self._inner = inner
        # bounded: a slow sink applies backpressure to the query loop
        # (the reference blocks on the previous output job) instead of
        # buffering the whole backlog in RAM
        self._q = BlockingQueue(maxsize=maxsize)
        self._q.set_producer_num(1)
        self._error: Exception | None = None
        self._t = threading.Thread(target=self._drain, daemon=True)
        self._t.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._inner.emit(item)
            except Exception as e:  # surface on the producer side
                self._error = e
                # keep draining so producers don't block on a full
                # queue; lines after the failure are dropped, and the
                # next emit()/close() raises
                while self._q.get() is not None:
                    pass
                return

    def _check(self):
        # error stays sticky: a second emit()/close() after a writer
        # failure must not silently succeed
        if self._error is not None:
            raise RuntimeError("async sink writer failed") from self._error

    def emit(self, line: str) -> None:
        self._check()
        self._q.put(line)

    def close(self) -> None:
        self._q.decrement_producer()
        self._t.join()
        try:
            self._check()
        finally:
            # always close/flush the inner sink, even when the writer
            # thread died mid-stream (no leaked handle / lost buffer)
            self._inner.close()


def kafka_available() -> bool:
    try:
        import confluent_kafka  # noqa: F401

        return True
    except ImportError:
        return False


class KafkaSource:  # pragma: no cover - requires kafka runtime
    def __init__(self, brokers: str, topic: str, group: str = "grape-tpu"):
        from confluent_kafka import Consumer

        self._c = Consumer(
            {"bootstrap.servers": brokers, "group.id": group,
             "auto.offset.reset": "earliest"}
        )
        self._c.subscribe([topic])

    def __iter__(self):
        while True:
            msg = self._c.poll(1.0)
            if msg is None or msg.error():
                continue
            yield msg.value().decode()


class KafkaSink:  # pragma: no cover - requires kafka runtime
    def __init__(self, brokers: str, topic: str):
        from confluent_kafka import Producer

        self._p = Producer({"bootstrap.servers": brokers})
        self._topic = topic

    def emit(self, line: str) -> None:
        self._p.produce(self._topic, line.encode())

    def close(self) -> None:
        self._p.flush()


def run_pipeline(fragment, sampler, source: Iterable[str], sink,
                 fanouts=(10, 5), batch: int = 512,
                 directed: bool = False, seed: int = 0) -> int:
    """The run_sampler.cc loop: drain updates/queries, extend the
    append-only fragment, batch-sample, emit `vid: n1 n2 ...` lines.

    `directed=False` (the reference's graph_spec, run_sampler.cc:78)
    inserts each update in both directions; an `e src dst [w]` line
    therefore means ONE undirected edge — a stream that already
    carries both orientations of each edge should pass directed=True
    (there is no dedup downstream).  Each query batch draws from seed
    `seed + batch number`, so re-queried vertices get independent
    samples."""
    import numpy as np

    queries: list[int] = []
    emitted = 0
    batch_no = 0

    def flush_queries():
        nonlocal emitted, batch_no
        if not queries:
            return
        fragment.flush()
        hops = [h.cpu().numpy() for h in sampler.sample(
            np.asarray(queries), fanouts, seed=seed + batch_no)]
        batch_no += 1
        for i, q in enumerate(queries):
            flat = [str(x) for h in hops for x in h[i].tolist() if x >= 0]
            sink.emit(f"{q}: {' '.join(flat)}")
            emitted += 1
        queries.clear()

    for line in source:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "e":
            # arrival order is the contract: queries already queued must
            # sample the PRE-update graph
            flush_queries()
            s, d = int(parts[1]), int(parts[2])
            w = [float(parts[3])] if len(parts) > 3 else None
            if directed:
                fragment.extend([s], [d], w)
            else:
                fragment.extend([s, d], [d, s], None if w is None
                                else w * 2)
        elif parts[0] == "q":
            queries.append(int(parts[1]))
            if len(queries) >= batch:
                flush_queries()
    flush_queries()
    return emitted
