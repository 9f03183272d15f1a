"""Graph loading pipeline and the garc fragment cache.

Counterpart of `libgrape_lite_tpu/fragment/loader.py::LoadGraph`
(reference `grape/fragment/loader.h:42-80`, `ev_fragment_loader.h`): read
the .v/.e files (`--string_id` keeps str oids), build the vertex map
(`--partitioner_type`, `--idxer_type`, or the degree-weighted blocks of
`--rebalance`), group edges by owner fragment and place the padded CSRs
on the device.  `GRAPE_VALIDATE_LOAD=1` checks every CSR after a load.

The serialization cache (`--serialize` / `--deserialize`, reference
`basic_fragment_loader_base.h:127-242`) writes the JAX package's format
byte for byte: `<prefix>/<sha256(sig)[:16]>/part_<fnum>/frag.garc` plus a
`sig` file, the same signature and the v3 stream encodings (delta /
plain LEB128 varints for id streams, packed bits for masks, byte-plane
deflate for floats, UTF-8 for string oids; `GRAPE_GARC_COMPACT=1`
deflates the varint payloads).  A cache that either package writes
loads in the other.  Reading refuses a pickle-era stream and any
deflate stream that inflates past its declared size.  The pre-garc npz
caches are not read.

`LOAD_SECONDS` holds the host seconds of each stage of the last load.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
import zlib
from dataclasses import dataclass

import numpy as np

from libgrape_lite_tpu_torch.fragment.edgecut import ShardedEdgecutFragment
from libgrape_lite_tpu_torch.fragment.partition import PARTITION_STATS
from libgrape_lite_tpu_torch.graph.csr import CSR
from libgrape_lite_tpu_torch.io.line_parser import (
    read_edge_file,
    read_vertex_file,
)
from libgrape_lite_tpu_torch.io.native import byte_join, byte_split
from libgrape_lite_tpu_torch.parallel.comm_spec import (
    CommSpec,
    host_allgather,
)
from libgrape_lite_tpu_torch.utils.archive import (
    InArchive,
    OutArchive,
    delta_varint_decode,
    delta_varint_encode,
    varint_decode,
    varint_encode,
)
from libgrape_lite_tpu_torch.utils.types import LoadStrategy
from libgrape_lite_tpu_torch.vertex_map.partitioner import make_partitioner
from libgrape_lite_tpu_torch.vertex_map.vertex_map import VertexMap

_LOG = logging.getLogger(__name__)

VALIDATE_LOAD_ENV = "GRAPE_VALIDATE_LOAD"
#: "1" folds rebalance=True into the spec before the cache signature
#: (GRAPE_PARTITION_REBALANCE_VF sets the vertex factor)
REBALANCE_ENV = "GRAPE_PARTITION_REBALANCE"

LOAD_SECONDS: dict = {}


@dataclass
class LoadGraphSpec:
    """Loading options (reference `LoadGraphSpec`,
    `basic_fragment_loader_base.h:30-109`)."""

    directed: bool = False
    weighted: bool = True
    load_strategy: LoadStrategy = LoadStrategy.kBothOutIn
    partitioner_type: str = "map"  # hash | map | segment
    idxer_type: str = "hashmap"  # hashmap | sorted_array | pthash | local
    rebalance: bool = False
    rebalance_vertex_factor: int = 0
    string_id: bool = False
    serialize: bool = False
    deserialize: bool = False
    serialization_prefix: str = ""
    edata_dtype: type = np.float32
    # keep the oid edge list on the fragment (`frag.edge_list`); a
    # deserialized fragment has none
    retain_edge_list: bool = False


def _cache_dir(efile: str, vfile: str, spec: LoadGraphSpec, fnum: int):
    """(cache directory, signature): the JAX package's, key for key."""
    sig = json.dumps(
        {
            "efile": os.path.abspath(efile),
            "vfile": os.path.abspath(vfile) if vfile else "",
            "esize": os.path.getsize(efile),
            "vsize": os.path.getsize(vfile) if vfile else 0,
            "directed": spec.directed,
            "weighted": spec.weighted,
            # undirected fragments alias oe and ie, so every load
            # strategy shares one entry
            "strategy": (
                "undirected-aliased" if not spec.directed
                else spec.load_strategy.value
            ),
            "partitioner": spec.partitioner_type,
            "idxer": spec.idxer_type,
            "rebalance": spec.rebalance,
            "string_id": spec.string_id,
            "rebalance_vertex_factor": spec.rebalance_vertex_factor,
            "type": "ShardedEdgecutFragment",
        },
        sort_keys=True,
    )
    h = hashlib.sha256(sig.encode()).hexdigest()[:16]
    return os.path.join(spec.serialization_prefix, h, f"part_{fnum}"), sig


def _fold_rebalance_env(spec: LoadGraphSpec) -> LoadGraphSpec:
    if spec.rebalance or os.environ.get(REBALANCE_ENV, "") in (
            "", "0", "off"):
        return spec
    vf = int(os.environ.get(REBALANCE_ENV + "_VF", "0") or 0)
    return dataclasses.replace(spec, rebalance=True,
                               rebalance_vertex_factor=vf)


def _shard_skew(partitioner, dst: np.ndarray, fnum: int) -> dict:
    """Per-shard in-edge counts under one partitioner; skew = max/mean
    (1.0 is a balanced cut)."""
    pids = partitioner.get_partition_id(dst)
    counts = np.bincount(pids[pids >= 0], minlength=fnum)
    mean = float(counts.mean()) if fnum else 0.0
    return {
        "max_shard_edges": int(counts.max()) if fnum else 0,
        "mean_shard_edges": round(mean, 1),
        "skew": round(float(counts.max()) / mean, 4) if mean else 1.0,
    }


def _validate_load(frag: ShardedEdgecutFragment) -> ShardedEdgecutFragment:
    """GRAPE_VALIDATE_LOAD=1: `CSR.validate` on every host CSR right
    after a load or deserialization."""
    if os.environ.get(VALIDATE_LOAD_ENV, "") in ("", "0"):
        return frag
    n_pad = frag.fnum * frag.vp
    sides = [("oe", frag.host_oe)]
    if frag.host_ie is not frag.host_oe:
        sides.append(("ie", frag.host_ie))
    for side, csrs in sides:
        for f, c in enumerate(csrs):
            c.validate(name=f"{side}[{f}]", n_pad=n_pad)
    _LOG.info("load validation: %d CSR(s) structurally sound",
              len(sides) * frag.fnum)
    return frag


def LoadGraph(
    efile: str,
    vfile: str | None,
    comm_spec: CommSpec,
    spec: LoadGraphSpec | None = None,
) -> ShardedEdgecutFragment:
    """Entry point, mirroring `LoadGraph<FRAG_T>` (`loader.h:42-53`).
    The device is `comm_spec.device`.  Under a process group every rank
    parses and builds the same host fragment and places its slab; with
    the serialization cache the coordinator alone writes it (the cache
    key does not depend on the world size: the host fragment is the
    same at any).

    With obs/ armed the load is a `load_graph` span with `read_edges`,
    `partition`, `build_fragment`, `deserialize` and `serialize`
    children, and sets the `grape_graph_edges` / `grape_graph_vertices`
    gauges (the JAX loader's spans and gauges)."""
    from libgrape_lite_tpu_torch import obs

    spec = _fold_rebalance_env(spec or LoadGraphSpec())
    LOAD_SECONDS.clear()
    tr = obs.tracer()
    with tr.span("load_graph", efile=efile, fnum=comm_spec.fnum) as lsp:
        cache = sig = None
        if (spec.serialize or spec.deserialize) and spec.serialization_prefix:
            cache, sig = _cache_dir(efile, vfile or "", spec, comm_spec.fnum)
        gang = getattr(comm_spec, "group", None) is not None
        cached = bool(cache) and os.path.exists(os.path.join(cache, "sig"))
        if gang and cache:
            # every rank of a group takes the coordinator's view of the
            # cache, so all of them read it or all build from source
            cached = bool(host_allgather(np.array([int(cached)]))[0][0])
        if spec.deserialize and cached:
            t0 = time.perf_counter()
            with tr.span("deserialize", cache=cache):
                frag = _deserialize_fragment(cache, comm_spec, spec)
            LOAD_SECONDS["deserialize"] = time.perf_counter() - t0
            lsp.set(path="deserialize")
            return _validate_load(frag)

        t0 = time.perf_counter()
        with tr.span("read_edges"):
            src, dst, w = read_edge_file(efile, weighted=spec.weighted,
                                         string_id=spec.string_id)
            if not spec.weighted:
                w = None
            if vfile:
                oids = read_vertex_file(vfile, string_id=spec.string_id)
            else:
                # efile-only loading: the vertex universe is the set of
                # endpoints
                oids = np.unique(np.concatenate([src, dst]))
        LOAD_SECONDS["parse"] = time.perf_counter() - t0
        lsp.set(edges=int(len(src)), vertices=int(len(oids)))

        t0 = time.perf_counter()
        fnum = comm_spec.fnum
        with tr.span("partition", kind=spec.partitioner_type):
            if spec.rebalance:
                from libgrape_lite_tpu_torch.fragment.rebalancer import (
                    Rebalancer,
                )

                partitioner = Rebalancer(
                    spec.rebalance_vertex_factor).partition(
                        oids, src, dst, fnum)
                # the skew the rebalancer fixed: in-edge counts of the
                # pull direction (both orientations when undirected)
                # against the cut it replaced
                d_all = dst if spec.directed else np.concatenate([dst, src])
                before = _shard_skew(
                    make_partitioner(spec.partitioner_type, fnum, oids),
                    d_all, fnum)
                after = _shard_skew(partitioner, d_all, fnum)
                PARTITION_STATS["rebalance"] = {
                    "fnum": fnum,
                    "vertex_factor": spec.rebalance_vertex_factor,
                    "before": before, "after": after,
                }
            else:
                partitioner = make_partitioner(spec.partitioner_type, fnum,
                                               oids)
            vm = VertexMap.build(oids, partitioner,
                                 idxer_type=spec.idxer_type)
        LOAD_SECONDS["vertex_map"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with tr.span("build_fragment"):
            frag = ShardedEdgecutFragment.build(
                comm_spec, vm, src, dst, w,
                directed=spec.directed,
                load_strategy=spec.load_strategy,
                edata_dtype=spec.edata_dtype,
                retain_edge_list=spec.retain_edge_list,
            )
            frag.load_spec = spec  # kept across a rebuild-on-mutate
        build = time.perf_counter() - t0
        LOAD_SECONDS["csr"] = build - frag.place_seconds
        LOAD_SECONDS["place"] = frag.place_seconds

        if spec.serialize and cache:
            t0 = time.perf_counter()
            # under a group the coordinator writes the cache and the
            # others wait until it is whole
            if not gang or comm_spec.is_coordinator:
                with tr.span("serialize", cache=cache):
                    _serialize_fragment(frag, cache, sig)
            if gang:
                comm_spec.barrier()
            LOAD_SECONDS["serialize"] = time.perf_counter() - t0
        if tr.enabled:
            obs.metrics().gauge("grape_graph_edges").set(int(len(src)))
            obs.metrics().gauge("grape_graph_vertices").set(int(len(oids)))
        return _validate_load(frag)


# ---- the garc stream format (utils/archive.py) --------------------------

_GARC_MAGIC = 0x47415243  # "GARC"
#: a v2 frag.garc inflates to at most this many times its file's size
#: (deflate's own ceiling is 1032:1; a fragment's CSR planes stay far
#: below this)
_V2_INFLATE_RATIO = 256

# stream encodings, one flag byte per array.  _ENC_PICKLE is never
# written since format v3 and refused on read: a crafted cache file must
# not reach pickle.loads.
(_ENC_RAW, _ENC_VARINT, _ENC_DELTA, _ENC_BITS, _ENC_PICKLE, _ENC_STR,
 _ENC_FPLANE, _ENC_VARINT_Z, _ENC_DELTA_Z) = range(9)

# deflate a float byte plane (or a compact varint payload) only when a
# level-1 pass wins at least 10%
_PLANE_MIN_GAIN = 0.9
# below this element count float streams stay raw
_FPLANE_MIN = 4096


def _put_array(ar: InArchive, a: np.ndarray) -> None:
    """Append one array: flag byte, element count, payload, dtype tag."""
    a = np.asarray(a)
    if a.dtype == object:  # string oids: varint lengths + UTF-8 payload
        blobs = [str(s).encode("utf-8") for s in a.tolist()]
        lens = varint_encode(np.array([len(b) for b in blobs],
                                      dtype=np.uint64))
        payload = b"".join(blobs)
        ar.add_scalar(_ENC_STR, "<b")
        ar.add_scalar(len(a))
        ar.add_scalar(len(lens))
        ar.add_bytes(lens)
        ar.add_scalar(len(payload))
        ar.add_bytes(payload)
        return
    if a.dtype == np.bool_:
        ar.add_scalar(_ENC_BITS, "<b")
        ar.add_scalar(len(a))
        ar.add_bytes(np.packbits(a).tobytes())
    elif np.issubdtype(a.dtype, np.integer) and (
            len(a) == 0 or (int(a.min()) >= 0 and int(a.max()) < (1 << 62))):
        monotone = len(a) > 0 and bool((np.diff(a) >= 0).all())
        enc = (delta_varint_encode if monotone else varint_encode)(
            a.astype(np.uint64))
        code = _ENC_DELTA if monotone else _ENC_VARINT
        # GRAPE_GARC_COMPACT=1 trades write time for bytes ("0" / ""
        # leave it off)
        compact = os.environ.get("GRAPE_GARC_COMPACT", "") not in ("", "0")
        if compact and len(enc) >= 1 << 12:
            z = zlib.compress(enc, 1)
            if len(z) < _PLANE_MIN_GAIN * len(enc):
                code = _ENC_DELTA_Z if monotone else _ENC_VARINT_Z
                enc = z
        ar.add_scalar(code, "<b")
        ar.add_scalar(len(a))
        ar.add_scalar(len(enc))
        ar.add_bytes(enc)
    elif np.issubdtype(a.dtype, np.floating) and len(a) >= _FPLANE_MIN:
        planes = byte_split(a)
        ar.add_scalar(_ENC_FPLANE, "<b")
        ar.add_scalar(len(a))
        ar.add_scalar(planes.shape[0], "<b")
        for p in planes:
            raw = p.tobytes()
            # probe a 1 MiB sample first: mantissa planes are noise and
            # a full deflate of them only finds that out slowly
            sample = raw[: 1 << 20]
            z = None
            if len(zlib.compress(sample, 1)) < _PLANE_MIN_GAIN * len(sample):
                z = zlib.compress(raw, 1)
            if z is not None and len(z) < _PLANE_MIN_GAIN * len(raw):
                ar.add_scalar(1, "<b")
                ar.add_scalar(len(z))
                ar.add_bytes(z)
            else:
                ar.add_scalar(0, "<b")
                ar.add_scalar(len(raw))
                ar.add_bytes(raw)
    else:
        ar.add_scalar(_ENC_RAW, "<b")
        ar.add_scalar(len(a))
        ar.add_array(a)
    tag = a.dtype.str.encode()
    ar.add_scalar(len(tag), "<b")
    ar.add_bytes(tag)


def _bounded_decompress(buf: bytes, max_out: int) -> bytes:
    """zlib inflate capped at the caller's expected size: the stream
    lengths in a frag.garc come from the file, so an uncapped inflate
    would let a small crafted file balloon (a decompression bomb)."""
    d = zlib.decompressobj()
    try:
        # max_length 0 means "no limit" to zlib: cap at 1 byte instead,
        # which any output at all then fails below
        out = d.decompress(buf, max(1, max_out))
        # input left after the cap means more output is wanted: probe
        # one byte to confirm
        extra = d.decompress(d.unconsumed_tail, 1) if d.unconsumed_tail \
            else b""
    except zlib.error as e:
        raise ValueError(f"corrupt deflate stream in frag.garc: {e}") from e
    if extra or len(out) > max_out:
        raise ValueError(
            "corrupt deflate stream in frag.garc: decompressed output "
            f"exceeds the expected {max_out} bytes")
    return out


def _get_array(oa: OutArchive) -> np.ndarray:
    enc = oa.get_scalar("<b")
    if enc == _ENC_PICKLE:
        raise ValueError(
            "pickle-era garc stream refused (deserializing it would run "
            "arbitrary code from the cache file); delete the cache dir "
            "and re-serialize from source")
    if enc == _ENC_STR:
        n = oa.get_scalar()
        lens = varint_decode(bytes(oa.get_bytes(oa.get_scalar())))
        payload = bytes(oa.get_bytes(oa.get_scalar()))
        if len(lens) != n or int(lens.sum()) != len(payload):
            raise ValueError("corrupt string stream in frag.garc")
        out = np.empty(n, dtype=object)
        pos = 0
        for i, ln in enumerate(lens.tolist()):
            out[i] = payload[pos:pos + ln].decode("utf-8")
            pos += ln
        return out
    n = oa.get_scalar()
    if enc == _ENC_FPLANE:
        itemsize = oa.get_scalar("<b")
        planes = np.empty((itemsize, n), dtype=np.uint8)
        for p in range(itemsize):
            comp = oa.get_scalar("<b")
            raw = bytes(oa.get_bytes(oa.get_scalar()))
            if comp:
                raw = _bounded_decompress(raw, n)  # a plane is n bytes
            if len(raw) != n:
                raise ValueError("corrupt float plane in frag.garc")
            planes[p] = np.frombuffer(raw, dtype=np.uint8)
        dt = np.dtype(bytes(oa.get_bytes(oa.get_scalar("<b"))).decode())
        if dt.itemsize != itemsize or dt.kind != "f":
            raise ValueError("corrupt float dtype tag in frag.garc")
        return byte_join(planes, dt)
    if enc == _ENC_BITS:
        vals = np.unpackbits(
            np.frombuffer(oa.get_bytes((n + 7) // 8), np.uint8)
        )[:n].astype(bool)
    elif enc in (_ENC_VARINT, _ENC_DELTA, _ENC_VARINT_Z, _ENC_DELTA_Z):
        buf = bytes(oa.get_bytes(oa.get_scalar()))
        if enc in (_ENC_VARINT_Z, _ENC_DELTA_Z):
            # LEB128 takes at most 10 bytes a uint64
            buf = _bounded_decompress(buf, 10 * n)
        vals = (delta_varint_decode(buf) if enc in (_ENC_DELTA, _ENC_DELTA_Z)
                else varint_decode(buf))
    else:
        vals = oa.get_array(np.uint8)
    dt = np.dtype(bytes(oa.get_bytes(oa.get_scalar("<b"))).decode())
    if enc == _ENC_RAW:
        return vals.view(dt).copy()
    return vals.astype(dt)


def _serialize_fragment(frag: ShardedEdgecutFragment, cache: str, sig: str):
    os.makedirs(cache, exist_ok=True)
    aliased = frag.host_ie is frag.host_oe
    ar = InArchive()
    ar.add_scalar(_GARC_MAGIC)
    ar.add_scalar(3)  # format version
    for v in (frag.fnum, frag.vp, int(frag.directed), int(frag.weighted),
              int(aliased), frag.dev.total_vnum, frag.dev.total_enum):
        ar.add_scalar(int(v))
    sides = [frag.host_oe] if aliased else [frag.host_oe, frag.host_ie]
    for f in range(frag.fnum):
        _put_array(ar, frag.inner_oids(f))
        for csrs in sides:
            c = csrs[f]
            _put_array(ar, c.indptr)
            _put_array(ar, c.edge_src)
            _put_array(ar, c.edge_nbr)
            _put_array(ar, c.edge_mask)
            ar.add_scalar(c.num_edges)
            ar.add_scalar(0 if c.edge_w is None else 1, "<b")
            if c.edge_w is not None:
                _put_array(ar, c.edge_w)
    with open(os.path.join(cache, "frag.garc"), "wb") as fh:
        fh.write(ar.get_buffer())
    with open(os.path.join(cache, "sig"), "w") as f:
        f.write(sig)


def _read_cache_file(path: str) -> bytes:
    """Read one cache file under the shared transient-IO retry policy
    (ft/retry.py): serialization prefixes live on shared filesystems,
    where a stale-handle EIO is worth another try before failing."""
    from libgrape_lite_tpu_torch.ft.retry import (
        CACHE_READ_POLICY,
        is_transient_io_error,
        with_retries,
    )

    def _read():
        with open(path, "rb") as fh:
            return fh.read()

    return with_retries(_read, policy=CACHE_READ_POLICY,
                        retryable=is_transient_io_error,
                        describe=f"garc cache read {path}")


def _read_garc(cache: str):
    """Parse frag.garc -> (meta dict, per-fragment streams)."""
    blob = _read_cache_file(os.path.join(cache, "frag.garc"))
    # v3 starts with the raw magic; v2 deflated the whole archive, and
    # its inflate is capped at a multiple of the file's size
    if not blob.startswith(_GARC_MAGIC.to_bytes(8, "little")):
        blob = _bounded_decompress(blob, _V2_INFLATE_RATIO * len(blob))
    oa = OutArchive(blob)
    if oa.get_scalar() != _GARC_MAGIC:
        raise ValueError("bad garc magic")
    version = oa.get_scalar()
    if version not in (2, 3):
        raise ValueError(f"unsupported garc version {version}")
    (fnum, vp, directed, weighted, aliased, total_vnum,
     total_enum) = (oa.get_scalar() for _ in range(7))
    meta = dict(fnum=fnum, vp=vp, directed=bool(directed),
                weighted=bool(weighted), aliased=bool(aliased),
                total_vnum=total_vnum, total_enum=total_enum)
    sides = ["oe"] if aliased else ["oe", "ie"]
    frags = []
    for _f in range(fnum):
        entry = {"oids": _get_array(oa)}
        for side in sides:
            indptr = _get_array(oa)
            src = _get_array(oa)
            nbr = _get_array(oa)
            mask = _get_array(oa)
            ne = oa.get_scalar()
            w = _get_array(oa) if oa.get_scalar("<b") else None
            entry[side] = (indptr, src, nbr, mask, ne, w)
        frags.append(entry)
    if not oa.empty():
        raise ValueError("trailing bytes in frag.garc")
    return meta, frags


def _deserialize_fragment(cache: str, comm_spec: CommSpec,
                          spec: LoadGraphSpec) -> ShardedEdgecutFragment:
    if not os.path.exists(os.path.join(cache, "frag.garc")):
        raise ValueError(
            f"{cache} holds no frag.garc (a pre-garc npz cache is not "
            "read); delete it and re-serialize from source")
    meta, frags = _read_garc(cache)
    fnum = meta["fnum"]
    if fnum != comm_spec.fnum:
        raise ValueError(
            f"serialized fnum={fnum} != requested {comm_spec.fnum}")
    # the content hash normally guarantees these; a moved or hand-made
    # cache must fail here, not inside the first query
    if spec.weighted and not meta["weighted"]:
        raise ValueError(
            "serialized fragment has no edge weights but the app requires "
            "them (spec.weighted=True); re-serialize from a weighted load")
    if meta["directed"] != bool(spec.directed):
        raise ValueError(f"serialized directed={meta['directed']} != "
                         f"requested {spec.directed}")
    vp = meta["vp"]
    all_oids = [e["oids"] for e in frags]

    def csr_from(e, side):
        indptr, src, nbr, mask, ne, w = e[side]
        return CSR(indptr=indptr, edge_src=src, edge_nbr=nbr, edge_w=w,
                   edge_mask=mask, num_rows=vp, num_edges=ne)

    host_oe = [csr_from(e, "oe") for e in frags]
    host_ie = (host_oe if meta["aliased"]
               else [csr_from(e, "ie") for e in frags])
    string_keyed = any(o.dtype == object for o in all_oids)
    oids = np.full((fnum, vp), -1,
                   dtype=object if string_keyed else np.int64)
    for f, o in enumerate(all_oids):
        oids[f, :len(o)] = o
    ivnum = np.array([len(o) for o in all_oids], dtype=np.int32)
    return ShardedEdgecutFragment(
        comm_spec, host_oe, host_ie, oids, ivnum, meta["directed"],
        meta["total_vnum"], meta["total_enum"])
