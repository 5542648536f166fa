"""Binary RPC wire for the fleet's shard fan-out — THE codec module.

The shard RPCs (`/shard/topk`, `/shard/user_row`, `/shard/item_rows`)
move f32 factor rows and top-k score vectors on every router query; the
JSON wire spends the fan-out budget printing and re-parsing float text.
This module is the single owner of the binary alternative (the
`wire-codec` lint rule sanctions exactly this file, like
data/columnar.py for the columnar wire): a CRC32C-framed message —
``utils/durable.frame`` envelope with its own magic, so truncation and
bit-rot die at the edge as a 400/failover, never a silent wrong score —
whose numeric sections are raw little-endian f32/int32 arrays decoded by
``np.frombuffer`` pointer-cast (the columnar wire's codec discipline).

Bit-parity contract: the f32 bytes ARE the shard's factor/score values,
so the router's ``(-score, global_index)`` merge stays bit-identical to
the single-host oracle — exactly as identical as the JSON wire, whose
float text round-trips f32→f64 repr→parse→f32 losslessly, just without
the printing/parsing. Entity ids keep their JSON semantics verbatim: the
id lists travel as a JSON sidecar inside the frame, so a non-string id
is (un)known exactly as it is on the JSON wire.

Negotiation (docs/performance.md "Internal RPC plane"): the router sends
``Accept: application/x-pio-rpc``; a binary-capable shard answers the
frame under that Content-Type, a pre-binary shard ignores the header and
answers JSON — the router detects the JSON body and downgrades that
replica STICKILY (logged once), mirroring ``find_columnar``'s downgrade.
Only after a replica has confirmed binary does the router also send the
top-k REQUEST body (the query user's f32 row) as a frame under
``Content-Type: application/x-pio-rpc``.

Message layout inside the durable envelope::

    PIOR\\x01 | crc32c(payload) | len(payload)      (durable._HEADER)
    payload = u8 kind | u32 header_len | header_json | sections...

    kind 1 TOPK_REQ       header {"k", "arm", "d"}          row f32[d]
    kind 2 TOPK_RESP      header {"n", "items": [...]}      gidx i32[n]
                                                            scores f32[n]
    kind 3 USER_ROW_RESP  header {"found", "d"}             row f32[d]
    kind 4 ITEM_ROWS_RESP header {"n", "k", "ids": [...]}   rows f32[n*k]
    kind 5 RESHARD_PART   header {"p", "iid", "nu", "ni",   user_rows f32[nu*k]
                          "k", "userIds", "itemIds"         gidx i32[ni]
                          [, "qdtype"]}                     item_rows f32[ni*k]
                                                            [qrows i8|u16[ni*k]
                                                             qscales f32[ni]]
    kind 6 CAND_REQ       header {"k", "arm", "d"}          row f32[d]

Kind 5 is the reshard migration unit (docs/serving.md "Elastic
resharding"): one virtual partition's factor rows, streamed old-owner ->
controller -> new owner CRC32C-framed end-to-end, so a partition that
arrives corrupt dies at the destination's decode as a 400 and the
transfer retries — never a silently wrong row in the new topology. When
the source shard serves clustered retrieval, the slice also carries the
QUANTIZED item rows (``qdtype`` names the encoding; per-row scales ride
as their own section) so the destination stages the candidate tier
without re-quantizing — encoding is deterministic (ops/retrieval.py
encode_rows), so carried and rebuilt tables are byte-identical and the
destination verifies exactly that before trusting them.

Kind 6 is the candidate-generation RPC (docs/serving.md "Two-stage
retrieval"): same row+k shape as the top-k request, answered on the
SAME kind-2 response frame — exact re-ranked f32 scores — so the
router's ``(-score, global_index)`` merge code is shared verbatim
between the exact and clustered tiers.

Batched scoring frames (docs/serving.md "Continuous batching"): kinds
1/2/6 each grow a MULTI-QUERY layout, selected by a ``"batch"`` header
key, under the same CRC32C envelope::

    kind 1/6 batched req  header {"batch": n, "d",      rows f32[n*d]
                          "ks": [k...], "arm"}
    kind 2 batched resp   header {"batch": n,           gidx i32[sum]
                          "counts": [...],              scores f32[sum]
                          "items": [flat...]}

A coalescing router fans N concurrent queries to a shard group as ONE
frame per shard; shards answer every query from one batched device
dispatch. Every count is bounded before allocation and the sections must
match the counts exactly (forged-count rejection). A PRE-BATCH shard
decoding a batched request fails the solo layout's section/`k` checks
and answers 400 ``bad rpc frame`` — the router then downgrades that
replica STICKILY to per-query frames (logged once), mirroring the
binary-wire negotiation above.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from pio_tpu_torch.utils import durable

RPC_CONTENT_TYPE = "application/x-pio-rpc"
RPC_MAGIC = b"PIOR\x01"

_KIND_TOPK_REQ = 1
_KIND_TOPK_RESP = 2
_KIND_USER_ROW_RESP = 3
_KIND_ITEM_ROWS_RESP = 4
_KIND_RESHARD_PART = 5
_KIND_CAND_REQ = 6

_PREFIX = struct.Struct(">BI")   # kind, header length
_F32 = np.dtype("<f4")
_I32 = np.dtype("<i4")
_QDTYPES = {"bf16": np.dtype("<u2"), "int8": np.dtype("<i1")}


class RpcWireError(ValueError):
    """A frame that passed the CRC but violates the message layout
    (wrong kind, forged counts, trailing bytes). Shard routes map it to
    400; the router maps it to a transport-level failure so the replica
    fails over."""


# -- envelope ----------------------------------------------------------------

def _seal(kind: int, header: dict, *sections: bytes) -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return durable.frame(
        _PREFIX.pack(kind, len(hdr)) + hdr + b"".join(sections),
        magic=RPC_MAGIC)


def _open(data: bytes, want_kind: int) -> tuple[dict, bytes]:
    """Verify the envelope + prefix -> (header, section bytes)."""
    if not durable.is_framed(data, RPC_MAGIC):
        raise RpcWireError("not a PIOR rpc frame")
    try:
        payload = durable.unframe(data, source="rpc frame",
                                  magic=RPC_MAGIC)
    except durable.ModelIntegrityError as e:
        # one exception surface for callers: a CRC/length mismatch and a
        # layout violation get the same 400/failover treatment
        raise RpcWireError(str(e)) from e
    if len(payload) < _PREFIX.size:
        raise RpcWireError("rpc frame too short for its prefix")
    kind, hdr_len = _PREFIX.unpack_from(payload)
    if kind != want_kind:
        raise RpcWireError(
            f"rpc frame kind {kind} where {want_kind} was expected "
            "(request/response or route confusion)")
    end = _PREFIX.size + hdr_len
    if hdr_len > len(payload) - _PREFIX.size:
        raise RpcWireError("rpc frame header overruns the payload")
    try:
        header = json.loads(payload[_PREFIX.size:end].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise RpcWireError(f"malformed rpc frame header: {e}") from e
    if not isinstance(header, dict):
        raise RpcWireError("rpc frame header must be a JSON object")
    return header, payload[end:]


def _count(header: dict, key: str, limit: int = 1 << 28) -> int:
    """A non-negative element count from the header, bounded BEFORE any
    allocation so a forged count dies in microseconds (the columnar
    wire's oversized-frame lesson)."""
    try:
        n = int(header[key])
    except (KeyError, TypeError, ValueError) as e:
        raise RpcWireError(f"rpc frame header missing count {key!r}") from e
    if n < 0 or n > limit:
        raise RpcWireError(f"rpc frame count {key}={n} out of range")
    return n


def _sections(body: bytes, *specs: tuple[np.dtype, int]) -> list[np.ndarray]:
    """Pointer-cast the section bytes into the declared arrays; the body
    must be EXACTLY the declared sizes (no trailing bytes: a length
    mismatch means a drifted encoder, and silence here corrupts
    scores)."""
    out = []
    off = 0
    for dtype, n in specs:
        nbytes = dtype.itemsize * n
        if off + nbytes > len(body):
            raise RpcWireError(
                f"rpc frame truncated: section of {n} x {dtype} at "
                f"offset {off} overruns {len(body)} body bytes")
        out.append(np.frombuffer(body, dtype=dtype, count=n, offset=off))
        off += nbytes
    if off != len(body):
        raise RpcWireError(
            f"rpc frame has {len(body) - off} trailing bytes")
    return out


def _f32_bytes(arr) -> tuple[bytes, int]:
    a = np.ascontiguousarray(np.asarray(arr), dtype=_F32)
    return a.tobytes(), int(a.size)


# -- messages ----------------------------------------------------------------

def encode_topk_request(row, k: int, arm: str = "active") -> bytes:
    row_bytes, d = _f32_bytes(row)
    return _seal(_KIND_TOPK_REQ, {"k": int(k), "arm": arm, "d": d},
                 row_bytes)


def decode_topk_request(data: bytes) -> tuple[np.ndarray, int, str]:
    header, body = _open(data, _KIND_TOPK_REQ)
    d = _count(header, "d")
    (row,) = _sections(body, (_F32, d))
    arm = header.get("arm", "active")
    if not isinstance(arm, str):
        raise RpcWireError("rpc frame arm must be a string")
    return row, _count(header, "k"), arm


def encode_candidates_request(row, k: int, arm: str = "active") -> bytes:
    """Kind 6: the candidate-tier fan-out body — the query user's f32
    row + k, exactly the top-k request's shape on its own kind so a
    route/codec confusion dies at `_open` instead of serving a
    clustered answer where an exact one was promised."""
    row_bytes, d = _f32_bytes(row)
    return _seal(_KIND_CAND_REQ, {"k": int(k), "arm": arm, "d": d},
                 row_bytes)


def decode_candidates_request(data: bytes) -> tuple[np.ndarray, int, str]:
    header, body = _open(data, _KIND_CAND_REQ)
    d = _count(header, "d")
    (row,) = _sections(body, (_F32, d))
    arm = header.get("arm", "active")
    if not isinstance(arm, str):
        raise RpcWireError("rpc frame arm must be a string")
    return row, _count(header, "k"), arm


# -- batched scoring messages (continuous batching) --------------------------

_SCORING_REQ_KINDS = {"topk": _KIND_TOPK_REQ, "candidates": _KIND_CAND_REQ}


def _seal_scoring_batch(kind: int, rows, ks, arm: str) -> bytes:
    mat = np.ascontiguousarray(np.asarray(rows), dtype=_F32)
    if mat.ndim != 2:
        raise RpcWireError(
            f"batched request rows must be a 2-D matrix, got shape "
            f"{mat.shape}")
    n, d = int(mat.shape[0]), int(mat.shape[1])
    if n < 1:
        raise RpcWireError("batched request needs at least one query")
    k_list = [int(k) for k in ks]
    if len(k_list) != n or any(k < 0 for k in k_list):
        raise RpcWireError(
            f"batched request k sidecar disagrees: {len(k_list)} ks for "
            f"{n} rows")
    return _seal(kind, {"batch": n, "d": d, "ks": k_list, "arm": arm},
                 mat.tobytes())


def encode_topk_batch_request(rows, ks, arm: str = "active") -> bytes:
    """N coalesced top-k queries as ONE kind-1 frame: stacked f32 rows +
    per-query k (k varies with each query's num+blackList over-fetch, so
    it rides as a sidecar, not a scalar)."""
    return _seal_scoring_batch(_KIND_TOPK_REQ, rows, ks, arm)


def encode_candidates_batch_request(rows, ks, arm: str = "active") -> bytes:
    return _seal_scoring_batch(_KIND_CAND_REQ, rows, ks, arm)


def decode_scoring_request(data: bytes, op: str):
    """Shard-side decode for `/shard/topk` + `/shard/candidates`
    accepting BOTH layouts -> (rows (n, d), ks, arm, batched). The solo
    layout comes back as a 1-row batch so the routes handle one shape;
    `batched` tells them which response frame the client expects."""
    try:
        kind = _SCORING_REQ_KINDS[op]
    except KeyError:
        raise RpcWireError(f"no scoring request kind for op {op!r}") \
            from None
    header, body = _open(data, kind)
    arm = header.get("arm", "active")
    if not isinstance(arm, str):
        raise RpcWireError("rpc frame arm must be a string")
    d = _count(header, "d", limit=1 << 20)
    if "batch" not in header:
        k = _count(header, "k")
        (row,) = _sections(body, (_F32, d))
        return row.reshape(1, d), [k], arm, False
    n = _count(header, "batch", limit=1 << 16)
    if n < 1:
        raise RpcWireError("batched request with zero queries")
    ks = header.get("ks")
    if not isinstance(ks, list) or len(ks) != n:
        raise RpcWireError("batched request k sidecar disagrees with "
                           "batch")
    k_list = []
    for k in ks:
        try:
            ki = int(k)
        except (TypeError, ValueError) as e:
            raise RpcWireError("batched request ks must be integers") \
                from e
        if ki < 0 or ki > 1 << 28:
            raise RpcWireError(f"batched request k={ki} out of range")
        k_list.append(ki)
    if n * d > 1 << 28:
        raise RpcWireError(
            f"batched request {n} x {d} floats out of range")
    (flat,) = _sections(body, (_F32, n * d))
    return flat.reshape(n, d), k_list, arm, True


def encode_topk_batch_response(results) -> bytes:
    """N per-query (items, indices, scores) answers, request order, as
    ONE kind-2 frame: per-query counts + flattened id sidecar in the
    header, concatenated i32/f32 sections."""
    counts: list[int] = []
    all_items: list = []
    gidx_parts: list[bytes] = []
    score_parts: list[bytes] = []
    for items, indices, scores in results:
        g = np.ascontiguousarray(np.asarray(indices), dtype=_I32)
        score_bytes, n = _f32_bytes(scores)
        if len(items) != n or g.size != n:
            raise RpcWireError(
                f"batched topk response sections disagree: {len(items)} "
                f"items, {g.size} indices, {n} scores")
        counts.append(n)
        all_items.extend(items)
        gidx_parts.append(g.tobytes())
        score_parts.append(score_bytes)
    return _seal(
        _KIND_TOPK_RESP,
        {"batch": len(results), "counts": counts, "items": all_items},
        b"".join(gidx_parts), b"".join(score_parts))


def decode_topk_batch_response(data: bytes) -> list[dict]:
    """Router-side split of a batched kind-2 frame back into per-query
    dicts (each the exact shape `decode_topk_response` yields). Every
    count is bounded before any slice and the id sidecar + sections must
    sum to exactly the declared totals — a forged count dies here, never
    as a silently misattributed score."""
    header, body = _open(data, _KIND_TOPK_RESP)
    n = _count(header, "batch", limit=1 << 16)
    counts = header.get("counts")
    if not isinstance(counts, list) or len(counts) != n:
        raise RpcWireError("batched topk response counts sidecar "
                           "disagrees with batch")
    total = 0
    c_list = []
    for c in counts:
        try:
            ci = int(c)
        except (TypeError, ValueError) as e:
            raise RpcWireError("batched topk response counts must be "
                               "integers") from e
        if ci < 0 or ci > 1 << 28:
            raise RpcWireError(
                f"batched topk response count {ci} out of range")
        total += ci
        c_list.append(ci)
    if total > 1 << 28:
        raise RpcWireError(
            f"batched topk response total count {total} out of range")
    items = header.get("items")
    if not isinstance(items, list) or len(items) != total:
        raise RpcWireError("batched topk response id sidecar disagrees "
                           "with counts")
    gidx, scores = _sections(body, (_I32, total), (_F32, total))
    out = []
    off = 0
    for ci in c_list:
        out.append({"items": items[off:off + ci],
                    "indices": gidx[off:off + ci],
                    "scores": scores[off:off + ci]})
        off += ci
    return out


def encode_topk_response(items: list, indices, scores) -> bytes:
    gidx = np.ascontiguousarray(np.asarray(indices), dtype=_I32)
    score_bytes, n = _f32_bytes(scores)
    if len(items) != n or gidx.size != n:
        raise RpcWireError(
            f"topk response sections disagree: {len(items)} items, "
            f"{gidx.size} indices, {n} scores")
    return _seal(_KIND_TOPK_RESP, {"n": n, "items": items},
                 gidx.tobytes(), score_bytes)


def decode_topk_response(data: bytes) -> dict:
    header, body = _open(data, _KIND_TOPK_RESP)
    n = _count(header, "n")
    items = header.get("items")
    if not isinstance(items, list) or len(items) != n:
        raise RpcWireError("topk response id sidecar disagrees with n")
    gidx, scores = _sections(body, (_I32, n), (_F32, n))
    return {"items": items, "indices": gidx, "scores": scores}


def encode_user_row_response(row) -> bytes:
    if row is None:
        return _seal(_KIND_USER_ROW_RESP, {"found": False, "d": 0})
    row_bytes, d = _f32_bytes(row)
    return _seal(_KIND_USER_ROW_RESP, {"found": True, "d": d}, row_bytes)


def decode_user_row_response(data: bytes) -> dict:
    header, body = _open(data, _KIND_USER_ROW_RESP)
    if not header.get("found"):
        _sections(body)     # nothing may trail a not-found response
        return {"found": False}
    d = _count(header, "d")
    (row,) = _sections(body, (_F32, d))
    return {"found": True, "row": row}


def encode_item_rows_response(ids: list, rows) -> bytes:
    mat = np.ascontiguousarray(np.asarray(rows), dtype=_F32)
    if mat.size == 0:
        mat = mat.reshape(0, 0)
    if mat.ndim != 2 or mat.shape[0] != len(ids):
        raise RpcWireError(
            f"item_rows response: {len(ids)} ids but row matrix shape "
            f"{mat.shape}")
    return _seal(
        _KIND_ITEM_ROWS_RESP,
        {"n": len(ids), "k": int(mat.shape[1]), "ids": ids},
        mat.tobytes())


def decode_item_rows_response(data: bytes) -> dict:
    header, body = _open(data, _KIND_ITEM_ROWS_RESP)
    n = _count(header, "n")
    k = _count(header, "k")
    ids = header.get("ids")
    if not isinstance(ids, list) or len(ids) != n:
        raise RpcWireError("item_rows response id sidecar disagrees "
                           "with n")
    (flat,) = _sections(body, (_F32, n * k))
    rows = flat.reshape(n, k) if n else flat.reshape(0, k or 0)
    return {"rows": {ids[i]: rows[i] for i in range(n)}}


def encode_partition_slice(sl) -> bytes:
    """A plan.PartitionSlice as one reshard transfer frame. A slice
    carrying a quantized sidecar (``item_qrows``/``item_qscales`` set
    by the source shard's extract) appends the quantized sections and
    names the encoding in the header; sidecar-less slices stay
    byte-identical to the pre-retrieval wire."""
    user_bytes, nu_k = _f32_bytes(sl.user_rows)
    item_bytes, ni_k = _f32_bytes(sl.item_rows)
    gidx = np.ascontiguousarray(np.asarray(sl.item_gidx), dtype=_I32)
    nu, ni, k = len(sl.user_ids), len(sl.item_ids), int(sl.k)
    if nu_k != nu * k or ni_k != ni * k or gidx.size != ni:
        raise RpcWireError(
            f"partition slice sections disagree: {nu} users x {k} but "
            f"{nu_k} user floats; {ni} items but {ni_k} item floats, "
            f"{gidx.size} indices")
    header = {"p": int(sl.partition), "iid": sl.instance_id, "nu": nu,
              "ni": ni, "k": k, "userIds": list(sl.user_ids),
              "itemIds": list(sl.item_ids)}
    sections = [user_bytes, gidx.tobytes(), item_bytes]
    qdtype = getattr(sl, "qdtype", None)
    if qdtype is not None:
        if qdtype not in _QDTYPES:
            raise RpcWireError(
                f"partition slice qdtype {qdtype!r} not one of "
                f"{sorted(_QDTYPES)}")
        qrows = np.ascontiguousarray(sl.item_qrows,
                                     dtype=_QDTYPES[qdtype])
        qscales = np.ascontiguousarray(sl.item_qscales, dtype=_F32)
        if qrows.shape != (ni, k) or qscales.shape != (ni,):
            raise RpcWireError(
                f"partition slice quantized sections disagree: "
                f"{qrows.shape} rows / {qscales.shape} scales for "
                f"{ni} items x {k}")
        header["qdtype"] = qdtype
        sections += [qrows.tobytes(), qscales.tobytes()]
    return _seal(_KIND_RESHARD_PART, header, *sections)


def decode_partition_slice(data: bytes):
    """Verify + rebuild the PartitionSlice from a kind-5 frame. The
    destination shard stages exactly what this returns; a truncated or
    bit-rotted transfer dies here as RpcWireError (400 -> retry)."""
    from pio_tpu_torch.serving_fleet.plan import PartitionSlice

    header, body = _open(data, _KIND_RESHARD_PART)
    nu = _count(header, "nu")
    ni = _count(header, "ni")
    k = _count(header, "k", limit=1 << 16)
    user_ids = header.get("userIds")
    item_ids = header.get("itemIds")
    if not isinstance(user_ids, list) or len(user_ids) != nu:
        raise RpcWireError("reshard frame user id sidecar disagrees "
                           "with nu")
    if not isinstance(item_ids, list) or len(item_ids) != ni:
        raise RpcWireError("reshard frame item id sidecar disagrees "
                           "with ni")
    iid = header.get("iid")
    if not isinstance(iid, str) or not iid:
        raise RpcWireError("reshard frame missing instance id")
    qdtype = header.get("qdtype")
    qrows = qscales = None
    if qdtype is None:
        user_flat, gidx, item_flat = _sections(
            body, (_F32, nu * k), (_I32, ni), (_F32, ni * k))
    else:
        if qdtype not in _QDTYPES:
            raise RpcWireError(
                f"reshard frame qdtype {qdtype!r} not one of "
                f"{sorted(_QDTYPES)}")
        user_flat, gidx, item_flat, qflat, qscales = _sections(
            body, (_F32, nu * k), (_I32, ni), (_F32, ni * k),
            (_QDTYPES[qdtype], ni * k), (_F32, ni))
        qrows = (qflat.reshape(ni, k) if ni
                 else qflat.reshape(0, k))
    return PartitionSlice(
        partition=_count(header, "p", limit=1 << 16),
        instance_id=iid,
        k=k,
        user_ids=[str(u) for u in user_ids],
        user_rows=user_flat.reshape(nu, k) if nu else
        user_flat.reshape(0, k),
        item_ids=[str(i) for i in item_ids],
        item_gidx=np.asarray(gidx, dtype=_I32),
        item_rows=item_flat.reshape(ni, k) if ni else
        item_flat.reshape(0, k),
        qdtype=qdtype,
        item_qrows=qrows,
        item_qscales=None if qscales is None else np.asarray(
            qscales, dtype=_F32),
    )


_RESPONSE_DECODERS = {
    "topk": decode_topk_response,
    "user_row": decode_user_row_response,
    "item_rows": decode_item_rows_response,
    # the candidate tier answers on the top-k response frame (exact
    # re-ranked f32 scores), so the router merge is shared verbatim
    "candidates": decode_topk_response,
}


def decode_response(op: str, data: bytes) -> dict:
    """Router-side dispatch: one negotiated response frame -> the same
    dict shape the JSON wire yields for `op` (arrays where JSON had
    number lists — exact f32 values either way)."""
    try:
        decoder = _RESPONSE_DECODERS[op]
    except KeyError:
        raise RpcWireError(f"no binary decoder for rpc op {op!r}") from None
    return decoder(data)
