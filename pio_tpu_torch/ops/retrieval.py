"""Two-stage retrieval: quantized candidate generation + exact re-rank.

Counterpart of ``pio_tpu.ops.retrieval``. The host half (the
``RetrievalParams`` block, the quantized-table codec, the seeded k-means
and the ``RetrievalIndex`` sidecar) is the same numpy code, so tables,
frames and cluster assignments are byte-identical to the reference's.
The device half holds the padded scan layout as torch tensors and runs
the two tiers:

  tier 1 (candidates): score the k-means centroids, expand the top
      ``nprobe`` clusters and scan their rows in the quantized dtype —
      ``ops/kernels/quantized_scan`` (the hand-written CUDA kernel for
      ``impl="pallas"``, its plain torch version for ``impl="xla"``);
  tier 2 (re-rank): re-score the surviving ``rerank_k`` rows with the
      exact f32 einsum, as the reference does outside any kernel.

``impl`` keeps its engine.json values: ``"auto"`` resolves to ``"xla"``
(the einsum scan), and ``"pallas"`` names the CUDA kernel in this port.
"""

from __future__ import annotations

import json
import math
import struct
from dataclasses import dataclass

import numpy as np
import torch

from pio_tpu_torch.ops import topk
from pio_tpu_torch.ops.bucketing import (
    dispatch_rows,
    padded_rows,
    pow2_bucket,
)
from pio_tpu_torch.ops.kernels.quantized_scan import (
    quantized_scan,
    quantized_scan_reference,
)
from pio_tpu_torch.utils import durable

RETRIEVAL_MAGIC = b"PIOQ\x01"

_KIND_QTABLE = 1
_PREFIX = struct.Struct(">BI")    # kind, header length (rpcwire layout)
_F32 = np.dtype("<f4")
_I8 = np.dtype("<i1")
_U16 = np.dtype("<u2")

_MODES = ("exact", "clustered")
_DTYPES = ("bf16", "int8")
_IMPLS = ("auto", "xla", "pallas")


class RetrievalCodecError(ValueError):
    """A quantized-table blob that fails the frame CRC, promises counts
    its sections cannot hold, or carries trailing bytes. Permanent for
    that blob — callers rebuild the table from the f32 rows (which are
    the source of truth) instead of retrying."""


@dataclass(frozen=True)
class RetrievalParams:
    """The engine.json ``retrieval`` block (docs/serving.md "Two-stage
    retrieval"). ``mode: "exact"`` is the default and keeps every
    serving path on today's oracle einsum untouched."""

    mode: str = "exact"
    dtype: str = "int8"    # candidate-tier scan dtype
    # clusters expanded per query. The default is sized against the
    # auto cluster count at CI-gate scale (recall@10 >= 0.95 on seeded
    # ALS factors at nprobe 32 of C=64 — near-isotropic small-rank
    # factors need ~half the clusters; structured real catalogs reach
    # the same recall at far smaller fractions, see docs/serving.md
    # tuning runbook): raise nprobe for recall, lower it for speed.
    nprobe: int = 32
    rerank_k: int = 1024   # survivors re-scored by the exact oracle
    n_clusters: int = 0    # 0 = auto: pow2 near sqrt(n_items)
    seed: int = 0          # k-means init seed (determinism contract)
    kmeans_iters: int = 8
    impl: str = "auto"     # candidate-scan kernel: auto|xla|pallas

    def __post_init__(self):
        # validate here, not at scan time: a typo'd mode would otherwise
        # silently serve exact (never entering the clustered branch)
        if self.mode not in _MODES:
            raise ValueError(
                f"retrieval.mode={self.mode!r}; expected one of {_MODES}")
        if self.dtype not in _DTYPES:
            raise ValueError(
                f"retrieval.dtype={self.dtype!r}; expected one of {_DTYPES}")
        if self.impl not in _IMPLS:
            raise ValueError(
                f"retrieval.impl={self.impl!r}; expected one of {_IMPLS}")
        if self.nprobe < 1:
            raise ValueError(f"retrieval.nprobe={self.nprobe} must be >= 1")
        if self.rerank_k < 1:
            raise ValueError(
                f"retrieval.rerank_k={self.rerank_k} must be >= 1")
        if self.n_clusters < 0:
            raise ValueError(
                f"retrieval.n_clusters={self.n_clusters} must be >= 0")
        if self.kmeans_iters < 1:
            raise ValueError(
                f"retrieval.kmeans_iters={self.kmeans_iters} must be >= 1")

    @classmethod
    def from_config(cls, d: "dict | None") -> "RetrievalParams":
        """Parse the engine.json block with the same unknown-key
        rejection discipline as controller params_from_dict — a typo'd
        knob must fail deploy, not silently serve defaults."""
        if d is None:
            return cls()
        if not isinstance(d, dict):
            raise ValueError(
                f"retrieval config must be an object, got {type(d).__name__}")
        allowed = {f for f in cls.__dataclass_fields__}
        unknown = sorted(set(d) - allowed)
        if unknown:
            raise ValueError(
                f"unknown retrieval config key(s) {unknown}; "
                f"allowed: {sorted(allowed)}")
        return cls(**d)

    def resolved_n_clusters(self, n_items: int) -> int:
        """The cluster count that actually runs: the explicit knob, or
        the auto rule (pow2 nearest sqrt(n) — the classic IVF balance
        point: centroid scan cost C and per-cluster scan cost n/C meet
        at sqrt(n)); always <= n_items, pow2 where possible so the
        compiled scan program is shared across same-bucket catalogs."""
        n = max(1, int(n_items))
        want = self.n_clusters if self.n_clusters > 0 else max(
            1, int(math.sqrt(n)))
        return min(pow2_bucket(want), n)

    def is_exhaustive(self, n_items: int) -> bool:
        """True when the clustered scan would expand EVERY cluster —
        callers must then take the oracle path (bit-parity falls out of
        running the identical computation, not of this module matching
        it ULP-for-ULP)."""
        return self.nprobe >= self.resolved_n_clusters(n_items)


# ---------------------------------------------------------------------------
# quantized item-factor tables (the one encode/decode)
# ---------------------------------------------------------------------------

@dataclass
class QuantizedTable:
    """Quantized item rows in ORIGINAL item order. ``data`` is
    (n,k) uint16 bf16 bit patterns or (n,k) int8; ``scales`` is the
    (n,) f32 per-row dequantization scale (all-ones for bf16, kept
    explicit so both dtypes share one scan expression)."""

    dtype: str
    data: np.ndarray
    scales: np.ndarray

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    def nbytes(self) -> int:
        return int(self.data.nbytes + self.scales.nbytes)

    def decode(self) -> np.ndarray:
        """f32 rows as the scan sees them (the dequantized view the
        drift bound is stated against)."""
        if self.dtype == "bf16":
            return (self.data.astype(np.uint32) << 16).view(np.float32)
        return self.data.astype(np.float32) * self.scales[:, None]


def encode_rows(rows, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """Quantize f32 rows -> (data, scales). A PURE function of the row
    bytes: the fold-in re-encode and the reshard carry/rebuild paths
    both rely on re-encoding being reproducible anywhere."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if rows.ndim != 2:
        raise ValueError(f"encode_rows expects (n, k), got {rows.shape}")
    n = rows.shape[0]
    if dtype == "bf16":
        u = rows.view(np.uint32)
        # round-to-nearest-even to the high 16 bits (matches the
        # hardware f32->bf16 cast, so a device-side re-encode agrees)
        bias = np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))
        data = ((u + bias) >> 16).astype(np.uint16)
        return data, np.ones(n, np.float32)
    if dtype == "int8":
        amax = np.max(np.abs(rows), axis=1) if rows.size else np.zeros(n)
        scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(rows / scales[:, None]), -127, 127)
        return q.astype(np.int8), scales
    raise ValueError(f"unknown quantization dtype {dtype!r}")


def quantize_table(rows, dtype: str) -> QuantizedTable:
    data, scales = encode_rows(rows, dtype)
    return QuantizedTable(dtype=dtype, data=data, scales=scales)


# -- the one codec (CRC32C-framed like the wire codecs) ----------------------

def table_to_bytes(table: QuantizedTable) -> bytes:
    """One ``PIOQ`` frame: durable envelope | u8 kind | u32 header_len |
    header json | data bytes | scales bytes."""
    data = np.ascontiguousarray(
        table.data, dtype=_U16 if table.dtype == "bf16" else _I8)
    scales = np.ascontiguousarray(table.scales, dtype=_F32)
    n, k = (data.shape if data.ndim == 2 else (0, 0))
    if scales.shape != (n,):
        raise RetrievalCodecError(
            f"quantized table sections disagree: {n} rows but "
            f"{scales.shape} scales")
    header = json.dumps(
        {"dtype": table.dtype, "n": int(n), "k": int(k)},
        separators=(",", ":")).encode()
    payload = (_PREFIX.pack(_KIND_QTABLE, len(header)) + header
               + data.tobytes() + scales.tobytes())
    return durable.frame(payload, magic=RETRIEVAL_MAGIC)


def table_from_bytes(blob: bytes) -> QuantizedTable:
    """Verify + decode a ``table_to_bytes`` frame. Truncation at ANY
    byte and bit-flips anywhere die here (frame CRC, then exact section
    lengths) as RetrievalCodecError; counts are bounded BEFORE any
    allocation (the columnar wire's oversized-frame lesson)."""
    if not durable.is_framed(blob, RETRIEVAL_MAGIC):
        raise RetrievalCodecError("not a PIOQ quantized-table frame")
    try:
        payload = durable.unframe(blob, source="quantized table",
                                  magic=RETRIEVAL_MAGIC)
    except durable.ModelIntegrityError as e:
        raise RetrievalCodecError(str(e)) from e
    if len(payload) < _PREFIX.size:
        raise RetrievalCodecError("quantized-table frame too short for "
                                  "its prefix")
    kind, hdr_len = _PREFIX.unpack_from(payload)
    if kind != _KIND_QTABLE:
        raise RetrievalCodecError(
            f"quantized-table frame kind {kind} where {_KIND_QTABLE} "
            "was expected")
    if hdr_len > len(payload) - _PREFIX.size:
        raise RetrievalCodecError(
            "quantized-table frame header overruns the payload")
    end = _PREFIX.size + hdr_len
    try:
        header = json.loads(payload[_PREFIX.size:end].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise RetrievalCodecError(
            f"malformed quantized-table header: {e}") from e
    if not isinstance(header, dict):
        raise RetrievalCodecError(
            "quantized-table header must be a JSON object")
    dtype = header.get("dtype")
    if dtype not in _DTYPES:
        raise RetrievalCodecError(
            f"quantized-table dtype {dtype!r} not one of {_DTYPES}")
    try:
        n = int(header["n"])
        k = int(header["k"])
    except (KeyError, TypeError, ValueError) as e:
        raise RetrievalCodecError(
            "quantized-table header missing n/k counts") from e
    if not (0 <= n <= 1 << 28) or not (0 <= k <= 1 << 16):
        raise RetrievalCodecError(
            f"quantized-table counts out of range: n={n} k={k}")
    body = payload[end:]
    elem = _U16 if dtype == "bf16" else _I8
    data_bytes = elem.itemsize * n * k
    scale_bytes = _F32.itemsize * n
    if len(body) != data_bytes + scale_bytes:
        raise RetrievalCodecError(
            f"quantized-table sections truncated or trailing: "
            f"{len(body)} body bytes where {data_bytes + scale_bytes} "
            "were declared")
    data = np.frombuffer(body, dtype=elem, count=n * k).reshape(n, k)
    scales = np.frombuffer(body, dtype=_F32, count=n, offset=data_bytes)
    return QuantizedTable(dtype=dtype, data=data.copy(),
                          scales=scales.copy())


# ---------------------------------------------------------------------------
# deterministic seeded k-means (the clustering beside the f32 partition)
# ---------------------------------------------------------------------------

def kmeans_cluster(rows, n_clusters: int, seed: int = 0,
                   iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """-> (assign (n,) int32, centroids (C,k) f32). Plain Lloyd's with a
    seeded distinct-row init, all numpy: rebuilding the clustering from
    the same f32 rows yields the same assignment everywhere the reshard
    or fold-in paths might rebuild it. Empty clusters keep their
    previous centroid (deterministic; they simply attract nothing)."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    n, k = rows.shape
    c = max(1, min(int(n_clusters), n))
    rng = np.random.RandomState(seed)
    cent = rows[rng.choice(n, size=c, replace=False)].astype(np.float32)
    assign = np.zeros(n, np.int32)
    row_sq = np.einsum("nk,nk->n", rows, rows)
    for _ in range(max(1, iters)):
        # squared distance via the matmul identity; row term constant in
        # the argmin but kept for a well-scaled comparison
        d = (row_sq[:, None] - 2.0 * (rows @ cent.T)
             + np.einsum("ck,ck->c", cent, cent)[None, :])
        assign = np.argmin(d, axis=1).astype(np.int32)
        for ci in range(c):
            members = rows[assign == ci]
            if len(members):
                cent[ci] = members.mean(axis=0)
    return assign, cent


# ---------------------------------------------------------------------------
# the retrieval index (host truth + device layout)
# ---------------------------------------------------------------------------

@dataclass
class RetrievalIndex:
    """Host-side sidecar beside a shard's/model's f32 item rows: the
    quantized table and the clustering, both in ORIGINAL item order.
    This is what fold-in updates in place (re-encode row, reassign
    cluster against the frozen centroids) and what the budget
    accounting charges; the padded device layout derives from it."""

    params: RetrievalParams
    table: QuantizedTable
    centroids: np.ndarray    # (C, k) f32
    assign: np.ndarray       # (n,) int32 cluster per item

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    def nbytes(self) -> int:
        return int(self.table.nbytes() + self.centroids.nbytes
                   + self.assign.nbytes)

    def updated(self, positions, new_rows) -> "RetrievalIndex":
        """Copy-on-write fold-in update: re-encode the given rows and
        reassign their clusters against the FROZEN centroids (the
        retrain/repartition path rebuilds the clustering wholesale; a
        fold-in must not move every other item's cluster). Returns a
        new index; the old one keeps serving until the atomic swap."""
        positions = np.asarray(positions, np.int64)
        new_rows = np.ascontiguousarray(new_rows, np.float32)
        data, scales = encode_rows(new_rows, self.params.dtype)
        tb = QuantizedTable(self.params.dtype, self.table.data.copy(),
                            self.table.scales.copy())
        tb.data[positions] = data
        tb.scales[positions] = scales
        assign = self.assign.copy()
        d = (-2.0 * (new_rows @ self.centroids.T)
             + np.einsum("ck,ck->c", self.centroids,
                         self.centroids)[None, :])
        assign[positions] = np.argmin(d, axis=1).astype(np.int32)
        return RetrievalIndex(self.params, tb, self.centroids, assign)


def build_index(item_factors, params: RetrievalParams) -> RetrievalIndex:
    """Quantized table + clustering from the f32 item rows — the whole
    sidecar is a deterministic function of (rows, params), so any
    holder of the f32 partition can rebuild an identical index."""
    rows = np.ascontiguousarray(np.asarray(item_factors), np.float32)
    c = params.resolved_n_clusters(rows.shape[0])
    assign, cent = kmeans_cluster(rows, c, seed=params.seed,
                                  iters=params.kmeans_iters)
    return RetrievalIndex(params, quantize_table(rows, params.dtype),
                          cent, assign)


def sidecar_nbytes_estimate(n_items: int, k: int,
                            params: RetrievalParams) -> int:
    """Upper-bound estimate of a clustered retrieval sidecar's bytes
    BEFORE building it — what the shard memory-budget check charges in
    addition to the f32 partition (the budget must reject a load that
    would only blow up after the expensive k-means). Counts the host
    table + clustering plus the padded (C, Lmax) device layout at a 2x
    padding allowance (the device layout pads clusters to a shared
    pow2 width; a pathologically imbalanced clustering can exceed the
    allowance, which is why the shard re-checks the REALIZED bytes
    after the build, before any swap)."""
    if params.mode != "clustered" or n_items <= 0:
        return 0
    isize = 2 if params.dtype == "bf16" else 1
    c = params.resolved_n_clusters(n_items)
    host = n_items * k * isize + n_items * 8 + c * k * 4
    device = 2 * n_items * (k * isize + 4 + 4)   # table + scales + gidx
    return int(host + device + c * k * 4)


@dataclass
class DeviceRetrievalIndex:
    """The on-device scan layout: clusters padded to a shared pow2
    width Lmax. ``gidx`` carries -1 in pad slots; pad scores are masked
    to -inf before any top-k, so padding can never surface as a
    candidate. A bf16 table is a ``torch.bfloat16`` view of the uint16
    bits the codec stores."""

    params: RetrievalParams
    n_items: int
    centroids: torch.Tensor  # (C, k) f32
    table: torch.Tensor      # (C, Lmax, k) int8 | bfloat16
    scales: torch.Tensor     # (C, Lmax) f32
    gidx: torch.Tensor       # (C, Lmax) int32, -1 = pad

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def pad_width(self) -> int:
        return int(self.table.shape[1])

    @property
    def device(self) -> torch.device:
        return self.table.device

    def nbytes(self) -> int:
        return int(sum(a.element_size() * a.numel()
                       for a in (self.centroids, self.table,
                                 self.scales, self.gidx)))


def build_device_index(index: RetrievalIndex,
                       device: "str | torch.device") -> DeviceRetrievalIndex:
    """Pad each cluster to the pow2-bucketed max cluster size and move
    the scan arrays to ``device`` (the reference's layout, element for
    element)."""
    n, k = index.table.shape
    c = index.n_clusters
    counts = np.bincount(index.assign, minlength=c)
    lmax = pow2_bucket(int(counts.max()) if n else 1)
    order = np.argsort(index.assign, kind="stable")
    np_dtype = np.uint16 if index.params.dtype == "bf16" else np.int8
    table = np.zeros((c, lmax, k), np_dtype)
    scales = np.zeros((c, lmax), np.float32)
    gidx = np.full((c, lmax), -1, np.int32)
    starts = np.zeros(c + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    for ci in range(c):
        rows = order[starts[ci]:starts[ci + 1]]
        table[ci, :len(rows)] = index.table.data[rows]
        scales[ci, :len(rows)] = index.table.scales[rows]
        gidx[ci, :len(rows)] = rows
    if index.params.dtype == "bf16":
        # same bits, reinterpreted (torch has no uint16 view on every
        # build, so go through int16)
        table_t = torch.from_numpy(table.view(np.int16)).view(torch.bfloat16)
    else:
        table_t = torch.from_numpy(table)
    return DeviceRetrievalIndex(
        params=index.params, n_items=n,
        centroids=torch.from_numpy(index.centroids.copy()).to(device),
        table=table_t.to(device),
        scales=torch.from_numpy(scales).to(device),
        gidx=torch.from_numpy(gidx).to(device),
    )


def resolved_impl(impl: str) -> str:
    """"auto" stays on the einsum scan ("xla"), as in the reference."""
    return "xla" if impl == "auto" else impl


def _clustered_topk(u, b: int, centroids, table, scales, gidx, item_factors,
                    nprobe: int, rerank: int, k: int, impl: str):
    """One two-stage query batch. u (n,k_f) f32 on the index's device, the
    first ``b`` rows live and the rest zero: the library products (the
    centroid scores, the re-rank, and the scan's plain version) run at the
    n rows of the dispatch shape, so a live row's scores carry the same
    bits whatever the batch (``ops.bucketing.DISPATCH_ROWS``). The scan
    kernel scores each (row, probe) in a block of its own, so it scans the
    ``b`` live rows alone, as do the rankings. Returns (scores (b,k) f32,
    gidx (b,k) int64) with -inf/-1 where fewer than k real candidates
    survived. Tier-2 scores come from the exact einsum over the f32 rows —
    the quantized tier only chooses candidates."""
    n = u.shape[0]
    lmax = table.shape[1]
    cs = torch.einsum("bk,ck->bc", u, centroids)[:b]
    _, top_c = topk.topk_lowest_index(cs, nprobe)          # (b, nprobe)
    top_c = top_c.to(torch.int32)
    if impl == "pallas":
        qs = quantized_scan(table, scales, gidx, top_c, u[:b])
    else:
        qs = quantized_scan_reference(table, scales, gidx,
                                      padded_rows(top_c, n), u)[:b]
    flat_g = gidx[top_c].reshape(b, nprobe * lmax)         # qs: (b, P*Lmax)
    _, cpos = topk.topk_lowest_index(qs, rerank)           # (b, rerank)
    cand_g = torch.gather(flat_g, 1, cpos).to(torch.int64)
    rows = padded_rows(item_factors[cand_g.clamp(min=0)], n)  # (n, rerank, kf)
    exact = torch.einsum("brk,bk->br", rows, u)[:b]
    exact = torch.where(cand_g >= 0, exact,
                        torch.full_like(exact, -math.inf))
    scores, pos = topk.topk_lowest_index(exact, k)
    out_g = torch.gather(cand_g, 1, pos)
    return scores, torch.where(torch.isfinite(scores), out_g,
                               torch.full_like(out_g, -1))


def candidate_topk(didx: DeviceRetrievalIndex, item_factors, user_rows,
                   k: int):
    """Two-stage top-k for a batch of user rows against the clustered
    index, with the reference's pow2 bucketing of k and the rerank width
    (trimmed on the host) and the batch padded to its dispatch rows.
    ``item_factors`` is the model's f32 (n_items, k) tensor on the index's
    device, the re-rank source. Returns numpy (scores, gidx); callers drop
    entries with gidx -1.

    Exhaustive scans (nprobe >= n_clusters) must not reach this
    function: callers branch to the exact path first."""
    u = torch.as_tensor(user_rows, dtype=torch.float32, device=didx.device)
    if u.ndim == 1:
        u = u[None, :]
    b = u.shape[0]
    n_scan = didx.n_clusters * didx.pad_width
    nprobe = min(didx.params.nprobe, didx.n_clusters)
    k = max(1, min(int(k), didx.n_items))
    k_bucket = pow2_bucket(k, cap=didx.n_items)
    rerank = pow2_bucket(
        max(didx.params.rerank_k, k_bucket),
        cap=min(nprobe * didx.pad_width, n_scan))
    k_bucket = min(k_bucket, rerank)
    scores, gidx = _clustered_topk(
        padded_rows(u, dispatch_rows(b)).contiguous(), b, didx.centroids,
        didx.table, didx.scales, didx.gidx, item_factors, nprobe=nprobe,
        rerank=rerank, k=k_bucket, impl=resolved_impl(didx.params.impl))
    return (scores[:, :k].cpu().numpy(), gidx[:, :k].cpu().numpy())


def recall_at_k(got_gidx, oracle_gidx) -> float:
    """Fraction of the oracle's top-k the candidate tier recovered
    (order-insensitive: tier 2 re-scores exactly, so membership is what
    tier 1 owes)."""
    got = np.asarray(got_gidx)
    want = np.asarray(oracle_gidx)
    if want.ndim == 1:
        got, want = got[None, :], want[None, :]
    hits = sum(len(set(g.tolist()) & set(w.tolist()))
               for g, w in zip(got, want))
    return hits / max(1, want.size)
