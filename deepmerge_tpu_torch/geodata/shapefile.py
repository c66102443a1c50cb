"""Pure-Python ESRI Shapefile reader/writer (.shp/.shx/.dbf).

The reference consumes vectors exclusively through OGR's shapefile driver
(``MyUtils1.py:309-317``): point layers with ``inner``/``object`` scale
fields, polygon layers with designed-feature attributes and a ``PointID``
mapping, and ``lines.shp`` RAG layers whose ``LEFT_FID``/``RIGHT_FID`` pairs
it reads and whose ``simi`` real field it writes back
(``ExtractFeatures.py:182-186,217-219``). GDAL is not available in this
image, so this module implements the subset of the format the pipeline
needs, natively in Python:

  * shapes: Point(1), PolyLine(3), Polygon(5) — read and write
  * attributes: dBase III (C character, N/F numeric, L logical) — read,
    write, add-field + value write-back (full .dbf rewrite, as adding a
    field changes the record layout)
"""

from __future__ import annotations

import datetime as _dt
import os
import struct
from dataclasses import dataclass, field

import numpy as np

SHP_POINT = 1
SHP_POLYLINE = 3
SHP_POLYGON = 5

_SHAPE_NAMES = {SHP_POINT: "point", SHP_POLYLINE: "polyline", SHP_POLYGON: "polygon"}

# Z (…Z, +10) and M (…M, +20) variants: the XY payload sits at the same
# offsets as the 2-D layout (z/m blocks are appended AFTER it, ESRI
# shapefile spec ch. 2), so reads normalize them to the base type — OGR
# does the same transparently, and GDAL-produced layers are often Z-typed.
_ZM_TO_BASE = {11: 1, 21: 1, 13: 3, 23: 3, 15: 5, 25: 5}


def _parse_guard(fn):
    """Normalize parse-time failures on untrusted bytes to ``ValueError``.

    A torn or corrupt file (a scene mid-copy is the realistic arrival in
    watch serving — ``infer/driver.process_folder``) must fail with a
    CLEAN, path-attributed ``ValueError`` — never a raw ``struct.error``,
    ``IndexError`` from a short slice, numpy buffer ``TypeError``, or a
    decode error. ``OSError`` (missing file) and ``NotImplementedError``
    (unsupported-format guards) pass through unchanged. Applied to every
    reader whose first argument is the file path.
    """
    import functools

    @functools.wraps(fn)
    def wrapped(path, *args, **kwargs):
        try:
            return fn(path, *args, **kwargs)
        except (OSError, NotImplementedError):
            raise
        except ValueError as e:
            if str(path) in str(e):
                raise  # already a clean path-attributed parse error
            raise ValueError(
                f"{path}: truncated or corrupt shapefile data ({e})"
            ) from e
        except (struct.error, IndexError, TypeError, KeyError,
                UnicodeDecodeError, OverflowError, MemoryError) as e:
            raise ValueError(
                f"{path}: truncated or corrupt shapefile data "
                f"({type(e).__name__}: {e})"
            ) from e

    return wrapped


@dataclass
class DbfField:
    name: str
    type: str         # 'C', 'N', 'F', 'L'
    length: int
    decimals: int = 0


@dataclass
class Shape:
    shape_type: int
    points: np.ndarray                  # (N, 2) float64 (x, y)
    parts: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    # original record content bytes (set by the reader): preserved verbatim
    # on save so read-modify-write cycles (write_simi's add-a-field rewrite)
    # never strip Z/M geometry the 2-D normalization above can't represent
    raw: bytes | None = None

    @property
    def x(self) -> float:
        return float(self.points[0, 0])

    @property
    def y(self) -> float:
        return float(self.points[0, 1])


class ShapefileTable:
    """A shapefile layer: shapes + attribute records, round-trippable."""

    def __init__(
        self,
        shape_type: int,
        shapes: list[Shape],
        fields: list[DbfField],
        records: list[dict],
        raw_shape_type: int | None = None,
        header_ranges: tuple[float, ...] | None = None,
    ):
        self.shape_type = shape_type
        self.shapes = shapes
        self.fields = fields
        self._records = records
        # column-major attribute storage (set by read()): get_field serves
        # straight from a column; the dict-of-rows view materializes
        # lazily on first .records access (mutators, save()) — building
        # 24k × 20-key dicts was the single largest ingest cost on the
        # serving walk's 1-core host (BENCH.md round 5)
        self._cols: "dict[str, list] | None" = None
        # file-level type incl. the Z/M variant + the header's 8 bbox/range
        # doubles, kept so a read-modify-write of ATTRIBUTES preserves the
        # layer type and z/m ranges byte-identically
        self.raw_shape_type = raw_shape_type or shape_type
        self.header_ranges = header_ranges
        # pre-filter dBase deletion flags (set by read(); None = no record
        # was flagged). Lets geometry read separately (read_point_coords)
        # re-align with the filtered attribute records.
        self.deleted_mask: "np.ndarray | None" = None

    def __len__(self) -> int:
        # attribute-only reads (with_geometry=False) leave shapes empty;
        # the record count is the table length either way
        if self.shapes:
            return len(self.shapes)
        if self._cols is not None and self._records is None:
            return len(next(iter(self._cols.values()), []))
        return len(self.records)

    @property
    def records(self) -> list[dict]:
        """Row-major view; materialized from columns on first access and
        authoritative from then on (mutators edit it in place)."""
        if self._records is None:
            names = [f.name for f in self.fields]
            cols = [self._cols[n] for n in names]
            self._records = [dict(zip(names, row)) for row in zip(*cols)] \
                if names else []
            self._cols = None
        return self._records

    @records.setter
    def records(self, value: list[dict]) -> None:
        self._records = value
        self._cols = None

    def get_field(self, name: str) -> list:
        if self._cols is not None and self._records is None:
            if name not in self._cols:
                raise KeyError(name)
            return list(self._cols[name])
        return [r[name] for r in self.records]

    def field_names(self) -> list[str]:
        return [f.name for f in self.fields]

    def add_field(self, f: DbfField, default=None) -> None:
        """OGR CreateField equivalent (``ExtractFeatures.py:184-186``)."""
        if f.name in self.field_names():
            return
        recs = self.records  # materialize BEFORE the field list grows
        self.fields.append(f)
        fill = default
        if fill is None:
            fill = "" if f.type == "C" else (False if f.type == "L" else 0)
        for r in recs:
            r[f.name] = fill

    def set_field(self, index: int, name: str, value) -> None:
        self.records[index][name] = value

    # -- IO -------------------------------------------------------------

    @staticmethod
    def read(path: str, with_geometry: bool = True) -> "ShapefileTable":
        """Read a .shp/.dbf pair.

        ``with_geometry=False`` parses only the .shp HEADER (type + ranges)
        and the .dbf attribute table — ``shapes`` is left empty. Use for
        attribute-only consumers (the ingest path reads polygon features /
        ``PointID`` and line ``LEFT_FID``/``RIGHT_FID`` without ever
        touching their vertices — parsing 64k geometry records was ~40% of
        ``load_scene``). Attribute-only tables must not be ``save()``d.
        """
        base, _ = os.path.splitext(path)
        if with_geometry:
            shape_type, shapes, raw_type, ranges = _read_shp_full(
                base + ".shp")
        else:
            shape_type, raw_type, ranges = _read_shp_header(base + ".shp")
            shapes = []
        fields, cols, deleted = _read_dbf_columnar(base + ".dbf")
        if any(deleted):
            if len(deleted) == len(shapes):
                # dBase deletion flags (editors that don't repack): drop
                # the flagged records AND their geometry together so
                # shapes[] and columns stay index-aligned (OGR does the
                # same)
                shapes = [s for s, d in zip(shapes, deleted) if not d]
            cols = [[v for v, d in zip(c, deleted) if not d] for c in cols]
        table = ShapefileTable(shape_type, shapes, fields, None,
                               raw_shape_type=raw_type, header_ranges=ranges)
        if fields:
            table._cols = {f.name: c for f, c in zip(fields, cols)}
        else:  # fieldless .dbf: the row view must still carry the count
            table._records = [{} for _ in range(len(deleted) - sum(deleted))]
        if any(deleted):
            table.deleted_mask = np.asarray(deleted, bool)
        return table

    def save(self, path: str) -> None:
        if not self.shapes and self.records:
            raise ValueError(
                "save() on an attribute-only table (read with "
                "with_geometry=False) would write an empty .shp — re-read "
                "with geometry, or use update_dbf_field for "
                "attribute-only write-back"
            )
        base, _ = os.path.splitext(path)
        _write_shp(base + ".shp", base + ".shx", self.raw_shape_type,
                   self.shapes, header_ranges=self.header_ranges)
        _write_dbf(base + ".dbf", self.fields, self.records)


# ---------------------------------------------------------------------------
# .shp / .shx
# ---------------------------------------------------------------------------

def _bbox(shapes: list[Shape]) -> tuple[float, float, float, float]:
    if not shapes or all(len(s.points) == 0 for s in shapes):
        return (0.0, 0.0, 0.0, 0.0)
    allp = np.concatenate([s.points for s in shapes if len(s.points)])
    return (
        float(allp[:, 0].min()), float(allp[:, 1].min()),
        float(allp[:, 0].max()), float(allp[:, 1].max()),
    )


def _read_shp(path: str) -> tuple[int, list[Shape]]:
    shape_type, shapes, _, _ = _read_shp_full(path)
    return shape_type, shapes


def _check_shp_header(path: str, data: bytes) -> None:
    if len(data) < 100:
        raise ValueError(
            f"{path}: truncated shapefile header ({len(data)} bytes < 100)"
        )
    code, = struct.unpack(">i", data[0:4])
    if code != 9994:
        raise ValueError(f"{path}: not a shapefile (code {code})")


@_parse_guard
def _read_shp_header(path: str) -> tuple[int, int, tuple[float, ...]]:
    """(base_shape_type, raw_shape_type, header ranges) — header only."""
    with open(path, "rb") as f:
        data = f.read(100)
    _check_shp_header(path, data)
    raw_type, = struct.unpack("<i", data[32:36])
    ranges = struct.unpack("<8d", data[36:100])
    return _ZM_TO_BASE.get(raw_type, raw_type), raw_type, ranges


@_parse_guard
def read_point_coords(
    path: str, deleted_mask: np.ndarray | None = None
) -> np.ndarray:
    """(N, 2) x/y of every record in a POINT-family .shp — vectorized.

    Point layers have uniform record sizes (Point 28, PointZ/M larger with
    x/y still at the same in-record offset), so the whole file parses as
    one strided view instead of a 64k-iteration Python loop (the ingest
    hot path — BENCH.md serving section). Falls back to the general
    record walk for mixed/null-shape files, raising the same null-shape
    error the slow path's consumers do. ``deleted_mask`` (the sibling
    .dbf's deleted-record flags, same record order) downgrades null shapes
    on deletion-flagged records to zero-filled coords — such records are
    dropped downstream, matching OGR which never surfaces them at all —
    while keeping the loud error for live records.
    """
    with open(path, "rb") as f:
        data = f.read()
    _check_shp_header(path, data)
    raw_type, = struct.unpack("<i", data[32:36])
    if _ZM_TO_BASE.get(raw_type, raw_type) != SHP_POINT:
        raise ValueError(f"{path}: not a point layer (type {raw_type})")
    file_len = struct.unpack(">i", data[24:28])[0] * 2
    body = len(data) if file_len > len(data) else file_len
    if body > 100:
        content_words, = struct.unpack(">i", data[104:108])
        stride = 8 + content_words * 2
        n, rem = divmod(body - 100, stride)
        if rem == 0 and n > 0:
            # per-record shape type sits 8 bytes into each record
            tview = np.ndarray((n,), "<i4", data, 108, (stride,))
            is_null = tview == 0
            if (is_null | (tview == raw_type)).all():
                _check_null_shapes(path, is_null, deleted_mask)
                xs = np.ndarray((n,), "<f8", data, 112, (stride,)).copy()
                ys = np.ndarray((n,), "<f8", data, 120, (stride,)).copy()
                xs[is_null] = 0.0
                ys[is_null] = 0.0
                return np.stack([xs, ys], axis=1).astype(np.float64)
    # mixed record sizes (rare): general walk
    _, shapes, _, _ = _read_shp_full(path)
    out = np.zeros((len(shapes), 2), np.float64)
    is_null = np.asarray([len(s.points) == 0 for s in shapes], bool)
    _check_null_shapes(path, is_null, deleted_mask)
    for i, s in enumerate(shapes):
        if not is_null[i]:
            out[i] = s.points[0]
    return out


def _check_null_shapes(
    path: str, is_null: np.ndarray, deleted_mask: np.ndarray | None
) -> None:
    """Raise on null shapes attached to LIVE records; deletion-flagged ones
    are tolerated (their coords are zero-filled and filtered downstream)."""
    if not is_null.any():
        return
    live_null = is_null
    if deleted_mask is not None and len(deleted_mask) == len(is_null):
        live_null = is_null & ~np.asarray(deleted_mask, bool)
    if live_null.any():
        i = int(np.argmax(live_null))
        raise ValueError(
            f"{path}: point record {i} is a null shape (no geometry) — "
            f"repack the layer or remove the record"
        )


@_parse_guard
def _read_shp_full(
    path: str,
) -> tuple[int, list[Shape], int, tuple[float, ...]]:
    """Returns (base_shape_type, shapes, raw_file_shape_type, the header's
    8 bbox/range doubles). Each Shape keeps its original record bytes in
    ``raw`` so attribute-only rewrites round-trip Z/M geometry verbatim."""
    with open(path, "rb") as f:
        data = f.read()
    _check_shp_header(path, data)
    file_len_words, = struct.unpack(">i", data[24:28])
    raw_type, = struct.unpack("<i", data[32:36])
    ranges = struct.unpack("<8d", data[36:100])
    shape_type = _ZM_TO_BASE.get(raw_type, raw_type)
    shapes: list[Shape] = []
    off = 100
    end = file_len_words * 2
    while off < end:
        _recno, content_words = struct.unpack(">ii", data[off : off + 8])
        if content_words < 0:
            # a corrupt negative length would walk ``off`` BACKWARD —
            # an infinite loop, not just a bad record
            raise ValueError(
                f"{path}: corrupt shapefile record at byte {off} "
                f"(negative content length {content_words})"
            )
        off += 8
        rec = data[off : off + content_words * 2]
        off += content_words * 2
        rec_type, = struct.unpack("<i", rec[0:4])
        stype = _ZM_TO_BASE.get(rec_type, rec_type)
        if rec_type != 0 and rec_type != raw_type and stype != shape_type:
            # the spec allows only null or the file's own type per record:
            # anything else is a corrupt record, not an unsupported format
            raise ValueError(
                f"{path}: corrupt shapefile record at byte {off - 8} "
                f"(shape type {rec_type} in a type-{raw_type} file)"
            )
        if stype == 0:  # null shape
            shapes.append(Shape(0, np.zeros((0, 2)), raw=rec))
        elif stype == SHP_POINT:
            x, y = struct.unpack("<dd", rec[4:20])
            shapes.append(Shape(stype, np.array([[x, y]]), raw=rec))
        elif stype in (SHP_POLYLINE, SHP_POLYGON):
            nparts, npoints = struct.unpack("<ii", rec[36:44])
            parts = np.frombuffer(rec, "<i4", nparts, 44)
            pts = np.frombuffer(rec, "<f8", npoints * 2, 44 + nparts * 4)
            shapes.append(Shape(stype, pts.reshape(-1, 2).copy(),
                                parts.copy(), raw=rec))
        else:
            raise NotImplementedError(f"shape type {stype}")
    return shape_type, shapes, raw_type, ranges


def _shape_record_bytes(s: Shape) -> bytes:
    if s.raw is not None:
        # reader-provided original content: geometry is never mutated by
        # the pipeline, so write it back verbatim (preserves Z/M payloads)
        return s.raw
    if s.shape_type == 0 or len(s.points) == 0:
        return struct.pack("<i", 0)
    if s.shape_type == SHP_POINT:
        return struct.pack("<idd", SHP_POINT, s.points[0, 0], s.points[0, 1])
    pts = np.asarray(s.points, "<f8")
    parts = np.asarray(s.parts, "<i4")
    box = (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
    return (
        struct.pack("<i4dii", s.shape_type, *box, len(parts), len(pts))
        + parts.tobytes()
        + pts.tobytes()
    )


def _write_shp(shp_path: str, shx_path: str, shape_type: int,
               shapes: list[Shape], header_ranges=None):
    recs = [_shape_record_bytes(s) for s in shapes]
    total = 100 + sum(8 + len(r) for r in recs)
    if header_ranges is not None:
        ranges = tuple(header_ranges)
    else:
        xmin, ymin, xmax, ymax = _bbox(shapes)
        ranges = (xmin, ymin, xmax, ymax, 0.0, 0.0, 0.0, 0.0)

    def header(length_bytes: int) -> bytes:
        return (
            struct.pack(">i5i i", 9994, 0, 0, 0, 0, 0, length_bytes // 2)
            + struct.pack("<ii", 1000, shape_type)
            + struct.pack("<8d", *ranges)
        )

    with open(shp_path, "wb") as f:
        f.write(header(total))
        for i, r in enumerate(recs):
            f.write(struct.pack(">ii", i + 1, len(r) // 2))
            f.write(r)
    with open(shx_path, "wb") as f:
        f.write(header(100 + 8 * len(recs)))
        off = 100
        for r in recs:
            f.write(struct.pack(">ii", off // 2, len(r) // 2))
            off += 8 + len(r)


# ---------------------------------------------------------------------------
# .dbf (dBase III)
# ---------------------------------------------------------------------------

def _read_dbf(path: str) -> tuple[list[DbfField], list[dict]]:
    fields, records, deleted = _read_dbf_full(path)
    return fields, [r for r, d in zip(records, deleted) if not d]


def _dbf_field_descriptors(path: str, data) -> list[DbfField]:
    """Walk the 32-byte field descriptors up to the 0x0D terminator —
    BOUNDED by the file, so a torn header (the terminator byte is the one
    that went missing) raises instead of running off the end."""
    fields: list[DbfField] = []
    off = 32
    while off < len(data) and data[off] != 0x0D:
        if off + 32 > len(data):
            break
        name = data[off : off + 11].split(b"\x00")[0].decode("ascii")
        fields.append(DbfField(name, chr(data[off + 11]),
                               data[off + 16], data[off + 17]))
        off += 32
    if off >= len(data):
        raise ValueError(
            f"{path}: truncated dbf header (no field-descriptor terminator)"
        )
    return fields


def _parse_dbf_column(fld: DbfField, raw: np.ndarray) -> list:
    """Decode one stripped BYTES column per dBase semantics. Vectorized —
    the per-cell decode/strip/float loop dominated scene ingestion
    (~0.45 s per 24k-edge scene). Numeric/logical columns parse straight
    from the S-dtype array (``astype(float64)`` / ``int(bytes)`` are
    exact); only text columns pay the unicode decode."""
    if fld.type in ("N", "F"):
        # blank or all-'*' cells are dBase NULLs
        blank = (raw == b"") | (
            (np.char.strip(raw, b"*") == b"") & (raw != b"")
        )
        if fld.decimals or fld.type == "F":
            floaty = np.ones(raw.shape, bool)
        else:
            floaty = (np.char.find(raw, b".") >= 0) | (
                np.char.find(np.char.lower(raw), b"e") >= 0
            )
        if not blank.any():
            # vectorized fast paths (the per-cell loop below was an
            # ingest hotspot on 24k-edge RAG tables): all-float parses
            # via one astype; all-int via int64 when the declared width
            # cannot overflow it (dBase N <= 18 digits)
            if floaty.all():
                return raw.astype(np.float64).tolist()
            if not floaty.any() and fld.length <= 18:
                return raw.astype(np.int64).tolist()
        num = np.where(blank, b"0", raw).astype(np.float64)
        # ints parse from the TEXT: a 16+-digit dBase N column would lose
        # precision through the float64 fast path
        return [
            None if b else (float(x) if f else int(t))
            for b, f, x, t in zip(blank.tolist(), floaty.tolist(),
                                  num.tolist(), raw.tolist())
        ]
    if fld.type == "L":
        return np.isin(np.char.upper(raw), (b"T", b"Y")).tolist()
    return np.char.decode(raw, "ascii", "replace").tolist()


@_parse_guard
def _read_dbf_columnar(
    path: str,
) -> tuple[list[DbfField], list[list], list[bool]]:
    """Returns (fields, column-major values over ALL physical records
    incl. deletion-flagged ones, deleted mask) — the mask lets
    ``ShapefileTable.read`` drop a flagged record's geometry too, keeping
    shapes[] and the columns index-aligned. Column-major is the parse's
    natural shape; ``_read_dbf_full`` materializes row dicts on top for
    callers that want them."""
    with open(path, "rb") as f:
        data = f.read()
    n_records, header_size, record_size = struct.unpack("<IHH", data[4:12])
    fields = _dbf_field_descriptors(path, data)
    table = np.frombuffer(
        data, np.uint8, n_records * record_size, header_size
    ).reshape(n_records, record_size)
    deleted_mask = (table[:, 0] == ord("*")).tolist()
    cols: list[list] = []
    col = 1
    for fld in fields:
        cell = np.ascontiguousarray(table[:, col : col + fld.length])
        col += fld.length
        raw = np.char.strip(cell.view(f"S{fld.length}")[:, 0])
        cols.append(_parse_dbf_column(fld, raw))
    if not fields:
        # fieldless .dbf (pathological but legal): keep the record count
        # through one empty pseudo-column? No — callers key on fields;
        # return no columns and let the row view carry the count.
        return fields, [[] for _ in range(0)], deleted_mask
    return fields, cols, deleted_mask


def _read_dbf_full(path: str) -> tuple[list[DbfField], list[dict], list[bool]]:
    fields, cols, deleted_mask = _read_dbf_columnar(path)
    names = [f.name for f in fields]
    records = [dict(zip(names, row)) for row in zip(*cols)] if fields else [
        {} for _ in range(len(deleted_mask))
    ]
    return fields, records, deleted_mask


def _format_payload(fld: DbfField, values: list) -> list[bytes]:
    """Format a whole column for write-back. The common bulk case — a
    finite float column with declared decimals and no NULLs (``simi``
    write-back over a 24k-edge RAG, ``ingest.write_simi``) — formats in
    one vectorized ``np.char.mod`` instead of 24k f-string calls; anything
    else falls back to the exact per-value path."""
    if fld.type in ("N", "F") and fld.decimals and len(values) >= 256:
        arr = np.asarray(values)
        if arr.dtype.kind == "f" and np.isfinite(arr).all():
            s = np.char.mod(f"%{fld.length}.{fld.decimals}f", arr)
            lens = np.char.str_len(s)
            if (lens == fld.length).all():
                return [x.encode("ascii") for x in s.tolist()]
    return [
        b" " * fld.length if v is None else _format_value(fld, v)
        for v in values
    ]


def _format_value(fld: DbfField, value) -> bytes:
    if fld.type == "C":
        s = ("" if value is None else str(value))[: fld.length]
        return s.ljust(fld.length).encode("ascii", "replace")
    if fld.type == "L":
        return (b"T" if value else b"F").ljust(fld.length)
    if value is None:
        return b" " * fld.length
    if fld.decimals:
        s = f"{float(value):.{fld.decimals}f}"
        # shrink decimals to fit (standard dBase writer behavior) before
        # giving up — NEVER right-truncate, which silently changes the value
        d = fld.decimals
        while len(s) > fld.length and d > 0:
            d -= 1
            s = f"{float(value):.{d}f}" if d else str(int(round(float(value))))
    else:
        s = str(int(value))
    if len(s) > fld.length:
        raise ValueError(
            f"value {value!r} does not fit dbf field "
            f"{fld.name} {fld.type}({fld.length},{fld.decimals})"
        )
    return s.rjust(fld.length).encode("ascii")


@_parse_guard
def read_dbf_columns(
    path: str, names: list[str]
) -> tuple[dict[str, list], list[bool]]:
    """Parse ONLY the named columns of a .dbf (plus the deletion mask, over
    ALL physical records). A fraction of ``_read_dbf_full``'s cost on wide
    tables — the attribute write-back path (``ingest.write_simi``) only
    needs ``LEFT_FID``/``RIGHT_FID`` to map edge scores onto records."""
    with open(path, "rb") as f:
        data = f.read()
    n_records, header_size, record_size = struct.unpack("<IHH", data[4:12])
    fields = _dbf_field_descriptors(path, data)
    offsets = {}
    col = 1  # the deletion-flag byte
    for fld in fields:
        offsets[fld.name] = (col, fld)
        col += fld.length
    missing = [n for n in names if n not in offsets]
    if missing:
        # ValueError (not KeyError): the guard above passes path-attributed
        # ValueErrors through, and callers treat every parse-contract
        # failure uniformly
        raise ValueError(f"{path}: no dbf field(s) {missing}")
    # vectorized: one strided table view, then the shared column parser
    # per requested field (the per-record/per-cell Python loop this
    # replaces was an ingest hotspot on 24k-edge RAG tables)
    table = np.frombuffer(
        data, np.uint8, n_records * record_size, header_size
    ).reshape(n_records, record_size)
    deleted = (table[:, 0] == ord("*")).tolist() if n_records else []
    cols: dict[str, list] = {}
    for n in names:
        o, fld = offsets[n]
        cell = np.ascontiguousarray(table[:, o : o + fld.length])
        raw = np.char.strip(cell.view(f"S{fld.length}")[:, 0])
        if fld.type in ("N", "F"):
            cols[n] = _parse_dbf_column(fld, raw)
        else:
            # historical contract of this reader: text columns come back
            # stripped but NOT L-decoded (callers only use numeric ids)
            cols[n] = np.char.decode(raw, "ascii", "replace").tolist()
    return cols, deleted


@_parse_guard
def update_dbf_field(path: str, fld: DbfField, values: list) -> None:
    """Write one attribute column into an existing .dbf WITHOUT touching the
    sibling .shp/.shx — OGR ``SetField``/``SetFeature`` semantics
    (``ExtractFeatures.py:182-186,217-219``): every other byte of every
    record (and any deletion flag) is preserved verbatim.

    ``values`` aligns with the PHYSICAL records (deleted ones included);
    ``None`` writes blanks. When the field is absent it is appended (one
    splice rewrite: original record bytes + the new column); when present
    with the same length the column is patched in place.
    """
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n_records, header_size, record_size = struct.unpack("<IHH", data[4:12])
    if len(values) != n_records:
        raise ValueError(
            f"{path}: {len(values)} values for {n_records} dbf records"
        )
    fields = _dbf_field_descriptors(path, data)
    col = 1
    existing = None
    for f_ in fields:
        if f_.name == fld.name:
            existing = (col, f_)
            break
        col += f_.length
    if existing is not None:
        col_off, f_ = existing
        if f_.length != fld.length:
            raise ValueError(
                f"{path}: field {fld.name} exists with length "
                f"{f_.length} != {fld.length}"
            )
        # format with the FILE's declared spec (decimals may differ)
        payload = _format_payload(f_, values)
        if n_records:
            # one strided numpy assignment instead of n_records bytearray
            # slice writes (write-back hot path on 24k-edge RAG tables)
            tbl = np.frombuffer(
                data, np.uint8, n_records * record_size, header_size
            ).reshape(n_records, record_size)
            tbl[:, col_off : col_off + fld.length] = np.frombuffer(
                b"".join(payload), np.uint8
            ).reshape(n_records, fld.length)
        with open(path, "wb") as f:
            f.write(data)
        return
    # append the field: splice the new descriptor + per-record column bytes
    payload = _format_payload(fld, values)
    descr = struct.pack(
        "<11sc4xBB14x", fld.name.encode("ascii")[:11],
        fld.type.encode("ascii"), fld.length, fld.decimals,
    )
    now = _dt.date.today()
    head = bytearray(data[:header_size])
    head[1:4] = bytes([now.year - 1900, now.month, now.day])
    struct.pack_into("<HH", head, 8, header_size + 32, record_size + fld.length)
    out = bytes(head[: header_size - 1]) + descr + b"\x0d"
    parts = [out]
    base = header_size
    for rec in payload:
        parts.append(bytes(data[base : base + record_size]) + rec)
        base += record_size
    parts.append(b"\x1a")
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def _write_dbf(path: str, fields: list[DbfField], records: list[dict]):
    record_size = 1 + sum(f.length for f in fields)
    header_size = 32 + 32 * len(fields) + 1
    now = _dt.date.today()
    with open(path, "wb") as f:
        f.write(
            struct.pack(
                "<BBBBIHH20x",
                0x03, now.year - 1900, now.month, now.day,
                len(records), header_size, record_size,
            )
        )
        for fld in fields:
            f.write(
                struct.pack(
                    "<11sc4xBB14x",
                    fld.name.encode("ascii")[:11],
                    fld.type.encode("ascii"),
                    fld.length, fld.decimals,
                )
            )
        f.write(b"\x0d")
        for rec in records:
            f.write(b" ")
            for fld in fields:
                f.write(_format_value(fld, rec.get(fld.name)))
        f.write(b"\x1a")
