"""Pure-Python GeoTIFF reader/writer.

The reference reads rasters exclusively through GDAL (``gdal.Open`` +
windowed ``ReadAsArray``, ``MyUtils1.py:319-323,188``). GDAL is not in this
image, so this module implements the raster subset the pipeline needs:

  * classic TIFF (magic 42) AND BigTIFF (magic 43, 8-byte offsets — the
    common container for real remote-sensing mosaics), little- or big-endian
  * uint8/uint16/int16/uint32/float32, striped or tiled, pixel-interleaved
    (PlanarConfiguration=1) or band-interleaved (=2, GDAL INTERLEAVE=BAND)
  * compression: none(1), Deflate(8/32946), PackBits(32773), LZW(5),
    LZMA(34925), ZSTD(50000/34926, via the zstandard package), and the
    lossy image codecs JPEG(7, incl. shared JPEGTables) and WebP(50001)
    via Pillow — together covering every compression GDAL commonly writes
    for remote-sensing mosaics
  * GeoTIFF geotransform from ModelPixelScale(33550) + ModelTiepoint(33922),
    or ModelTransformation(34264) for rotated/sheared rasters
  * writer: uncompressed striped uint8, with geo tags; classic or BigTIFF

The reader exposes GDAL-like windowed access (``read_window``) with the same
geo→pixel transform the reference applies, including its ``+1`` offset
(``MyUtils1.py:70-72``).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

try:  # C++ LZW/PackBits (GIL-released); pure-Python decoders are the fallback
    from deepmerge_tpu_torch.native import rastercodec as _native_codec

    _HAVE_NATIVE = _native_codec.available()
except Exception:  # pragma: no cover - toolchain missing
    _HAVE_NATIVE = False

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339
_JPEG_TABLES = 347
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_MODEL_TRANSFORMATION = 34264

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q", 18: "Q"}


def _unpackbits(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i : i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF LZW (MSB-first codes, early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitpos = 0
    nbits = 9
    prev: bytes | None = None
    total_bits = len(data) * 8
    while bitpos + nbits <= total_bits and len(out) < expected:
        byte_idx = bitpos >> 3
        chunk = int.from_bytes(data[byte_idx : byte_idx + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - (bitpos & 7) - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == CLEAR:
            reset()
            nbits = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    return bytes(out)


def _jpeg_decode(data: bytes, tables: bytes | None) -> np.ndarray:
    """Decode one new-style-JPEG (compression 7) tile/strip via Pillow.

    TIFF stores shared quantization/Huffman tables in the JPEGTables tag
    (347) as an abbreviated JPEG stream ``SOI .. tables .. EOI``; each
    tile/strip is then ``SOI <scan> EOI``. Splicing ``tables[:-2]`` (drop
    EOI) with ``data[2:]`` (drop SOI) rebuilds a standalone JPEG.
    """
    import io

    from PIL import Image

    if tables and len(tables) > 4:
        data = tables[:-2] + data[2:]
    arr = np.asarray(Image.open(io.BytesIO(data)))
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _decompress(data: bytes, method: int, expected: int) -> bytes:
    if method == 1:
        return data
    if method in (8, 32946):
        import zlib

        return zlib.decompress(data)
    if method == 32773:
        if _HAVE_NATIVE:
            return _native_codec.unpackbits(data, expected)
        return _unpackbits(data, expected)
    if method == 5:
        if _HAVE_NATIVE:
            return _native_codec.lzw_decode(data, expected)
        return _lzw_decode(data, expected)
    if method == 34925:  # LZMA2 (GDAL COMPRESS=LZMA)
        import lzma

        return lzma.decompress(data)
    if method in (50000, 34926):  # ZSTD (official + deprecated code)
        try:
            import zstandard
        except ImportError as exc:  # pragma: no cover
            raise NotImplementedError(
                "TIFF ZSTD compression needs the zstandard package"
            ) from exc
        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=expected
        )
    raise NotImplementedError(f"TIFF compression {method}")


def _run_blocks(fn, jobs) -> None:
    """Decode-and-place every strip/tile; thread pool when there are many.

    Each job writes a disjoint region of the output array, so threads never
    overlap; zlib/lzma and the native LZW/PackBits codecs all release the
    GIL, which is where the parallelism comes from. Small block counts stay
    serial (pool startup would dominate).
    """
    if len(jobs) >= 16 and os.environ.get("DEEPMERGE_TIFF_THREADS", "1") != "0":
        from concurrent.futures import ThreadPoolExecutor

        workers = min(8, os.cpu_count() or 1, len(jobs))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(fn, jobs))
            return
    for job in jobs:
        fn(job)


@dataclass
class GeoTiff:
    """A decoded raster + geotransform (GDAL convention)."""

    array: np.ndarray                       # (H, W, C)
    geotransform: tuple[float, ...] = (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    meta: dict = field(default_factory=dict)

    @property
    def shape(self):
        return self.array.shape

    def geo_to_pixel(self, x_geo: float, y_geo: float) -> tuple[int, int]:
        """Reference geo→pixel transform INCLUDING its +1 offset
        (``MyUtils1.py:70-72``): XPixel = |gt0 − X|/gt1 + 1."""
        gt = self.geotransform
        xp = int(abs((gt[0] - x_geo) / gt[1]) + 1)
        yl = int(abs((gt[3] - y_geo) / gt[5]) + 1)
        return yl, xp

    def read_window(self, x0: int, y0: int, w: int, h: int) -> np.ndarray:
        """Boundary-clipped zero-padded window read (``cut_image`` semantics,
        ``MyUtils1.py:162-200``); returns (h, w, C) of the array dtype."""
        hh, ww, c = self.array.shape
        out = np.zeros((h, w, c), self.array.dtype)
        sx, sy = max(x0, 0), max(y0, 0)
        ex, ey = min(x0 + w, ww), min(y0 + h, hh)
        if ex > sx and ey > sy:
            out[sy - y0 : ey - y0, sx - x0 : ex - x0] = self.array[sy:ey, sx:ex]
        return out


def read_geotiff(path: str) -> GeoTiff:
    """Parse + decode a (Big)TIFF. Failure contract for untrusted bytes
    (watch serving ingests scenes as they appear — a file mid-copy is the
    realistic arrival): a torn or corrupt file raises a CLEAN,
    path-attributed ``ValueError`` — never a raw ``zlib.error`` /
    ``struct.error`` / short-slice ``IndexError``, and never a hang or
    unbounded allocation (IFD walks and tag values are bounded by the
    file size below). ``OSError`` from opening the file and
    ``NotImplementedError`` from unsupported-format guards pass through.
    """
    import mmap

    # mmap instead of slurping: strip/tile slices page in on demand, so a
    # multi-GB BigTIFF mosaic doesn't hold raw-bytes + decoded-array peak
    # RSS (block slices are small copies; no views into the map escape)
    with open(path, "rb") as f:
        try:
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # zero-length file
            data = f.read()
    try:
        return _parse_geotiff(path, data)
    except NotImplementedError:
        raise
    except ValueError as e:
        if str(path) in str(e):
            raise  # already a clean path-attributed parse error
        raise ValueError(
            f"{path}: truncated or corrupt TIFF ({e})"
        ) from e
    except Exception as e:  # zlib/lzma/struct/PIL/numpy decode failures
        raise ValueError(
            f"{path}: truncated or corrupt TIFF ({type(e).__name__}: {e})"
        ) from e


def _parse_geotiff(path: str, data) -> GeoTiff:
    import mmap

    bo = data[:2]
    if bo == b"II":
        e = "<"
    elif bo == b"MM":
        e = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    magic, = struct.unpack(e + "H", data[2:4])
    if magic == 42:  # classic TIFF: 4-byte offsets, 12-byte IFD entries
        big = False
        ifd_off, = struct.unpack(e + "I", data[4:8])
    elif magic == 43:  # BigTIFF: 8-byte offsets, 20-byte IFD entries
        big = True
        offsize, zero = struct.unpack(e + "HH", data[4:8])
        if offsize != 8 or zero != 0:
            raise ValueError(f"{path}: malformed BigTIFF header")
        ifd_off, = struct.unpack(e + "Q", data[8:16])
    else:
        raise ValueError(f"{path}: not a TIFF (magic {magic})")

    if big:
        n_entries, = struct.unpack(e + "Q", data[ifd_off : ifd_off + 8])
        entry0, entry_sz, inline = ifd_off + 8, 20, 8
        cnt_fmt, off_fmt = "Q", "Q"
    else:
        n_entries, = struct.unpack(e + "H", data[ifd_off : ifd_off + 2])
        entry0, entry_sz, inline = ifd_off + 2, 12, 4
        cnt_fmt, off_fmt = "I", "I"
    if entry0 + n_entries * entry_sz > len(data):
        # bounds the walk BEFORE iterating: a corrupt 64-bit entry count
        # would otherwise spin a near-infinite Python loop
        raise ValueError(
            f"{path}: truncated TIFF ({n_entries} IFD entries extend "
            f"past the file)"
        )
    tags: dict[int, list] = {}
    for i in range(n_entries):
        off = entry0 + entry_sz * i
        tag, typ = struct.unpack(e + "HH", data[off : off + 4])
        count, = struct.unpack(
            e + cnt_fmt, data[off + 4 : off + 4 + struct.calcsize(cnt_fmt)]
        )
        vpos = off + entry_sz - inline
        size = _TYPE_SIZES.get(typ, 1) * count
        if size > len(data):
            # a tag's value region cannot exceed the file; reject before
            # building a giant unpack format string from a corrupt count
            raise ValueError(
                f"{path}: truncated TIFF (tag {tag} claims {size} value "
                f"bytes in a {len(data)}-byte file)"
            )
        if size <= inline:
            raw = data[vpos : vpos + size]
        else:
            val_off, = struct.unpack(e + off_fmt, data[vpos : vpos + inline])
            raw = data[val_off : val_off + size]
        if typ in _TYPE_FMT:
            tags[tag] = list(struct.unpack(e + _TYPE_FMT[typ] * count, raw))
        elif typ == 5:  # rational
            vals = struct.unpack(e + "II" * count, raw)
            tags[tag] = [vals[2 * j] / max(vals[2 * j + 1], 1) for j in range(count)]
        else:
            tags[tag] = [raw]

    w = tags[_IMAGE_WIDTH][0]
    h = tags[_IMAGE_LENGTH][0]
    spp = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
    bps = tags.get(_BITS_PER_SAMPLE, [8])[0]
    comp = tags.get(_COMPRESSION, [1])[0]
    fmt = tags.get(_SAMPLE_FORMAT, [1])[0]
    planar = tags.get(_PLANAR_CONFIG, [1])[0]
    predictor = tags.get(_PREDICTOR, [1])[0]
    if planar not in (1, 2):
        raise NotImplementedError(f"TIFF planar configuration {planar}")
    if predictor not in (1, 2):
        # 3 = floating-point horizontal differencing (GDAL PREDICTOR=3 on
        # float rasters) — decoding it as raw bytes would yield garbage
        # pixels with no error, so refuse loudly instead
        raise NotImplementedError(f"TIFF predictor {predictor}")
    dtype = {
        (1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
        (2, 16): np.int16, (2, 32): np.int32, (3, 32): np.float32,
    }[(fmt, bps)]
    dtype = np.dtype(dtype).newbyteorder(e)

    total_bytes = int(h) * int(w) * int(spp) * dtype.itemsize
    max_bytes = int(os.environ.get("DEEPMERGE_TIFF_MAX_BYTES",
                                   64 * 1024**3))
    if h <= 0 or w <= 0 or total_bytes > max_bytes:
        # compressed payloads can't be cross-checked against the file
        # size, so a corrupt dimension tag is caught by plausibility:
        # refuse before allocating (cap overridable for outsized mosaics)
        raise ValueError(
            f"{path}: implausible TIFF dimensions {h}x{w}x{spp} "
            f"({total_bytes} bytes; DEEPMERGE_TIFF_MAX_BYTES={max_bytes})"
        )

    jpeg_tables = tags.get(_JPEG_TABLES, [b""])[0] if comp == 7 else None

    # PlanarConfiguration=2 (GDAL INTERLEAVE=BAND): every strip/tile holds
    # ONE sample plane, blocks ordered all-of-band-0 first (TIFF 6.0 §"
    # PlanarConfiguration"); each block therefore carries 1 sample/pixel.
    bspp = 1 if planar == 2 else spp

    def decode(raw: bytes, nrows: int, ncols: int) -> np.ndarray:
        """One tile/strip → (nrows, ncols, bspp) array of ``dtype``."""
        if comp == 7:  # new-style JPEG (lossy; PIL returns RGB for YCbCr)
            return _jpeg_decode(raw, jpeg_tables)[:nrows, :ncols]
        if comp == 50001:  # WebP-in-TIFF (GDAL COMPRESS=WEBP)
            return _jpeg_decode(raw, None)[:nrows, :ncols]
        out = _decompress(raw, comp, nrows * ncols * bspp * dtype.itemsize)
        block = np.frombuffer(out, dtype, nrows * ncols * bspp).reshape(
            nrows, ncols, bspp
        )
        if predictor == 2:
            block = np.cumsum(block.astype(np.int64), axis=1).astype(dtype)
        return block

    img = np.zeros((h, w, spp), dtype)
    if _TILE_OFFSETS in tags:
        tw, tl = tags[_TILE_WIDTH][0], tags[_TILE_LENGTH][0]
        offs, cnts = tags[_TILE_OFFSETS], tags[_TILE_BYTE_COUNTS]
        tiles_across = -(-w // tw)
        tiles_per_band = tiles_across * (-(-h // tl)) if planar == 2 else None

        def place_tile(job):
            idx, o, cnt = job
            if planar == 2:
                band, ti = divmod(idx, tiles_per_band)
                bands = slice(band, band + 1)
            else:
                ti, bands = idx, slice(None)
            tile = decode(data[o : o + cnt], tl, tw)
            ty, tx = (ti // tiles_across) * tl, (ti % tiles_across) * tw
            img[ty : ty + tl, tx : tx + tw, bands] = tile[
                : max(0, min(tl, h - ty)), : max(0, min(tw, w - tx))
            ]

        _run_blocks(place_tile, list(zip(range(len(offs)), offs, cnts)))
    else:
        rps = tags.get(_ROWS_PER_STRIP, [h])[0]
        offs, cnts = tags[_STRIP_OFFSETS], tags[_STRIP_BYTE_COUNTS]
        strips_per_band = -(-h // rps)

        def place_strip(job):
            idx, o, cnt = job
            if planar == 2:
                band, si = divmod(idx, strips_per_band)
                bands = slice(band, band + 1)
            else:
                si, bands = idx, slice(None)
            row = si * rps
            nrows = min(rps, h - row)
            img[row : row + nrows, :, bands] = decode(
                data[o : o + cnt], nrows, w
            )

        _run_blocks(place_strip, list(zip(range(len(offs)), offs, cnts)))

    gt = (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    if _MODEL_PIXEL_SCALE in tags and _MODEL_TIEPOINT in tags:
        sx, sy = tags[_MODEL_PIXEL_SCALE][0], tags[_MODEL_PIXEL_SCALE][1]
        tp = tags[_MODEL_TIEPOINT]
        # tiepoint: (i, j, k, X, Y, Z) — pixel (i, j) sits at geo (X, Y)
        origin_x = tp[3] - tp[0] * sx
        origin_y = tp[4] + tp[1] * sy
        gt = (origin_x, sx, 0.0, origin_y, 0.0, -sy)
    elif _MODEL_TRANSFORMATION in tags:
        # 4x4 row-major geo transform matrix (GDAL writes this instead of
        # scale+tiepoint for rotated/sheared rasters):
        #   X = m[0]*col + m[1]*row + m[3];  Y = m[4]*col + m[5]*row + m[7]
        m = tags[_MODEL_TRANSFORMATION]
        gt = (m[3], m[0], m[1], m[7], m[4], m[5])
    if isinstance(data, mmap.mmap):
        data.close()  # img is fully materialized; nothing views the map
    return GeoTiff(array=np.ascontiguousarray(img), geotransform=gt,
                   meta={"compression": comp})


def write_geotiff(
    path: str,
    array: np.ndarray,
    geotransform: tuple[float, ...] = (0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
    bigtiff: bool = False,
    compression: str | None = None,
    rows_per_strip: int | None = None,
) -> None:
    """Write a striped uint8/uint16 GeoTIFF (little-endian).

    ``bigtiff=True`` writes the BigTIFF (magic 43, 8-byte offsets) layout —
    required once a mosaic crosses 4 GB, and the common real-world container
    for large remote-sensing scenes. ``compression`` may be ``None`` (one
    uncompressed strip, the historical layout) or ``"deflate"`` (zlib per
    strip, default 256 rows/strip — the GDAL ``COMPRESS=DEFLATE`` shape).
    uint16 (the common deep-pixel RS dtype) writes BitsPerSample=16 with
    the same layout.
    """
    if array.ndim == 2:
        array = array[..., None]
    assert array.dtype in (np.uint8, np.uint16), (
        f"writer supports uint8/uint16, got {array.dtype}"
    )
    bits = array.dtype.itemsize * 8
    h, w, c = array.shape
    array = np.ascontiguousarray(array)

    if compression in (None, "none"):
        comp_tag = 1
        rps = rows_per_strip or h

        def encode(b: bytes) -> bytes:
            return b
    elif compression == "deflate":
        import zlib

        comp_tag = 8
        rps = rows_per_strip or min(h, 256)
        encode = zlib.compress
    else:
        raise NotImplementedError(f"writer compression {compression!r}")
    rps = max(1, min(rps, h))
    strips = [
        encode(array[r : r + rps].tobytes()) for r in range(0, h, rps)
    ]
    n_strips = len(strips)

    gt = geotransform
    scale = struct.pack("<3d", gt[1], -gt[5], 0.0)
    tiepoint = struct.pack("<6d", 0, 0, 0, gt[0], gt[3], 0)

    ifd_entries = 11
    if bigtiff:
        header_size = 16
        ifd_size = 8 + ifd_entries * 20 + 8
        off_fmt, off_sz, off_typ = "<Q", 8, 16  # LONG8
    else:
        header_size = 8
        ifd_size = 2 + ifd_entries * 12 + 4
        off_fmt, off_sz, off_typ = "<I", 4, 4   # LONG
    inline = 8 if bigtiff else 4
    # layout: header | IFD | out-of-line values | strip data
    extra: list[bytes] = []
    extra_off = header_size + ifd_size

    def add_extra(b: bytes) -> int:
        nonlocal extra_off
        off = extra_off
        extra.append(b)
        extra_off += len(b)
        return off

    bps_vals = struct.pack(f"<{c}H", *([bits] * c))
    bps_off = add_extra(bps_vals) if len(bps_vals) > inline else None
    scale_off = add_extra(scale)
    tie_off = add_extra(tiepoint)
    # strip offset/count arrays go out-of-line when they don't fit inline;
    # their contents need data_off, which depends only on their SIZES
    offs_inline = n_strips * off_sz <= inline
    offs_arr_off = None if offs_inline else add_extra(b"\0" * (n_strips * off_sz))
    cnts_arr_off = None if offs_inline else add_extra(b"\0" * (n_strips * off_sz))
    data_off = extra_off
    strip_offs = []
    pos = data_off
    for s in strips:
        strip_offs.append(pos)
        pos += len(s)
    offs_bytes = b"".join(struct.pack(off_fmt, o) for o in strip_offs)
    cnts_bytes = b"".join(struct.pack(off_fmt, len(s)) for s in strips)
    if not offs_inline:
        extra[-2] = offs_bytes
        extra[-1] = cnts_bytes

    def entry(tag, typ, count, value, raw: bytes | None = None) -> bytes:
        """One IFD entry; ``raw`` = inline value bytes (padded), else
        ``value`` packs as offset/integer."""
        if bigtiff:
            head = struct.pack("<HHQ", tag, typ, count)
            if raw is not None:
                return head + raw.ljust(8, b"\0")
            return head + struct.pack("<Q", value)
        head = struct.pack("<HHI", tag, typ, count)
        if raw is not None:
            return head + raw.ljust(4, b"\0")
        return head + struct.pack("<I", value)

    bps_entry = (
        entry(_BITS_PER_SAMPLE, 3, c, bps_off)
        if bps_off is not None
        else entry(_BITS_PER_SAMPLE, 3, c, 0, raw=bps_vals)
    )
    if offs_inline:
        offs_entry = entry(_STRIP_OFFSETS, off_typ, n_strips, 0, raw=offs_bytes)
        cnts_entry = entry(_STRIP_BYTE_COUNTS, off_typ, n_strips, 0, raw=cnts_bytes)
    else:
        offs_entry = entry(_STRIP_OFFSETS, off_typ, n_strips, offs_arr_off)
        cnts_entry = entry(_STRIP_BYTE_COUNTS, off_typ, n_strips, cnts_arr_off)
    e = [
        entry(_IMAGE_WIDTH, 4, 1, w, raw=struct.pack("<I", w)),
        entry(_IMAGE_LENGTH, 4, 1, h, raw=struct.pack("<I", h)),
        bps_entry,
        entry(_COMPRESSION, 3, 1, 0, raw=struct.pack("<H", comp_tag)),
        entry(_PHOTOMETRIC, 3, 1, 0, raw=struct.pack("<H", 2 if c >= 3 else 1)),
        offs_entry,
        entry(_SAMPLES_PER_PIXEL, 3, 1, 0, raw=struct.pack("<H", c)),
        entry(_ROWS_PER_STRIP, 4, 1, rps, raw=struct.pack("<I", rps)),
        cnts_entry,
        entry(_MODEL_PIXEL_SCALE, 12, 3, scale_off),
        entry(_MODEL_TIEPOINT, 12, 6, tie_off),
    ]
    assert len(e) == ifd_entries
    with open(path, "wb") as f:
        if bigtiff:
            f.write(b"II" + struct.pack("<HHHQ", 43, 8, 0, 16))
            f.write(struct.pack("<Q", ifd_entries))
        else:
            f.write(b"II" + struct.pack("<HI", 42, 8))
            f.write(struct.pack("<H", ifd_entries))
        f.write(b"".join(e))
        f.write(struct.pack("<Q" if bigtiff else "<I", 0))
        for b in extra:
            f.write(b)
        for s in strips:
            f.write(s)
