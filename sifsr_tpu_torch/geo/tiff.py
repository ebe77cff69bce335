"""Self-contained GeoTIFF reader/writer (classic TIFF, single band).

Covers everything the reference pipeline reads or writes through GDAL/rasterio
(utils.py:508-543, predict.py:105-128, model_perf_aster_formatds.py:253-305):
little/big-endian classic TIFFs, strip or tile layout, compression none /
deflate / PackBits, integer and float sample formats, and the three GeoTIFF
tags that carry georeferencing for axis-aligned rasters (ModelPixelScale,
ModelTiepoint, GeoKeyDirectory + ascii/double params).

The geotransform convention is GDAL's 6-tuple:
    (origin_x, pixel_w, 0, origin_y, 0, -pixel_h)
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

__all__ = ["GeoTiff", "read_geotiff", "write_geotiff"]

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
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GDAL_NODATA = 42113
_GEO_KEY_DIRECTORY = 34735
_GEO_DOUBLE_PARAMS = 34736
_GEO_ASCII_PARAMS = 34737

_TYPE_FMT = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d"}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}


@dataclasses.dataclass
class GeoTiff:
    """A decoded single-band raster + its georeferencing."""

    array: np.ndarray
    geotransform: tuple[float, float, float, float, float, float] | None = None
    geo_keys: dict | None = None
    geo_ascii: str | None = None
    geo_doubles: tuple | None = None
    nodata: float | None = None

    @property
    def shape(self):
        return self.array.shape

    def pixel_to_world(self, row: np.ndarray, col: np.ndarray):
        gt = self.geotransform
        x = gt[0] + col * gt[1] + row * gt[2]
        y = gt[3] + col * gt[4] + row * gt[5]
        return x, y

    def epsg(self) -> int | None:
        """ProjectedCSTypeGeoKey (3072) or GeographicTypeGeoKey (2048)."""
        if not self.geo_keys:
            return None
        for key in (3072, 2048):
            v = self.geo_keys.get(key)
            if v and v != 32767:
                return int(v)
        return None


def _read_tag_values(data, endian, typ, count, value_field):
    size = _TYPE_SIZE[typ] * count
    if size <= 4:
        raw = value_field[:size]
    else:
        (offset,) = struct.unpack(endian + "I", value_field)
        raw = data[offset : offset + size]
    if len(raw) < size:
        # validate BEFORE building the unpack format: count is a raw uint32
        # from the file, and a lying value must not drive O(count) work
        raise ValueError(
            f"TIFF tag values truncated: need {size} B, file has {len(raw)}"
        )
    if typ == 2:
        return raw.rstrip(b"\0").decode("ascii", "replace")
    fmt = _TYPE_FMT[typ]
    if typ in (5, 10):  # rationals -> floats
        vals = struct.unpack(endian + f"{2 * count}{fmt[0]}", raw)
        return tuple(vals[i] / vals[i + 1] for i in range(0, len(vals), 2))
    # numeric repeat count: parses in O(digits), not O(count) format chars
    return struct.unpack(endian + f"{count}{fmt}", raw)


def _dtype_from(bits, sample_format, endian):
    kind = {1: "u", 2: "i", 3: "f"}[sample_format]
    return np.dtype(f"{endian}{kind}{bits // 8}")


def _unpackbits_decode(raw: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw) and len(out) < expected:
        n = raw[i]
        i += 1
        if n < 128:
            out += raw[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += raw[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


def read_geotiff(path: str) -> GeoTiff:
    with open(path, "rb") as f:
        data = f.read()

    if len(data) < 8 or data[:2] not in (b"II", b"MM"):
        raise ValueError(f"{path}: not a TIFF (no II/MM byte-order mark)")
    endian = {b"II": "<", b"MM": ">"}[data[:2]]
    magic, ifd_offset = struct.unpack(endian + "HI", data[2:8])
    if magic != 42:
        raise ValueError(f"{path}: not a classic TIFF (magic={magic})")

    (n_tags,) = struct.unpack(endian + "H", data[ifd_offset : ifd_offset + 2])
    tags = {}
    for i in range(n_tags):
        entry = data[ifd_offset + 2 + 12 * i : ifd_offset + 2 + 12 * (i + 1)]
        tag, typ, count = struct.unpack(endian + "HHI", entry[:8])
        tags[tag] = _read_tag_values(data, endian, typ, count, entry[8:12])

    width = tags[_IMAGE_WIDTH][0]
    height = tags[_IMAGE_LENGTH][0]
    bits = tags.get(_BITS_PER_SAMPLE, (8,))[0]
    compression = tags.get(_COMPRESSION, (1,))[0]
    sample_format = tags.get(_SAMPLE_FORMAT, (1,))[0]
    samples = tags.get(_SAMPLES_PER_PIXEL, (1,))[0]
    predictor = tags.get(_PREDICTOR, (1,))[0]
    planar = tags.get(_PLANAR_CONFIG, (1,))[0]
    if samples != 1 and planar != 1:
        raise NotImplementedError(
            f"{path}: planar multi-band TIFF not supported (planar={planar})"
        )
    dtype = _dtype_from(bits, sample_format, endian)

    def decode(raw: bytes, expected: int) -> bytes:
        if compression == 1:
            return raw
        if compression in (8, 32946):  # deflate / legacy deflate
            # bound the inflate to the strip/tile's expected size: a few-KB
            # hostile payload must not balloon to GBs (same guard as the
            # HDF4 reader); +1 so over-long streams fail the size check
            # below instead of silently truncating
            out = zlib.decompressobj().decompress(raw, expected + 1)
            return out
        if compression == 32773:  # PackBits
            return _unpackbits_decode(raw, expected)
        raise NotImplementedError(f"{path}: TIFF compression {compression} not supported")

    # multi-band (chunky/PlanarConfig=1): samples interleave per pixel, so
    # every decode below carries a trailing sample axis that squeezes away
    # for the single-band case
    if _TILE_OFFSETS in tags:
        tw, tl = tags[_TILE_WIDTH][0], tags[_TILE_LENGTH][0]
        offsets, counts = tags[_TILE_OFFSETS], tags[_TILE_BYTE_COUNTS]
        tiles_across = (width + tw - 1) // tw
        img = np.zeros((height, width, samples), dtype=dtype)
        for idx, (off, cnt) in enumerate(zip(offsets, counts)):
            tile = np.frombuffer(
                decode(data[off : off + cnt], tw * tl * samples * dtype.itemsize),
                dtype=dtype,
            ).reshape(tl, tw, samples)
            if predictor == 2:
                tile = np.cumsum(tile.astype(np.int64), axis=1).astype(dtype)
            r0 = (idx // tiles_across) * tl
            c0 = (idx % tiles_across) * tw
            img[r0 : r0 + tl, c0 : c0 + tw] = tile[: height - r0, : width - c0]
    else:
        rows_per_strip = tags.get(_ROWS_PER_STRIP, (height,))[0]
        offsets, counts = tags[_STRIP_OFFSETS], tags[_STRIP_BYTE_COUNTS]
        parts = []
        for i, (off, cnt) in enumerate(zip(offsets, counts)):
            rows = min(rows_per_strip, height - i * rows_per_strip)
            raw = decode(data[off : off + cnt], rows * width * samples * dtype.itemsize)
            strip = np.frombuffer(raw, dtype=dtype).reshape(rows, width, samples)
            if predictor == 2:
                strip = np.cumsum(strip.astype(np.int64), axis=1).astype(dtype)
            parts.append(strip)
        img = np.concatenate(parts, axis=0)
    if samples == 1:
        img = img[..., 0]

    geotransform = None
    if _MODEL_PIXEL_SCALE in tags and _MODEL_TIEPOINT in tags:
        sx, sy = tags[_MODEL_PIXEL_SCALE][0], tags[_MODEL_PIXEL_SCALE][1]
        tp = tags[_MODEL_TIEPOINT]
        # tiepoint: raster (i, j, k) -> model (x, y, z)
        i, j, x, y = tp[0], tp[1], tp[3], tp[4]
        geotransform = (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)

    geo_keys = None
    if _GEO_KEY_DIRECTORY in tags:
        kd = tags[_GEO_KEY_DIRECTORY]
        geo_keys = {}
        n_keys = kd[3]
        for k in range(n_keys):
            key_id, loc, count, value = kd[4 + 4 * k : 8 + 4 * k]
            if loc == 0:
                geo_keys[key_id] = value
            elif loc == _GEO_DOUBLE_PARAMS and _GEO_DOUBLE_PARAMS in tags:
                vals = tags[_GEO_DOUBLE_PARAMS][value : value + count]
                geo_keys[key_id] = vals[0] if count == 1 else vals
            elif loc == _GEO_ASCII_PARAMS and _GEO_ASCII_PARAMS in tags:
                geo_keys[key_id] = tags[_GEO_ASCII_PARAMS][value : value + count].rstrip("|")

    nodata = None
    if _GDAL_NODATA in tags:
        try:
            nodata = float(str(tags[_GDAL_NODATA]).strip("\x00 "))
        except ValueError:
            pass

    return GeoTiff(
        array=np.ascontiguousarray(img.astype(img.dtype.newbyteorder("="))),
        geotransform=geotransform,
        geo_keys=geo_keys,
        geo_ascii=tags.get(_GEO_ASCII_PARAMS),
        geo_doubles=tags.get(_GEO_DOUBLE_PARAMS),
        nodata=nodata,
    )


def _sample_format_of(dtype: np.dtype) -> int:
    return {"u": 1, "i": 2, "f": 3}[dtype.kind]


def write_geotiff(
    path: str,
    array: np.ndarray,
    geotransform: tuple | None = None,
    epsg: int | None = None,
    geo_ascii: str | None = None,
    nodata: float | None = None,
) -> None:
    """Write a single-band uncompressed little-endian GeoTIFF.

    ``epsg`` becomes ProjectedCSTypeGeoKey (or GeographicTypeGeoKey for
    4xxx geographic codes); ``geo_ascii`` lands in GeoAsciiParams (citation).
    Rotation-free geotransforms only (gt[2] == gt[4] == 0), like the
    reference's save path (utils.py:528-543).
    """
    array = np.ascontiguousarray(array)
    if array.ndim != 2:
        raise ValueError("write_geotiff expects a 2-D single-band array")
    height, width = array.shape
    dtype = array.dtype.newbyteorder("<")
    payload = array.astype(dtype).tobytes()

    entries = []  # (tag, type, count, raw_value_or_bytes)

    def entry(tag, typ, values):
        if typ == 2:
            raw = values.encode("ascii") + b"\0"
            count = len(raw)
        else:
            values = values if isinstance(values, (tuple, list)) else (values,)
            count = len(values)
            raw = struct.pack("<" + _TYPE_FMT[typ] * count, *values)
        entries.append((tag, typ, count, raw))

    entry(_IMAGE_WIDTH, 3, width)
    entry(_IMAGE_LENGTH, 3, height)
    entry(_BITS_PER_SAMPLE, 3, dtype.itemsize * 8)
    entry(_COMPRESSION, 3, 1)
    entry(_PHOTOMETRIC, 3, 1)
    entry(_SAMPLES_PER_PIXEL, 3, 1)
    entry(_ROWS_PER_STRIP, 3, height)
    entry(_PLANAR_CONFIG, 3, 1)
    entry(_SAMPLE_FORMAT, 3, _sample_format_of(dtype))

    if geotransform is not None:
        gt = geotransform
        if gt[2] != 0 or gt[4] != 0:
            raise NotImplementedError("rotated geotransforms not supported")
        entry(_MODEL_PIXEL_SCALE, 12, (gt[1], -gt[5], 0.0))
        entry(_MODEL_TIEPOINT, 12, (0.0, 0.0, 0.0, gt[0], gt[3], 0.0))

    if epsg is not None or geo_ascii is not None:
        keys = [(1024, 0, 1, 1)]  # GTModelTypeGeoKey = projected
        keys.append((1025, 0, 1, 1))  # RasterPixelIsArea
        ascii_blob = ""
        if geo_ascii is not None:
            keys.append((1026, _GEO_ASCII_PARAMS, len(geo_ascii) + 1, 0))
            ascii_blob = geo_ascii + "|"
        if epsg is not None:
            if 4000 <= epsg < 5000:
                keys[0] = (1024, 0, 1, 2)  # geographic model
                keys.append((2048, 0, 1, epsg))
            else:
                keys.append((3072, 0, 1, epsg))
        header = (1, 1, 0, len(keys))
        flat = list(header)
        for k in sorted(keys):
            flat.extend(k)
        entry(_GEO_KEY_DIRECTORY, 3, tuple(flat))
        if ascii_blob:
            entry(_GEO_ASCII_PARAMS, 2, ascii_blob)

    if nodata is not None:
        entry(_GDAL_NODATA, 2, repr(float(nodata)))

    # strip offsets/counts appended after layout is known (single strip)
    # layout: header(8) + payload + IFD + out-of-line values
    data_offset = 8
    ifd_offset = data_offset + len(payload)
    entry(_STRIP_OFFSETS, 4, data_offset)
    entry(_STRIP_BYTE_COUNTS, 4, len(payload))

    entries.sort(key=lambda e: e[0])
    n = len(entries)
    overflow_offset = ifd_offset + 2 + 12 * n + 4
    ifd = struct.pack("<H", n)
    overflow = b""
    for tag, typ, count, raw in entries:
        if len(raw) <= 4:
            value_field = raw.ljust(4, b"\0")
        else:
            value_field = struct.pack("<I", overflow_offset + len(overflow))
            overflow += raw
        ifd += struct.pack("<HHI", tag, typ, count) + value_field
    ifd += struct.pack("<I", 0)  # next IFD

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_offset))
        f.write(payload)
        f.write(ifd)
        f.write(overflow)
