"""Minimal HDF4 / HDF-EOS reader for MODIS granules (no GDAL, no pyhdf).

The port's own copy of ``sifsr_tpu/geo/hdf4.py`` (numpy and zlib only).
Covers what the reference extracts with GDAL's HDF4 reader
(utils.py:243-543): named scientific datasets (SDS) with their scale factors,
and the grid geotransform from the HDF-EOS StructMetadata.0 global attribute.

Format support (the HDF 4.2 specification):
- classic DD-block file layout (big-endian);
- SDS discovery via the SD-interface Vgroups (class ``Var0.0``, name = SDS
  name) pointing at their NDG (numeric data group) of SDD (dims) + NT
  (number type) + SD (data);
- data elements: contiguous, linked-block (SPECIAL_LINKED), whole-element
  deflate (SPECIAL_COMP) and chunked (SPECIAL_CHUNKED, with per-chunk
  deflate) — the layouts NASA MODIS products use;
- Vdata (VH/VS) parsing for chunk tables and text attributes.

Validated by round-trip against the conforming writer in this module (the
repository holds no real .hdf granule; the writer emits the same on-disk
structures the reader parses).

MODIS product readers apply the reference's scalings: LST DN x 0.02 K
(utils.py:338), reflectance DN x 0.0001 (utils.py:428), ASTER DN x 0.1 K
(utils.py:456).
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = [
    "HDF4Error",
    "HDF4File",
    "read_modis_lst",
    "read_modis_nir_red",
    "read_mod44w",
    "write_hdf4_sds",
]


class HDF4Error(ValueError):
    """Raised for structurally invalid / truncated / corrupt HDF4 input.

    Every malformed-input path raises this (never a bare struct.error,
    IndexError or infinite loop) so callers can distinguish bad files from
    bugs."""

_MAGIC = b"\x0e\x03\x13\x01"

# tags
TAG_NT = 106
TAG_SDD = 701
TAG_SD = 702
TAG_NDG = 720
TAG_VH = 1962
TAG_VS = 1963
TAG_VG = 1965
TAG_COMPRESSED = 40
TAG_LINKED = 20
TAG_CHUNK = 61
_EXT_BIT = 0x4000

SPECIAL_LINKED = 1
SPECIAL_COMP = 2
SPECIAL_CHUNKED = 6
COMP_DEFLATE = 4

_NT_DTYPES = {
    5: ">f4", 6: ">f8",
    20: ">i1", 21: ">u1",
    22: ">i2", 23: ">u2",
    24: ">i4", 25: ">u4",
    3: ">u1", 4: ">i1",
}


class HDF4File:
    """Parsed HDF4 file: DD index, Vgroups, SDS catalogue."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        if self.data[:4] != _MAGIC:
            raise HDF4Error(f"{path}: not an HDF4 file")
        self.path = path
        self.dds: dict[tuple[int, int], tuple[int, int]] = {}  # (tag, ref) -> (offset, length)
        off = 4
        seen_blocks: set[int] = set()
        while off:
            if off in seen_blocks:
                raise HDF4Error(f"{path}: cyclic DD-block chain at offset {off}")
            seen_blocks.add(off)
            if off + 6 > len(self.data):
                raise HDF4Error(f"{path}: truncated DD block header at offset {off}")
            ndd, nxt = struct.unpack(">hI", self.data[off : off + 6])
            if ndd < 0 or off + 6 + 12 * ndd > len(self.data):
                raise HDF4Error(
                    f"{path}: DD block at {off} declares {ndd} entries beyond EOF"
                )
            for i in range(ndd):
                tag, ref, o, l = struct.unpack(
                    ">HHII", self.data[off + 6 + 12 * i : off + 6 + 12 * (i + 1)]
                )
                if tag != 0:
                    if o != 0xFFFFFFFF and o + l > len(self.data):
                        raise HDF4Error(
                            f"{path}: element ({tag},{ref}) spans past EOF "
                            f"(offset {o}, length {l}, file {len(self.data)})"
                        )
                    self.dds[(tag, ref)] = (o, l)
            off = nxt
        self._sds_index = None

    # ------------------------------------------------------------- raw access
    def _raw(self, tag: int, ref: int) -> bytes:
        o, l = self.dds[(tag, ref)]
        return self.data[o : o + l]

    def _element(self, tag: int, ref: int) -> bytes:
        """Data element content, resolving extended/special storage."""
        if (tag, ref) in self.dds:
            return self._raw(tag, ref)
        ext = (tag | _EXT_BIT, ref)
        if ext not in self.dds:
            raise HDF4Error(f"no element ({tag}, {ref})")
        hdr = self._raw(*ext)
        if len(hdr) < 2:
            raise HDF4Error(f"truncated special-element header ({tag}, {ref})")
        special = struct.unpack(">h", hdr[:2])[0]
        if special == SPECIAL_COMP:
            # int16 special, uint16 version, uint32 uncomp_len,
            # uint16 comp_ref, uint16 model, uint16 comp_type [, config]
            if len(hdr) < 14:
                raise HDF4Error(f"truncated compression header ({tag}, {ref})")
            _, uncomp_len, comp_ref, _model, comp_type = struct.unpack(">HIHHH", hdr[2:14])
            if (TAG_COMPRESSED, comp_ref) not in self.dds:
                raise HDF4Error(f"missing compressed payload ref {comp_ref}")
            payload = self._raw(TAG_COMPRESSED, comp_ref)
            if comp_type == COMP_DEFLATE:
                try:
                    # bound the output to the header's declared uncompressed
                    # length: a stream that expands past it is hostile (a
                    # few-KB decompression bomb must not size a huge buffer)
                    dec = zlib.decompressobj()
                    out = dec.decompress(payload, uncomp_len + 1)
                    if len(out) > uncomp_len:
                        raise HDF4Error(
                            f"deflate stream ({tag}, {ref}) exceeds its "
                            f"declared uncompressed length {uncomp_len}"
                        )
                    return out
                except zlib.error as exc:
                    raise HDF4Error(f"corrupt deflate stream ({tag}, {ref}): {exc}") from exc
            raise NotImplementedError(f"compression type {comp_type}")
        if special == SPECIAL_LINKED:
            # int32 length, int32 blk_len, int32 num_blk, uint16 link_ref
            if len(hdr) < 16:
                raise HDF4Error(f"truncated linked-block header ({tag}, {ref})")
            length, blk_len, _num, link_ref = struct.unpack(">iiiH", hdr[2:16])
            if length < 0:
                raise HDF4Error(f"negative linked-block length ({tag}, {ref})")
            out = bytearray()
            seen: set[int] = set()
            while link_ref and len(out) < length:
                if link_ref in seen:
                    raise HDF4Error(f"cyclic linked-block table at ref {link_ref}")
                seen.add(link_ref)
                if (TAG_LINKED, link_ref) not in self.dds:
                    raise HDF4Error(f"missing linked-block table ref {link_ref}")
                table = self._raw(TAG_LINKED, link_ref)
                if len(table) < 2:
                    raise HDF4Error(f"truncated linked-block table ref {link_ref}")
                next_ref = struct.unpack(">H", table[:2])[0]
                n = (len(table) - 2) // 2
                refs = struct.unpack(f">{n}H", table[2 : 2 + 2 * n])
                for r in refs:
                    if r == 0 or len(out) >= length:
                        break
                    if (TAG_LINKED, r) not in self.dds:
                        raise HDF4Error(f"missing linked data block ref {r}")
                    out += self._raw(TAG_LINKED, r)
                link_ref = next_ref
            if len(out) < length:
                raise HDF4Error(
                    f"linked element ({tag}, {ref}) shorter than declared "
                    f"({len(out)} < {length})"
                )
            return bytes(out[:length])
        raise NotImplementedError(f"special element {special}")

    # --------------------------------------------------------------- vgroups
    def vgroups(self):
        for (tag, ref) in self.dds:
            if tag != TAG_VG:
                continue
            raw = self._raw(tag, ref)
            if len(raw) < 2:
                raise HDF4Error(f"truncated Vgroup ({tag}, {ref})")
            nelt = struct.unpack(">H", raw[:2])[0]
            if 2 + 4 * nelt + 2 > len(raw):
                raise HDF4Error(f"Vgroup ({tag}, {ref}) member table beyond end")
            tags = struct.unpack(f">{nelt}H", raw[2 : 2 + 2 * nelt])
            refs = struct.unpack(f">{nelt}H", raw[2 + 2 * nelt : 2 + 4 * nelt])
            p = 2 + 4 * nelt
            namelen = struct.unpack(">H", raw[p : p + 2])[0]
            name = raw[p + 2 : p + 2 + namelen].decode("ascii", "replace").rstrip("\0")
            p += 2 + namelen
            if p + 2 > len(raw):
                raise HDF4Error(f"Vgroup ({tag}, {ref}) class name beyond end")
            classlen = struct.unpack(">H", raw[p : p + 2])[0]
            klass = raw[p + 2 : p + 2 + classlen].decode("ascii", "replace").rstrip("\0")
            yield name, klass, list(zip(tags, refs))

    def vdata(self, ref: int) -> dict:
        """Parse a VH header + its VS payload into field arrays. Names,
        orders or offsets that overrun the header or the payload raise
        HDF4Error, as every other malformed element does."""
        try:
            return self._vdata(ref)
        except (struct.error, ValueError) as exc:
            if isinstance(exc, HDF4Error):
                raise
            raise HDF4Error(f"Vdata ref {ref}: {exc}") from exc

    def _vdata(self, ref: int) -> dict:
        if (TAG_VH, ref) not in self.dds:
            raise HDF4Error(f"no Vdata header ref {ref}")
        raw = self._raw(TAG_VH, ref)
        if len(raw) < 10:
            raise HDF4Error(f"truncated Vdata header ref {ref}")
        interlace, nvert, ivsize, nfields = struct.unpack(">hihh", raw[:10])
        if nvert < 0 or nfields < 0 or ivsize < 0:
            raise HDF4Error(f"Vdata ref {ref}: negative counts")
        if nvert > 0 and ivsize == 0:
            # ivsize==0 would bypass the payload-length bound below while
            # nvert (an int32 from the file) sizes the column allocations
            raise HDF4Error(f"Vdata ref {ref}: {nvert} records of zero size")
        if 10 + 8 * nfields > len(raw):
            raise HDF4Error(f"Vdata ref {ref}: field tables beyond end")
        p = 10
        types = struct.unpack(f">{nfields}h", raw[p : p + 2 * nfields]); p += 2 * nfields
        isizes = struct.unpack(f">{nfields}h", raw[p : p + 2 * nfields]); p += 2 * nfields
        offsets = struct.unpack(f">{nfields}h", raw[p : p + 2 * nfields]); p += 2 * nfields
        orders = struct.unpack(f">{nfields}h", raw[p : p + 2 * nfields]); p += 2 * nfields
        names = []
        for _ in range(nfields):
            ln = struct.unpack(">h", raw[p : p + 2])[0]; p += 2
            names.append(raw[p : p + ln].decode("ascii", "replace")); p += ln
        ln = struct.unpack(">h", raw[p : p + 2])[0]; p += 2
        vname = raw[p : p + ln].decode("ascii", "replace"); p += ln

        payload = self._element(TAG_VS, ref)
        if nvert * ivsize > len(payload):
            raise HDF4Error(
                f"Vdata ref {ref}: payload {len(payload)} B < "
                f"{nvert} records x {ivsize} B"
            )
        fields = {}
        for i, fname in enumerate(names):
            dt = _NT_DTYPES.get(types[i], ">u1")
            width = isizes[i]
            col = np.zeros(nvert * orders[i], dtype=np.dtype(dt).newbyteorder("="))
            itemsize = np.dtype(dt).itemsize
            for v in range(nvert):
                base = v * ivsize + offsets[i]
                chunk = payload[base : base + width]
                col[v * orders[i] : (v + 1) * orders[i]] = np.frombuffer(
                    chunk, dtype=dt, count=orders[i]
                )
            fields[fname] = col.reshape(nvert, orders[i])
        return {"name": vname, "fields": fields, "nvert": nvert}

    # ------------------------------------------------------------------- SDS
    def sds_names(self) -> list[str]:
        return list(self._index().keys())

    def _index(self) -> dict:
        if self._sds_index is None:
            self._sds_index = {}
            for name, klass, members in self.vgroups():
                if klass != "Var0.0":
                    continue
                for tag, ref in members:
                    if tag == TAG_NDG:
                        self._sds_index[name] = ref
        return self._sds_index

    def read_sds(self, name: str, dtype=None) -> np.ndarray:
        """Read one SDS. `dtype` (optional) converts straight from the
        big-endian payload into the requested native dtype in a single
        numpy pass — the MODIS readers use it to avoid materialising the
        intermediate native-endian integer array (the decode chain was
        3 full-array copies; profiled at ~3 s per MOD09GQ granule)."""
        ndg_ref = self._index().get(name)
        if ndg_ref is None:
            raise KeyError(f"SDS {name!r} not found; have {self.sds_names()}")
        if (TAG_NDG, ndg_ref) not in self.dds:
            raise HDF4Error(f"SDS {name!r}: dangling NDG ref {ndg_ref}")
        raw = self._raw(TAG_NDG, ndg_ref)
        n = len(raw) // 4
        members = struct.unpack(f">{2 * n}H", raw[: 4 * n])
        members = list(zip(members[0::2], members[1::2]))

        dims = None
        sds_dtype = None
        data_ref = None
        for tag, ref in members:
            if tag == TAG_SDD:
                sdd = self._raw(TAG_SDD, ref)
                if len(sdd) < 2:
                    raise HDF4Error(f"SDS {name!r}: truncated SDD")
                rank = struct.unpack(">H", sdd[:2])[0]
                if 6 + 4 * rank > len(sdd):
                    raise HDF4Error(f"SDS {name!r}: SDD rank {rank} beyond end")
                dims = struct.unpack(f">{rank}I", sdd[2 : 2 + 4 * rank])
                nt_tag, nt_ref = struct.unpack(">HH", sdd[2 + 4 * rank : 6 + 4 * rank])
                if (nt_tag, nt_ref) not in self.dds:
                    raise HDF4Error(f"SDS {name!r}: missing number-type element")
                nt = self._raw(nt_tag, nt_ref)
                if len(nt) < 2 or nt[1] not in _NT_DTYPES:
                    raise HDF4Error(f"SDS {name!r}: unknown number type")
                sds_dtype = _NT_DTYPES[nt[1]]
            elif tag == TAG_SD:
                data_ref = ref
        if dims is None or data_ref is None:
            raise HDF4Error(f"incomplete SDS {name!r}")

        out_dtype = np.dtype(dtype) if dtype is not None else np.dtype(
            np.dtype(sds_dtype).newbyteorder("=")
        )
        if (TAG_SD, data_ref) not in self.dds and (TAG_SD | _EXT_BIT, data_ref) in self.dds:
            hdr = self._raw(TAG_SD | _EXT_BIT, data_ref)
            if struct.unpack(">h", hdr[:2])[0] == SPECIAL_CHUNKED:
                return self._read_chunked(hdr, dims, sds_dtype, out_dtype)
        payload = self._element(TAG_SD, data_ref)
        expect = int(np.prod(dims)) * np.dtype(sds_dtype).itemsize
        if len(payload) < expect:
            raise HDF4Error(
                f"SDS {name!r}: payload {len(payload)} B < expected {expect} B "
                f"for dims {tuple(dims)}"
            )
        return np.frombuffer(payload, dtype=sds_dtype, count=int(np.prod(dims))).reshape(
            dims
        ).astype(out_dtype)

    def _read_chunked(self, hdr: bytes, dims, sds_dtype, out_dtype) -> np.ndarray:
        """SPECIAL_CHUNKED header + chunk-table vdata -> assembled array.

        Chunk payloads are resolved in a thread pool: real MODIS granules
        store each chunk as an independently-deflated element and
        zlib releases the GIL, so decompression scales with cores."""
        # layout: int16 special, uint8 version, int32 flag, int32 elem_tot,
        # int32 chunk_size(bytes), int32 nt_size, uint16 chk_tbl_tag,
        # uint16 chk_tbl_ref, uint16 sp_tag, uint16 sp_ref, int32 ndims,
        # then per dim: int32 flag, int32 dim_len, int32 chunk_len
        p = 2
        _version = hdr[p]; p += 1
        _flag, _elem_tot, _chunk_size, _nt_size = struct.unpack(">iiii", hdr[p : p + 16]); p += 16
        _tbl_tag, tbl_ref, _sp_tag, _sp_ref = struct.unpack(">HHHH", hdr[p : p + 8]); p += 8
        ndims = struct.unpack(">i", hdr[p : p + 4])[0]; p += 4
        dim_lens, chunk_lens = [], []
        for _ in range(ndims):
            _dflag, dlen, clen = struct.unpack(">iii", hdr[p : p + 12]); p += 12
            dim_lens.append(dlen)
            chunk_lens.append(clen)

        table = self.vdata(tbl_ref)
        for field in ("origin", "chk_tag", "chk_ref"):
            if field not in table["fields"]:
                raise HDF4Error(f"chunk table missing field {field!r}")
        origins = table["fields"]["origin"]
        chk_tags = table["fields"]["chk_tag"].reshape(-1)
        chk_refs = table["fields"]["chk_ref"].reshape(-1)

        item = np.dtype(sds_dtype).itemsize
        nchunks = table["nvert"]
        if nchunks > 1:
            with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
                payloads = list(pool.map(
                    self._element,
                    [int(t) for t in chk_tags[:nchunks]],
                    [int(r) for r in chk_refs[:nchunks]],
                ))
        else:
            payloads = [self._element(int(chk_tags[k]), int(chk_refs[k]))
                        for k in range(nchunks)]
        out = np.zeros(dim_lens, dtype=out_dtype)
        for k in range(nchunks):
            payload = payloads[k]
            need = int(np.prod(chunk_lens)) * item
            if len(payload) < need:
                raise HDF4Error(
                    f"chunk {k}: payload {len(payload)} B < expected {need} B"
                )
            chunk = np.frombuffer(
                payload, dtype=sds_dtype, count=int(np.prod(chunk_lens))
            ).reshape(chunk_lens)
            sl = tuple(
                slice(int(origins[k][d]) * chunk_lens[d],
                      min((int(origins[k][d]) + 1) * chunk_lens[d], dim_lens[d]))
                for d in range(ndims)
            )
            clip = tuple(slice(0, s.stop - s.start) for s in sl)
            out[sl] = chunk[clip]
        return out.reshape(dims)

    # -------------------------------------------------------- EOS metadata
    def text_attribute(self, name: str) -> str | None:
        """A text global attribute stored as a Vdata (e.g. StructMetadata.0)."""
        for vg_name, klass, members in self.vgroups():
            pass  # attributes are free-standing vdatas, not vgroup members
        for (tag, ref) in self.dds:
            if tag != TAG_VH:
                continue
            vd = self.vdata(ref)
            if vd["name"] == name:
                col = next(iter(vd["fields"].values()))
                return col.astype(np.uint8).tobytes().decode("ascii", "replace").rstrip("\0")
        return None

    def grid_geotransform(self) -> tuple | None:
        """Geotransform from StructMetadata.0 (UpperLeftPointMtrs, XDim...)."""
        meta = self.text_attribute("StructMetadata.0")
        if not meta:
            return None
        ul = re.search(r"UpperLeftPointMtrs=\(([-\d.eE]+),([-\d.eE]+)\)", meta)
        lr = re.search(r"LowerRightMtrs=\(([-\d.eE]+),([-\d.eE]+)\)", meta)
        xd = re.search(r"XDim=(\d+)", meta)
        yd = re.search(r"YDim=(\d+)", meta)
        if not (ul and lr and xd and yd):
            return None
        ulx, uly = float(ul.group(1)), float(ul.group(2))
        lrx, lry = float(lr.group(1)), float(lr.group(2))
        nx, ny = int(xd.group(1)), int(yd.group(1))
        if nx == 0 or ny == 0:
            return None
        return (ulx, (lrx - ulx) / nx, 0.0, uly, 0.0, (lry - uly) / ny)


# --------------------------------------------------------- MODIS product I/O
def read_modis_lst(path: str, time: str = "day", with_qc: bool = False):
    """MOD11A1/MOD21A1D LST in Kelvin (+ QC), with the grid geotransform
    (reference read_LST, utils.py:300-380; DN scale 0.02 K)."""
    f = HDF4File(path)
    names = f.sds_names()
    want = "LST_Day" if time == "day" else "LST_Night"
    lst_name = next((n for n in names if want in n or n == "LST"), None)
    qc_name = next((n for n in names if "QC" in n), None)
    if lst_name is None:
        raise KeyError(f"no LST SDS in {path}: {names}")
    lst = f.read_sds(lst_name, dtype=np.float32)
    lst *= 0.02
    qc = f.read_sds(qc_name, dtype=np.uint8) if (with_qc and qc_name) else None
    gt = f.grid_geotransform()
    if with_qc:
        return lst, qc, gt
    return lst, gt


def read_modis_nir_red(path: str):
    """MOD09GQ Red/NIR reflectances (DN x 1e-4; reference read_NIRRED,
    utils.py:383-440). Returns (red, nir, geotransform)."""
    f = HDF4File(path)
    names = f.sds_names()
    red_name = next((n for n in names if "b01" in n), None)
    nir_name = next((n for n in names if "b02" in n), None)
    if red_name is None or nir_name is None:
        raise KeyError(f"no b01/b02 SDS in {path}: {names}")
    red = f.read_sds(red_name, dtype=np.float32)
    red *= 1e-4
    nir = f.read_sds(nir_name, dtype=np.float32)
    nir *= 1e-4
    return red, nir, f.grid_geotransform()


def read_mod44w(path: str):
    """MOD44W water mask (reference read_MOD44W, utils.py:459-505)."""
    f = HDF4File(path)
    name = next((n for n in f.sds_names() if "water" in n.lower()), f.sds_names()[0])
    return f.read_sds(name), f.grid_geotransform()


# ---------------------------------------------------------------- writer
def write_hdf4_sds(
    path: str,
    datasets: dict[str, np.ndarray],
    struct_metadata: str | None = None,
    deflate: bool = False,
    chunks: tuple[int, int] | None = None,
) -> None:
    """Write a minimal spec-conforming HDF4 file (for round-trip tests and
    for producing MODIS-like fixtures): big-endian SDS with SD Vgroups,
    optional whole-element deflate, optional StructMetadata.0 text vdata.

    chunks=(cy, cx) stores each 2-D SDS in the SPECIAL_CHUNKED layout with
    per-chunk deflate (HDF4 spec §10: chunk-table Vdata of (origin, chk_tag,
    chk_ref) records, each chunk an independent whole-element-deflate
    special element, partial edge chunks zero-padded to full size) — the
    layout real NASA MODIS granules use, for full-scale ingest stress tests."""
    NT_BY_KIND = {("u", 1): 21, ("i", 1): 20, ("i", 2): 22, ("u", 2): 23,
                  ("i", 4): 24, ("u", 4): 25, ("f", 4): 5, ("f", 8): 6}

    blobs: list[tuple[int, int, bytes]] = []  # (tag, ref, payload)
    next_ref = 1

    def add(tag: int, payload: bytes) -> int:
        nonlocal next_ref
        ref = next_ref
        next_ref += 1
        blobs.append((tag, ref, payload))
        return ref

    for name, arr in datasets.items():
        arr = np.ascontiguousarray(arr)
        nt_code = NT_BY_KIND[(arr.dtype.kind, arr.dtype.itemsize)]
        be = arr.astype(arr.dtype.newbyteorder(">"))
        nt_ref = add(TAG_NT, bytes([1, nt_code, arr.dtype.itemsize * 8, 0]))
        sdd = struct.pack(">H", arr.ndim) + b"".join(
            struct.pack(">I", d) for d in arr.shape
        ) + struct.pack(">HH", TAG_NT, nt_ref) + b"".join(
            struct.pack(">HH", TAG_NT, nt_ref) for _ in range(arr.ndim)
        )
        sdd_ref = add(TAG_SDD, sdd)
        if chunks is not None and arr.ndim == 2:
            cy, cx = chunks
            item = arr.dtype.itemsize
            records = []
            for oy in range(-(-arr.shape[0] // cy)):
                for ox in range(-(-arr.shape[1] // cx)):
                    full = np.zeros((cy, cx), dtype=be.dtype)
                    part = be[oy * cy : (oy + 1) * cy, ox * cx : (ox + 1) * cx]
                    full[: part.shape[0], : part.shape[1]] = part
                    raw = full.tobytes()
                    comp_ref = add(TAG_COMPRESSED, zlib.compress(raw))
                    chdr = struct.pack(">hHIHHH", SPECIAL_COMP, 0, len(raw),
                                       comp_ref, 0, COMP_DEFLATE)
                    chunk_ref = add(TAG_SD | _EXT_BIT, chdr)
                    records.append(struct.pack(">iiHH", oy, ox, TAG_SD, chunk_ref))
            # chunk-table Vdata: origin (2x int32), chk_tag/chk_ref (uint16)
            fields = [("origin", 24, 8, 2), ("chk_tag", 23, 2, 1),
                      ("chk_ref", 23, 2, 1)]
            vh = struct.pack(">hihh", 0, len(records),
                             sum(f[2] for f in fields), len(fields))
            vh += struct.pack(f">{len(fields)}h", *[f[1] for f in fields])
            vh += struct.pack(f">{len(fields)}h", *[f[2] for f in fields])
            offs, o = [], 0
            for fdef in fields:
                offs.append(o)
                o += fdef[2]
            vh += struct.pack(f">{len(fields)}h", *offs)
            vh += struct.pack(f">{len(fields)}h", *[f[3] for f in fields])
            for fdef in fields:
                vh += struct.pack(">h", len(fdef[0])) + fdef[0].encode()
            tbl_name = "_HDF_CHK_TBL_0"
            vh += struct.pack(">h", len(tbl_name)) + tbl_name.encode()
            vh += struct.pack(">h", 0)
            vh_ref = add(TAG_VH, vh)
            blobs.append((TAG_VS, vh_ref, b"".join(records)))
            chunked_hdr = struct.pack(
                ">hBiiiiHHHHi", SPECIAL_CHUNKED, 1, 0, be.nbytes,
                cy * cx * item, item, TAG_VH, vh_ref, 0, 0, arr.ndim,
            )
            for dim_len, chk_len in zip(arr.shape, (cy, cx)):
                chunked_hdr += struct.pack(">iii", 0, dim_len, chk_len)
            sd_ref = add(TAG_SD | _EXT_BIT, chunked_hdr)
        elif deflate:
            comp_payload = zlib.compress(be.tobytes())
            comp_ref = add(TAG_COMPRESSED, comp_payload)
            hdr = struct.pack(">hHIHHH", SPECIAL_COMP, 0, be.nbytes, comp_ref, 0, COMP_DEFLATE)
            sd_ref = add(TAG_SD | _EXT_BIT, hdr)
        else:
            sd_ref = add(TAG_SD, be.tobytes())
        ndg = struct.pack(">HHHH", TAG_SDD, sdd_ref, TAG_SD, sd_ref)
        ndg_ref = add(TAG_NDG, ndg)
        # SD-interface Vgroup: class Var0.0, name = SDS name
        vg = struct.pack(">H", 1) + struct.pack(">H", TAG_NDG) + struct.pack(">H", ndg_ref)
        vg += struct.pack(">H", len(name)) + name.encode()
        vg += struct.pack(">H", len("Var0.0")) + b"Var0.0"
        vg += struct.pack(">HHHH", 0, 0, 3, 0)
        add(TAG_VG, vg)

    if struct_metadata is not None:
        text = struct_metadata.encode("ascii")
        nfields = 1
        vh = struct.pack(">hihh", 0, len(text), 1, nfields)
        vh += struct.pack(">h", 3)        # DFNT_UCHAR8
        vh += struct.pack(">h", 1)        # isize
        vh += struct.pack(">h", 0)        # offset
        vh += struct.pack(">h", 1)        # order
        vh += struct.pack(">h", len("VALUES")) + b"VALUES"
        vh += struct.pack(">h", len("StructMetadata.0")) + b"StructMetadata.0"
        vh += struct.pack(">h", 0)        # class len
        vh += struct.pack(">HHhh", 0, 0, 3, 0)
        ref = add(TAG_VH, vh)
        blobs.append((TAG_VS, ref, text))

    # layout: magic + one DD block + payloads
    n = len(blobs)
    header_len = 4 + 6 + 12 * n
    offsets = []
    cursor = header_len
    for _, _, payload in blobs:
        offsets.append(cursor)
        cursor += len(payload)

    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">hI", n, 0))
        for (tag, ref, payload), off in zip(blobs, offsets):
            f.write(struct.pack(">HHII", tag, ref, off, len(payload)))
        for _, _, payload in blobs:
            f.write(payload)
