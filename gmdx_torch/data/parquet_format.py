"""Parquet files read and written in numpy and the standard library.

The card's machine has no ``pyarrow``; the Stage-2 metadata (columns
``sdr``, ``gainmap``, ``text``) is parquet, so the port reads it itself.

The reader takes what pyarrow writes for flat tables of byte-array
columns (strings and binaries):

- the footer and page headers in Thrift's compact protocol; every field is
  decoded, so fields the reader does not use (statistics, size statistics,
  encoding stats, column orders) are passed over;
- any number of row groups;
- data pages v1 and v2, and dictionary pages;
- values ``PLAIN`` (4-byte little-endian length, then the bytes) or
  ``RLE_DICTIONARY`` / ``PLAIN_DICTIONARY`` indices; a column chunk may
  switch from dictionary to ``PLAIN`` pages part way through, as pyarrow's
  writer does once the dictionary page passes its size limit;
- definition levels of optional columns (nulls come back as ``None``), the
  RLE / bit-packed hybrid: in v1 pages behind a 4-byte length and
  compressed with the page, in v2 pages ahead of the values and never
  compressed;
- codecs ``UNCOMPRESSED``, ``SNAPPY`` (decoded here) and ``GZIP``
  (``zlib``). Any other codec raises, naming it and the file.

The writer writes one row group of required byte-array columns, ``PLAIN``
and uncompressed, in data pages of about 1 MiB (the counterpart of
``gmdx/data/parquet.py:write_parquet_dataset``); pyarrow reads its files.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Sequence

import numpy as np

_MAGIC = b"PAR1"
# Thrift compact protocol type ids.
_STOP, _TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, _LIST, _SET, _MAP, _STRUCT = (
    range(13))
_CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4", 6: "ZSTD",
           7: "LZ4_RAW"}
_ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
              5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
              8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
_TYPES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT", 5: "DOUBLE",
          6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}
_BYTE_ARRAY = 6
_PLAIN, _PLAIN_DICTIONARY, _RLE, _RLE_DICTIONARY = 0, 2, 3, 8
_DATA_PAGE, _DICTIONARY_PAGE, _DATA_PAGE_V2 = 0, 2, 3
_REQUIRED, _OPTIONAL = 0, 1
_UTF8 = 0  # ConvertedType
_PAGE_BYTES = 1 << 20


# ---------------------------------------------------------------- Thrift


def _varint(buf, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


class _Thrift:
    """A compact-protocol decoder: a struct is a {field id: value} dict,
    a list a Python list, binary ``bytes``."""

    def __init__(self, buf, pos: int = 0):
        self.buf, self.pos = buf, pos

    def _uvarint(self) -> int:
        v, self.pos = _varint(self.buf, self.pos)
        return v

    def _int(self) -> int:
        v = self._uvarint()
        return (v >> 1) ^ -(v & 1)

    def _value(self, ctype: int) -> Any:
        if ctype in (_TRUE, _FALSE):  # a bool outside a field header: one byte
            self.pos += 1
            return self.buf[self.pos - 1] == _TRUE
        if ctype == _BYTE:
            self.pos += 1
            return struct.unpack("<b", self.buf[self.pos - 1:self.pos])[0]
        if ctype in (_I16, _I32, _I64):
            return self._int()
        if ctype == _DOUBLE:
            self.pos += 8
            return struct.unpack("<d", self.buf[self.pos - 8:self.pos])[0]
        if ctype == _BINARY:
            n = self._uvarint()
            self.pos += n
            return bytes(self.buf[self.pos - n:self.pos])
        if ctype in (_LIST, _SET):
            head = self.buf[self.pos]
            self.pos += 1
            n, etype = head >> 4, head & 0x0F
            if n == 15:
                n = self._uvarint()
            return [self._value(etype) for _ in range(n)]
        if ctype == _MAP:
            n = self._uvarint()
            if not n:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            return {self._value(kv >> 4): self._value(kv & 0x0F) for _ in range(n)}
        if ctype == _STRUCT:
            return self.struct()
        raise ValueError(f"unknown Thrift compact type {ctype}")

    def struct(self) -> dict[int, Any]:
        out: dict[int, Any] = {}
        last = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == _STOP:
                return out
            ctype, delta = head & 0x0F, head >> 4
            fid = last + delta if delta else self._int()
            last = fid
            out[fid] = (ctype == _TRUE) if ctype in (_TRUE, _FALSE) else self._value(ctype)


def _uvarint_bytes(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _zz(n: int) -> bytes:
    return _uvarint_bytes((n << 1) ^ (n >> 63))


def _t_i32(v: int):
    return _I32, _zz(v)


def _t_i64(v: int):
    return _I64, _zz(v)


def _t_bin(b: bytes):
    return _BINARY, _uvarint_bytes(len(b)) + b


def _t_list(etype: int, items: Sequence[bytes]):
    n = len(items)
    head = bytes([(n << 4) | etype]) if n < 15 else bytes([0xF0 | etype]) + _uvarint_bytes(n)
    return _LIST, head + b"".join(items)


def _t_struct(fields: Sequence[tuple[int, tuple[int, bytes]]]):
    """``fields``: (field id, (type, payload)), ids ascending."""
    out, last = bytearray(), 0
    for fid, (ctype, payload) in fields:
        if 0 < fid - last <= 15:
            out.append(((fid - last) << 4) | ctype)
        else:
            out.append(ctype)
            out += _zz(fid)
        out += payload
        last = fid
    out.append(_STOP)
    return _STRUCT, bytes(out)


# ---------------------------------------------------------------- codecs


def _snappy_decompress(buf) -> bytes:
    """Raw snappy (the block format parquet uses): the uncompressed length,
    then literals and back-references."""
    buf = memoryview(buf)
    n, pos = _varint(buf, 0)
    out = bytearray(n)
    o = 0
    end = len(buf)
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out[o:o + ln] = buf[pos:pos + ln]
            pos += ln
            o += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > o or o + ln > n:
            raise ValueError("corrupt snappy block")
        src = o - off
        if off >= ln:
            out[o:o + ln] = out[src:src + ln]
        else:  # the copy overlaps what it writes: a repeated pattern
            out[o:o + ln] = (bytes(out[src:o]) * (ln // off + 1))[:ln]
        o += ln
    if o != n:
        raise ValueError(f"corrupt snappy block: {o} of {n} bytes")
    return bytes(out)


def _decompress(buf, codec: int, path: str):
    if codec == 0:
        return buf
    if codec == 1:
        return _snappy_decompress(buf)
    if codec == 2:
        return zlib.decompress(bytes(buf), 47)  # gzip (or zlib) framing
    raise NotImplementedError(_codec_message(codec, path))


def _codec_message(codec: int, path: str) -> str:
    return (f"{path}: parquet codec {_CODECS.get(codec, codec)} is not read "
            f"(UNCOMPRESSED, SNAPPY, GZIP); rewrite the file with one of those")


# ---------------------------------------------------------------- pages


def _rle_hybrid(buf, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE / bit-packed hybrid (no length prefix)."""
    out = np.zeros(count, np.int64)
    width_bytes = (bit_width + 7) // 8
    weights = (1 << np.arange(bit_width, dtype=np.int64))
    i = pos = 0
    while i < count:
        head, pos = _varint(buf, pos)
        if head & 1:  # bit-packed groups of 8, least significant bit first
            groups = head >> 1
            nbytes = groups * bit_width
            take = min(groups * 8, count - i)
            if bit_width:
                bits = np.unpackbits(np.frombuffer(bytes(buf[pos:pos + nbytes]), np.uint8),
                                     bitorder="little")
                out[i:i + take] = (bits.reshape(-1, bit_width).astype(np.int64) @ weights)[:take]
            pos += nbytes
        else:
            take = min(head >> 1, count - i)
            out[i:i + take] = int.from_bytes(buf[pos:pos + width_bytes], "little")
            pos += width_bytes
        i += take
    return out


def _plain_byte_arrays(buf, n: int) -> list[bytes]:
    out, pos = [], 0
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", buf, pos)
        out.append(bytes(buf[pos + 4:pos + 4 + ln]))
        pos += 4 + ln
    return out


def _read_chunk(data: memoryview, meta: dict, optional: bool, path: str, name: str) -> list:
    codec = meta[4]
    if codec not in (0, 1, 2):
        raise NotImplementedError(_codec_message(codec, path))
    if meta[1] != _BYTE_ARRAY:
        raise NotImplementedError(f"{path}: column {name!r} is {_TYPES.get(meta[1], meta[1])}; "
                                  f"the reader takes BYTE_ARRAY columns")
    total = meta[5]
    pos = meta[9]
    if meta.get(11):  # dictionary_page_offset
        pos = min(pos, meta[11])
    values: list = []
    dictionary: list[bytes] | None = None
    while len(values) < total:
        reader = _Thrift(data, pos)
        header = reader.struct()
        body = data[reader.pos:reader.pos + header[3]]
        pos = reader.pos + header[3]
        kind = header[1]
        if kind == _DICTIONARY_PAGE:
            dictionary = _plain_byte_arrays(_decompress(body, codec, path), header[7][1])
            continue
        if kind == _DATA_PAGE:
            dh = header[5]
            n, encoding = dh[1], dh[2]
            raw = memoryview(_decompress(body, codec, path))
            levels = None
            if optional:
                (ln,) = struct.unpack_from("<I", raw, 0)
                levels = _rle_hybrid(raw[4:4 + ln], 1, n)
                raw = raw[4 + ln:]
        elif kind == _DATA_PAGE_V2:
            dh = header[8]
            n, encoding = dh[1], dh[4]
            def_len, rep_len = dh[5], dh[6]
            levels = _rle_hybrid(body[rep_len:rep_len + def_len], 1, n) if optional else None
            raw = body[rep_len + def_len:]
            if dh.get(7, True):
                raw = memoryview(_decompress(raw, codec, path))
        else:  # index pages carry no values
            continue
        present = n if levels is None else int(levels.sum())
        if encoding == _PLAIN:
            page = _plain_byte_arrays(raw, present)
        elif encoding in (_PLAIN_DICTIONARY, _RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError(f"{path}: column {name!r} has dictionary indices before its "
                                 f"dictionary page")
            idx = _rle_hybrid(raw[1:], raw[0], present)
            page = [dictionary[i] for i in idx]
        else:
            raise NotImplementedError(
                f"{path}: column {name!r} has {_ENCODINGS.get(encoding, encoding)} pages; the "
                f"reader takes PLAIN and dictionary pages")
        if levels is None:
            values.extend(page)
        else:
            it = iter(page)
            values.extend(next(it) if d else None for d in levels)
    if len(values) != total:
        raise ValueError(f"{path}: column {name!r} holds {len(values)} values, its metadata "
                         f"{total}")
    return values


def _footer(data: memoryview, path: str) -> dict:
    if len(data) < 12 or data[:4] != _MAGIC or data[-4:] != _MAGIC:
        raise ValueError(f"{path}: not a parquet file")
    (n,) = struct.unpack("<I", data[-8:-4])
    return _Thrift(data, len(data) - 8 - n).struct()


def _leaves(meta: dict, path: str) -> dict[str, dict]:
    schema = meta[2]
    leaves = {}
    for el in schema[1:]:
        name = el[4].decode()
        if el.get(5):
            raise NotImplementedError(f"{path}: nested column {name!r}; the reader takes flat "
                                      f"tables")
        if el.get(3, _REQUIRED) not in (_REQUIRED, _OPTIONAL):
            raise NotImplementedError(f"{path}: repeated column {name!r}")
        leaves[name] = el
    return leaves


def read_parquet(path: str, columns: Sequence[str] | None = None) -> dict[str, list]:
    """{column: values} of the named (default: every) column: ``str`` for
    UTF-8 columns, ``bytes`` for other byte arrays, ``None`` for a null."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    meta = _footer(data, path)
    leaves = _leaves(meta, path)
    names = list(leaves) if columns is None else list(columns)
    missing = set(names) - set(leaves)
    if missing:
        raise ValueError(f"{path}: parquet missing columns {sorted(missing)}; has "
                         f"{sorted(leaves)}")
    order = list(leaves)
    out: dict[str, list] = {c: [] for c in names}
    for rg in meta.get(4, []):
        for c in names:
            chunk = rg[1][order.index(c)]
            if chunk.get(1):
                raise NotImplementedError(f"{path}: column {c!r} lies in another file")
            out[c].extend(_read_chunk(data, chunk[3], leaves[c].get(3) == _OPTIONAL, path, c))
    for c in names:
        el = leaves[c]
        if el.get(6) == _UTF8 or 1 in el.get(10, {}):  # ConvertedType UTF8 / LogicalType STRING
            out[c] = [None if v is None else v.decode("utf-8") for v in out[c]]
    return out


def write_parquet(path: str, columns: dict[str, Sequence[str | bytes]]) -> None:
    """One row group of required columns: ``str`` values as UTF-8 strings,
    ``bytes`` as binaries; ``PLAIN``, uncompressed, v1 data pages of about
    1 MiB."""
    names = list(columns)
    rows = {len(v) for v in columns.values()}
    if len(rows) != 1:
        raise ValueError(f"columns of different lengths: { {c: len(v) for c, v in columns.items()} }")
    (n_rows,) = rows
    body = bytearray(_MAGIC)
    chunks, schema = [], [_t_struct([(4, _t_bin(b"schema")), (5, _t_i32(len(names)))])[1]]
    for name in names:
        vals = list(columns[name])
        is_str = all(isinstance(v, str) for v in vals)
        if not is_str and not all(isinstance(v, (bytes, bytearray)) for v in vals):
            raise TypeError(f"column {name!r}: every value must be str, or every value bytes")
        leaf = [(1, _t_i32(_BYTE_ARRAY)), (3, _t_i32(_REQUIRED)), (4, _t_bin(name.encode()))]
        if is_str:
            leaf += [(6, _t_i32(_UTF8)), (10, _t_struct([(1, _t_struct([]))]))]
        schema.append(_t_struct(leaf)[1])
        start = len(body)
        page, n_page = bytearray(), 0

        def flush():
            header = _t_struct([
                (1, _t_i32(_DATA_PAGE)), (2, _t_i32(len(page))), (3, _t_i32(len(page))),
                (5, _t_struct([(1, _t_i32(n_page)), (2, _t_i32(_PLAIN)), (3, _t_i32(_RLE)),
                               (4, _t_i32(_RLE))]))])[1]
            body.extend(header)
            body.extend(page)

        for v in vals:
            b = v.encode("utf-8") if is_str else bytes(v)
            page += struct.pack("<I", len(b)) + b
            n_page += 1
            if len(page) >= _PAGE_BYTES:
                flush()
                page, n_page = bytearray(), 0
        if n_page or not vals:
            flush()
        size = len(body) - start
        meta = _t_struct([
            (1, _t_i32(_BYTE_ARRAY)), (2, _t_list(_I32, [_zz(_PLAIN), _zz(_RLE)])),
            (3, _t_list(_BINARY, [_t_bin(name.encode())[1]])), (4, _t_i32(0)),
            (5, _t_i64(len(vals))), (6, _t_i64(size)), (7, _t_i64(size)), (9, _t_i64(start))])
        chunks.append(_t_struct([(2, _t_i64(start)), (3, meta)])[1])
    total = len(body) - len(_MAGIC)
    row_group = _t_struct([(1, _t_list(_STRUCT, chunks)), (2, _t_i64(total)),
                           (3, _t_i64(n_rows))])[1]
    footer = _t_struct([
        (1, _t_i32(1)), (2, _t_list(_STRUCT, schema)), (3, _t_i64(n_rows)),
        (4, _t_list(_STRUCT, [row_group])), (6, _t_bin(b"gmdx_torch"))])[1]
    body += footer + struct.pack("<I", len(footer)) + _MAGIC
    with open(path, "wb") as f:
        f.write(body)


__all__ = ["read_parquet", "write_parquet"]
