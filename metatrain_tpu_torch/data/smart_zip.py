"""Random-access read-only zip for datasets with millions of members.

Counterpart of ``metatrain_tpu/data/smart_zip.py`` (a copy: numpy only).
``zipfile.ZipFile`` builds one ``ZipInfo`` object per member when it reads
the central directory, which makes multi-million-member archives slow to
open, heavy to hold and costly to pickle into loader workers.
``SmartZip`` reads the central directory once into flat numpy arrays
(a name blob with its offsets, local-header offsets, sizes, CRC-32s,
compression methods), follows zip64 extras, checks every member's CRC-32
when it reads it, and pickles without its file handle (each process
reopens the file on its first read).
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np


_EOCD_SIG = b"PK\x05\x06"
_EOCD64_LOC_SIG = b"PK\x06\x07"
_EOCD64_SIG = b"PK\x06\x06"
_CDH_SIG = b"PK\x01\x02"
_LFH_SIG = b"PK\x03\x04"

_STORED = 0
_DEFLATED = 8


class BadZip(ValueError):
    pass


class SmartZip:
    """Read-only zip with a flat numpy central-directory index."""

    def __init__(self, path: str):
        self.path = str(path)
        self._local = threading.local()
        self._build_index()

    # -- indexing -----------------------------------------------------------

    def _build_index(self) -> None:
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            file_size = f.tell()
            # find EOCD: scan the last 64KiB+22 bytes for the signature
            tail_size = min(file_size, 65536 + 22)
            f.seek(file_size - tail_size)
            tail = f.read(tail_size)
            pos = tail.rfind(_EOCD_SIG)
            if pos < 0:
                raise BadZip(f"{self.path}: end-of-central-directory not found")
            (
                _disk,
                _cd_disk,
                _n_disk,
                n_entries,
                cd_size,
                cd_offset,
                _comment_len,
            ) = struct.unpack("<HHHHIIH", tail[pos + 4 : pos + 22])

            if n_entries == 0xFFFF or cd_offset == 0xFFFFFFFF:
                # ZIP64: locate the zip64 EOCD record
                loc_pos = tail.rfind(_EOCD64_LOC_SIG, 0, pos)
                if loc_pos < 0:
                    raise BadZip(f"{self.path}: zip64 locator missing")
                (eocd64_offset,) = struct.unpack(
                    "<Q", tail[loc_pos + 8 : loc_pos + 16]
                )
                f.seek(eocd64_offset)
                rec = f.read(56)
                if rec[:4] != _EOCD64_SIG:
                    raise BadZip(f"{self.path}: bad zip64 EOCD signature")
                n_entries = struct.unpack("<Q", rec[32:40])[0]
                cd_size = struct.unpack("<Q", rec[40:48])[0]
                cd_offset = struct.unpack("<Q", rec[48:56])[0]

            f.seek(cd_offset)
            cd = f.read(cd_size)

        n = int(n_entries)
        header_offsets = np.empty(n, dtype=np.int64)
        comp_sizes = np.empty(n, dtype=np.int64)
        raw_sizes = np.empty(n, dtype=np.int64)
        crcs = np.empty(n, dtype=np.uint32)
        methods = np.empty(n, dtype=np.uint16)
        name_ends = np.empty(n, dtype=np.int64)
        name_chunks: List[bytes] = []

        p = 0
        for i in range(n):
            if cd[p : p + 4] != _CDH_SIG:
                raise BadZip(f"{self.path}: bad central-directory entry {i}")
            (
                method,
                crc,
                comp_size,
                raw_size,
                name_len,
                extra_len,
                comment_len,
                header_offset,
            ) = struct.unpack("<HxxxxIIIHHHxxxxxxxxI", cd[p + 10 : p + 46])
            name = cd[p + 46 : p + 46 + name_len]
            extra = cd[p + 46 + name_len : p + 46 + name_len + extra_len]
            if 0xFFFFFFFF in (comp_size, raw_size, header_offset):
                comp_size, raw_size, header_offset = _parse_zip64_extra(
                    extra, comp_size, raw_size, header_offset
                )
            header_offsets[i] = header_offset
            comp_sizes[i] = comp_size
            raw_sizes[i] = raw_size
            crcs[i] = crc
            methods[i] = method
            name_chunks.append(name)
            name_ends[i] = (name_ends[i - 1] if i else 0) + len(name)
            p += 46 + name_len + extra_len + comment_len

        self._names_blob = b"".join(name_chunks)
        self._name_ends = name_ends
        self._header_offsets = header_offsets
        self._comp_sizes = comp_sizes
        self._raw_sizes = raw_sizes
        self._crcs = crcs
        self._methods = methods
        # name -> index lookup without per-member Python objects held
        # permanently: built lazily on first string lookup
        self._lookup: Optional[Dict[bytes, int]] = None

    # -- pickling: drop the file handle -------------------------------------

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_local"] = None
        state["_lookup"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local = threading.local()

    # -- reading -------------------------------------------------------------

    def _file(self):
        f = getattr(self._local, "f", None)
        if f is None:
            f = open(self.path, "rb")
            self._local.f = f
        return f

    def __len__(self) -> int:
        return len(self._header_offsets)

    def _name_at(self, i: int) -> bytes:
        start = int(self._name_ends[i - 1]) if i else 0
        return self._names_blob[start : int(self._name_ends[i])]

    def namelist(self) -> List[str]:
        return [self._name_at(i).decode("utf-8") for i in range(len(self))]

    def index_of(self, name: str) -> int:
        if self._lookup is None:
            self._lookup = {
                self._name_at(i): i for i in range(len(self))
            }
        try:
            return self._lookup[name.encode("utf-8")]
        except KeyError:
            raise KeyError(f"{name!r} not in {self.path}") from None

    def read(self, name_or_index) -> bytes:
        """Read one member fully, verifying its CRC-32."""
        i = (
            name_or_index
            if isinstance(name_or_index, (int, np.integer))
            else self.index_of(name_or_index)
        )
        f = self._file()
        f.seek(int(self._header_offsets[i]))
        header = f.read(30)
        if header[:4] != _LFH_SIG:
            raise BadZip(f"{self.path}: bad local header for member {i}")
        name_len, extra_len = struct.unpack("<HH", header[26:30])
        f.seek(name_len + extra_len, os.SEEK_CUR)
        data = f.read(int(self._comp_sizes[i]))
        method = int(self._methods[i])
        if method == _DEFLATED:
            data = zlib.decompress(data, -15)
        elif method != _STORED:
            raise BadZip(f"unsupported compression method {method}")
        if (zlib.crc32(data) & 0xFFFFFFFF) != int(self._crcs[i]):
            raise BadZip(
                f"{self.path}: CRC mismatch for member "
                f"{self._name_at(i).decode()!r}"
            )
        return data

    def close(self) -> None:
        f = getattr(self._local, "f", None)
        if f is not None:
            f.close()
            self._local.f = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
        return False


def _parse_zip64_extra(extra: bytes, comp_size, raw_size, header_offset):
    p = 0
    while p + 4 <= len(extra):
        tag, size = struct.unpack("<HH", extra[p : p + 4])
        if tag == 0x0001:
            q = p + 4
            if raw_size == 0xFFFFFFFF:
                raw_size = struct.unpack("<Q", extra[q : q + 8])[0]
                q += 8
            if comp_size == 0xFFFFFFFF:
                comp_size = struct.unpack("<Q", extra[q : q + 8])[0]
                q += 8
            if header_offset == 0xFFFFFFFF:
                header_offset = struct.unpack("<Q", extra[q : q + 8])[0]
            break
        p += 4 + size
    return comp_size, raw_size, header_offset
