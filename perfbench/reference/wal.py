"""A plain reader of the storm tick WAL as it lies on the disk.

The file is a run of frames ``[u32 len][u32 crc32][payload]``, little
endian, one a tick. A payload is ``[u32 hlen]``, a JSON header of
``hlen`` bytes, then the tick's op words (u32). The header (format
version ``v`` 0 to 3) holds ``ts`` and ``docs``: one entry a document of
the tick, ``[doc, client, cseq0, ref, count, n_seq, first, last, msn,
w_off]``, whose ``count`` words start ``w_off`` bytes into the words. A
trimmed tick is a filler with no documents.

Numpy and the standard library only: nothing of the program is read or
imported, so what this returns is what the disk holds."""

from __future__ import annotations

import json
import pathlib
import struct
import zlib

import numpy as np

#: The newest tick format this reader knows.
VERSION = 3
FRAME = struct.Struct("<II")
#: The columns of a decoded tick's ``scalars``, in the header's order.
SCALARS = ("cseq0", "ref", "count", "n_seq", "first", "last", "msn")


class WalError(ValueError):
    """A frame or a record the reader cannot decode."""


def records(path) -> tuple[list, str | None]:
    """(the payloads, as memoryviews, of the intact frames from the file's
    start, what stopped the read): the read stops at a torn frame or at a
    payload whose CRC is wrong, and says so; ``None`` at a clean end."""
    data = pathlib.Path(path).read_bytes()
    view = memoryview(data)
    out, pos = [], 0
    while pos < len(data):
        if pos + FRAME.size > len(data):
            return out, f"torn frame header at byte {pos}"
        length, crc = FRAME.unpack_from(data, pos)
        end = pos + FRAME.size + length
        if end > len(data):
            return out, f"record {len(out)} torn at byte {len(data)}"
        payload = view[pos + FRAME.size:end]
        if zlib.crc32(payload) != crc:
            return out, f"record {len(out)}: CRC mismatch"
        out.append(payload)
        pos = end
    return out, None


def decode(payload) -> dict:
    """One tick: ``ts``, the ``docs`` and ``clients`` (names, in the
    header's order), ``scalars`` i64[docs, 7] (:data:`SCALARS`) and
    ``ops``, each document's u32 words. A record of another shape raises
    :class:`WalError`."""
    try:
        return _decode(payload)
    except (KeyError, TypeError, ValueError, struct.error) as err:
        if isinstance(err, WalError):
            raise
        raise WalError(f"undecodable record: {err!r}") from err


def _decode(payload) -> dict:
    (hlen,) = struct.unpack_from("<I", payload)
    header = json.loads(bytes(payload[4:4 + hlen]))
    version = header.get("v", 0)
    if not 0 <= version <= VERSION:
        raise WalError(f"tick format v{version} is newer than v{VERSION}")
    body = payload[4 + hlen:]
    if len(body) % 4:
        raise WalError("words region is not whole words")
    words = np.frombuffer(body, np.uint32)
    docs, clients, scalars, ops = [], [], [], []
    for entry in header["docs"]:
        if len(entry) != 10:
            raise WalError(f"document entry of {len(entry)} fields")
        doc, client, *nums, w_off = entry
        count = nums[2]
        if w_off % 4 or w_off < 0 or w_off // 4 + count > len(words):
            raise WalError(f"{doc}: words outside the record")
        docs.append(doc)
        clients.append(client)
        scalars.append(nums)
        ops.append(words[w_off // 4:w_off // 4 + count])
    return {"ts": header["ts"], "docs": docs, "clients": clients,
            "scalars": np.array(scalars, np.int64).reshape(-1, 7),
            "ops": ops}


def read(path) -> list:
    """Every tick of the WAL at ``path``, decoded (:func:`decode`); a file
    the reader stops in raises :class:`WalError`."""
    payloads, fault = records(path)
    if fault is not None:
        raise WalError(fault)
    return [decode(p) for p in payloads]
