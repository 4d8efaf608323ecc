"""A tensorboard event file of scalars, written without tensorboard.

The training log's scalars go to ``<dir>/events.out.tfevents.<time>.<host>.
<pid>.0.v2`` as tensorboard reads them: TFRecord framing (a little-endian
uint64 length, its masked CRC-32C, the bytes, their masked CRC-32C) around
``Event`` protobufs, the first with ``file_version`` "brain.Event:2", then
one a scalar, each encoded by hand as ``tf.summary.scalar`` writes it: a
``Summary.Value`` with the tag, a 0-d float32 ``TensorProto`` (its bytes in
``tensor_content``) and the "scalars" plugin's metadata. (Importing
``torch.utils.tensorboard`` loads tensorflow where it is installed, and the
card's machine has neither; this module needs only the standard library.)
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames its records."""
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord."""
    n = struct.pack("<Q", len(data))
    return n + struct.pack("<I", masked_crc32c(n)) + data + struct.pack("<I", masked_crc32c(data))


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1  # int64 two's complement
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int | None = None, **what: bytes) -> bytes:
    """``Event{wall_time = 1, step = 2, file_version = 3 | summary = 5}``."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step is not None:
        out += b"\x10" + _varint(int(step))
    if "file_version" in what:
        out += _field(3, what["file_version"])
    if "summary" in what:
        out += _field(5, what["summary"])
    return out


_SCALAR_METADATA = _field(1, _field(1, b"scalars"))  # SummaryMetadata.plugin_data.plugin_name


def scalar_summary(tag: str, value: float) -> bytes:
    """``Summary{value: [Value{tag, tensor: DT_FLOAT scalar, metadata}]}``."""
    tensor = b"\x08\x01" + _field(2, b"") + _field(4, struct.pack("<f", float(value)))
    value_msg = _field(1, tag.encode()) + _field(8, tensor) + _field(9, _SCALAR_METADATA)
    return _field(1, value_msg)


class EventWriter:
    """Scalars into one new event file in ``logdir`` (created)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{int(now)}.{socket.gethostname()}.{os.getpid()}.0.v2"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._f.write(record(_event(now, file_version=b"brain.Event:2")))
        self._f.flush()

    def scalars(self, step: int, values: dict[str, float]) -> None:
        """One event per value at ``step``, then a flush."""
        now = time.time()
        for tag, v in values.items():
            self._f.write(record(_event(now, step, summary=scalar_summary(tag, v))))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
