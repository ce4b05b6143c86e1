"""Dependency-free TensorBoard scalar and text event writer: the port's copy
of ``w2v2_speaker_tpu/runtime/tb_writer.py``.

It hand-encodes the two small protobuf messages that TensorBoard scalars
need (Event and Summary of TensorFlow's event.proto and summary.proto) and
frames them as TFRecords with a masked CRC32C, so ``tensorboard --logdir``
reads the files, with no TensorFlow or tensorboard package installed.

Wire format notes:
- protobuf: varint keys `(field_number << 3) | wire_type`; doubles are
  wire-type 1 (64-bit LE), floats wire-type 5 (32-bit LE), strings and
  sub-messages wire-type 2 (length-delimited), ints wire-type 0 (varint).
- TFRecord: u64le(len) + u32le(maskedcrc(len bytes)) + data +
  u32le(maskedcrc(data)); mask(crc) = ((crc >> 15 | crc << 17) + 0xa282ead8).
- CRC32C is the Castagnoli polynomial (0x82f63b78 reflected), NOT zlib's.
"""

from __future__ import annotations

import os
import pathlib
import socket
import struct
import time
from typing import Union

__all__ = ["TensorBoardWriter"]

# ------------------------------------------------------------------- crc32c

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------------ protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, value: Union[bytes, str]) -> bytes:
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _key(field, 2) + _varint(len(value)) + value


def _scalar_event(step: int, tag: str, value: float, wall_time: float) -> bytes:
    # Summary.Value { tag = 1, simple_value = 2 }
    sv = _f_bytes(1, tag) + _f_float(2, float(value))
    # Summary { repeated Value value = 1 }
    summary = _f_bytes(1, sv)
    # Event { wall_time = 1, step = 2, summary = 5 }
    return _f_double(1, wall_time) + _f_varint(2, int(step)) + _f_bytes(
        5, summary
    )


def _text_event(step: int, tag: str, text: str, wall_time: float) -> bytes:
    """TensorBoard text-plugin event (the reference logs tracked-sample
    transcriptions as text, speech_recognition_module.py:249-288).

    Summary.Value { tag=1, tensor=8, metadata=9 } where the tensor is a
    rank-1 DT_STRING TensorProto and the metadata routes it to the "text"
    plugin with DATA_CLASS_TENSOR."""
    # TensorProto { dtype = 1 (DT_STRING = 7), tensor_shape = 2,
    #               repeated bytes string_val = 8 }
    shape = _f_bytes(2, _f_varint(1, 1))  # TensorShapeProto.Dim { size = 1 }
    tensor = _f_varint(1, 7) + _f_bytes(2, shape) + _f_bytes(8, text)
    # SummaryMetadata { plugin_data = 1 { plugin_name = 1 },
    #                   data_class = 4 (DATA_CLASS_TENSOR = 2) }
    metadata = _f_bytes(1, _f_bytes(1, "text")) + _f_varint(4, 2)
    sv = _f_bytes(1, tag) + _f_bytes(8, tensor) + _f_bytes(9, metadata)
    summary = _f_bytes(1, sv)
    return _f_double(1, wall_time) + _f_varint(2, int(step)) + _f_bytes(
        5, summary
    )


def _version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1, file_version = 3 }
    return _f_double(1, wall_time) + _f_bytes(3, "brain.Event:2")


class TensorBoardWriter:
    """Minimal SummaryWriter: `add_scalar` + `add_text`."""

    def __init__(self, log_dir: Union[str, pathlib.Path]):
        log_dir = pathlib.Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname()
        fname = f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}.0"
        self._f = open(log_dir / fname, "wb")
        self._record(_version_event(time.time()))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_scalar_event(step, tag, value, time.time()))

    def add_text(self, tag: str, text: str, step: int) -> None:
        self._record(_text_event(step, tag, text, time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()
