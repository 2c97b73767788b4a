"""H.264/AVC bitstream structures: NAL units, AVCDecoderConfigurationRecord,
length-prefixed NAL iteration.
(the port's copy of ``mixlab_tpu/av/avc.py``)

Byte-exact reimplementation of the reference's pure-Rust AVC layer:
  * NAL unit header parse/write — ``codec/src/avc/nal.rs:13-110``
  * DCR parse/write — ``codec/src/avc/dcr.rs:41-140``
  * length-prefixed NALU iterator — ``codec/src/avc/bitstream.rs:8-36``
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Iterator, List, Tuple


class AvcError(Exception):
    pass


class UnitType(IntEnum):
    NON_IDR_PICTURE = 1
    DATA_PARTITION_A = 2
    DATA_PARTITION_B = 3
    DATA_PARTITION_C = 4
    IDR_PICTURE = 5
    SEI = 6
    SEQUENCE_PARAMETER_SET = 7
    PICTURE_PARAMETER_SET = 8
    ACCESS_UNIT_DELIMITER = 9
    SEQUENCE_END = 10
    STREAM_END = 11
    FILLER_DATA = 12
    SPS_EXTENSION = 13
    PREFIX = 14
    SPS_SUBSET = 15
    NOT_AUXILIARY_CODED = 19
    CODED_SLICE_EXTENSION = 20

    @staticmethod
    def parse(value: int) -> "UnitType":
        if value in (16, 17, 18, 22, 23):
            raise AvcError(f"reserved NAL unit type {value}")
        try:
            return UnitType(value)
        except ValueError:
            raise AvcError(f"unknown NAL unit type {value}")


@dataclass(frozen=True)
class NalUnit:
    ref_idc: int
    kind: UnitType
    data: bytes  # RBSP

    @staticmethod
    def parse(buf: bytes) -> "NalUnit":
        if len(buf) < 1:
            raise AvcError("empty NAL unit")
        header = buf[0]
        if header >> 7:
            raise AvcError("forbidden_zero_bit set")
        return NalUnit(
            ref_idc=(header >> 5) & 0x03,
            kind=UnitType.parse(header & 0x1F),
            data=bytes(buf[1:]),
        )

    @property
    def byte_size(self) -> int:
        return 1 + len(self.data)

    def to_bytes(self) -> bytes:
        header = ((self.ref_idc & 0x03) << 5) | (int(self.kind) & 0x1F)
        return bytes([header]) + self.data


def iter_nal_units(data: bytes, nalu_size: int) -> Iterator[NalUnit]:
    """Iterate length-prefixed NAL units (avcc framing)."""
    pos = 0
    n = len(data)
    while pos < n:
        if n - pos < nalu_size:
            raise AvcError("truncated NALU length prefix")
        length = int.from_bytes(data[pos : pos + nalu_size], "big")
        pos += nalu_size
        if n - pos < length:
            raise AvcError("truncated NALU payload")
        yield NalUnit.parse(data[pos : pos + length])
        pos += length


def write_nal_units(units: List[NalUnit], nalu_size: int = 4) -> bytes:
    out = bytearray()
    for u in units:
        out += u.byte_size.to_bytes(nalu_size, "big")
        out += u.to_bytes()
    return bytes(out)


def split_annexb(data: bytes) -> List[bytes]:
    """Split an Annex B byte stream into raw NAL unit byte strings
    (start codes 00 00 01 / 00 00 00 01 removed)."""
    units = []
    i = 0
    n = len(data)
    start = None
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            if start is not None:
                end = i
                while end > start and data[end - 1] == 0:
                    end -= 1
                units.append(bytes(data[start:end]))
            i += 3
            start = i
        else:
            i += 1
    if start is not None and start < n:
        units.append(bytes(data[start:]))
    return units


def annexb_to_avcc(data: bytes, nalu_size: int = 4) -> Tuple[bytes, List[NalUnit]]:
    """Convert Annex B -> length-prefixed (avcc) bytes.  Returns
    (avcc_payload, parameter_sets) where parameter_sets collects any SPS/PPS
    found (used to build the DCR; they are excluded from the payload)."""
    payload = bytearray()
    params: List[NalUnit] = []
    for raw in split_annexb(data):
        if not raw:
            continue
        unit = NalUnit.parse(raw)
        if unit.kind in (UnitType.SEQUENCE_PARAMETER_SET, UnitType.PICTURE_PARAMETER_SET):
            params.append(unit)
            continue
        if unit.kind == UnitType.ACCESS_UNIT_DELIMITER:
            continue
        payload += len(raw).to_bytes(nalu_size, "big")
        payload += raw
    return bytes(payload), params


@dataclass
class DecoderConfigurationRecord:
    """AVCDecoderConfigurationRecord (ISO/IEC 14496-15 5.2.4.1)."""

    version: int = 1
    profile_indication: int = 0
    profile_compatibility: int = 0
    level_indication: int = 0
    nalu_size: int = 4
    sps: List[NalUnit] = field(default_factory=list)
    pps: List[NalUnit] = field(default_factory=list)

    @staticmethod
    def parse(buf: bytes) -> "DecoderConfigurationRecord":
        if len(buf) < 6:
            raise AvcError("DCR too short")
        version = buf[0]
        if version != 1:
            raise AvcError(f"unsupported DCR version {version}")
        profile_indication = buf[1]
        profile_compatibility = buf[2]
        level_indication = buf[3]
        nalu_size = (buf[4] & 0x03) + 1
        pos = 5
        sps_count = buf[pos] & 0x1F
        pos += 1
        sps = []
        for _ in range(sps_count):
            if len(buf) - pos < 2:
                raise AvcError("DCR truncated in SPS")
            (length,) = struct.unpack_from(">H", buf, pos)
            pos += 2
            if len(buf) - pos < length:
                raise AvcError("DCR truncated SPS payload")
            sps.append(NalUnit.parse(buf[pos : pos + length]))
            pos += length
        if len(buf) - pos < 1:
            raise AvcError("DCR truncated before PPS count")
        pps_count = buf[pos]
        pos += 1
        pps = []
        for _ in range(pps_count):
            if len(buf) - pos < 2:
                raise AvcError("DCR truncated in PPS")
            (length,) = struct.unpack_from(">H", buf, pos)
            pos += 2
            if len(buf) - pos < length:
                raise AvcError("DCR truncated PPS payload")
            pps.append(NalUnit.parse(buf[pos : pos + length]))
            pos += length
        return DecoderConfigurationRecord(
            version,
            profile_indication,
            profile_compatibility,
            level_indication,
            nalu_size,
            sps,
            pps,
        )

    def to_bytes(self) -> bytes:
        out = bytearray()
        out.append(self.version)
        out.append(self.profile_indication)
        out.append(self.profile_compatibility)
        out.append(self.level_indication)
        out.append(0xFC | ((self.nalu_size - 1) & 0x03))
        out.append(0xE0 | (len(self.sps) & 0x1F))
        for s in self.sps:
            out += struct.pack(">H", s.byte_size)
            out += s.to_bytes()
        out.append(len(self.pps))
        for p in self.pps:
            out += struct.pack(">H", p.byte_size)
            out += p.to_bytes()
        return bytes(out)
