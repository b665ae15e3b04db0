"""MP4 (ISO BMFF) demuxer — mirror of the reference player's
Player/mp4.js (Bytestream :37, MP4Reader :227 box parser, Track :523
sample/chunk/offset/time maps, getSampleNALUnits :711).

Parses ftyp/moov/trak/mdia/minf/stbl (stsd/avc1/avcC, stts, stss, stsc,
stsz, stco) and exposes per-sample NAL units (4-byte length prefixes
stripped) plus the avcC parameter sets, ready to feed the decoder.

The port's own copy of ``broadway_tpu/player/mp4.py`` (host code only).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional


class Mp4Error(Exception):
    pass


class _Stream:
    def __init__(self, data: bytes, start: int = 0, end: int = None):
        self.data = data
        self.pos = start
        self.end = len(data) if end is None else end

    def remaining(self) -> int:
        return self.end - self.pos

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        v = struct.unpack_from(">H", self.data, self.pos)[0]
        self.pos += 2
        return v

    def u24(self) -> int:
        b = self.data[self.pos:self.pos + 3]
        self.pos += 3
        return (b[0] << 16) | (b[1] << 8) | b[2]

    def u32(self) -> int:
        v = struct.unpack_from(">I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from(">Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def fourcc(self) -> str:
        v = self.data[self.pos:self.pos + 4].decode("latin1")
        self.pos += 4
        return v

    def bytes(self, n: int) -> bytes:
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def skip(self, n: int) -> None:
        self.pos += n


@dataclasses.dataclass
class AvcC:
    profile: int
    profile_compat: int
    level: int
    nal_length_size: int
    sps: List[bytes]
    pps: List[bytes]


@dataclasses.dataclass
class Track:
    track_id: int = 0
    handler: str = ""
    timescale: int = 0
    duration: int = 0
    width: int = 0
    height: int = 0
    avcc: Optional[AvcC] = None
    stts: List[tuple] = dataclasses.field(default_factory=list)
    stss: List[int] = dataclasses.field(default_factory=list)
    stsc: List[tuple] = dataclasses.field(default_factory=list)
    stsz: List[int] = dataclasses.field(default_factory=list)
    stco: List[int] = dataclasses.field(default_factory=list)

    # -- derived sample maps (mirror Track methods in mp4.js :539-705) --

    @property
    def sample_count(self) -> int:
        return len(self.stsz)

    def sample_to_chunk(self, sample: int):
        """(chunk_index, offset_within_chunk) — mp4.js:572."""
        if not self.stsc:
            raise Mp4Error("no stsc")
        # stsc entries: (first_chunk(1-based), samples_per_chunk, desc_id)
        total = 0
        for i, (first, per, _d) in enumerate(self.stsc):
            last = self.stsc[i + 1][0] - 1 if i + 1 < len(self.stsc) else \
                None
            n_chunks_here = (last - first + 1) if last is not None else None
            if n_chunks_here is not None:
                n_samples_here = n_chunks_here * per
                if sample < total + n_samples_here:
                    k = (sample - total) // per
                    return first - 1 + k, (sample - total) % per
                total += n_samples_here
            else:
                k = (sample - total) // per
                return first - 1 + k, (sample - total) % per
        raise Mp4Error("sample out of range")

    def sample_offset(self, sample: int) -> int:
        chunk, idx = self.sample_to_chunk(sample)
        # first sample of the chunk
        first_sample = sample - idx
        off = self.stco[chunk]
        for s in range(first_sample, sample):
            off += self.stsz[s]
        return off

    def sample_size(self, sample: int) -> int:
        return self.stsz[sample]

    def time_to_sample(self, t: int) -> int:
        total_t = 0
        s = 0
        for count, delta in self.stts:
            if t < total_t + count * delta:
                return s + (t - total_t) // delta
            total_t += count * delta
            s += count
        return self.sample_count - 1

    def sample_nal_units(self, data: bytes, sample: int) -> List[bytes]:
        """Strip length prefixes (mp4.js:711 getSampleNALUnits)."""
        off = self.sample_offset(sample)
        end = off + self.sample_size(sample)
        ls = self.avcc.nal_length_size if self.avcc else 4
        out = []
        while off < end:
            if ls == 4:
                n = struct.unpack_from(">I", data, off)[0]
            elif ls == 2:
                n = struct.unpack_from(">H", data, off)[0]
            else:
                n = data[off]
            off += ls
            out.append(data[off:off + n])
            off += n
        return out


class MP4Reader:
    """Box-tree parser; collects video tracks."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.tracks: List[Track] = []
        self.timescale = 0
        self.duration = 0
        self.ftyp: Optional[str] = None

    def read(self) -> "MP4Reader":
        self._boxes(_Stream(self.data), None)
        return self

    @property
    def video_track(self) -> Optional[Track]:
        for t in self.tracks:
            if t.handler == "vide" or t.avcc is not None:
                return t
        return None

    # ------------------------------------------------------------------
    def _boxes(self, s: _Stream, trak: Optional[Track]) -> None:
        while s.remaining() >= 8:
            start = s.pos
            size = s.u32()
            typ = s.fourcc()
            if size == 1:
                size = s.u64()
            elif size == 0:
                size = s.remaining() + 8
            body_end = start + size
            self._box(s, typ, body_end, trak)
            s.pos = body_end

    def _box(self, s: _Stream, typ: str, end: int, trak) -> None:
        sub = _Stream(self.data, s.pos, end)
        if typ == "ftyp":
            self.ftyp = sub.fourcc()
        elif typ in ("moov", "mdia", "minf", "stbl"):
            self._boxes(sub, trak)
        elif typ == "mvhd":
            ver = sub.u8()
            sub.skip(3)
            if ver == 1:
                sub.skip(16)
                self.timescale = sub.u32()
                self.duration = sub.u64()
            else:
                sub.skip(8)
                self.timescale = sub.u32()
                self.duration = sub.u32()
        elif typ == "trak":
            t = Track()
            self.tracks.append(t)
            self._boxes(sub, t)
        elif typ == "tkhd" and trak is not None:
            ver = sub.u8()
            sub.skip(3)
            if ver == 1:
                sub.skip(16)
                trak.track_id = sub.u32()
                sub.skip(4 + 8)
            else:
                sub.skip(8)
                trak.track_id = sub.u32()
                sub.skip(4 + 4)
            sub.skip(8 + 2 + 2 + 2 + 2 + 36)
            trak.width = sub.u32() >> 16
            trak.height = sub.u32() >> 16
        elif typ == "mdhd" and trak is not None:
            ver = sub.u8()
            sub.skip(3)
            if ver == 1:
                sub.skip(16)
                trak.timescale = sub.u32()
                trak.duration = sub.u64()
            else:
                sub.skip(8)
                trak.timescale = sub.u32()
                trak.duration = sub.u32()
        elif typ == "hdlr" and trak is not None:
            sub.skip(4 + 4)
            trak.handler = sub.fourcc()
        elif typ == "stsd" and trak is not None:
            sub.skip(4)
            n = sub.u32()
            for _ in range(n):
                e_start = sub.pos
                e_size = sub.u32()
                e_type = sub.fourcc()
                if e_type in ("avc1", "avc3"):
                    sub.skip(6 + 2 + 2 + 2 + 12)
                    sub.skip(2 + 2)          # width/height (use tkhd)
                    sub.skip(4 + 4 + 4 + 2 + 32 + 2 + 2)
                    # nested boxes until avcC
                    inner = _Stream(self.data, sub.pos, e_start + e_size)
                    while inner.remaining() >= 8:
                        bsz = inner.u32()
                        btyp = inner.fourcc()
                        if btyp == "avcC":
                            trak.avcc = self._avcc(
                                _Stream(self.data, inner.pos,
                                        inner.pos + bsz - 8))
                            break
                        inner.skip(bsz - 8)
                sub.pos = e_start + e_size
        elif typ == "stts" and trak is not None:
            sub.skip(4)
            n = sub.u32()
            trak.stts = [(sub.u32(), sub.u32()) for _ in range(n)]
        elif typ == "stss" and trak is not None:
            sub.skip(4)
            n = sub.u32()
            trak.stss = [sub.u32() for _ in range(n)]
        elif typ == "stsc" and trak is not None:
            sub.skip(4)
            n = sub.u32()
            trak.stsc = [(sub.u32(), sub.u32(), sub.u32())
                         for _ in range(n)]
        elif typ == "stsz" and trak is not None:
            sub.skip(4)
            uniform = sub.u32()
            n = sub.u32()
            if uniform:
                trak.stsz = [uniform] * n
            else:
                trak.stsz = [sub.u32() for _ in range(n)]
        elif typ == "stco" and trak is not None:
            sub.skip(4)
            n = sub.u32()
            trak.stco = [sub.u32() for _ in range(n)]
        # mdat and unknown boxes are skipped (samples read by offset)

    @staticmethod
    def _avcc(s: _Stream) -> AvcC:
        s.skip(1)  # configurationVersion
        profile = s.u8()
        compat = s.u8()
        level = s.u8()
        nal_len = (s.u8() & 3) + 1
        n_sps = s.u8() & 31
        sps = []
        for _ in range(n_sps):
            ln = s.u16()
            sps.append(s.bytes(ln))
        n_pps = s.u8()
        pps = []
        for _ in range(n_pps):
            ln = s.u16()
            pps.append(s.bytes(ln))
        return AvcC(profile, compat, level, nal_len, sps, pps)
