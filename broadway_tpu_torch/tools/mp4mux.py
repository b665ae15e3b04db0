"""Minimal MP4 muxer for demuxer tests: wraps an Annex-B stream into an
ISO BMFF file (ftyp/mdat/moov with avc1+avcC sample entry), one sample
per access unit, 4-byte NAL length prefixes — the shape of the
reference's bundled clips (tree.mp4 / mozilla_story.mp4). The port's own
copy of ``tools/mp4mux.py``."""

from __future__ import annotations

import struct

from ..bitstream import bitreader as br


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + typ + payload


def _full(typ: bytes, payload: bytes, ver=0, flags=0) -> bytes:
    return _box(typ, struct.pack(">B", ver) +
                struct.pack(">I", flags)[1:] + payload)


def mux(annexb: bytes, width: int, height: int, fps: int = 30) -> bytes:
    sps_list, pps_list, samples = [], [], []
    cur = []
    for _, payload in br.split_nal_units(annexb):
        t = payload[0] & 0x1F
        if t == 7:
            sps_list.append(payload)
        elif t == 8:
            pps_list.append(payload)
        elif t in (1, 5):
            # new access unit if first_mb_in_slice == 0 (ue starting with 1)
            first_mb_zero = bool(payload[1] & 0x80)
            if first_mb_zero and cur:
                samples.append(cur)
                cur = []
            cur.append(payload)
    if cur:
        samples.append(cur)

    sample_data = []
    for s in samples:
        b = b"".join(struct.pack(">I", len(n)) + n for n in s)
        sample_data.append(b)
    mdat_payload = b"".join(sample_data)

    avcc = (bytes([1, sps_list[0][1], sps_list[0][2], sps_list[0][3],
                   0xFF, 0xE0 | len(sps_list)]) +
            b"".join(struct.pack(">H", len(s)) + s for s in sps_list) +
            bytes([len(pps_list)]) +
            b"".join(struct.pack(">H", len(p)) + p for p in pps_list))
    avc1 = _box(b"avc1",
                b"\x00" * 6 + struct.pack(">H", 1) +
                b"\x00" * 16 +
                struct.pack(">HH", width, height) +
                struct.pack(">II", 0x480000, 0x480000) +
                struct.pack(">I", 0) + struct.pack(">H", 1) +
                b"\x00" * 32 +
                struct.pack(">Hh", 0x18, -1) +
                _box(b"avcC", avcc))
    stsd = _full(b"stsd", struct.pack(">I", 1) + avc1)
    n = len(samples)
    timescale = fps * 1000
    delta = 1000
    stts = _full(b"stts", struct.pack(">III", 1, n, delta))
    stsc = _full(b"stsc", struct.pack(">I", 1) +
                 struct.pack(">III", 1, n, 1))
    stsz = _full(b"stsz", struct.pack(">II", 0, n) +
                 b"".join(struct.pack(">I", len(s)) for s in sample_data))
    stss = _full(b"stss", struct.pack(">II", 1, 1))

    # layout: ftyp + mdat + moov; chunk offset = after ftyp + mdat header
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomavc1")
    mdat = _box(b"mdat", mdat_payload)
    chunk_off = len(ftyp) + 8
    stco = _full(b"stco", struct.pack(">II", 1, chunk_off))
    stbl = _box(b"stbl", stsd + stts + stss + stsc + stsz + stco)
    vmhd = _full(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1)
    dref = _full(b"dref", struct.pack(">I", 1) +
                 _full(b"url ", b"", flags=1))
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", vmhd + dinf + stbl)
    hdlr = _full(b"hdlr", struct.pack(">I", 0) + b"vide" +
                 b"\x00" * 12 + b"VideoHandler\x00")
    dur = n * delta
    mdhd = _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, timescale, dur,
                                      0x55C4, 0))
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(b"tkhd",
                 struct.pack(">IIIII", 0, 0, 1, 0, dur) +
                 b"\x00" * 8 + struct.pack(">HHHH", 0, 0, 0, 0) +
                 struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                             0x40000000) +
                 struct.pack(">II", width << 16, height << 16), flags=7)
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(b"mvhd",
                 struct.pack(">IIIII", 0, 0, timescale, dur, 0x10000) +
                 struct.pack(">H", 0x100) + b"\x00" * 10 +
                 struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                             0x40000000) +
                 b"\x00" * 24 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)
    return ftyp + mdat + moov
