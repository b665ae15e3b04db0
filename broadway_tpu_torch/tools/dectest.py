#!/usr/bin/env python3
"""Conformance testbench CLI of the port — mirror of the reference's
Decoder/src/DecTestBench.c (golden YUV writer), counterpart of
``tools/dectest.py``:

  python3 -m broadway_tpu_torch.tools.dectest [-Nn] [-Ooutfile] [-P] [-U] \\
             [-C] [-R] [-T] [-B device] file.h264

  -Nn      stop after n pictures
  -Ofile   output file (default out_wXXXhYYY.yuv); -Onone: no output
  -P       packet-by-packet mode (one NAL per Decode call)
  -U       NAL-unit stream mode (no start codes)
  -C       write cropped output
  -R       disable output reordering
  -T       API-call trace to dec_api.trc (DecTestBench.c:115 / the
           H264SwDecTrace example sink, Broadway.c:755-772)
  -B       device: cuda (default; fails without a card) or cpu
"""

import sys

import numpy as np

from ..api import DecRet, H264Decoder
from ..bitstream import bitreader as br


def main(argv):

    n_max = 0
    outfile = None
    packetize = nal_mode = crop = no_reorder = trace = False
    device = "cuda"
    fname = None
    i = 1
    while i < len(argv):
        a = argv[i]
        if a.startswith("-N"):
            n_max = int(a[2:])
        elif a.startswith("-O"):
            outfile = a[2:]
        elif a == "-P":
            packetize = True
        elif a == "-U":
            nal_mode = True
        elif a == "-C":
            crop = True
        elif a == "-R":
            no_reorder = True
        elif a == "-T":
            trace = True
        elif a == "-B":
            i += 1
            device = argv[i]
        else:
            fname = a
        i += 1
    if fname is None:
        print(__doc__)
        return 1

    with open(fname, "rb") as f:
        data = f.read()

    trc = open("dec_api.trc", "w") if trace else None
    dec = H264Decoder(
        no_output_reordering=no_reorder, device=device,
        trace=(lambda s: trc.write(s + "\n")) if trace else None)

    if packetize or nal_mode:
        packets = []
        for k, (off, payload) in enumerate(br.split_nal_units(data)):
            packets.append(payload if nal_mode
                           else b"\x00\x00\x00\x01" + payload)
    else:
        packets = None

    fout = None
    n_pics = 0
    errors = 0

    def emit(pic):
        nonlocal fout, n_pics
        if outfile == "none":
            n_pics += 1
            return
        if crop and pic.crop:
            l, r, t, b = pic.crop
            y = pic.frame.y[t:pic.height - b, l:pic.width - r]
            cb = pic.frame.cb[t // 2:(pic.height - b) // 2,
                              l // 2:(pic.width - r) // 2]
            cr = pic.frame.cr[t // 2:(pic.height - b) // 2,
                              l // 2:(pic.width - r) // 2]
            buf = (np.asarray(y).astype(np.uint8).tobytes() +
                   np.asarray(cb).astype(np.uint8).tobytes() +
                   np.asarray(cr).astype(np.uint8).tobytes())
            w, h = pic.width - l - r, pic.height - t - b
        else:
            buf = pic.output_picture
            w, h = pic.width, pic.height
        if fout is None:
            name = outfile or f"out_w{w}h{h}.yuv"
            fout = open(name, "wb")
        fout.write(buf)
        n_pics += 1

    def drain(flush=False):
        nonlocal errors
        while True:
            pic = dec.next_picture(flush=flush)
            if pic is None:
                return False
            errors += pic.nbr_of_err_mbs
            emit(pic)
            if n_max and n_pics >= n_max:
                return True

    done = False
    if packets is not None:
        for p in packets:
            ret, _ = dec.decode(p, nal_unit_stream=nal_mode)
            if ret in (DecRet.PIC_RDY, DecRet.PIC_RDY_BUFF_NOT_EMPTY):
                if drain():
                    done = True
                    break
    else:
        buf = data
        while buf and not done:
            ret, used = dec.decode(buf)
            if ret in (DecRet.PIC_RDY, DecRet.PIC_RDY_BUFF_NOT_EMPTY):
                if drain():
                    done = True
            if used <= 0:
                break
            buf = buf[used:]

    if not done:
        drain(flush=True)
    if fout:
        fout.close()
    if trc:
        trc.close()
    info = dec.get_info()
    if info:
        print(f"Width {info.pic_width} Height {info.pic_height}")
    print(f"{n_pics} pictures decoded, {errors} concealed MBs")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
