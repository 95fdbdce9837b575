"""Multi-carrier DVB-S fleet receiver CLI — the 64 x 2.4 Msps north-star
shape (BASELINE.json) as a product surface, not just a benchmark.

The reference has no multi-carrier DVB-S app (leandvb is single-carrier;
leanmlmrx channelizes FM, leanmlmrx.cc:47-118); on a device the natural
unit of work is a channel FLEET, so this app fronts MultiDvbsReceiver: N
independent carriers demodulated in one device batch (demod kernel +
device deconvolution/Viterbi) with the byte domain in the native C++
backend, software-pipelined via submit()/flush().

Input (stdin): sample-interleaved IQ — each frame is nchan * (I, Q) in
the selected format, i.e. the natural layout of a channelizer or of N
tuners DMA'd in lockstep.

Output (stdout): either a tagged multiplex (default) — per flush:
  [u32 chan][u32 npkts][npkts * 188 bytes]  (little-endian header)
— or per-channel files via --out-template 'out_%03d.ts'.

Flags shared with leandvb keep its exact names/semantics.
"""

import os
import struct
import sys

import numpy as np


def usage(code=0, f=sys.stderr):
    f.write(
        "Usage: leandvbfleet --nchan N [options]  < IQ  > MUX\n"
        "Demodulate N sample-interleaved DVB-S carriers in one device "
        "batch\n"
        "\nInput: --u8|--s8|--u16|--s16|--f32 (default f32), "
        "--float-scale F, -f FREQ\n"
        "DVB-S: --sr HZ --cr N/D --sampler S --viterbi --hq --fastlock\n"
        "       --exact-lut/--no-exact-lut --const C --tune FREQ\n"
        "       --acq   per-channel FFT coarse carrier search on the\n"
        "               first chunk; each channel is derotated by its\n"
        "               estimate (accelerator; not in the reference)\n"
        "       --segments S   time-segmented demod: split each chunk\n"
        "               into S lane-parallel segments (fills idle demod\n"
        "               lanes; approximate splices, TS-level parity)\n"
        "Output: --out-template PATTERN   per-channel files (printf-style"
        " %d)\n"
        "        (default: tagged multiplex [u32 chan][u32 npkts][TS] on"
        " stdout)\n"
        "Info:   --fd-info FD   per-channel lock/VBER lines (tagged "
        "text)\n")
    sys.exit(code)


def parse_args(argv):
    from ..pipelines.dvbs_rx import RxConfig
    from ._dvbs_flags import handle_dvbs_flag

    cfg = RxConfig()
    opts = {"input": "f32", "nchan": 0, "out_template": None,
            "fd_info": -1, "chunk": 1 << 16, "acq": False}
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-h":
            usage(0, sys.stdout)
        elif a == "--nchan":
            opts["nchan"] = int(val())
        elif a == "--chunk":
            opts["chunk"] = int(val())
        elif a == "--out-template":
            opts["out_template"] = val()
        elif a == "--fd-info":
            opts["fd_info"] = int(val())
        elif a == "--acq":
            opts["acq"] = True
        elif a in ("--u8", "--s8", "--u16", "--s16", "--f32"):
            opts["input"] = a[2:]
        elif handle_dvbs_flag(a, val, cfg):
            pass
        else:
            sys.stderr.write(f"leandvbfleet: unknown option {a}\n")
            usage(1)
        i += 1
    if opts["nchan"] <= 0:
        sys.stderr.write("leandvbfleet: --nchan is required\n")
        usage(1)
    return cfg, opts


_DTYPES = {
    "u8": (np.uint8, lambda a: (a.astype(np.float32) - 128.0)),
    "s8": (np.int8, lambda a: a.astype(np.float32)),
    "u16": (np.uint16, lambda a: (a.astype(np.float32) - 32768.0)),
    "s16": (np.int16, lambda a: a.astype(np.float32)),
    "f32": (np.float32, lambda a: a),
}


def main(argv=None):
    cfg, opts = parse_args(sys.argv[1:] if argv is None else argv)
    from ..pipelines.multi_rx import MultiDvbsReceiver
    from ..util.info import InfoWriter
    from ..util.jax_cache import setup_cache
    setup_cache()

    nchan = opts["nchan"]
    rx = MultiDvbsReceiver(cfg, nchan, chunk_samples=opts["chunk"],
                           segments=cfg.segments,
                           seg_warmup=cfg.seg_warmup,
                           seg_holdoff=cfg.seg_holdoff)
    dtype, tofloat = _DTYPES[opts["input"]]
    itemsize = np.dtype(dtype).itemsize
    frame_bytes = nchan * 2 * itemsize
    read_frames = opts["chunk"]

    info = None
    if opts["fd_info"] >= 0:
        info = InfoWriter(os.fdopen(opts["fd_info"], "w", buffering=1))

    outs = None
    mux = None
    if opts["out_template"]:
        outs = [open(opts["out_template"] % c, "wb")
                for c in range(nchan)]
    else:
        mux = sys.stdout.buffer

    def emit(batches):
        """batches: list of per-channel packet-array lists."""
        for per_chan in batches:
            for c, pkts in enumerate(per_chan):
                if not len(pkts):
                    continue
                if outs is not None:
                    outs[c].write(pkts.tobytes())
                else:
                    mux.write(struct.pack("<II", c, len(pkts)))
                    mux.write(pkts.tobytes())
        if mux is not None:
            mux.flush()

    src = sys.stdin.buffer
    import time
    next_info = 0.0
    while True:
        raw = src.read(read_frames * frame_bytes)
        if not raw:
            break
        n = len(raw) // frame_bytes
        if n == 0:
            break
        a = np.frombuffer(raw[:n * frame_bytes], dtype=dtype)
        iq = tofloat(a).reshape(n, nchan, 2).transpose(1, 0, 2)
        iq = np.ascontiguousarray(iq)
        if opts["acq"]:
            # Per-channel FFT coarse carrier search on the first chunk
            # (dsp/acquisition.py); each channel is then DEROTATED by
            # its estimate at ingest, which re-centers every carrier in
            # the shared PLL clamp window without per-channel clamp
            # state. Accelerator beyond the reference (SURVEY.md sec 6).
            opts["acq"] = False
            from ..dsp.acquisition import coarse_carrier_estimate
            from ..dsp.blocks import Rotator
            m = rx.cstln.nsymbols
            m = m if m in (2, 4, 8) else 4
            derots = []
            for c in range(nchan):
                est = coarse_carrier_estimate(iq[c], msymbols=m)
                derots.append(Rotator(-est) if abs(est) > 1e-4 else None)
            opts["derots"] = derots
        if opts.get("derots"):
            for c, rot in enumerate(opts["derots"]):
                if rot is None:
                    continue
                z = rot.process(iq[c, :, 0] + 1j * iq[c, :, 1])
                iq[c, :, 0] = z.real
                iq[c, :, 1] = z.imag
        emit(rx.submit(iq))
        # Info at ~1 Hz: metrics() fetches device state and would
        # otherwise serialize the submit() pipeline every chunk.
        if info and time.monotonic() >= next_info:
            next_info = time.monotonic() + 1.0
            locks = rx.locks
            info.f.write(f"FLEETLOCKS {int(np.sum(locks))}\n")
            m = rx.metrics()
            info.f.write(f"FLEETMER {m['mer_db'].min():.1f} "
                         f"{m['mer_db'].mean():.1f}\n")
            vb = int(np.sum(rx.vbitcount))
            if vb:
                info.f.write(
                    f"FLEETVBER {float(np.sum(rx.verrcount)) / vb:.6f}\n")
            info.flush()
    emit(rx.flush())
    if outs is not None:
        for f in outs:
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
