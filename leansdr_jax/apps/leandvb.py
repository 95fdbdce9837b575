"""leandvb-compatible DVB-S receiver CLI (reference leandvb.cc:974-1221).

Usage: python -m leansdr_jax.apps.leandvb [options] < IQ > TS
Flags mirror the reference 1:1 (the bench scripts depend on them).
"""

import os
import sys

import numpy as np


def usage(code=0, f=sys.stderr):
    f.write(
        "Usage: leandvb [options]  < IQ  > TS\n"
        "Demodulate DVB-S I/Q on stdin, output MPEG packets on stdout\n"
        "\nInput options:\n"
        "  --u8, --s8, --u16, --s16, --f32   Input format (default u8)\n"
        "  --float-scale FLOAT     Scaling factor for float data\n"
        "  -f FREQ                 Sampling rate (Hz)\n"
        "  --loop                  Repeat input file forever\n"
        "\nPreprocessing options:\n"
        "  --awgn STDDEV           Add white gaussian noise\n"
        "  --anf INT               Number of birdies to remove (default 0)\n"
        "  --derotate FREQ         Shift frequency (Hz)\n"
        "  --resample              Lowpass and decimate to ~4 sps\n"
        "  --resample-rej FLOAT    Lowpass rejection (default 10)\n"
        "  --decim INT             Decimate by INT\n"
        "  --cnr                   Measure CNR\n"
        "\nDVB-S options:\n"
        "  --sr SYMBOLRATE         Symbol rate (Hz, default 2e6)\n"
        "  --tune FREQ             Bias frequency for acquisition (Hz)\n"
        "  --drift                 Follow carrier beyond safe limits\n"
        "  --standard S            DVB-S (default) or DVB-S2\n"
        "  --const C               Constellation (QPSK, BPSK, ... )\n"
        "  --cr N/D                Code rate (default 1/2)\n"
        "  --sampler S             nearest, linear (default), rrc\n"
        "  --rrc-steps INT         RRC oversampling\n"
        "  --rrc-rej FLOAT         RRC filter rejection (default 30)\n"
        "  --roll-off FLOAT        RRC roll-off (default 0.35)\n"
        "  --hard-metric           Use Hamming metric\n"
        "  --exact-lut             Bit-exact LUT decisions (default on CPU)\n"
        "  --no-exact-lut          Computed decisions / demod kernel "
        "(default on GPU)\n"
        "  --fastlock              Synchronize more aggressively\n"
        "  --acq                   FFT coarse carrier search on the\n"
        "                          first chunk seeds --tune (additive\n"
        "                          accelerator; not in the reference)\n"
        "  --viterbi               Use Viterbi decoding\n"
        "  --hq                    --fastlock --viterbi --sampler rrc\n"
        "  --segments S            Time-segmented demod: S lane-parallel\n"
        "                          segments per chunk (GPU accelerator;\n"
        "                          approximate splices, TS-level parity)\n"
        "\nUI options:\n"
        "  --fd-info FDNUM         Info messages to file descriptor\n"
        "  --fd-const FDNUM        Constellation to file descriptor\n"
        "  --fd-spectrum FDNUM     Spectrum to file descriptor\n"
        "  --fd-pp FDNUM           Dump preprocessed IQ data to fd\n"
        "  --duration FLOAT        Width of timeline plot (s) [no-op:\n"
        "                          GUI replaced by the fd streams]\n"
        "  --json                  JSON format for aux outputs\n"
        "  --version               Display version and exit\n"
        "  -v, -d                  Verbose / debug\n")
    sys.exit(code)


def parse_args(argv):
    from ..pipelines.dvbs_rx import RxConfig
    from ._dvbs_flags import handle_dvbs_flag

    cfg = RxConfig(anf=1)     # leandvb default anf=1 (leandvb.cc:103)
    opts = {
        "input": "u8", "loop": False, "fd_info": -1, "fd_const": -1,
        "fd_spectrum": -1, "json": False, "verbose": False, "debug": False,
        "hs": False, "hdlc": False, "packetized": False, "buf_factor": 4,
        "Finfo": 5.0, "standard": "DVB-S", "acq": False, "debug2": False,
    }
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i]

        if a == "-h":
            usage(0, sys.stdout)
        elif a == "--version":
            # leandvb.cc:1073-1075 (prints VERSION and exits).
            from .. import __version__
            print(f"leansdr-jax-{__version__}")
            sys.exit(0)
        elif a == "-v":
            opts["verbose"] = True
        elif a == "-d":
            # Second -d promotes to debug2 (leandvb.cc:1068-1071).
            opts["debug2"] = opts["debug"]
            opts["debug"] = True
            cfg.debug = True
        elif a == "--u8":
            opts["input"] = "u8"
        elif a in ("--s8", "--char"):
            opts["input"] = "s8"
        elif a == "--u16":
            opts["input"] = "u16"
        elif a == "--s16":
            opts["input"] = "s16"
        elif a == "--f32":
            opts["input"] = "f32"
        elif a == "--derotate":
            cfg.Fderot = float(val())
        elif a == "--loop":
            opts["loop"] = True
        elif a == "--awgn":
            cfg.awgn = float(val())
        elif a == "--anf":
            cfg.anf = int(val())
        elif a == "--cnr":
            cfg.cnr = True
        elif a == "--resample":
            cfg.resample = True
        elif a == "--resample-rej":
            cfg.resample_rej = float(val())
        elif a == "--decim":
            cfg.decim = int(val())
        elif a == "--standard":
            opts["standard"] = val()
        elif a == "--hard-metric":
            cfg.hard_metric = True
        elif a == "--hs":
            opts["hs"] = True
        elif a == "--hdlc":
            opts["hdlc"] = True
        elif a == "--packetized":
            opts["packetized"] = True
        elif a == "--fd-info":
            opts["fd_info"] = int(val())
        elif a == "--fd-const":
            opts["fd_const"] = int(val())
        elif a == "--fd-spectrum":
            opts["fd_spectrum"] = int(val())
        elif a == "--fd-pp":
            cfg.fd_pp = int(val())
        elif a == "--duration":
            # GUI timeline width in seconds (leandvb.cc:83,128,1176);
            # accepted for flag parity — the GUI is replaced by the fd
            # streams, so it has no effect here.
            val()
        elif a == "--json":
            opts["json"] = True
        elif a == "--buf-factor":
            opts["buf_factor"] = int(val())
        elif a == "--inpipe" or a == "--inbuf":
            val()   # accepted, no-op (host buffering is adaptive)
        elif a == "--acq":
            opts["acq"] = True
        elif a == "--gui" or a == "--linger" or a == "--filler":
            pass    # GUI replaced by the fd-info/const/spectrum streams
        elif a == "--nhelpers":
            val()
        elif handle_dvbs_flag(a, val, cfg):
            pass    # shared DVB-S flags (_dvbs_flags.py)
        else:
            usage(1)
        i += 1
    if opts["fd_spectrum"] >= 0:
        cfg.want_spectrum = True
    if opts["hs"]:
        if opts["input"] != "u8":
            print("** --hs requires u8 input (fast_qpsk_receiver is "
                  "a u8 pipeline, sdr.h:946)", file=sys.stderr)
            sys.exit(1)
        cfg.hs = True
        cfg.anf = 0
    if opts["fd_const"] >= 0:
        cfg.want_const = True
    if opts["hdlc"]:
        cfg.hdlc = True
        cfg.packetized = opts["packetized"]
    return cfg, opts


def main(argv=None):
    from ..pipelines.dvbs_rx import DvbsReceiver
    from ..util.iofmt import read_iq
    from ..util import info as info_mod
    from ..util.jax_cache import setup_cache

    cfg, opts = parse_args(sys.argv[1:] if argv is None else argv)
    setup_cache()
    rx = DvbsReceiver(cfg)

    if opts["debug"]:
        # Glyph legend (leandvb.cc:700-713).
        if not cfg.hdlc:
            sys.stderr.write(
                "Output:\n"
                "  '_': packet received without errors\n"
                "  '.': error-corrected packet\n"
                "  '!': packet with remaining errors\n")
        else:
            sys.stderr.write(
                "Output:\n"
                "  '_': HDLC frame with correct checksum\n"
                "  '!': HDLC frame with invalid checksum\n"
                "  '^': HDLC framing error\n")

    info = None
    if opts["fd_info"] >= 0:
        info = info_mod.InfoWriter(opts["fd_info"], opts["json"])
        bits_in, bits_out = __import__(
            "leansdr_jax.fec.convenc", fromlist=["FEC_SPECS"]
        ).FEC_SPECS[cfg.rate]
        info.initial(opts["standard"], rx.cstln.name,
                     f"{bits_in}/{bits_out}", cfg.Fm)
    constw = None
    if opts["fd_const"] >= 0:
        constw = info_mod.ConstWriter(opts["fd_const"], opts["json"])
        constw.const(rx.cstln.symbols)
    specw = None
    if opts["fd_spectrum"] >= 0:
        specw = info_mod.SpectrumWriter(opts["fd_spectrum"], opts["json"])

    itemsize = {"u8": 2, "s8": 2, "u16": 4, "s16": 4, "f32": 8}[opts["input"]]
    stdin = sys.stdin.buffer
    out = sys.stdout.buffer
    CHUNK_BYTES = (1 << 17) * itemsize

    meas_sent = {"freq": 0, "ss": 0, "mer": 0, "cnr": 0}
    locktime_sent = 0
    spectrum_sent = 0

    def flush_info():
        nonlocal locktime_sent, spectrum_sent
        if info:
            n = len(rx.meas["freq"])
            for k in range(meas_sent["freq"], n):
                # freq_tap is cycles/sample at the POST-decimation rate
                info.freq(rx.meas["freq"][k], scale=rx.Fs_eff)
                info.ss(rx.meas["ss"][k])
                info.mer(rx.meas["mer"][k])
            meas_sent["freq"] = n
            for k in range(meas_sent["cnr"], len(rx.meas["cnr"])):
                info.cnr(rx.meas["cnr"][k])
            meas_sent["cnr"] = len(rx.meas["cnr"])
            for st in rx.mpeg.lock_events:
                info.lock(st)
            rx.mpeg.lock_events.clear()
            if rx.mpeg.locktime_count > locktime_sent:
                info.locktime(rx.mpeg.locktime)
                locktime_sent = rx.mpeg.locktime_count
            if rx.vbitcount:
                info.vber(rx.vber)
            info.flush()
        if specw:
            for line in rx.spectrum_lines[spectrum_sent:]:
                specw.spectrum(line)
            spectrum_sent = len(rx.spectrum_lines)
        if constw:
            pts = getattr(rx, "sampled_points", [])
            while len(pts) >= 128:
                constw.symbols(pts[:128])
                del pts[:128]

    while True:
        raw = stdin.read(CHUNK_BYTES)
        if not raw:
            if opts["loop"]:
                # file_reader.loop: lseek to 0 on EOF (generic.h:59-63)
                try:
                    stdin.seek(0)
                    continue
                except OSError:
                    break
            break
        nitems = len(raw) // itemsize * itemsize
        iq = read_iq(raw[:nitems], opts["input"])
        if opts["acq"]:
            # FFT coarse carrier search (dsp/acquisition.py): estimate
            # the offset on the first chunk and rebuild the receiver
            # with --tune seeded, so the PLL clamp window is centered on
            # the actual carrier. Additive accelerator — the reference
            # has no coarse search (SURVEY.md section 6).
            opts["acq"] = False
            from ..dsp.acquisition import coarse_carrier_estimate
            m = rx.cstln.nsymbols
            m = m if m in (2, 4, 8) else 4
            est = coarse_carrier_estimate(iq, msymbols=m)
            cfg.Ftune += est * cfg.Fs
            if opts["verbose"]:
                print(f"coarse acquisition: {est * cfg.Fs:+.0f} Hz",
                      file=sys.stderr)
            rx = DvbsReceiver(cfg)
        ts = rx.process(iq)
        if cfg.hdlc:
            frames = getattr(rx, "hdlc_frames", None)
            if frames is not None and len(frames):
                out.write(frames.tobytes())
                out.flush()
                rx.hdlc_frames = frames[:0]
        elif len(ts):
            out.write(ts.tobytes())
            out.flush()
        flush_info()
    flush_info()
    return 0


if __name__ == "__main__":
    sys.exit(main())
