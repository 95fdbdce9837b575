"""leaniiorx/leaniiotx (reference leaniiorx.cc / leaniiotx.cc) with the
simulated AD936x backend, plus the PMP zero-copy descriptor transport
end-to-end into leanmlmrx (leanmlmrx.cc:353-376)."""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from leansdr_jax.util import ad936x, pmp

REPO = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}


def _run(mod, args, input=None, timeout=120):
    return subprocess.run([sys.executable, "-m", mod] + args,
                          input=input, capture_output=True,
                          timeout=timeout, env=ENV, cwd=str(REPO))


# -- rate planning / FIR configuration (hardware-independent core) ----------


def test_rate_plan_windows():
    assert not ad936x.plan_rate(2.5e6).use_fir
    assert not ad936x.plan_rate(61.44e6).use_fir
    p = ad936x.plan_rate(1e6)
    assert p.use_fir and p.factor == 4 and p.converter_fs == 4_000_000
    with pytest.raises(ad936x.RatePlanError):
        ad936x.plan_rate(62e6)          # leaniiorx.cc:222-223
    with pytest.raises(ad936x.RatePlanError):
        ad936x.plan_rate(400e3)         # needs FPGA decimation


def test_fir_config_string_roundtrip():
    taps = ad936x.quarter_band_taps()
    text = ad936x.fir_config("RX", 4, taps)
    assert text.startswith("RX 3 GAIN 0 DEC 4\n")
    d, f, back = ad936x.parse_fir_config(text)
    assert (d, f) == ("RX", 4)
    np.testing.assert_array_equal(back, taps)
    # TX filters below 64 taps are zero-padded (leaniiotx.cc:109-110)
    _, _, tx = ad936x.parse_fir_config(
        ad936x.fir_config("TX", 4, taps[:32]))
    assert len(tx) == 64 and not tx[:16].any() and not tx[-16:].any()


def test_quarter_band_response():
    t = ad936x.quarter_band_taps().astype(np.float64)
    H = 20 * np.log10(np.abs(np.fft.rfft(t / t.sum(), 4096)) + 1e-12)
    f = np.linspace(0, 0.5, len(H))
    assert abs(H[np.argmin(abs(f - 0.05))]) < 0.5      # passband flat
    assert H[(f > 0.2)].max() < -40                    # quarter-band image


# -- simulated capture / playback -------------------------------------------


def test_leaniiorx_tone_capture():
    r = _run("leansdr_jax.apps.leaniio",
             ["rx", "-s", "2.5e6", "--bufsize", "4096", "--count", "2",
              "--sim", "tone:100e3", "-v"])
    assert r.returncode == 0, r.stderr.decode()[-500:]
    iq = np.frombuffer(r.stdout, np.int16).reshape(-1, 2)
    assert len(iq) == 2 * 4096
    z = iq[:, 0].astype(np.float64) + 1j * iq[:, 1]
    fpk = np.argmax(np.abs(np.fft.fft(z))) / len(z) * 2.5e6
    assert abs(fpk - 100e3) < 2.5e6 / 4096
    assert b"Setting sampling rate 2500 kHz" in r.stderr


def test_leaniiorx_fir_decimator_low_rate():
    # 1 Msps requires the FIR /4 path: converter runs at 4 Msps, a tone
    # at 1.4 MHz (out of band after decimation) must come out attenuated.
    out_of_band = _run("leansdr_jax.apps.leaniio",
                       ["rx", "-s", "1e6", "--bufsize", "4096",
                        "--count", "2", "--sim", "tone:1.4e6", "-v"])
    in_band = _run("leansdr_jax.apps.leaniio",
                   ["rx", "-s", "1e6", "--bufsize", "4096",
                    "--count", "2", "--sim", "tone:100e3"])
    assert out_of_band.returncode == 0 and in_band.returncode == 0
    assert b"FIR decimator /4" in out_of_band.stderr
    a_stop = np.abs(np.frombuffer(out_of_band.stdout, np.int16)
                    .astype(np.float64)).mean()
    a_pass = np.abs(np.frombuffer(in_band.stdout, np.int16)
                    .astype(np.float64)).mean()
    assert len(out_of_band.stdout) == 2 * 4096 * 4   # decimated rate
    assert a_stop < a_pass / 30                      # stopband rejection


def test_leaniiorx_rejects_unplannable_rates():
    r = _run("leansdr_jax.apps.leaniio",
             ["rx", "-s", "100e6", "--sim", "tone:1e3"])
    assert r.returncode == 1 and b"too high" in r.stderr
    r = _run("leansdr_jax.apps.leaniio",
             ["rx", "-s", "100e3", "--sim", "tone:1e3"])
    assert r.returncode == 1 and b"FPGA decimation" in r.stderr


def test_leaniiotx_interpolator(tmp_path):
    # TX at 1 Msps engages the INT-4 FIR; the sink file holds the
    # 4 Msps converter-rate signal with the baseband tone preserved.
    sink = tmp_path / "dac.iq"
    n = 8192
    t = np.arange(n)
    iq = np.empty((n, 2), np.int16)
    iq[:, 0] = np.round(8000 * np.cos(2 * np.pi * 0.02 * t))
    iq[:, 1] = np.round(8000 * np.sin(2 * np.pi * 0.02 * t))
    r = _run("leansdr_jax.apps.leaniio",
             ["tx", "-s", "1e6", "--bufsize", "4096",
              "--sim", f"file:{sink}", "-v"], input=iq.tobytes())
    assert r.returncode == 0, r.stderr.decode()[-500:]
    assert b"FIR interpolator x4" in r.stderr
    out = np.frombuffer(sink.read_bytes(), np.int16).reshape(-1, 2)
    assert len(out) > 3 * n                          # ~4x samples
    z = out[:, 0].astype(np.float64) + 1j * out[:, 1]
    fpk = np.argmax(np.abs(np.fft.fft(z))) / len(z)
    assert abs(fpk - 0.005) < 2.0 / len(z)           # tone at 0.02/4


# -- PMP zero-copy transport -------------------------------------------------


def test_pmp_descriptor_wire_format():
    # 4 little-endian u64s, canary = first u64 of the buffer
    # (leaniiorx.cc:132-144, leanmlmrx.cc:359-369).
    assert pmp.DESC_SIZE == 32
    buf = struct.pack("<Q", 0xFEEDFACECAFEF00D) + b"x" * 56
    d = pmp.make_descriptor(buf, physaddr=0x10000)
    assert d.canary == 0xFEEDFACECAFEF00D and d.size == 64
    raw = d.pack()
    assert raw[:8] == struct.pack("<Q", pmp.PMP_MAGIC)
    back = pmp.parse(raw)
    assert (back.physaddr, back.size, back.canary) == \
        (0x10000, 64, 0xFEEDFACECAFEF00D)


def test_leaniiorx_pmp_publish_and_recycle(tmp_path):
    devmem = tmp_path / "cma"
    r = _run("leansdr_jax.apps.leaniio",
             ["rx", "-s", "2.5e6", "--bufsize", "1024", "--count", "6",
              "--nbufs", "4", "--pmp", "--devmem", str(devmem),
              "--sim", "tone:200e3"])
    assert r.returncode == 0, r.stderr.decode()[-500:]
    descs = [pmp.parse(r.stdout[i:i + pmp.DESC_SIZE])
             for i in range(0, len(r.stdout), pmp.DESC_SIZE)]
    assert len(descs) == 6
    # Fresh descriptors (the last ring generation) map and validate.
    samples = []
    for d in descs[2:]:
        buf = pmp.map_buffer(d, devmem=str(devmem))
        assert d.size == 1024 * 4
        samples.append(np.frombuffer(buf, np.int16).reshape(-1, 2))
    # Consecutive buffers continue the same tone phase (zero-copy data
    # is the actual stream, not repeated content).
    z = np.concatenate(samples)[:, 0].astype(np.float64)
    fpk = np.argmax(np.abs(np.fft.fft(z))) / len(z) * 2.5e6
    assert abs(fpk - 200e3) < 2.5e6 / len(z) * 2
    # Descriptor 0's slot was recycled by buffer 4: canary must fail.
    with pytest.raises(ValueError):
        pmp.map_buffer(descs[0], devmem=str(devmem))


def test_leanmlmrx_consumes_pmp(tmp_path):
    # leaniiorx --pmp | leanmlmrx --pmp: FM-modulate a tone, publish by
    # reference through the CMA stand-in, demodulate to audio.
    devmem = tmp_path / "cma"
    cap = tmp_path / "fm.iq"
    fs, fdev, tone = 2.5e6, 10e3, 500.0
    foff = 400e3                               # carrier at Fc + 400 kHz
    n = 1 << 17
    t = np.arange(n)
    phase = (2 * np.pi * foff * t / fs
             + (fdev / tone) * np.sin(2 * np.pi * tone * t / fs))
    iq = np.empty((n, 2), np.int16)
    iq[:, 0] = np.round(10000 * np.cos(phase))
    iq[:, 1] = np.round(10000 * np.sin(phase))
    cap.write_bytes(iq.tobytes())

    rx = subprocess.Popen(
        [sys.executable, "-m", "leansdr_jax.apps.leaniio",
         "rx", "-s", "2.5e6", "--bufsize", "16384", "--pmp",
         "--devmem", str(devmem), "--sim", f"file:{cap}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=ENV, cwd=str(REPO))
    descs, _ = rx.communicate(timeout=120)
    assert rx.returncode == 0
    assert len(descs) == 8 * pmp.DESC_SIZE

    # The stand-in ring recycles: keep only the live last generation
    # (consecutive buffers 4..7, a continuous stream slice).
    live = descs[-pmp.DESC_SIZE * 4:]
    fq = 2.5e6 / 64
    r = _run("leansdr_jax.apps.leanmlmrx",
             ["--fs", "2.5e6", "--fc", "98e6", "--fq", str(fq),
              "--fa", "0", "--pmp", "--devmem", str(devmem), "98.4"],
             input=live, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-800:]
    au = np.frombuffer(r.stdout, np.int8).astype(np.float64)
    assert len(au) >= 900
    # Audible 500 Hz tone dominates the demodulated audio.
    steady = au[len(au) // 4:]
    spec = np.abs(np.fft.rfft(steady - steady.mean()))
    fpk = np.argmax(spec) / len(steady) * fq
    assert abs(fpk - tone) < 100
