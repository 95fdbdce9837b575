"""Time-segmented demod (MultiDvbsReceiver(segments=S), docs/PERF.md
"Segmented demod"): each channel's chunk is demodulated as S
lane-parallel segments, two-pass (precursor seeds + emit) with
per-segment persistent state. Acceptance is TS-level: on clean signal
the segmented receiver must decode BYTE-IDENTICAL TS output to the
sequential one (the emit trajectories are near-sequential-exact); under
noise, the same packet set after lock.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from leansdr_jax.pipelines import tsgen, dvbs_tx
from leansdr_jax.pipelines.dvbs_rx import RxConfig
from leansdr_jax.pipelines.multi_rx import MultiDvbsReceiver


def _stimulus(nchan, npackets, rate="1/2"):
    iqs, payloads = [], []
    for c in range(nchan):
        pkts = tsgen.generate(npackets, start=1000 * c)
        iq = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate=rate, interp=2))
        iqs.append(iq)
        payloads.append(pkts)
    n = min(len(q) for q in iqs)
    return np.stack([q[:n] for q in iqs]), payloads


def _run(rx, x, chunk, ra):
    outs = [np.empty((0, 188), np.uint8)] * rx.nchan
    n = (x.shape[1] - ra) // chunk * chunk
    for o in range(0, n, chunk):
        res = rx.process(jnp.asarray(x[:, o:o + chunk + ra]))
        outs = [np.concatenate([a, b]) for a, b in zip(outs, res)]
    return outs


def _assert_zero_loss(seq, seg, tag=""):
    """The PERF.md claim, verbatim: the segmented receiver decodes
    every packet the sequential one does (ZERO packet loss).  Superset,
    not equality: the sequential trajectory can hit a symbol-timing
    slip of its own (mu hovers at the emit threshold; the deconv/mpeg
    machinery resyncs, reference dvb.h:428-454) and lose packets the
    segmented trajectory keeps — observed on the CPU-numerics path.
    When neither side slips the outputs are byte-identical."""
    sseq = {bytes(r) for r in seq}
    sseg = {bytes(r) for r in seg}
    missing = sseq - sseg
    assert not missing, \
        f"{tag}: segmented lost {len(missing)}/{len(sseq)} packets"
    assert len(seg) >= len(seq), (tag, len(seg), len(seq))
    assert len(seg) <= len(seq) + 20, \
        f"{tag}: segmented over-produced ({len(seg)} vs {len(seq)})"


def test_segmented_demod_matches_sequential_ts():
    """segments=4 through the full fast path (matched filter + demod +
    deconv sync election): decodes the same TS packets as segments=1."""
    C, CH, S = 2, 1 << 15, 4
    x, payloads = _stimulus(C, npackets=220)
    x = x * np.float32(75.0)
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True,
                   float_scale=75.0, exact_lut=False, sampler="rrc")
    rx1 = MultiDvbsReceiver(cfg, C, use_pallas=False, chunk_samples=CH)
    rxs = MultiDvbsReceiver(cfg, C, use_pallas=False, chunk_samples=CH,
                            segments=S, seg_warmup=2048)
    assert rx1.mf_taps is not None          # mf branch is covered
    ra = rx1.params.readahead + len(rx1.mf_taps) - 1
    out1 = _run(rx1, x, CH, ra)
    outs = _run(rxs, x, CH, ra)
    for c in range(C):
        assert len(out1[c]) >= 100, f"sequential ch{c}: {len(out1[c])}"
        _assert_zero_loss(out1[c], outs[c], f"ch{c}")
        # Payload verification: output rows are real TX packets.
        hits = sum(1 for o in outs[c]
                   if (payloads[c] == o).all(axis=1).any())
        assert hits >= 0.95 * len(outs[c]), f"ch{c}: {hits}/{len(outs[c])}"


def test_segmented_pallas_interpret_matches_sequential_ts():
    """The kernel branch of the segmented demod ([NSTATE, lanes] plane
    state, pass-1/pass-2 lanes, derotated carry) in the Pallas
    interpreter: segments=8 decodes byte-for-byte the TS of the
    sequential kernel receiver, after seg_holdoff=1 chunk."""
    C, CH, S = 2, 1 << 15, 8
    x, payloads = _stimulus(C, npackets=160)
    x = x * np.float32(75.0)
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True,
                   float_scale=75.0, exact_lut=False, sampler="rrc")
    rx1 = MultiDvbsReceiver(cfg, C, use_pallas=True, chunk_samples=CH)
    rxs = MultiDvbsReceiver(cfg, C, use_pallas=True, chunk_samples=CH,
                            segments=S, seg_warmup=2048, seg_holdoff=1)
    assert rx1.use_pallas and rx1._interpret
    ra = rx1.params.readahead + len(rx1.mf_taps) - 1
    out1 = _run(rx1, x, CH, ra)
    outs = _run(rxs, x, CH, ra)
    assert rxs._seg_state is not None           # the segmented path ran
    for c in range(C):
        assert len(out1[c]) >= 60, f"sequential ch{c}: {len(out1[c])}"
        np.testing.assert_array_equal(outs[c], out1[c], f"ch{c}")
        hits = sum(1 for o in outs[c]
                   if (payloads[c] == o).all(axis=1).any())
        assert hits >= 0.95 * len(outs[c]), f"ch{c}: {hits}/{len(outs[c])}"


# Boundary overlap windows of the 64-channel rate-1/2 fleet on an H100
# (first segmented chunk): the outgoing segment's owned tail, the
# incoming segment's prefix, and the sequential receiver over the same
# rows ('.' = no emission, digit = symbol). Both trajectories slip
# their emission parity, and the incoming one starts one symbol into a
# run of equal symbols, which a row-level anchor splice cut one symbol
# short.
_SPLICE_WINDOWS = {
    "run_of_ones": (
        "1.11.1.3..3.22.3.2.0.3.0..0.2.2.3.2.1.2.3.2.0.0.1.2.3.02.3.0.2.0"
        ".0.2.0.0..3.2.2.0.3.1.3.0.3.3.1.1.01.1.0.2..3.3.13.2.1.2.0.0.0..",
        ".1.1.1.3.3..22.3.2.0.3.0.0..2.2.3.2.1.2.3.2.00.1..2.30.2.3.0.2.0"
        ".0.2.0.0..3.2.2.0.3.1.3.0.3.3.1.1.01.1.0.2.3..3.13.2.1.2.0.0.0..",
        "1.11.1.3..3.22.3.2.0.3.0..0.2.2.3.2.1.2.3.2.0.0.1.2.3.02.3.0.2.0"
        ".0.2.0.0..3.2.2.0.3.1.3.0.3.3.1.1.01.1.0.2..3.3.13.2.1.2.0.0.0.."),
    "run_of_zeros": (
        "0.0.1.1.3.2.1.0.1.3.1.1.2.3.2.1.2.31.2.3.2.2.1.1.1.3.1.2.0.1.0.2"
        "..2.3.12.3.1.0..1.3.3.0.2.0.11.0.1.1.0..1.2.1.0.2.2.2.1.0.1.0.23",
        ".0..1.1.3.2.1.0.1.3.1.1.2.3.2.1.2.31.2.3.2.2.1.1.1.3.1.2.0.1.0.2"
        "..2.3.12.3.1.0..1.3.3.0.2.0.1.10.1.1.0..1.2.1.0.2.2.2.1.0.1.0.23",
        "0.0.1.1.3.2.1.0.1.3.1.1.2.3.2.1.2.31.2.3.2.2.1.1.1.3.1.2.0.1.0.2"
        "..2.3.12.3.1.0..1.3.3.0.2.0.11.0.1.1.0..1.2.1.0.2.2.2.1.0.1.02.3"),
}


@pytest.mark.parametrize("case", sorted(_SPLICE_WINDOWS))
def test_segment_splice_keeps_runs_of_equal_symbols(case, monkeypatch):
    """The splice of two kernel trajectories continues the symbol stream
    exactly: the demod kernel is stubbed to return the recorded
    windows, and the spliced emissions must be the sequential ones."""
    from leansdr_jax.dsp import receiver, receiver_pallas as rp
    from leansdr_jax.pipelines import multi_rx as mr
    out_w, in_w, seq_w = _SPLICE_WINDOWS[case]
    T, S, C, W, nseg = mr._SEG_T, 2, 1, 128, 256
    assert len(out_w) == len(in_w) == len(seq_w) == T

    def rows(w):
        return (np.array([ch != "." for ch in w]),
                np.array([0 if ch == "." else int(ch) for ch in w]))

    sym = np.zeros((nseg + T, S), np.int32)
    val = np.zeros((nseg + T, S), bool)
    val[nseg - T:nseg, 0], sym[nseg - T:nseg, 0] = rows(out_w)
    val[:T, 1], sym[:T, 1] = rows(in_w)
    packed = jnp.asarray((sym << 16) | (val.astype(np.int32) << 24))
    planes = jnp.zeros((rp.NSTATE, S * C), jnp.float32)
    outs = iter([(planes[:, :C], None), (planes, packed)])
    monkeypatch.setattr(rp, "demod_pallas", lambda *a, **k: next(outs))
    params = receiver.ReceiverParams(omega=2.0, sampler="linear",
                                     nsymbols=4, exact_lut=False)
    x = jnp.zeros((C, S * nseg + params.readahead, 2), jnp.float32)
    _, _, s_out, v_out, _ = mr._demod_segmented(
        params, None, None, C, S, W, False, True, False, None,
        planes[:, :C], planes, x)
    got = np.asarray(s_out)[:, 0][np.asarray(v_out)[:, 0]]
    v_ref, s_ref = rows(seq_w)
    want = s_ref[v_ref]
    # The spliced window may end one emission early or late (the
    # incoming trajectory's parity); the symbols must be the stream's.
    m = min(len(got), len(want))
    assert abs(len(got) - len(want)) <= 1, (len(got), len(want))
    np.testing.assert_array_equal(got[:m], want[:m])


def test_segmented_viterbi_noisy():
    """segments=2 with AWGN and soft-decision Viterbi: the two-pass
    seeds and the handover rule must hold up when emissions carry noise
    (hard decisions can differ between trajectories at low margin).
    With per-segment persistent state the emit trajectories coincide
    with the sequential one — output stays byte-identical."""
    C, CH, S = 1, 1 << 15, 2
    rng = np.random.default_rng(7)
    x, payloads = _stimulus(C, npackets=200)
    x = x * np.float32(75.0)
    x = x + rng.normal(scale=75.0 * 10 ** (-12.0 / 20),
                       size=x.shape).astype(np.float32)   # ~12 dB Es/N0
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2", fastlock=True,
                   float_scale=75.0, exact_lut=False, sampler="rrc",
                   viterbi=True)
    rx1 = MultiDvbsReceiver(cfg, C, use_pallas=False, chunk_samples=CH)
    rxs = MultiDvbsReceiver(cfg, C, use_pallas=False, chunk_samples=CH,
                            segments=S, seg_warmup=2048, seg_holdoff=6)
    ra = rx1.params.readahead + len(rx1.mf_taps) - 1
    out1 = _run(rx1, x, CH, ra)
    outs = _run(rxs, x, CH, ra)
    assert len(out1[0]) >= 100, len(out1[0])
    _assert_zero_loss(out1[0], outs[0], "noisy")
    hits = sum(1 for o in outs[0]
               if (payloads[0] == o).all(axis=1).any())
    assert hits >= 0.9 * len(outs[0]), (hits, len(outs[0]))


def test_segmented_punctured_rate_decodes():
    """Punctured 3/4 (banked-trellis symbol geometry) through
    segments=2: the splice must not slip symbols, or the deconvolution
    alignment breaks every boundary."""
    C, CH, S = 1, 1 << 15, 2
    x, payloads = _stimulus(C, npackets=200, rate="3/4")
    x = x * np.float32(75.0)
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="3/4", fastlock=True,
                   float_scale=75.0, exact_lut=False, sampler="rrc",
                   viterbi=True)
    rx1 = MultiDvbsReceiver(cfg, C, use_pallas=False, chunk_samples=CH)
    rxs = MultiDvbsReceiver(cfg, C, use_pallas=False, chunk_samples=CH,
                            segments=S, seg_warmup=2048, seg_holdoff=6)
    ra = rx1.params.readahead + len(rx1.mf_taps) - 1
    out1 = _run(rx1, x, CH, ra)
    outs = _run(rxs, x, CH, ra)
    assert len(out1[0]) >= 100, len(out1[0])
    _assert_zero_loss(out1[0], outs[0], "3/4")
    hits = sum(1 for o in outs[0]
               if (payloads[0] == o).all(axis=1).any())
    assert hits >= 0.95 * len(outs[0]), (hits, len(outs[0]))


def test_segmented_single_channel_cli():
    """leandvb --segments S at the CLI surface (shared flag handler ->
    DvbsReceiver routing through the same _demod_segmented engine)."""
    import subprocess
    import sys
    from leansdr_jax.util.iofmt import write_iq

    pkts = tsgen.generate(220)
    iq = dvbs_tx.modulate(pkts, dvbs_tx.TxConfig(rate="1/2", interp=2))
    raw = write_iq(iq, "f32")
    outs = {}
    for seg in ("1", "4"):
        r = subprocess.run(
            [sys.executable, "-m", "leansdr_jax.apps.leandvb",
             "--f32", "--float-scale", "75", "-f", "4e6", "--sr", "2e6",
             "--cr", "1/2", "--anf", "0", "--fastlock",
             "--segments", seg],
            input=raw, capture_output=True, timeout=900)
        assert r.returncode == 0, r.stderr[-400:]
        outs[seg] = np.frombuffer(r.stdout, np.uint8).reshape(-1, 188)
    assert len(outs["1"]) >= 150
    _assert_zero_loss(outs["1"], outs["4"], "cli")


def test_segmented_banked_fleet_shape():
    """The production combination of the fleet headlines (VERDICT r4
    item 6): segments=2 composed with the Pallas ACS kernel at a
    34-channel fleet shape, interpret mode on CPU, small chunk. Segmented output must equal sequential
    output byte-for-byte per channel."""
    C, CH, S = 34, 1 << 14, 2
    x, payloads = _stimulus(C, npackets=42, rate="3/4")
    x = x * np.float32(75.0)
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="3/4", fastlock=True,
                   float_scale=75.0, exact_lut=False, sampler="rrc",
                   viterbi=True)

    def make(**kw):
        rx = MultiDvbsReceiver(cfg, C, use_pallas=False,
                               chunk_samples=CH, **kw)
        rx.deconv = type(rx.deconv)(rx.cstln, "3/4", C, CH, 2.0,
                                    interpret=True)
        assert rx.deconv.kind == "viterbi_acs"
        return rx

    rx1 = make()
    rxs = make(segments=S, seg_warmup=2048, seg_holdoff=2)
    ra = rx1.params.readahead + len(rx1.mf_taps) - 1
    out1 = _run(rx1, x, CH, ra)
    outs = _run(rxs, x, CH, ra)
    total = sum(len(o) for o in out1)
    assert total >= C * 8, total
    for c in range(C):
        _assert_zero_loss(out1[c], outs[c], f"banked ch{c}")


def test_segmented_guardrails():
    cfg = RxConfig(Fs=4e6, Fm=2e6, rate="1/2", float_scale=75.0)
    with pytest.raises(ValueError):
        MultiDvbsReceiver(cfg, 2, segments=0)
    with pytest.raises(ValueError):
        MultiDvbsReceiver(cfg, 2, segments=2, seg_warmup=100)
    with pytest.raises(ValueError):
        MultiDvbsReceiver(cfg, 600, segments=2)
