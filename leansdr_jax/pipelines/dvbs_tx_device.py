"""Device-side DVB-S modulator: the whole TX chain as one jitted program.

Every stage of leandvbtx (randomizer -> RS(204,188) -> interleaver ->
convolutional encoder -> mapper -> RRC interpolation) is GF(2)-linear or
a gather, so the chain maps onto matmuls and elementwise ops end to end:

  randomize    XOR with the precomputed 188*8 pattern (VPU)
  RS encode    0/1 matmul mod 2 (fec/rs.py gf2_encode_matrix)
  interleave   static gather over a 12-packet window
  convolve     XOR of statically-shifted bit lanes (the puncturing is in
               the shifted-polynomial taps, like the host encoder)
  map          constellation gather -> (re, im) planes
  RRC          polyphase taps as `interp` stacked streaming FIRs

Batch axis = packets. The host
`dvbs_tx.modulate` remains the behavioral reference (bit-exact vs the
C++ binary); this path is validated against it.
"""

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from ..fec import prbs, rs, convenc, interleave
from ..dsp import filtergen
from ..dsp.cstln import CSTLN_AMP, make_dvbs2_constellation, Predef


@lru_cache(maxsize=None)
def _conv_taps(rate: str):
    """For each output bit position p: input-bit offsets (relative to the
    emitting input-bit index i_t) whose XOR gives the coded bit."""
    polys = convenc.POLYS[rate]
    H = convenc.HISTSIZE
    return tuple(
        tuple(j - (H - 1) for j in range(H) if (poly >> j) & 1)
        for poly in polys)


@partial(jax.jit, static_argnames=("rate", "bps", "interp", "ncoeffs"))
def _tx_jit(packets_u8, pat, enc_m, ilv_idx, sym_pts, rrc, rate, bps,
            interp, ncoeffs):
    n = packets_u8.shape[0]
    # --- randomizer: XOR with the 8-packet PRBS pattern ---
    phases = jnp.arange(n) % 8
    rand = packets_u8 ^ pat[phases]
    # --- RS encode: GF(2) matmul of message bits (float32 at HIGHEST
    # precision is exact: the sums are at most 1504) ---
    bits = _unpack_bits(rand)                       # [n, 1504]
    par_bits = (jnp.dot(bits.astype(jnp.float32),
                        enc_m.astype(jnp.float32),
                        precision=jax.lax.Precision.HIGHEST
                        ).astype(jnp.int32) & 1)
    rsp_bits = jnp.concatenate([bits, par_bits.astype(jnp.uint8)], axis=1)
    rspackets = _pack_bits(rsp_bits)                # [n, 204]
    # --- interleaver: gather over 12-packet windows ---
    flat = rspackets.reshape(-1)
    nout = n - 11
    base = jnp.arange(nout)[:, None] * 204 + ilv_idx[None, :]
    ilv = flat[base].reshape(-1)                    # [(n-11)*204]
    # --- convolutional encoder: XOR of shifted bit lanes ---
    bits_in, bits_out = convenc.FEC_SPECS[rate]
    dbits = _unpack_bits(ilv[None, : (ilv.shape[0] // bits_in) * bits_in]
                         )[0]
    nb = dbits.shape[0]
    ext = jnp.concatenate(
        [jnp.zeros(convenc.HISTSIZE - 1, jnp.uint8), dbits])
    ngroups = nb // bits_in
    i_t = (jnp.arange(ngroups) + 1) * bits_in - 1
    taps = _conv_taps(rate)
    outb = []
    for tap in taps:
        acc = jnp.zeros(ngroups, jnp.uint8)
        for off in tap:
            acc = acc ^ ext[i_t + off + (convenc.HISTSIZE - 1)]
        outb.append(acc)
    stream = jnp.stack(outb, axis=1).reshape(-1)
    symbols = jnp.zeros(stream.shape[0] // bps, jnp.int32)
    for k in range(bps):
        symbols = symbols | (stream[k::bps].astype(jnp.int32)
                             << (bps - 1 - k))
    # --- mapper ---
    iq = sym_pts[symbols]                           # [nsym, 2] f32
    # --- RRC interpolation: polyphase = interp FIRs over the symbols ---
    nsym = iq.shape[0]
    phases_out = []
    for i in range(interp):
        taps_i = rrc[i]                             # [ntaps_i] f32 (padded)
        acc_re = jnp.zeros(nsym, jnp.float32)
        acc_im = jnp.zeros(nsym, jnp.float32)
        npoly = taps_i.shape[0]
        ext_re = jnp.concatenate(
            [jnp.zeros(npoly - 1, jnp.float32), iq[:, 0]])
        ext_im = jnp.concatenate(
            [jnp.zeros(npoly - 1, jnp.float32), iq[:, 1]])
        for j in range(npoly):
            c = taps_i[j]
            acc_re = acc_re + c * ext_re[npoly - 1 - j: npoly - 1 - j + nsym]
            acc_im = acc_im + c * ext_im[npoly - 1 - j: npoly - 1 - j + nsym]
        phases_out.append(jnp.stack([acc_re, acc_im], axis=1))
    y = jnp.stack(phases_out, axis=1).reshape(nsym * interp, 2)
    return y


def _unpack_bits(bytes_u8):
    b = bytes_u8.astype(jnp.int32)
    k = jnp.arange(8)
    bits = (b[..., None] >> (7 - k)) & 1
    return bits.reshape(*bytes_u8.shape[:-1], -1).astype(jnp.uint8)


def _pack_bits(bits_u8):
    shape = bits_u8.shape[:-1]
    b = bits_u8.reshape(*shape, -1, 8).astype(jnp.int32)
    k = jnp.arange(8)
    return jnp.sum(b << (7 - k), axis=-1).astype(jnp.uint8)


class DeviceModulator:
    """Jit-compiled TX for a fixed (constellation, rate, interp) config."""

    def __init__(self, constellation=Predef.QPSK, rate="1/2",
                 amp=1.0, interp=2, rolloff=0.35, rrc_rej=10.0):
        cstln = make_dvbs2_constellation(constellation, rate)
        if rate == "2/3" and cstln.nsymbols in (4, 64):
            rate = "4/6"
        self.rate = rate
        self.bps = cstln.bits_per_symbol
        self.interp = interp
        self.pat = jnp.asarray(prbs.prbs_pattern().reshape(8, 188))
        self.enc_m = jnp.asarray(rs.gf2_encode_matrix())
        self.ilv_idx = jnp.asarray(interleave.interleave_indices())
        self.sym_pts = jnp.asarray(cstln.symbols.astype(np.float32))
        order = int(interp * rrc_rej)
        coeffs = filtergen.normalize_power(
            filtergen.root_raised_cosine(order, 1.0 / interp, rolloff),
            amp / CSTLN_AMP)
        self.ncoeffs = len(coeffs)
        # Polyphase split: output sample p*interp+i uses coeffs[i::interp]
        # on symbols p, p-1, ... — pad branches to a common length.
        branches = [coeffs[i::interp] for i in range(interp)]
        npoly = max(len(b) for b in branches)
        self.rrc = jnp.asarray(np.stack(
            [np.pad(b, (0, npoly - len(b))) for b in branches]))

    def modulate(self, packets: np.ndarray) -> np.ndarray:
        """[n,188] uint8 TS -> [m,2] float32 IQ (device computed)."""
        y = _tx_jit(jnp.asarray(packets), self.pat, self.enc_m,
                    self.ilv_idx, self.sym_pts, self.rrc,
                    self.rate, self.bps, self.interp, self.ncoeffs)
        return np.asarray(y)


def device_stimulus(pkts, rate: str = "1/2", interp: int = 2,
                    amp: float = 75.0):
    """TS packets -> DEVICE-resident float32 IQ [m, 2], modulated on
    device with no host round trip (benchmark and smoke-test stimulus).
    """
    mod = DeviceModulator(rate=rate, interp=interp, amp=amp)
    return _tx_jit(jnp.asarray(pkts), mod.pat, mod.enc_m, mod.ilv_idx,
                   mod.sym_pts, mod.rrc, mod.rate, mod.bps, mod.interp,
                   mod.ncoeffs)
