"""Fixed-point math primitives shared by the whole framework.

The reference (math.h:95-111, sdr.h:277-278) uses a 16-bit angle convention
(65536 = 2*pi) everywhere in the carrier loops, with a 65536-entry
complex<float> sin/cos table. We keep the exact convention and the exact
table-quantized trigonometry so that loop trajectories can match the
reference bit-for-bit; on device the table is a gather operand and
`expi` vectorizes over channel lanes.

Parity / popcount (math.h:56-85) are re-expressed as vectorized int32 lane
ops rather than byte LUTs.
"""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

# 16-bit angle convention: u_angle in [0, 2pi) as uint16, s_angle in
# [-pi, pi) as int16 (sdr.h:277-278).  65536 = 2*pi.
ANGLE_SCALE = 65536


@lru_cache(maxsize=None)
def trig16_table() -> np.ndarray:
    """The 65536-entry complex exp table of math.h:95-111, as float32 [65536, 2].

    Entry a is (cos, sin) of a*2*pi/65536, computed in float32 like the
    reference's cosf/sinf.
    """
    # Match the reference's argument quantization: af is float32.
    af = (np.arange(65536, dtype=np.float64) * (2 * np.pi) / 65536).astype(
        np.float32
    )
    tab = np.stack([np.cos(af.astype(np.float64)), np.sin(af.astype(np.float64))],
                   axis=-1)
    return tab.astype(np.float32)


def expi_u16(table: jnp.ndarray, angle_u16: jnp.ndarray) -> jnp.ndarray:
    """expi(uint16 a): gather (cos,sin) pairs; angle already wrapped."""
    return table[angle_u16.astype(jnp.uint16).astype(jnp.int32)]


def expi_float(table: jnp.ndarray, a: jnp.ndarray) -> jnp.ndarray:
    """expi(float a): reference casts (uint16)(int16)(int32)a (math.h:108-110).

    The float is truncated toward zero to int32, then wrapped to 16 bits.
    Returns [..., 2] float32 (cos, sin).
    """
    idx = jnp.trunc(a).astype(jnp.int32) & 0xFFFF
    return table[idx]


def cmul(a_re, a_im, b_re, b_im):
    """Complex multiply on separate planes (math.h:40-43)."""
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def parity_u32(x: jnp.ndarray) -> jnp.ndarray:
    """XOR-fold parity of each uint32/int32 lane (math.h:73-85)."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return (x & 1).astype(jnp.uint8)


def parity_u64_np(x) -> np.ndarray:
    """NumPy parity for uint64 scalars/arrays (setup-time use)."""
    x = np.asarray(x, dtype=np.uint64)
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint64(s))
    return (x & np.uint64(1)).astype(np.uint8)


def popcount_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Per-lane popcount (hamming_weight, math.h:56-71)."""
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24).astype(jnp.int32)


def log2i(x: int) -> int:
    """Integer log2 (math.h:87-91)."""
    n = -1
    while x:
        n += 1
        x >>= 1
    return n


# Polynomial atan/atan2 shared by the XLA computed path and the Pallas
# kernel (both paths use the same formula so their trajectories agree). Max error < 3e-7 rad, well under the s16
# angle quantum 2*pi/65536 ~ 9.6e-5.
def _fit_atan_coeffs(order=7):
    import numpy as _np
    r = _np.linspace(0, 1, 4001)[1:]
    u = r * r
    A = _np.stack([u ** k for k in range(order)], axis=1) * r[:, None]
    c, *_ = _np.linalg.lstsq(A, _np.arctan(r), rcond=None)
    return tuple(float(v) for v in c)


ATAN_COEFFS = _fit_atan_coeffs()


def atan2_poly(q, i):
    """Vectorized atan2 with C sign conventions, polynomial core."""
    ax = jnp.abs(i)
    ay = jnp.abs(q)
    mx = jnp.maximum(ax, ay)
    mn = jnp.minimum(ax, ay)
    r = jnp.where(mx > 0, mn / jnp.where(mx > 0, mx, 1.0), 0.0)
    u = r * r
    p = jnp.float32(ATAN_COEFFS[-1])
    for c in ATAN_COEFFS[-2::-1]:
        p = p * u + jnp.float32(c)
    t = r * p
    t = jnp.where(ay > ax, jnp.float32(np.pi / 2) - t, t)
    t = jnp.where(i < 0, jnp.float32(np.pi) - t, t)
    return jnp.where(q < 0, -t, t)
