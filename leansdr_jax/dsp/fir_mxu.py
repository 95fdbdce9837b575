"""Causal FIR as a banded matmul.

Convolution by a short real tap vector (~65 taps for the RRC matched
filter, filtergen.h:68-92 / leandvb.cc:364) is a BANDED Toeplitz
matmul: split time into blocks of B=128 outputs; block b's outputs need
inputs from blocks b-1 and b only (ntaps <= B+1), so

    y[r, b, j] = sum_m x[r, b-1, m] * A_hi[m, j] + x[r, b, m] * A_lo[m, j]
    A_lo[m, j] = taps[j - m]       (0 <= j - m  < ntaps, else 0)
    A_hi[m, j] = taps[j + B - m]   (0 <= j+B-m < ntaps, else 0)

i.e. two [B, B] constant matrices and two [R*nb, B] @ [B, B] matmuls
that XLA hands to the matrix unit. precision=HIGHEST keeps f32-grade
results (max rel err ~2e-7 vs a float64 convolve) — on a GPU the
default float32 matmul precision would be TF32, which the decision path
cannot take. Speed on the card: not measured yet.

Reference parity: same math as fir_filter's real-tap path
(dsp.h:219-285) up to f32 summation order; decision-path acceptance is
TS-level (SURVEY.md section 7.2), and the exact-parity golden path is
unchanged (dsp/blocks.py on host).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

B = 128


def make_bands(taps) -> tuple[np.ndarray, np.ndarray]:
    """Banded Toeplitz factors (A_lo, A_hi), each [B, B] float32."""
    t = np.asarray(taps, np.float32)
    nt = len(t)
    if nt > B + 1:
        raise ValueError(f"{nt} taps > {B + 1}: needs a third band")
    m, j = np.meshgrid(np.arange(B), np.arange(B), indexing="ij")
    k_lo = j - m
    k_hi = j + B - m
    A_lo = np.where((k_lo >= 0) & (k_lo < nt),
                    t[np.clip(k_lo, 0, nt - 1)], 0)
    A_hi = np.where((k_hi >= 0) & (k_hi < nt),
                    t[np.clip(k_hi, 0, nt - 1)], 0)
    return A_lo.astype(np.float32), A_hi.astype(np.float32)


@partial(jax.jit, static_argnames=("taps", "precision"))
def fir_mxu(x: jnp.ndarray, taps: tuple,
            precision: str = "highest") -> jnp.ndarray:
    """Causal FIR over the last axis: y[r,t] = sum_k taps[k] x[r,t-k].

    x [R, n] float32 with n % 128 == 0; taps: static tuple of floats
    (ntaps <= 129); zeros before the stream head.  precision:
    "highest" (f32-grade, default) or "default" (bf16 multiplies).
    """
    R, n = x.shape
    if n % B:
        raise ValueError(f"n={n} not a multiple of {B}")
    A_lo, A_hi = make_bands(taps)
    xb = x.reshape(R, n // B, B)
    xp = jnp.pad(xb[:, :-1], ((0, 0), (1, 0), (0, 0)))
    y = (jnp.einsum("rbm,mj->rbj", xb, jnp.asarray(A_lo),
                    precision=precision)
         + jnp.einsum("rbm,mj->rbj", xp, jnp.asarray(A_hi),
                      precision=precision))
    return y.reshape(R, n)


@partial(jax.jit, static_argnames=("taps", "precision"))
def fir_mxu_valid(x: jnp.ndarray, taps: tuple,
                  precision: str = "highest") -> jnp.ndarray:
    """VALID-mode correlation as a banded matmul: y[r,t] = sum_k taps[k] x[r,t+k],
    t in [0, n - ntaps + 1).

    The chunked-streaming contract: filter history is IN-BAND — callers
    pass ntaps-1 samples of readahead overlap in x (as the matched
    filter in pipelines/multi_rx.py does), so the kernel itself stays
    stateless and no boundary carry is needed.  Arbitrary n (padded to
    the 128-block grid internally).
    """
    n = x.shape[1]
    nt = len(taps)
    pad = -n % B
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad)))
    y = fir_mxu(x, tuple(taps)[::-1], precision=precision)
    return y[:, nt - 1:n]
