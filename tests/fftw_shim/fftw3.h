/* Minimal FFTW3 single-precision API shim — just enough surface to
 * build the REFERENCE leanmlmrx.cc for golden testing in a container
 * without libfftw3f (leanmlmrx.cc uses: fftwf_complex, fftwf_malloc,
 * fftwf_free, fftwf_plan_dft_1d(FFTW_ESTIMATE, sign=-1),
 * fftwf_execute, fftwf_destroy_plan). Implements the exact FFTW
 * transform definition (unnormalized, exp(sign*2*pi*i*jk/n)) with an
 * iterative radix-2 FFT; power-of-two sizes only (leanmlmrx defaults
 * to N=64 and the golden tests control N).
 */
#ifndef LEANSDR_JAX_FFTW_SHIM_H
#define LEANSDR_JAX_FFTW_SHIM_H

#include <stddef.h>
#include <stdio.h>   /* the real fftw3.h includes it; sources rely on it */

#ifdef __cplusplus
extern "C" {
#endif

typedef float fftwf_complex[2];
typedef struct fftwf_plan_s *fftwf_plan;

#define FFTW_FORWARD (-1)
#define FFTW_BACKWARD (+1)
#define FFTW_ESTIMATE (1U << 6)

void *fftwf_malloc(size_t n);
void fftwf_free(void *p);
fftwf_plan fftwf_plan_dft_1d(int n, fftwf_complex *in,
                             fftwf_complex *out, int sign,
                             unsigned flags);
void fftwf_execute(fftwf_plan p);
void fftwf_destroy_plan(fftwf_plan p);

#ifdef __cplusplus
}
#endif

#endif
