"""The one place that maps the JAX backend to the kernel families the
receive chain runs.

  cpu  the XLA reference paths: the exact-LUT demod scan
       (dsp/receiver.run_chunks), the XLA-scan Viterbi ACS
       (fec/viterbi_device.viterbi_decode_xla) and the host
       preprocessing blocks.  A Pallas kernel runs here only when a
       caller asks for it, and then in the Pallas interpreter.
  gpu  the compiled kernels (Pallas through Triton, interpret=False):
       the demod recurrence (dsp/receiver_pallas.py) and the Viterbi ACS
       (fec/viterbi_acs.py), with the batched device preprocessing
       blocks.

Any other backend raises: no code path guesses what an unknown device
can compile.
"""

from dataclasses import dataclass

import jax


@dataclass(frozen=True)
class KernelFamilies:
    platform: str
    kernels: bool          # Pallas demod + ACS kernels by default
    exact_lut: bool        # default demod decision path (exact LUT scan)
    device_blocks: bool    # batched device preprocessing blocks
    interpret: bool        # a kernel asked for here runs interpreted


_FAMILIES = {
    "cpu": KernelFamilies("cpu", kernels=False, exact_lut=True,
                          device_blocks=False, interpret=True),
    "gpu": KernelFamilies("gpu", kernels=True, exact_lut=False,
                          device_blocks=True, interpret=False),
}


def families(platform: str | None = None) -> KernelFamilies:
    """Kernel families for `platform` (default: jax.default_backend())."""
    p = platform or jax.default_backend()
    try:
        return _FAMILIES[p]
    except KeyError:
        raise RuntimeError(
            f"no kernel families for JAX platform {p!r} "
            f"(supported: {', '.join(sorted(_FAMILIES))})") from None
