"""leansdr_jax — a device-native software-defined-radio framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of pabr/leansdr
(see SURVEY.md): a chunked block-streaming DSP graph, batched DSP and
channel-coding ops, and DVB-S receive/transmit pipelines that scale over
channels and demodulation hypotheses on device meshes.

Layer map (mirrors SURVEY.md section 1, re-expressed for a device):

  core/      chunk-stream runtime (replaces pipebuf/runnable/scheduler,
             reference framework.h:39-122)
  dsp/       math tables, filter design, FIR/FFT, constellations, the
             demodulator scan (reference math.h, dsp.h, filtergen.h, sdr.h)
  fec/       PRBS, Reed-Solomon, interleaving, convolutional coding and
             algebraic deconvolution, Viterbi (reference rs.h,
             convolutional.h, viterbi.h, parts of dvb.h)
  proto/     DVB-S protocol constants and framing (reference dvb.h), HDLC,
             IESS (reference hdlc.h, iess.h)
  pipelines/ complete RX/TX/chansim/tsgen graphs (reference src/apps/*.cc)
  parallel/  mesh/sharding helpers (channel sharding, halo exchange)
  util/      sample-format conversion, tagged-line info protocol
"""

__version__ = "0.1.0"
