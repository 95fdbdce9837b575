#!/bin/bash
# Round-5 sensitivity matrix (VERDICT r4 items 1 and 3):
#  * QEF bound: full-capture cumulative VBER at 4.5/5.0 dB,
#    4.2sps-viterbi-rrc, >=20k packets (3e7 Viterbi bits — thousands of
#    error events at the 2e-4 criterion), 3 noise realizations, for the
#    reference binary, the sequential receiver AND the segmented
#    (segments=4) receiver.  Explicit PASS/FAIL against the DVB-S QEF
#    criterion VBER <= 2e-4 @ Eb/N0 4.5 dB (leandvb_bench.gnuplot:20-21).
#  * Segmented threshold parity: paired 3000-packet lock/VBER rows,
#    sequential vs segments=4, same seeds, at 4.5 and 5.0 dB — the
#    "Done" bar for the two-pass persistent-state engine.
#  * satmodem4200-60sps leansdr_jax points (ADVICE r4: reference-only
#    rows so far).
# Runs CPU-only (JAX_PLATFORMS=cpu), J jobs in parallel, results append
# to leandvb_bench_results_r5.txt.
set -u
cd "$(dirname "$0")/.."
OUT=${OUT:-leandvb_bench_results_r5.txt}
J=${J:-3}
NQEF=${NQEF:-20000}
RUN="env JAX_PLATFORMS=cpu nice -n 19 \
     python tools/bench_vber.py"

jobs=()
add() { jobs+=("$*"); }

# 1) QEF bound (item 3): ref / sequential / segmented, 3 seeds.
for snr in 4.5 5.0; do
  for seedopt in "" "--seed 1" "--seed 2"; do
    add "--qef --snr $snr $seedopt --npackets $NQEF --ref --out $OUT"
    add "--qef --snr $snr $seedopt --npackets $NQEF --out $OUT"
    add "--qef --snr $snr $seedopt --npackets $NQEF --segments 4 --out $OUT"
  done
done

# 2) Segmented threshold parity (item 1): paired seq/seg4 rows, 5 seeds.
for snr in 4.5 5.0; do
  for seedopt in "" "--seed 1" "--seed 2" "--seed 3" "--seed 4"; do
    add "4.2sps-viterbi-rrc --snr $snr $seedopt --out $OUT"
    add "4.2sps-viterbi-rrc --snr $snr $seedopt --segments 4 --out $OUT"
  done
done

# 3) satmodem4200 ours (ADVICE r4).
for snr in 6 5 4.6; do
  add "satmodem4200-60sps --snr $snr --npackets 1200 --out $OUT"
done

printf '%s\n' "${jobs[@]}" | xargs -P "$J" -I{} sh -c "$RUN {} \
  >> /tmp/sens_r5.log 2>&1"
echo "done: $(grep -c . $OUT 2>/dev/null || echo 0) result lines"
