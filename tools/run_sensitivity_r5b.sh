#!/bin/bash
# Round-5 sensitivity matrix, part B (continuation of
# run_sensitivity_r5.sh after the first two QEF points): the remaining
# QEF / parity / satmodem jobs, trimmed to fit the round —
# segmented-QEF at the default seed only (threshold parity across
# seeds is covered by the cheaper 3000-packet paired block).
set -u
cd "$(dirname "$0")/.."
OUT=${OUT:-leandvb_bench_results_r5.txt}
J=${J:-2}
NQEF=${NQEF:-20000}
RUN="env JAX_PLATFORMS=cpu nice -n 19 \
     python tools/bench_vber.py"

jobs=()
add() { jobs+=("$*"); }

# QEF refs (fast, native binary): all seeds/SNRs.
for snr in 4.5 5.0; do
  for seedopt in "--seed 1" "--seed 2"; do
    add "--qef --snr $snr $seedopt --npackets $NQEF --ref --out $OUT"
  done
done
add "--qef --snr 5.0 --npackets $NQEF --ref --out $OUT"

# QEF ours (sequential): remaining seeds/SNRs.
add "--qef --snr 4.5 --seed 1 --npackets $NQEF --out $OUT"
add "--qef --snr 4.5 --seed 2 --npackets $NQEF --out $OUT"
add "--qef --snr 5.0 --npackets $NQEF --out $OUT"
add "--qef --snr 5.0 --seed 1 --npackets $NQEF --out $OUT"
add "--qef --snr 5.0 --seed 2 --npackets $NQEF --out $OUT"

# QEF segmented: one more point (5.0 dB default seed).
add "--qef --snr 5.0 --npackets $NQEF --segments 4 --out $OUT"

# Segmented threshold parity: paired seq/seg4 rows, 5 seeds x 2 SNRs.
for snr in 4.5 5.0; do
  for seedopt in "" "--seed 1" "--seed 2" "--seed 3" "--seed 4"; do
    add "4.2sps-viterbi-rrc --snr $snr $seedopt --out $OUT"
    add "4.2sps-viterbi-rrc --snr $snr $seedopt --segments 4 --out $OUT"
  done
done

# satmodem4200 ours (ADVICE r4).
for snr in 6 5 4.6; do
  add "satmodem4200-60sps --snr $snr --npackets 1200 --out $OUT"
done

printf '%s\n' "${jobs[@]}" | xargs -P "$J" -I{} sh -c "$RUN {} \
  >> /tmp/sens_r5.log 2>&1"
echo "done part B"
