#!/bin/bash
# Round-4 sensitivity matrix (VERDICT r3 item 4):
#  * multi-seed the 4.5/5.0 dB 4.2sps-viterbi-rrc headline (5 noise
#    realizations, both receivers, paired);
#  * widen series coverage to ALL 8 of the reference's grid
#    (test/leandvb_bench.sh:119-134): 2.4/4/8/32 sps viterbi-rrc, the
#    u8 --hs series, 8.2sps linear, and the satmodem4200 60sps case.
# Runs CPU-only (JAX_PLATFORMS=cpu), J jobs in parallel, results append
# to leandvb_bench_results_r4.txt.
set -u
cd "$(dirname "$0")/.."
OUT=leandvb_bench_results_r4.txt
J=${J:-3}
RUN="env JAX_PLATFORMS=cpu nice -n 19 \
     python tools/bench_vber.py"

jobs=()
add() { jobs+=("$*"); }

# 1) Multi-seed headline (seed omitted = the reference default stream).
for snr in 4.5 5.0; do
  for seedopt in "" "--seed 1" "--seed 2" "--seed 3" "--seed 4"; do
    add "4.2sps-viterbi-rrc --snr $snr $seedopt --out $OUT"
    add "4.2sps-viterbi-rrc --snr $snr $seedopt --ref --out $OUT"
  done
done

# 2) Series breadth (one-seed paired rows).
for p in "4sps-viterbi-rrc --snr 6.5" "4sps-viterbi-rrc --snr 5.5" \
         "4sps-viterbi-rrc --snr 4.5" \
         "2.4sps-viterbi-rrc --snr 8" "2.4sps-viterbi-rrc --snr 5.6" \
         "2.4sps-viterbi-rrc --snr 5.0" \
         "8sps-viterbi-rrc --snr 6 --npackets 2000" \
         "8sps-viterbi-rrc --snr 5 --npackets 2000" \
         "8sps-viterbi-rrc --snr 4.5 --npackets 2000" \
         "32sps-viterbi-rrc --snr 6 --npackets 1500" \
         "32sps-viterbi-rrc --snr 5 --npackets 1500" \
         "1.2sps-hs --snr 14" "1.2sps-hs --snr 12" "1.2sps-hs --snr 10" \
         "2.4sps-hs --snr 12" \
         "8.2sps --snr 21" "8.2sps --snr 18" \
         "satmodem4200-60sps --snr 6 --npackets 1200" \
         "satmodem4200-60sps --snr 5 --npackets 1200"; do
  add "$p --out $OUT"
  add "$p --ref --out $OUT"
done

printf '%s\n' "${jobs[@]}" | xargs -P "$J" -I{} sh -c "$RUN {} \
  >> /tmp/sens_r4.log 2>&1"
echo "done: $(grep -c . $OUT 2>/dev/null || echo 0) result lines"
