// Native (C++) byte-domain RX backend for the multi-channel receiver.
//
// Implements the host side of the DVB-S chain — MPEG-TS framing FSM,
// Forney convolutional deinterleaver, RS(204,188) decode, energy-dispersal
// derandomizer — for a whole channel fleet in one call, replacing the
// per-channel Python loop in pipelines/multi_rx.py::_ByteBackend.
//
// Behavior matches the Python modules bit-for-bit (they are the behavioral
// reference, themselves verified against the upstream C++ binaries):
//   proto/framing.py   (mpeg_sync FSM; reference dvb.h:712-891)
//   fec/interleave.py  (deinterleaver;  reference dvb.h:926-948)
//   fec/rs.py          (RS decode;      reference rs.h:86-272)
//   fec/prbs.py        (derandomizer;   reference dvb.h:1063-1163)
// Parity is enforced by tests/test_native_backend.py on noisy streams.
//
// Built on demand by leansdr_jax/native/__init__.py (g++ -O3 -shared) and
// loaded via ctypes; no Python.h dependency.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int RS_SIZE = 204;
constexpr int TS_SIZE = 188;
constexpr int N_PARITY = 16;
constexpr uint8_t MPEG_SYNC = 0x47;
constexpr uint8_t MPEG_SYNC_INV = 0xB8;
constexpr uint8_t MPEG_SYNC_CORRUPTED = 0x55;
constexpr int DEPTH = 17 * 11 * 12;  // deinterleaver history (2244)

// ---------------------------------------------------------------- GF(256)

struct GfTables {
  uint8_t exp[512];
  uint8_t log[256];
  // syndrome contribution of byte value v at position j, as two u64
  // (16 syndrome bytes): syn_tab[j][v]
  uint64_t syn0[RS_SIZE][256];
  uint64_t syn1[RS_SIZE][256];
  GfTables() {
    int a = 1;
    for (int i = 0; i < 255; i++) {
      exp[i] = exp[255 + i] = (uint8_t)a;
      log[a] = (uint8_t)i;
      a <<= 1;
      if (a & 0x100) a ^= 0x11D;
    }
    exp[510] = exp[0];
    exp[511] = exp[1];
    log[0] = 0;
    // consts[j][i] = alpha^(i*(203-j)); syndrome_i ^= mul(byte, consts)
    for (int j = 0; j < RS_SIZE; j++) {
      uint8_t row[16];
      for (int i = 0; i < N_PARITY; i++)
        row[i] = exp[(i * (RS_SIZE - 1 - j)) % 255];
      for (int v = 0; v < 256; v++) {
        uint8_t s[16];
        for (int i = 0; i < N_PARITY; i++)
          s[i] = (v && row[i]) ? exp[log[v] + log[row[i]]] : 0;
        std::memcpy(&syn0[j][v], s, 8);
        std::memcpy(&syn1[j][v], s + 8, 8);
      }
    }
  }
  inline uint8_t mul(uint8_t x, uint8_t y) const {
    return (x && y) ? exp[log[x] + log[y]] : 0;
  }
  inline uint8_t div(uint8_t x, uint8_t y) const {
    return x ? exp[log[x] + 255 - log[y]] : 0;
  }
  inline uint8_t inv(uint8_t x) const { return exp[255 - log[x]]; }
};

const GfTables GF;

// Syndromes of one 204-byte packet; returns true if any nonzero.
inline bool syndromes(const uint8_t* p, uint8_t synd[16]) {
  uint64_t s0 = 0, s1 = 0;
  for (int j = 0; j < RS_SIZE; j++) {
    s0 ^= GF.syn0[j][p[j]];
    s1 ^= GF.syn1[j][p[j]];
  }
  std::memcpy(synd, &s0, 8);
  std::memcpy(synd + 8, &s1, 8);
  return (s0 | s1) != 0;
}

// Berlekamp-Massey (rs.h:177-201 / fec/rs.py:143-181).
inline void berlekamp_massey(const uint8_t synd[16], uint8_t C[16],
                             int* Lout) {
  uint8_t B[16] = {1};
  std::memset(C, 0, 16);
  C[0] = 1;
  int L = 0, m = 1;
  uint8_t b = 1;
  for (int step = 0; step < 16; step++) {
    uint8_t d = synd[step];
    for (int i = 1; i <= L && i <= step; i++)
      d ^= GF.mul(C[i], synd[step - i]);
    bool grow = d && (2 * L <= step);
    if (d) {
      uint8_t T[16];
      std::memcpy(T, C, 16);
      uint8_t scale = GF.mul(d, GF.inv(b));
      for (int i = 0; m + i < 16; i++) C[m + i] ^= GF.mul(scale, B[i]);
      if (grow) {
        L = step + 1 - L;
        std::memcpy(B, T, 16);
        b = d;
        m = 1;
        continue;
      }
    }
    m++;
  }
  *Lout = L;
}

// RS decode of one packet in place; returns (failed<<1)|corrupted flags
// via out-params. bits = popcount of the applied error pattern.
inline void rs_decode_packet(uint8_t* p, bool* failed, int* bits) {
  uint8_t synd[16];
  *bits = 0;
  *failed = false;
  if (!syndromes(p, synd)) return;

  uint8_t C[16];
  int L;
  berlekamp_massey(synd, C, &L);

  // Omega = (synd * C) mod X^16, coefficients limited to degree <= L at
  // evaluation time (rs.py:197-211 passes maxdeg=L to _eval_all_points).
  uint8_t omega[16] = {0};
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < 16 - i; j++)
      omega[i + j] ^= GF.mul(synd[i], C[j]);
  uint8_t Cp[16] = {0};  // formal derivative: even i -> C[i+1]
  for (int i = 0; i < 15; i += 2) Cp[i] = C[i + 1];

  uint8_t Cm[16], Om[16];
  for (int i = 0; i < 16; i++) {
    Cm[i] = (i <= L) ? C[i] : 0;
    Om[i] = (i <= L) ? omega[i] : 0;
  }

  uint8_t E[RS_SIZE] = {0};
  if (L > 0) {
    for (int j = 0; j < 255; j++) {
      int loc = (255 - j) % 255;  // byte position (log of root inverse)
      if (loc >= RS_SIZE) continue;
      // Horner at x = alpha^j
      uint8_t cv = Cm[15], ov = Om[15], dv = Cp[15];
      for (int d = 14; d >= 0; d--) {
        cv = (cv ? GF.exp[GF.log[cv] + j] : 0) ^ Cm[d];
        ov = (ov ? GF.exp[GF.log[ov] + j] : 0) ^ Om[d];
        dv = (dv ? GF.exp[GF.log[dv] + j] : 0) ^ Cp[d];
      }
      if (cv == 0 && dv != 0) {
        uint8_t xk = GF.exp[loc];
        uint8_t e = GF.div(GF.mul(xk, ov), dv);
        E[RS_SIZE - 1 - loc] ^= e;
      }
    }
  }
  int nb = 0;
  for (int i = 0; i < RS_SIZE; i++) {
    p[i] ^= E[i];
    nb += __builtin_popcount(E[i]);
  }
  *bits = nb;
  *failed = syndromes(p, synd);
}

// ------------------------------------------------------------ PRBS pattern

struct PrbsPattern {
  uint8_t pat[8][TS_SIZE];
  PrbsPattern() {
    std::memset(pat, 0, sizeof(pat));
    pat[0][0] = 0xFF;
    int st = 0251;  // octal, EN 300 421 seed
    for (int i = 1; i < TS_SIZE * 8; i++) {
      int out = 0;
      for (int k = 0; k < 8; k++) {
        int bit = ((st >> 13) ^ (st >> 14)) & 1;
        out = ((out << 1) | bit) & 0xFF;
        st = ((st << 1) | bit) & 0xFFFF;
      }
      if (i % TS_SIZE) pat[i / TS_SIZE][i % TS_SIZE] = (uint8_t)out;
    }
  }
};

const PrbsPattern PRBS;

// ----------------------------------------------------- deinterleave indices

struct DeintIdx {
  int idx[RS_SIZE];
  DeintIdx() {
    for (int i = 0; i < RS_SIZE; i++) {
      int delay = (17 * 11 - 17 * (i % 12)) % (17 * 12);
      idx[i] = DEPTH + i - delay * 12;
    }
  }
};

const DeintIdx DEINT;

// -------------------------------------------------------------- backlog buf

// A byte FIFO with O(1) amortized consume (head index + periodic compact).
struct ByteFifo {
  std::vector<uint8_t> buf;
  size_t head = 0;
  size_t size() const { return buf.size() - head; }
  const uint8_t* data() const { return buf.data() + head; }
  void append(const uint8_t* p, size_t n) {
    if (head > 65536 && head > buf.size() / 2) {
      buf.erase(buf.begin(), buf.begin() + head);
      head = 0;
    }
    buf.insert(buf.end(), p, p + n);
  }
  void consume(size_t n) { head += n; }
};

// ----------------------------------------------------------------- channel

struct Chan {
  ByteFifo backlog;       // deconvolved bytes awaiting framing
  ByteFifo mpeg_backlog;  // framed 204-byte packets awaiting deinterleave
  // mpeg_sync FSM (proto/framing.py:35-53)
  int polarity = 0;  // 0 or 0xFF
  int bitphase = 0;
  bool sync = false;
  int next_sync_count = 0;
  int resync_phase = 0;
  int phase8 = -1;
  int lock_timeleft = 0;
  long long locktime = 0;
  // derandomizer / stats
  int derand_pos = 0;
  long long vbitcount = 0, verrcount = 0;
};

struct Ctx {
  int nchan;
  bool fastlock;
  int scan_syncs = 8, want_syncs = 4, lock_timeout = 4, resync_period = 1;
  std::vector<Chan> ch;
  std::vector<uint8_t> rsbuf;  // scratch: deinterleaved packets
};

// out[i] = ((data[i]<<8 | data[i+1]) >> bitphase) & 0xff
inline void bitshift(const uint8_t* d, size_t n_out, int bp, uint8_t* out) {
  for (size_t i = 0; i < n_out; i++)
    out[i] = (uint8_t)((((d[i] << 8) | d[i + 1]) >> bp) & 0xFF);
}

// framing.py::_search_sync. Returns consumed-to-lock, or -1.
int search_sync(Ctx* cx, Chan* c, const uint8_t* data) {
  const int chunk = RS_SIZE * cx->scan_syncs;
  uint8_t shifted[RS_SIZE * 8];
  bitshift(data, chunk, c->bitphase, shifted);
  int last_use_p = 0, last_phase8 = -1;
  for (int o = 0; o < RS_SIZE; o++) {
    int np = 0, nn = 0, last_p = -1, last_n = -1;
    for (int j = 0; j < cx->scan_syncs; j++) {
      uint8_t b = shifted[j * RS_SIZE + o];
      if (b == MPEG_SYNC) { np++; last_p = j; }
      else if (b == MPEG_SYNC_INV) { nn++; last_n = j; }
    }
    // note the cross: positive polarity derives phase8 from the INVERTED
    // sync position (phase 0 of the 8-packet cycle), framing.py:75-79
    int phase8_n = last_p >= 0 ? (8 - last_p) & 7 : -1;
    int phase8_p = last_n >= 0 ? (8 - last_n) & 7 : -1;
    bool use_p = np > nn;
    int nsyncs = use_p ? np : nn;
    int phase8 = use_p ? phase8_p : phase8_n;
    last_use_p = use_p;
    last_phase8 = phase8;
    if (nsyncs >= cx->want_syncs && phase8 >= 0) {
      c->polarity = use_p ? 0 : 0xFF;
      c->phase8 = phase8;
      int consumed = o;
      if (o == 0) {  // avoid scheduler fixpoint (dvb.h:826-829)
        consumed = RS_SIZE;
        c->phase8 = (c->phase8 + 1) & 7;
      }
      c->sync = true;
      c->lock_timeleft = cx->lock_timeout;
      c->locktime = 0;
      return consumed;
    }
  }
  c->polarity = last_use_p ? 0 : 0xFF;
  c->phase8 = last_phase8;
  return -1;
}

// framing.py::_run_searching. Returns consumed; *nsync_fired incremented
// when the non-fastlock FSM requests a deconvolver resync.
size_t run_searching(Ctx* cx, Chan* c, const uint8_t* data, size_t len,
                     int* nsync_fired) {
  const size_t chunk = RS_SIZE * cx->scan_syncs;
  size_t consumed = 0;
  bool next_sync = false;
  while (len - consumed >= chunk + 1) {
    int r = search_sync(cx, c, data + consumed);
    if (r >= 0) return consumed + r;
    consumed += chunk;
    if (++c->bitphase == 8) {
      c->bitphase = 0;
      next_sync = true;
    }
  }
  if (next_sync) {
    if (++c->next_sync_count >= 3) {
      c->next_sync_count = 0;
      (*nsync_fired)++;
    }
  }
  return consumed;
}

// framing.py::_run_searching_fast
size_t run_searching_fast(Ctx* cx, Chan* c, const uint8_t* data,
                          size_t len) {
  const size_t chunk = RS_SIZE * cx->scan_syncs;
  size_t consumed = 0;
  while (len - consumed >= chunk + 1) {
    if (c->resync_phase == 0) {
      for (int bp = 0; bp < 8; bp++) {
        c->bitphase = bp;
        int r = search_sync(cx, c, data + consumed);
        if (r >= 0) return consumed + r;
      }
    }
    consumed += RS_SIZE;
    if (++c->resync_phase >= cx->resync_period) c->resync_phase = 0;
  }
  return consumed;
}

// framing.py::_run_decoding — emit aligned packets into mpeg_backlog.
size_t run_decoding(Ctx* cx, Chan* c, const uint8_t* data, size_t len) {
  long n_all = ((long)len - 1) / RS_SIZE;
  if (n_all <= 0) return 0;
  int t = c->lock_timeleft;
  long n_emit = 0;
  uint8_t pkt[RS_SIZE];
  for (long i = 0; i < n_all; i++) {
    bitshift(data + i * RS_SIZE, RS_SIZE, c->bitphase, pkt);
    if (c->polarity)
      for (int k = 0; k < RS_SIZE; k++) pkt[k] ^= 0xFF;
    uint8_t expected =
        ((c->phase8 + i) & 7) ? MPEG_SYNC : MPEG_SYNC_INV;
    t = (pkt[0] == expected ? cx->lock_timeout : t) - 1;
    c->mpeg_backlog.append(pkt, RS_SIZE);
    n_emit = i + 1;
    if (t <= 0) {  // unlock; this packet is still emitted
      c->sync = false;
      c->next_sync_count = 0;
      break;
    }
  }
  c->locktime += n_emit;
  c->phase8 = (int)((c->phase8 + n_emit) & 7);
  c->lock_timeleft = t;
  return (size_t)(n_emit * RS_SIZE);
}

// framing.py::process on the channel's backlog FIFO.
void mpeg_process(Ctx* cx, Chan* c, int* nsync_fired) {
  for (;;) {
    const uint8_t* d = c->backlog.data();
    size_t len = c->backlog.size();
    if (c->sync) {
      size_t used = run_decoding(cx, c, d, len);
      c->backlog.consume(used);
      if (c->sync) break;  // ran out of data while locked
    } else {
      size_t used = cx->fastlock ? run_searching_fast(cx, c, d, len)
                                 : run_searching(cx, c, d, len, nsync_fired);
      c->backlog.consume(used);
      if (!c->sync) break;  // ran out of data while searching
    }
  }
}

}  // namespace

namespace {
template <typename T>
void put(std::vector<uint8_t>& v, T x) {
  const uint8_t* b = (const uint8_t*)&x;
  v.insert(v.end(), b, b + sizeof(T));
}
template <typename T>
T get(const uint8_t*& p) {
  T x;
  std::memcpy(&x, p, sizeof(T));
  p += sizeof(T);
  return x;
}
}  // namespace

extern "C" {

void* bb_create(int nchan, int fastlock) {
  Ctx* cx = new Ctx;
  cx->nchan = nchan;
  cx->fastlock = fastlock != 0;
  cx->ch.resize(nchan);
  return cx;
}

void bb_destroy(void* p) { delete (Ctx*)p; }

// Feed one chunk's new bytes for every channel.
//   bytes + offs[nchan+1]: concatenated per-channel byte arrays
//   out:        [cap_pkts][188] output TS packets (all channels, in
//               channel order)
//   out_counts: [nchan] packets emitted per channel
//   nsync_out:  [nchan] deconvolver-resync requests (non-fastlock)
// Returns total packets, or -1 if out overflows.
long bb_feed(void* p, const uint8_t* bytes, const long* offs, uint8_t* out,
             long cap_pkts, long* out_counts, int* nsync_out) {
  Ctx* cx = (Ctx*)p;
  long total = 0;
  for (int cidx = 0; cidx < cx->nchan; cidx++) {
    Chan* c = &cx->ch[cidx];
    out_counts[cidx] = 0;
    nsync_out[cidx] = 0;
    long n_new = offs[cidx + 1] - offs[cidx];
    if (n_new > 0) c->backlog.append(bytes + offs[cidx], (size_t)n_new);

    mpeg_process(cx, c, &nsync_out[cidx]);

    // deinterleave as many packets as the history allows
    long avail = (long)c->mpeg_backlog.size();
    long n = (avail - DEPTH) / RS_SIZE;
    if (n <= 0) continue;
    const uint8_t* stream = c->mpeg_backlog.data();
    cx->rsbuf.resize((size_t)n * RS_SIZE);
    for (long k = 0; k < n; k++) {
      uint8_t* dst = cx->rsbuf.data() + k * RS_SIZE;
      const uint8_t* base = stream + k * RS_SIZE;
      for (int i = 0; i < RS_SIZE; i++) dst[i] = base[DEINT.idx[i]];
    }
    c->mpeg_backlog.consume((size_t)n * RS_SIZE);

    // RS decode + derandomize
    for (long k = 0; k < n; k++) {
      uint8_t* pk = cx->rsbuf.data() + k * RS_SIZE;
      bool failed;
      int bits;
      rs_decode_packet(pk, &failed, &bits);
      c->vbitcount += RS_SIZE * 8;
      c->verrcount += bits;
      if (failed) pk[0] ^= MPEG_SYNC_CORRUPTED;
      // derandomizer position recurrence (fec/prbs.py:77-103)
      uint8_t sync_in = pk[0];
      if (sync_in == MPEG_SYNC_INV ||
          sync_in == (MPEG_SYNC_INV ^ MPEG_SYNC_CORRUPTED))
        c->derand_pos = 0;
      uint8_t ts[TS_SIZE];
      const uint8_t* pat = PRBS.pat[c->derand_pos];
      for (int i = 0; i < TS_SIZE; i++) ts[i] = pk[i] ^ pat[i];
      c->derand_pos = (c->derand_pos + 1) & 7;
      if (ts[0] == MPEG_SYNC) {
        if (total >= cap_pkts) return -1;
        std::memcpy(out + total * TS_SIZE, ts, TS_SIZE);
        total++;
        out_counts[cidx]++;
      }
    }
  }
  return total;
}

void bb_stats(void* p, long long* vbit, long long* verr, uint8_t* locks,
              long long* locktimes) {
  Ctx* cx = (Ctx*)p;
  for (int i = 0; i < cx->nchan; i++) {
    vbit[i] = cx->ch[i].vbitcount;
    verr[i] = cx->ch[i].verrcount;
    locks[i] = cx->ch[i].sync ? 1 : 0;
    locktimes[i] = cx->ch[i].locktime;
  }
}

// ---- checkpoint/resume: flat little-endian blob of all mutable state ----

long bb_save(void* ctx, uint8_t* out, long cap) {
  Ctx* cx = (Ctx*)ctx;
  std::vector<uint8_t> v;
  put<int64_t>(v, 0x4242534156315ALL);  // magic 'BBSAV1Z'
  put<int32_t>(v, cx->nchan);
  put<int32_t>(v, cx->fastlock ? 1 : 0);
  for (auto& c : cx->ch) {
    for (int32_t f : {c.polarity, c.bitphase, (int32_t)c.sync,
                      c.next_sync_count, c.resync_phase, c.phase8,
                      c.lock_timeleft, c.derand_pos})
      put<int32_t>(v, f);
    put<int64_t>(v, c.locktime);
    put<int64_t>(v, c.vbitcount);
    put<int64_t>(v, c.verrcount);
    put<int64_t>(v, (int64_t)c.backlog.size());
    v.insert(v.end(), c.backlog.data(),
             c.backlog.data() + c.backlog.size());
    put<int64_t>(v, (int64_t)c.mpeg_backlog.size());
    v.insert(v.end(), c.mpeg_backlog.data(),
             c.mpeg_backlog.data() + c.mpeg_backlog.size());
  }
  if (out && cap >= (long)v.size()) std::memcpy(out, v.data(), v.size());
  return (long)v.size();  // size query when out==NULL or cap too small
}

int bb_restore(void* ctx, const uint8_t* in, long n) {
  Ctx* cx = (Ctx*)ctx;
  const uint8_t* p = in;
  const uint8_t* end = in + n;
  if (n < 16 || get<int64_t>(p) != 0x4242534156315ALL) return -1;
  if (get<int32_t>(p) != cx->nchan) return -2;
  cx->fastlock = get<int32_t>(p) != 0;
  for (auto& c : cx->ch) {
    if (p + 8 * 4 + 3 * 8 > end) return -3;
    c.polarity = get<int32_t>(p);
    c.bitphase = get<int32_t>(p);
    c.sync = get<int32_t>(p) != 0;
    c.next_sync_count = get<int32_t>(p);
    c.resync_phase = get<int32_t>(p);
    c.phase8 = get<int32_t>(p);
    c.lock_timeleft = get<int32_t>(p);
    c.derand_pos = get<int32_t>(p);
    c.locktime = get<int64_t>(p);
    c.vbitcount = get<int64_t>(p);
    c.verrcount = get<int64_t>(p);
    int64_t nb = get<int64_t>(p);
    if (p + nb > end) return -4;
    c.backlog.buf.assign(p, p + nb);
    c.backlog.head = 0;
    p += nb;
    int64_t nm = get<int64_t>(p);
    if (p + nm > end) return -5;
    c.mpeg_backlog.buf.assign(p, p + nm);
    c.mpeg_backlog.head = 0;
    p += nm;
  }
  return p == end ? 0 : -6;
}

}  // extern "C"
