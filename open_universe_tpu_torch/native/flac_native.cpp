// Native FLAC codec for the audio IO of the enhance CLI and the server
// (the PyTorch port's own copy of the JAX package's native/flac_native.cpp).
//
// Mirrors open_universe_tpu_torch/data/codecs.py exactly (same spec subset, same
// error conditions): full frame decoder — constant/verbatim/fixed/LPC
// subframes, Rice/Rice2 residual partitions, wasted bits, all four stereo
// decorrelation modes, CRC-8/CRC-16 verification — and the matching
// constant/verbatim/fixed encoder.  The Python implementation stays as the
// reference and fallback; tests assert the two agree sample-for-sample.
//
// Plain C ABI (ctypes-loaded, no pybind11 in this image):
//   ou_flac_decode(data, len, &out, &nch, &nsamp, &rate, &bps, err, errlen)
//   ou_flac_encode(samples, nch, t, fs, bps, block, mode, &out, &outlen, ...)
//   ou_free(ptr)
// Decoded samples are planar int32 (channel-major), scaled to float on the
// Python side.  Reference parity: reference reads flac via torchaudio
// (reference open_universe/bin/enhance.py:173-178); this replaces that
// dependency with an in-house native path.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FlacError {
  std::string msg;
  explicit FlacError(std::string m) : msg(std::move(m)) {}
};

// ---------------------------------------------------------------------------
// Bit reader (MSB first)
// ---------------------------------------------------------------------------

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

  uint64_t read(int n) {
    // n <= 57 for all callers (max is 36-bit STREAMINFO total)
    uint64_t v = 0;
    while (n > 0) {
      size_t byte = pos_ >> 3;
      if (byte >= len_) throw FlacError("flac: out of data");
      int avail = 8 - (pos_ & 7);
      int take = n < avail ? n : avail;
      uint8_t b = data_[byte];
      b = static_cast<uint8_t>(b << (8 - avail));      // drop consumed msbs
      v = (v << take) | (static_cast<uint64_t>(b) >> (8 - take));
      pos_ += take;
      n -= take;
    }
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n < 64 && v >= (1ULL << (n - 1)))
      return static_cast<int64_t>(v) - (1LL << n);
    return static_cast<int64_t>(v);
  }

  int unary() {
    int q = 0;
    for (;;) {
      size_t byte = pos_ >> 3;
      if (byte >= len_) throw FlacError("flac: out of data in unary read");
      int shift = 7 - (pos_ & 7);
      uint8_t rest = static_cast<uint8_t>(data_[byte] << (7 - shift)) &
                     0xFFu;  // bits from pos_ to end of byte, msb-aligned
      if (rest == 0) {
        q += shift + 1;
        pos_ += shift + 1;
        continue;
      }
      // find highest set bit position within rest
      int lead = __builtin_clz(static_cast<unsigned>(rest)) - 24;
      q += lead;
      pos_ += lead + 1;
      return q;
    }
  }

  void align() { pos_ = (pos_ + 7) & ~static_cast<size_t>(7); }

  size_t pos_bits() const { return pos_; }
  void set_pos_bits(size_t p) { pos_ = p; }

 private:
  const uint8_t* data_;
  size_t len_;
  size_t pos_ = 0;
};

// ---------------------------------------------------------------------------
// CRCs (FLAC polynomials, table-driven)
// ---------------------------------------------------------------------------

struct CrcTables {
  uint8_t crc8[256];
  uint16_t crc16[256];
  CrcTables() {
    for (int i = 0; i < 256; i++) {
      uint8_t c8 = static_cast<uint8_t>(i);
      for (int k = 0; k < 8; k++)
        c8 = (c8 & 0x80) ? static_cast<uint8_t>((c8 << 1) ^ 0x07)
                         : static_cast<uint8_t>(c8 << 1);
      crc8[i] = c8;
      uint16_t c16 = static_cast<uint16_t>(i << 8);
      for (int k = 0; k < 8; k++)
        c16 = (c16 & 0x8000) ? static_cast<uint16_t>((c16 << 1) ^ 0x8005)
                             : static_cast<uint16_t>(c16 << 1);
      crc16[i] = c16;
    }
  }
};
const CrcTables kCrc;

uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; i++) c = kCrc.crc8[c ^ d[i]];
  return c;
}

uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; i++)
    c = static_cast<uint16_t>((c << 8) ^ kCrc.crc16[(c >> 8) ^ d[i]]);
  return c;
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

const int kBlocksizeTable[16] = {0,   192,  576,  1152, 2304, 4608, -1, -1,
                                 256, 512,  1024, 2048, 4096, 8192,
                                 16384, 32768};
const int kRateTable[12] = {0,    88200, 176400, 192000, 8000,  16000,
                            22050, 24000, 32000,  44100,  48000, 96000};

uint64_t read_utf8_number(BitReader& bits) {
  uint64_t first = bits.read(8);
  if (first < 0x80) return first;
  int n = 0;
  uint64_t mask = 0x80;
  while (first & mask) {
    n++;
    mask >>= 1;
  }
  uint64_t val = first & (mask - 1);
  for (int i = 0; i < n - 1; i++) val = (val << 6) | (bits.read(8) & 0x3F);
  return val;
}

void decode_residual(BitReader& bits, int blocksize, int order,
                     int64_t* out /* blocksize-order entries */) {
  uint64_t method = bits.read(2);
  if (method > 1) throw FlacError("flac: reserved residual method");
  int plen = method == 0 ? 4 : 5;
  uint64_t escape = (1ULL << plen) - 1;
  int part_order = static_cast<int>(bits.read(4));
  int nparts = 1 << part_order;
  // spec: blocksize must divide evenly into 2^order partitions and the
  // first partition (blocksize/nparts - order samples) cannot be negative;
  // without this a crafted stream drives the write cursor out of bounds
  if (blocksize % nparts || (blocksize >> part_order) < order)
    throw FlacError("flac: invalid residual partition order");
  int w = 0;
  for (int p = 0; p < nparts; p++) {
    int n = (blocksize >> part_order) - (p == 0 ? order : 0);
    uint64_t param = bits.read(plen);
    if (param == escape) {
      int nbits = static_cast<int>(bits.read(5));
      for (int i = 0; i < n; i++)
        out[w + i] = nbits ? bits.read_signed(nbits) : 0;
    } else {
      int k = static_cast<int>(param);
      for (int i = 0; i < n; i++) {
        uint64_t q = static_cast<uint64_t>(bits.unary());
        uint64_t r = k ? bits.read(k) : 0;
        uint64_t v = (q << k) | r;
        out[w + i] = static_cast<int64_t>(v >> 1) ^
                     -static_cast<int64_t>(v & 1);  // zigzag
      }
    }
    w += n;
  }
}

const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

void decode_subframe(BitReader& bits, int blocksize, int bps, int64_t* out) {
  if (bits.read(1)) throw FlacError("flac: invalid subframe padding bit");
  int stype = static_cast<int>(bits.read(6));
  int wasted = 0;
  if (bits.read(1)) {
    wasted = bits.unary() + 1;
    bps -= wasted;
  }
  if (bps <= 0) throw FlacError("flac: wasted bits exceed bits per sample");

  std::vector<int64_t> res;
  if (stype == 0) {  // constant
    int64_t v = bits.read_signed(bps);
    for (int i = 0; i < blocksize; i++) out[i] = v;
  } else if (stype == 1) {  // verbatim
    for (int i = 0; i < blocksize; i++) out[i] = bits.read_signed(bps);
  } else if (stype >= 8 && stype <= 12) {  // fixed
    int order = stype - 8;
    if (order > blocksize)
      throw FlacError("flac: predictor order exceeds blocksize");
    for (int i = 0; i < order; i++) out[i] = bits.read_signed(bps);
    res.resize(blocksize - order);
    decode_residual(bits, blocksize, order, res.data());
    const int* c = kFixedCoeffs[order];
    // __int128 + truncation = numpy int64 wraparound semantics without
    // signed-overflow UB (the Python path wraps here too)
    for (int i = order; i < blocksize; i++) {
      __int128 pred = 0;
      for (int j = 0; j < order; j++)
        pred += static_cast<__int128>(c[j]) * out[i - 1 - j];
      out[i] = static_cast<int64_t>(
          static_cast<__int128>(res[i - order]) + pred);
    }
  } else if (stype >= 32) {  // LPC
    int order = stype - 31;
    if (order > blocksize)
      throw FlacError("flac: predictor order exceeds blocksize");
    for (int i = 0; i < order; i++) out[i] = bits.read_signed(bps);
    int precision = static_cast<int>(bits.read(4)) + 1;
    if (precision == 16) throw FlacError("flac: invalid lpc precision");
    int shift = static_cast<int>(bits.read_signed(5));
    if (shift < 0) throw FlacError("flac: negative lpc shift");
    std::vector<int64_t> coeffs(order);
    for (int i = 0; i < order; i++) coeffs[i] = bits.read_signed(precision);
    res.resize(blocksize - order);
    decode_residual(bits, blocksize, order, res.data());
    // accumulate in 128 bits: with crafted warmup/coefficients the feedback
    // grows without bound, and the Python reference path (arbitrary-
    // precision ints into an int64 array) raises OverflowError there
    for (int i = order; i < blocksize; i++) {
      __int128 pred = 0;
      for (int j = 0; j < order; j++)
        pred += static_cast<__int128>(coeffs[j]) * out[i - 1 - j];
      __int128 v = static_cast<__int128>(res[i - order]) + (pred >> shift);
      if (v > INT64_MAX || v < INT64_MIN)
        throw FlacError("flac: lpc sample overflow");
      out[i] = static_cast<int64_t>(v);
    }
  } else {
    throw FlacError("flac: reserved subframe type " + std::to_string(stype));
  }

  if (wasted)
    for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
}

struct Decoded {
  std::vector<int32_t> samples;  // planar, nch * nsamp
  int nch = 0;
  int64_t nsamp = 0;
  int rate = 0;
  int bps = 0;
};

Decoded decode_flac(const uint8_t* data, size_t len) {
  if (len < 4 || memcmp(data, "fLaC", 4) != 0)
    throw FlacError("not a FLAC file");

  size_t pos = 4;
  int rate = -1, channels = 0, bps = 0;
  int64_t total = -1;
  for (;;) {
    if (pos + 4 > len) throw FlacError("flac: truncated metadata");
    uint8_t hdr = data[pos];
    bool last = hdr & 0x80;
    int btype = hdr & 0x7F;
    size_t length = (static_cast<size_t>(data[pos + 1]) << 16) |
                    (static_cast<size_t>(data[pos + 2]) << 8) |
                    data[pos + 3];
    if (btype == 0) {  // STREAMINFO
      // clip the declared block length to the buffer (a lying length field
      // must not let the bit reader run past the end of the input)
      size_t avail = len - (pos + 4);
      BitReader b(data + pos + 4, length < avail ? length : avail);
      b.read(16); b.read(16);
      b.read(24); b.read(24);
      rate = static_cast<int>(b.read(20));
      channels = static_cast<int>(b.read(3)) + 1;
      bps = static_cast<int>(b.read(5)) + 1;
      total = static_cast<int64_t>(b.read(36));
    }
    pos += 4 + length;
    if (last) break;
  }
  if (rate < 0) throw FlacError("flac: missing STREAMINFO");

  // per-channel sample accumulators
  std::vector<std::vector<int64_t>> out(channels);
  int64_t n_done = 0;
  std::vector<int64_t> bufs[2];  // scratch for decorrelated modes
  while (pos < len && (total <= 0 || n_done < total)) {
    size_t frame_start = pos;
    BitReader bits(data + pos, len - pos);
    if (bits.read(14) != 0b11111111111110)
      throw FlacError("flac: bad frame sync at byte " + std::to_string(pos));
    bits.read(1);  // reserved
    bits.read(1);  // blocking strategy
    int bs_code = static_cast<int>(bits.read(4));
    int sr_code = static_cast<int>(bits.read(4));
    int ch_code = static_cast<int>(bits.read(4));
    int ss_code = static_cast<int>(bits.read(3));
    bits.read(1);  // reserved
    read_utf8_number(bits);

    int blocksize;
    if (bs_code == 6)
      blocksize = static_cast<int>(bits.read(8)) + 1;
    else if (bs_code == 7)
      blocksize = static_cast<int>(bits.read(16)) + 1;
    else if (kBlocksizeTable[bs_code] > 0)
      blocksize = kBlocksizeTable[bs_code];
    else
      throw FlacError("flac: reserved blocksize code");
    if (sr_code == 12)
      bits.read(8);
    else if (sr_code == 13 || sr_code == 14)
      bits.read(16);
    int fbps;
    switch (ss_code) {
      case 0: fbps = bps; break;
      case 1: fbps = 8; break;
      case 2: fbps = 12; break;
      case 4: fbps = 16; break;
      case 5: fbps = 20; break;
      case 6: fbps = 24; break;
      case 7: fbps = 32; break;
      default: throw FlacError("flac: reserved sample size code");
    }
    size_t hdr_bytes = (bits.pos_bits() + 7) / 8;
    if (frame_start + hdr_bytes >= len ||
        crc8(data + frame_start, hdr_bytes) != data[frame_start + hdr_bytes])
      throw FlacError("flac: frame header CRC mismatch at " +
                      std::to_string(pos));
    bits.set_pos_bits((hdr_bytes + 1) * 8);

    auto sub = [&](int which, int b) {
      bufs[which].resize(blocksize);
      decode_subframe(bits, blocksize, b, bufs[which].data());
    };
    std::vector<const int64_t*> chans;
    std::vector<std::vector<int64_t>> indep;
    if (ch_code < 8) {
      int nch = ch_code + 1;
      if (nch != channels) throw FlacError("flac: channel count mismatch");
      indep.resize(nch);
      for (int c = 0; c < nch; c++) {
        indep[c].resize(blocksize);
        decode_subframe(bits, blocksize, fbps, indep[c].data());
        chans.push_back(indep[c].data());
      }
    } else if (ch_code == 8) {  // left/side
      sub(0, fbps);
      sub(1, fbps + 1);
      for (int i = 0; i < blocksize; i++) bufs[1][i] = bufs[0][i] - bufs[1][i];
      chans = {bufs[0].data(), bufs[1].data()};
    } else if (ch_code == 9) {  // right/side
      sub(0, fbps + 1);  // side
      sub(1, fbps);      // right
      for (int i = 0; i < blocksize; i++) bufs[0][i] = bufs[1][i] + bufs[0][i];
      chans = {bufs[0].data(), bufs[1].data()};
    } else if (ch_code == 10) {  // mid/side
      sub(0, fbps);      // mid
      sub(1, fbps + 1);  // side
      for (int i = 0; i < blocksize; i++) {
        int64_t mid = bufs[0][i], side = bufs[1][i];
        int64_t left = (((mid << 1) | (side & 1)) + side) >> 1;
        bufs[0][i] = left;
        bufs[1][i] = left - side;
      }
      chans = {bufs[0].data(), bufs[1].data()};
    } else {
      throw FlacError("flac: reserved channel assignment");
    }
    if (static_cast<int>(chans.size()) != channels)
      throw FlacError("flac: channel count mismatch");

    bits.align();
    size_t frame_len = bits.pos_bits() / 8;
    if (frame_start + frame_len + 2 > len)
      throw FlacError("flac: truncated frame");
    uint16_t crc = static_cast<uint16_t>(
        (data[frame_start + frame_len] << 8) |
        data[frame_start + frame_len + 1]);
    if (crc16(data + frame_start, frame_len) != crc)
      throw FlacError("flac: frame CRC-16 mismatch at " + std::to_string(pos));
    pos = frame_start + frame_len + 2;

    for (int c = 0; c < channels; c++)
      out[c].insert(out[c].end(), chans[c], chans[c] + blocksize);
    n_done += blocksize;
  }

  Decoded d;
  d.nch = channels;
  d.rate = rate;
  d.bps = bps;
  int64_t nsamp = out.empty() ? 0 : static_cast<int64_t>(out[0].size());
  if (total > 0 && nsamp > total) nsamp = total;  // python: audio[:, :total]
  d.nsamp = nsamp;
  d.samples.resize(static_cast<size_t>(channels) * nsamp);
  for (int c = 0; c < channels; c++)
    for (int64_t i = 0; i < nsamp; i++) {
      int64_t v = out[c][i];
      // any valid stream fits signed 32-bit (bps <= 32); mirror the Python
      // fallback's rejection instead of silently truncating
      if (v > INT32_MAX || v < INT32_MIN)
        throw FlacError("flac: decoded sample out of int32 range");
      d.samples[static_cast<size_t>(c) * nsamp + i] =
          static_cast<int32_t>(v);
    }
  return d;
}

// ---------------------------------------------------------------------------
// Bit writer + encoder (constant / verbatim / fixed subframes, Rice order 0)
// ---------------------------------------------------------------------------

class BitWriter {
 public:
  void write(uint64_t val, int n) {
    if (n == 0) return;
    acc_ = (acc_ << n) | (val & (n >= 64 ? ~0ULL : ((1ULL << n) - 1)));
    nbits_ += n;
    while (nbits_ >= 8) {
      nbits_ -= 8;
      buf_.push_back(static_cast<uint8_t>((acc_ >> nbits_) & 0xFF));
    }
    acc_ &= nbits_ ? ((1ULL << nbits_) - 1) : 0;
  }

  void write_signed(int64_t val, int n) {
    write(static_cast<uint64_t>(val) & ((n >= 64) ? ~0ULL : ((1ULL << n) - 1)),
          n);
  }

  void unary(int64_t q) {
    while (q >= 32) {
      write(0, 32);
      q -= 32;
    }
    write(1, static_cast<int>(q) + 1);
  }

  void align() {
    if (nbits_) write(0, 8 - static_cast<int>(nbits_));
  }

  std::vector<uint8_t>& buf() { return buf_; }
  size_t nbits_pending() const { return nbits_; }

 private:
  std::vector<uint8_t> buf_;
  uint64_t acc_ = 0;
  size_t nbits_ = 0;
};

std::vector<uint8_t> utf8_encode(uint64_t n) {
  if (n < 0x80) return {static_cast<uint8_t>(n)};
  std::vector<uint8_t> payload;
  int nbytes = 2;
  while (nbytes < 7 && n >= (1ULL << (5 * nbytes + 1))) nbytes++;
  for (int i = 0; i < nbytes - 1; i++) {
    payload.push_back(static_cast<uint8_t>(0x80 | (n & 0x3F)));
    n >>= 6;
  }
  std::vector<uint8_t> out;
  out.push_back(static_cast<uint8_t>(((0xFF << (8 - nbytes)) & 0xFF) | n));
  for (int i = static_cast<int>(payload.size()) - 1; i >= 0; i--)
    out.push_back(payload[i]);
  return out;
}

int64_t rice_cost(const int64_t* res, size_t n, int param) {
  int64_t cost = 0;
  for (size_t i = 0; i < n; i++) {
    uint64_t z = (static_cast<uint64_t>(res[i] < 0 ? -res[i] : res[i]) << 1) -
                 (res[i] < 0 ? 1 : 0);
    cost += static_cast<int64_t>(z >> param);
  }
  return cost + static_cast<int64_t>(n) * (param + 1);
}

int best_rice_param(const int64_t* res, size_t n) {
  if (n == 0) return 0;
  // integer accumulation: matches numpy's float64 mean exactly for audio
  // residual magnitudes (partial sums stay far below 2^53)
  int64_t acc = 0;
  for (size_t i = 0; i < n; i++) acc += res[i] < 0 ? -res[i] : res[i];
  double mean = static_cast<double>(acc) / static_cast<double>(n) * 2.0;
  int guess = static_cast<int>(std::log2(mean + 1.0));
  if (guess < 0) guess = 0;
  if (guess > 14) guess = 14;
  int best = guess;
  int64_t best_cost = rice_cost(res, n, guess);
  for (int p : {guess - 1, guess + 1}) {
    if (p >= 0 && p <= 14) {
      int64_t c = rice_cost(res, n, p);
      if (c < best_cost) {
        best = p;
        best_cost = c;
      }
    }
  }
  return best;
}

void write_rice_residual(BitWriter& w, const int64_t* res, size_t n) {
  w.write(0, 2);  // method 0 (4-bit Rice)
  w.write(0, 4);  // partition order 0
  int param = best_rice_param(res, n);
  w.write(static_cast<uint64_t>(param), 4);
  for (size_t i = 0; i < n; i++) {
    int64_t v = res[i];
    uint64_t z = v < 0 ? ((static_cast<uint64_t>(-v) << 1) - 1)
                       : (static_cast<uint64_t>(v) << 1);
    w.unary(static_cast<int64_t>(z >> param));
    if (param) w.write(z & ((1ULL << param) - 1), param);
  }
}

void encode_subframe(BitWriter& w, const int64_t* x, size_t n, int bps) {
  w.write(0, 1);  // padding bit
  bool all_const = n > 0;
  for (size_t i = 1; i < n && all_const; i++) all_const = x[i] == x[0];
  if (all_const && n) {
    w.write(0b000000, 6);
    w.write(0, 1);  // no wasted bits
    w.write_signed(x[0], bps);
    return;
  }
  // fixed predictor orders 0..4 via successive differences
  std::vector<std::vector<int64_t>> diffs(1, std::vector<int64_t>(x, x + n));
  for (int o = 0; o < 4; o++) {
    const std::vector<int64_t>& prev = diffs.back();
    std::vector<int64_t> d(prev.size() ? prev.size() - 1 : 0);
    for (size_t i = 0; i + 1 < prev.size(); i++) d[i] = prev[i + 1] - prev[i];
    diffs.push_back(std::move(d));
  }
  int best_order = 0;
  int64_t best_cost = -1;
  int max_order = n < 5 ? static_cast<int>(n) : 5;
  for (int order = 0; order < max_order; order++) {
    const std::vector<int64_t>& res = diffs[order];
    int64_t cost = static_cast<int64_t>(order) * bps +
                   rice_cost(res.data(), res.size(),
                             best_rice_param(res.data(), res.size()));
    if (best_cost < 0 || cost < best_cost) {
      best_order = order;
      best_cost = cost;
    }
  }
  if (best_cost >= 0 && best_cost < static_cast<int64_t>(n) * bps) {
    int order = best_order;
    w.write(0b001000 | order, 6);
    w.write(0, 1);
    for (int i = 0; i < order; i++) w.write_signed(x[i], bps);
    write_rice_residual(w, diffs[order].data(), diffs[order].size());
    return;
  }
  w.write(0b000001, 6);  // verbatim
  w.write(0, 1);
  for (size_t i = 0; i < n; i++) w.write_signed(x[i], bps);
}

int sr_code_for(int fs) {
  switch (fs) {
    case 88200: return 1;
    case 176400: return 2;
    case 192000: return 3;
    case 8000: return 4;
    case 16000: return 5;
    case 22050: return 6;
    case 24000: return 7;
    case 32000: return 8;
    case 44100: return 9;
    case 48000: return 10;
    case 96000: return 11;
    default: return 14;
  }
}

int bs_code_for(int n) {
  for (int k = 1; k < 16; k++)
    if (kBlocksizeTable[k] == n) return k;
  return 7;
}

int ss_code_for(int bps) {
  switch (bps) {
    case 8: return 1;
    case 12: return 2;
    case 16: return 4;
    case 20: return 5;
    case 24: return 6;
    case 32: return 7;
    default: throw FlacError("unsupported bits-per-sample");
  }
}

// stereo_mode: 0=independent, 1=left_side, 2=right_side, 3=mid_side
std::vector<uint8_t> encode_flac(const int32_t* samples, int nch, int64_t t,
                                 int fs, int bps, int block_size,
                                 int stereo_mode) {
  if (nch > 8) throw FlacError("flac supports at most 8 channels");
  if (stereo_mode != 0 && nch != 2)
    throw FlacError("stereo mode needs 2 channels");
  int ss_code = ss_code_for(bps);

  std::vector<uint8_t> out = {'f', 'L', 'a', 'C'};
  {
    BitWriter si;
    si.write(static_cast<uint64_t>(block_size), 16);
    si.write(static_cast<uint64_t>(block_size), 16);
    si.write(0, 24);
    si.write(0, 24);
    si.write(static_cast<uint64_t>(fs), 20);
    si.write(static_cast<uint64_t>(nch - 1), 3);
    si.write(static_cast<uint64_t>(bps - 1), 5);
    si.write(static_cast<uint64_t>(t), 36);
    for (int i = 0; i < 16; i++) si.buf().push_back(0);  // MD5 unset
    out.push_back(0x80);  // last-block | STREAMINFO
    size_t n = si.buf().size();
    out.push_back(static_cast<uint8_t>(n >> 16));
    out.push_back(static_cast<uint8_t>(n >> 8));
    out.push_back(static_cast<uint8_t>(n));
    out.insert(out.end(), si.buf().begin(), si.buf().end());
  }

  uint64_t frame_idx = 0;
  int64_t span = t > 0 ? t : 1;
  for (int64_t start = 0; start < span; start += block_size) {
    int64_t n64 = t - start;
    if (n64 > block_size) n64 = block_size;
    if (n64 <= 0) break;
    int n = static_cast<int>(n64);

    BitWriter w;
    w.write(0b11111111111110, 14);
    w.write(0, 1);  // reserved
    w.write(0, 1);  // fixed blocksize stream
    int bs_code = bs_code_for(n);
    int sr_code = sr_code_for(fs);
    int ch_code;
    switch (stereo_mode) {
      case 1: ch_code = 8; break;
      case 2: ch_code = 9; break;
      case 3: ch_code = 10; break;
      default: ch_code = nch - 1;
    }
    w.write(static_cast<uint64_t>(bs_code), 4);
    w.write(static_cast<uint64_t>(sr_code), 4);
    w.write(static_cast<uint64_t>(ch_code), 4);
    w.write(static_cast<uint64_t>(ss_code), 3);
    w.write(0, 1);  // reserved
    for (uint8_t b : utf8_encode(frame_idx)) w.write(b, 8);
    if (bs_code == 7) w.write(static_cast<uint64_t>(n - 1), 16);
    if (sr_code == 14) w.write(static_cast<uint64_t>(fs), 16);
    if (w.nbits_pending() != 0) throw FlacError("flac: header misaligned");
    w.write(crc8(w.buf().data(), w.buf().size()), 8);

    std::vector<int64_t> a(n), b(n);
    const int32_t* c0 = samples + 0 * t + start;
    const int32_t* c1 = nch > 1 ? samples + 1 * t + start : nullptr;
    if (ch_code == 8) {  // left/side
      for (int i = 0; i < n; i++) {
        a[i] = c0[i];
        b[i] = static_cast<int64_t>(c0[i]) - c1[i];
      }
      encode_subframe(w, a.data(), n, bps);
      encode_subframe(w, b.data(), n, bps + 1);
    } else if (ch_code == 9) {  // right/side
      for (int i = 0; i < n; i++) {
        a[i] = static_cast<int64_t>(c0[i]) - c1[i];
        b[i] = c1[i];
      }
      encode_subframe(w, a.data(), n, bps + 1);
      encode_subframe(w, b.data(), n, bps);
    } else if (ch_code == 10) {  // mid/side
      for (int i = 0; i < n; i++) {
        a[i] = (static_cast<int64_t>(c0[i]) + c1[i]) >> 1;
        b[i] = static_cast<int64_t>(c0[i]) - c1[i];
      }
      encode_subframe(w, a.data(), n, bps);
      encode_subframe(w, b.data(), n, bps + 1);
    } else {
      for (int c = 0; c < nch; c++) {
        const int32_t* cc = samples + static_cast<int64_t>(c) * t + start;
        for (int i = 0; i < n; i++) a[i] = cc[i];
        encode_subframe(w, a.data(), n, bps);
      }
    }
    w.align();
    uint16_t crc = crc16(w.buf().data(), w.buf().size());
    out.insert(out.end(), w.buf().begin(), w.buf().end());
    out.push_back(static_cast<uint8_t>(crc >> 8));
    out.push_back(static_cast<uint8_t>(crc));
    frame_idx++;
  }
  return out;
}

void set_err(char* errbuf, size_t errlen, const std::string& msg) {
  if (errbuf && errlen) {
    size_t n = msg.size() < errlen - 1 ? msg.size() : errlen - 1;
    memcpy(errbuf, msg.data(), n);
    errbuf[n] = 0;
  }
}

}  // namespace

extern "C" {

// Decode a FLAC byte buffer.  On success returns 0 and sets *out to a
// malloc'd planar int32 array of shape (nch, nsamp).  Caller frees with
// ou_free.  On failure returns -1 and writes the message to errbuf.
int ou_flac_decode(const uint8_t* data, size_t len, int32_t** out,
                   int32_t* nch, int64_t* nsamp, int32_t* rate, int32_t* bps,
                   char* errbuf, size_t errlen) {
  try {
    Decoded d = decode_flac(data, len);
    size_t bytes = d.samples.size() * sizeof(int32_t);
    *out = static_cast<int32_t*>(malloc(bytes ? bytes : 1));
    if (!*out) throw FlacError("flac: out of memory");
    memcpy(*out, d.samples.data(), bytes);
    *nch = d.nch;
    *nsamp = d.nsamp;
    *rate = d.rate;
    *bps = d.bps;
    return 0;
  } catch (const FlacError& e) {
    set_err(errbuf, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {
    set_err(errbuf, errlen, e.what());
    return -1;
  }
}

// Encode planar int32 samples (nch, t).  stereo_mode: 0=independent,
// 1=left_side, 2=right_side, 3=mid_side.  On success returns 0 and sets
// *out (malloc'd, caller frees with ou_free) and *outlen.
int ou_flac_encode(const int32_t* samples, int32_t nch, int64_t t, int32_t fs,
                   int32_t bps, int32_t block_size, int32_t stereo_mode,
                   uint8_t** out, size_t* outlen, char* errbuf,
                   size_t errlen) {
  try {
    std::vector<uint8_t> data =
        encode_flac(samples, nch, t, fs, bps, block_size, stereo_mode);
    *out = static_cast<uint8_t*>(malloc(data.size() ? data.size() : 1));
    if (!*out) throw FlacError("flac: out of memory");
    memcpy(*out, data.data(), data.size());
    *outlen = data.size();
    return 0;
  } catch (const FlacError& e) {
    set_err(errbuf, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {
    set_err(errbuf, errlen, e.what());
    return -1;
  }
}

void ou_free(void* p) { free(p); }

}  // extern "C"
