// Native batched audio loader of the port's data pipeline: the port's own
// copy of the JAX package's native/audioload.cpp (the port imports nothing of
// that package). Multi-threaded WAV + FLAC decode + mono downmix +
// random-crop/pad directly into a caller-provided float32 batch buffer, so the
// Python hot loop does zero per-sample work. The FLAC decoder is a from-
// scratch implementation of the format (metadata blocks, frame headers,
// constant/verbatim/fixed/LPC subframes, rice + rice2 residual coding with
// escape partitions, wasted bits, and left/right/mid-side stereo modes).
// Built with g++ at first use by data/native_loader.py.
//
// Exposed C ABI (ctypes):
//   int al_load_batch(const char** paths, int n, long max_length,
//                     unsigned long long seed, float* out, long* out_lengths,
//                     int* out_rates, int num_threads);
//     out: (n, max_length) float32, zero-padded.  Returns 0 on success,
//     else the index+1 of the first failing file.
//   int al_probe(const char* path, long* length, int* rate, int* channels);
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libaudioload.so audioload.cpp -lpthread
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Wav {
  std::vector<float> samples;  // mono
  int rate = 0;
  int channels = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

bool parse_wav_buf(const uint8_t* buf, long size, Wav& out) {
  if (size < 44) return false;
  if (memcmp(buf, "RIFF", 4) || memcmp(buf + 8, "WAVE", 4))
    return false;

  int fmt = 0, channels = 0, rate = 0, bits = 0;
  const uint8_t* data = nullptr;
  long data_len = 0;
  long pos = 12;
  while (pos + 8 <= size) {
    const uint8_t* chunk = buf + pos;
    uint32_t clen = rd_u32(chunk + 4);
    if (!memcmp(chunk, "fmt ", 4) && clen >= 16 && pos + 8 + 16 <= size) {
      fmt = rd_u16(chunk + 8);
      channels = rd_u16(chunk + 10);
      rate = (int)rd_u32(chunk + 12);
      bits = rd_u16(chunk + 22);
    } else if (!memcmp(chunk, "data", 4)) {
      data = chunk + 8;
      data_len = clen;
      if (pos + 8 + data_len > size) data_len = size - pos - 8;
    }
    pos += 8 + clen + (clen & 1);
  }
  if (!data || channels <= 0 || rate <= 0) return false;

  long frames;
  out.rate = rate;
  out.channels = channels;
  const float inv_ch = 1.0f / channels;

  if (fmt == 1 && bits == 16) {
    frames = data_len / (2 * channels);
    out.samples.resize(frames);
    const int16_t* s = reinterpret_cast<const int16_t*>(data);
    for (long i = 0; i < frames; i++) {
      float acc = 0;
      for (int c = 0; c < channels; c++) acc += s[i * channels + c];
      out.samples[i] = acc * inv_ch / 32768.0f;
    }
  } else if (fmt == 1 && bits == 32) {
    frames = data_len / (4 * channels);
    out.samples.resize(frames);
    const int32_t* s = reinterpret_cast<const int32_t*>(data);
    for (long i = 0; i < frames; i++) {
      double acc = 0;
      for (int c = 0; c < channels; c++) acc += s[i * channels + c];
      out.samples[i] = (float)(acc * inv_ch / 2147483648.0);
    }
  } else if (fmt == 1 && bits == 24) {
    frames = data_len / (3 * channels);
    out.samples.resize(frames);
    for (long i = 0; i < frames; i++) {
      float acc = 0;
      for (int c = 0; c < channels; c++) {
        const uint8_t* p = data + (i * channels + c) * 3;
        int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
        if (v & 0x800000) v -= 0x1000000;
        acc += (float)v;
      }
      out.samples[i] = acc * inv_ch / 8388608.0f;
    }
  } else if (fmt == 3 && bits == 32) {  // IEEE float
    frames = data_len / (4 * channels);
    out.samples.resize(frames);
    const float* s = reinterpret_cast<const float*>(data);
    for (long i = 0; i < frames; i++) {
      float acc = 0;
      for (int c = 0; c < channels; c++) acc += s[i * channels + c];
      out.samples[i] = acc * inv_ch;
    }
  } else {
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// FLAC decoder (from scratch; format per the public FLAC spec).
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed in current byte (0..7), MSB-first
  bool error = false;

  bool eof() const { return byte >= size; }

  uint32_t read_bits(int n) {  // n in [0, 32]
    uint32_t v = 0;
    while (n > 0) {
      if (byte >= size) { error = true; return 0; }
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      uint32_t chunk = (data[byte] >> (avail - take)) & ((1u << take) - 1);
      v = (v << take) | chunk;
      bit += take;
      if (bit == 8) { bit = 0; byte++; }
      n -= take;
    }
    return v;
  }

  uint64_t read_bits64(int n) {  // n in [0, 64]
    if (n <= 32) return read_bits(n);
    uint64_t hi = read_bits(n - 32);
    uint64_t lo = read_bits(32);
    return (hi << 32) | lo;
  }

  int64_t read_signed(int n) {  // two's-complement sign extension
    if (n == 0) return 0;
    uint64_t v = read_bits64(n);
    uint64_t sign = 1ull << (n - 1);
    return (int64_t)((v ^ sign) - sign);
  }

  uint32_t read_unary() {  // count of 0 bits before the terminating 1
    uint32_t q = 0;
    for (;;) {
      if (byte >= size) { error = true; return 0; }
      // fast path: scan remaining bits of this byte
      uint8_t rest = (uint8_t)(data[byte] << bit);
      if (rest == 0) {
        q += 8 - bit;
        bit = 0;
        byte++;
        continue;
      }
      int lead = __builtin_clz((uint32_t)rest) - 24;  // leading zeros in 8 bits
      q += lead;
      bit += lead + 1;
      if (bit >= 8) { bit -= 8; byte++; }
      return q;
    }
  }

  void align() {
    if (bit) { bit = 0; byte++; }
  }

  void skip_bytes(size_t n) {
    align();
    byte += n;
    if (byte > size) error = true;
  }
};

// UTF-8-style coded number used for frame/sample numbers (up to 36 bits).
bool read_utf8_number(BitReader& br, uint64_t* out) {
  uint32_t b0 = br.read_bits(8);
  if (br.error) return false;
  int extra;
  uint64_t v;
  if (b0 < 0x80) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { extra = 6; v = 0; }
  else return false;
  for (int i = 0; i < extra; i++) {
    uint32_t b = br.read_bits(8);
    if (br.error || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

// Decode one residual-coded partition set into res[0..n-1] (n = blocksize -
// predictor order).
bool read_residual(BitReader& br, int blocksize, int order,
                   std::vector<int64_t>& res) {
  uint32_t method = br.read_bits(2);
  if (br.error || method > 1) return false;
  int plen = method == 0 ? 4 : 5;  // rice vs rice2 parameter width
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t porder = br.read_bits(4);
  int partitions = 1 << porder;
  if (blocksize % partitions != 0) return false;
  int part_samples = blocksize >> porder;
  if (part_samples <= 0) return false;
  res.resize((size_t)(blocksize - order));
  size_t idx = 0;
  for (int p = 0; p < partitions; p++) {
    int count = part_samples - (p == 0 ? order : 0);
    if (count < 0) return false;
    uint32_t param = br.read_bits(plen);
    if (br.error) return false;
    if (param == escape) {
      uint32_t rawbits = br.read_bits(5);
      for (int i = 0; i < count; i++)
        res[idx++] = rawbits ? br.read_signed(rawbits) : 0;
    } else {
      for (int i = 0; i < count; i++) {
        uint32_t q = br.read_unary();
        uint32_t lo = param ? br.read_bits(param) : 0;
        uint64_t u = ((uint64_t)q << param) | lo;
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // zigzag
      }
    }
    if (br.error) return false;
  }
  return idx == (size_t)(blocksize - order);
}

// Decode one subframe into out[0..blocksize-1] at effective bit depth `bps`.
bool read_subframe(BitReader& br, int blocksize, int bps,
                   std::vector<int64_t>& out) {
  if (br.read_bits(1) != 0) return false;  // mandatory zero pad bit
  uint32_t type = br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) wasted = (int)br.read_unary() + 1;
  if (br.error) return false;
  int ebps = bps - wasted;
  if (ebps <= 0 || ebps > 33) return false;
  out.resize((size_t)blocksize);

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (int i = 0; i < blocksize; i++) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) out[i] = br.read_signed(ebps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0..4
    int order = (int)type - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(ebps);
    std::vector<int64_t> res;
    if (!read_residual(br, blocksize, order, res)) return false;
    switch (order) {
      case 0:
        for (int i = 0; i < blocksize; i++) out[i] = res[i];
        break;
      case 1:
        for (int i = 1; i < blocksize; i++) out[i] = res[i - 1] + out[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; i++)
          out[i] = res[i - 2] + 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; i++)
          out[i] = res[i - 3] + 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; i++)
          out[i] = res[i - 4] + 4 * out[i - 1] - 6 * out[i - 2] +
                   4 * out[i - 3] - out[i - 4];
        break;
    }
  } else if (type >= 32) {  // LPC, order 1..32
    int order = (int)(type & 31) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(ebps);
    uint32_t prec = br.read_bits(4);
    if (br.error || prec == 15) return false;
    int precision = (int)prec + 1;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(precision);
    std::vector<int64_t> res;
    if (!read_residual(br, blocksize, order, res)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t pred = 0;
      for (int j = 0; j < order; j++) pred += coef[j] * out[i - 1 - j];
      out[i] = res[i - order] + (pred >> shift);
    }
  } else {
    return false;  // reserved subframe type
  }
  if (br.error) return false;
  if (wasted)
    for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
  return true;
}

bool parse_flac(const uint8_t* buf, size_t size, Wav& out) {
  if (size < 42 || memcmp(buf, "fLaC", 4)) return false;
  BitReader br{buf, size, 4, 0, false};

  int si_rate = 0, si_channels = 0, si_bps = 0;
  uint64_t total_samples = 0;
  bool have_streaminfo = false, last = false;
  while (!last) {
    uint32_t hdr = br.read_bits(8);
    if (br.error) return false;
    last = (hdr & 0x80) != 0;
    uint32_t btype = hdr & 0x7F;
    uint32_t blen = br.read_bits(24);
    if (btype == 0) {  // STREAMINFO
      if (blen < 34) return false;
      br.read_bits(16);  // min blocksize
      br.read_bits(16);  // max blocksize
      br.read_bits(24);  // min framesize
      br.read_bits(24);  // max framesize
      si_rate = (int)br.read_bits(20);
      si_channels = (int)br.read_bits(3) + 1;
      si_bps = (int)br.read_bits(5) + 1;
      total_samples = br.read_bits64(36);
      br.skip_bytes(16 + (blen - 34));  // md5 + any extension
      have_streaminfo = true;
    } else {
      br.skip_bytes(blen);
    }
    if (br.error) return false;
  }
  if (!have_streaminfo || si_rate <= 0 || si_channels <= 0) return false;

  out.rate = si_rate;
  out.channels = si_channels;
  if (total_samples) out.samples.reserve((size_t)total_samples);
  const float inv_ch = 1.0f / si_channels;

  static const int kRateTable[12] = {0,     88200, 176400, 192000,
                                     8000,  16000, 22050,  24000,
                                     32000, 44100, 48000,  96000};

  std::vector<int64_t> ch_buf[8];
  std::vector<int64_t> sub;
  while (true) {
    br.align();
    if (br.byte >= br.size) break;  // clean end of stream
    if (total_samples && out.samples.size() >= total_samples) break;

    // frame header: 14-bit sync 11111111111110
    uint32_t sync = br.read_bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return false;
    br.read_bits(1);                       // reserved
    br.read_bits(1);                       // blocking strategy
    uint32_t bs_code = br.read_bits(4);
    uint32_t sr_code = br.read_bits(4);
    uint32_t ch_asgn = br.read_bits(4);
    uint32_t ss_code = br.read_bits(3);
    br.read_bits(1);                       // reserved
    uint64_t num;
    if (!read_utf8_number(br, &num)) return false;

    int blocksize;
    if (bs_code == 0) return false;        // reserved
    else if (bs_code == 1) blocksize = 192;
    else if (bs_code <= 5) blocksize = 576 << (bs_code - 2);
    else if (bs_code == 6) blocksize = (int)br.read_bits(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.read_bits(16) + 1;
    else blocksize = 256 << (bs_code - 8);

    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    else if (sr_code == 15) return false;
    (void)kRateTable;  // frame rate must match STREAMINFO; we trust STREAMINFO

    int bps;
    switch (ss_code) {
      case 0: bps = si_bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return false;
    }
    br.read_bits(8);  // header CRC-8 (not verified)
    if (br.error) return false;

    int nch = ch_asgn < 8 ? (int)ch_asgn + 1 : 2;
    if (nch != si_channels || nch > 8) return false;
    for (int c = 0; c < nch; c++) {
      // in left/side (8) the 2nd channel, in right/side (9) the 1st, and in
      // mid/side (10) the 2nd carry the side signal at bps+1 bits
      int sub_bps = bps;
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        sub_bps += 1;
      if (!read_subframe(br, blocksize, sub_bps, sub)) return false;
      ch_buf[c] = sub;
    }
    br.align();
    br.read_bits(16);  // frame CRC-16 (not verified)
    if (br.error) return false;

    // undo stereo decorrelation
    if (ch_asgn == 8) {  // left/side: right = left - side
      for (int i = 0; i < blocksize; i++)
        ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
    } else if (ch_asgn == 9) {  // right/side: left = side + right
      for (int i = 0; i < blocksize; i++)
        ch_buf[0][i] = ch_buf[0][i] + ch_buf[1][i];
    } else if (ch_asgn == 10) {  // mid/side
      for (int i = 0; i < blocksize; i++) {
        int64_t side = ch_buf[1][i];
        int64_t mid = (ch_buf[0][i] << 1) | (side & 1);
        ch_buf[0][i] = (mid + side) >> 1;
        ch_buf[1][i] = (mid - side) >> 1;
      }
    }

    const float scale = inv_ch / (float)(1ull << (bps - 1));
    size_t keep = (size_t)blocksize;
    if (total_samples) {
      size_t remain = (size_t)total_samples - out.samples.size();
      if (keep > remain) keep = remain;
    }
    for (size_t i = 0; i < keep; i++) {
      float acc = 0;
      for (int c = 0; c < nch; c++) acc += (float)ch_buf[c][i];
      out.samples.push_back(acc * scale);
    }
  }
  return !out.samples.empty();
}

// Dispatch on file magic: RIFF/WAVE or fLaC.
bool parse_audio(const char* path, Wav& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 12) { fclose(f); return false; }
  std::vector<uint8_t> buf((size_t)size);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return false;
  }
  fclose(f);
  if (!memcmp(buf.data(), "fLaC", 4))
    return parse_flac(buf.data(), buf.size(), out);
  return parse_wav_buf(buf.data(), (long)size, out);
}

}  // namespace

extern "C" {

int al_probe(const char* path, long* length, int* rate, int* channels) {
  Wav w;
  if (!parse_audio(path, w)) return 1;
  *length = (long)w.samples.size();
  *rate = w.rate;
  *channels = w.channels;
  return 0;
}

int al_load_batch(const char** paths, int n, long max_length,
                  unsigned long long seed, float* out, long* out_lengths,
                  int* out_rates, int num_threads) {
  std::atomic<int> fail{0};
  std::atomic<int> next{0};
  if (num_threads < 1) num_threads = 1;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Wav w;
      if (!parse_audio(paths[i], w)) {
        int expected = 0;
        fail.compare_exchange_strong(expected, i + 1);
        continue;
      }
      out_rates[i] = w.rate;
      long len = (long)w.samples.size();
      float* dst = out + (long)i * max_length;
      if (len > max_length) {
        // deterministic random crop from (seed, i)
        std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ull + i);
        std::uniform_int_distribution<long> dist(0, len - max_length);
        long start = dist(rng);
        memcpy(dst, w.samples.data() + start, max_length * sizeof(float));
        out_lengths[i] = max_length;
      } else {
        memcpy(dst, w.samples.data(), len * sizeof(float));
        memset(dst + len, 0, (max_length - len) * sizeof(float));
        out_lengths[i] = len;
      }
    }
  };

  std::vector<std::thread> threads;
  int t = std::min(num_threads, n);
  for (int i = 0; i < t; i++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return fail.load();
}

}  // extern "C"
