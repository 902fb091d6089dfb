// anuraxla native WAV batch decoder.
//
// Replaces the per-file librosa.load hot loop of the reference
// (08_fit_radial_detector.py:488-506) on the host side: a thread pool
// decodes RIFF/WAVE files (PCM 8/16/24/32-bit, IEEE float32/64) straight
// into a caller-provided [n, num_samples] float32 batch buffer — mono
// mixdown, crop/pad, optional Kaiser-polyphase resample (scipy
// resample_poly math) — zero Python in the loop.
// The TPU consumes the batch directly; decode of batch i+1 overlaps device
// compute of batch i (see anuraxla.pipeline.dataset).
//
// C ABI only (ctypes binding in wavloader.py). No exceptions across the
// boundary: every failure is a per-row ok=0 + truncated message.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

namespace {

constexpr uint16_t kPcm = 0x0001;
constexpr uint16_t kFloat = 0x0003;
constexpr uint16_t kExtensible = 0xFFFE;

struct Fmt {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

bool parse_wav(const uint8_t* raw, size_t raw_len, Fmt* fmt, const uint8_t** data,
               size_t* data_len, std::string* err) {
  if (raw_len < 12 || std::memcmp(raw, "RIFF", 4) != 0 ||
      std::memcmp(raw + 8, "WAVE", 4) != 0) {
    *err = "not a RIFF/WAVE file";
    return false;
  }
  size_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= raw_len) {
    const uint8_t* cid = raw + pos;
    uint32_t size = rd_u32(raw + pos + 4);
    size_t body = pos + 8;
    size_t avail = raw_len > body ? raw_len - body : 0;
    size_t take = size < avail ? size : avail;  // tolerate truncated files
    if (std::memcmp(cid, "fmt ", 4) == 0 && take >= 16) {
      const uint8_t* b = raw + body;
      fmt->format = rd_u16(b);
      fmt->channels = rd_u16(b + 2);
      fmt->sample_rate = rd_u32(b + 4);
      fmt->bits = rd_u16(b + 14);
      // spec-complete extensible fmt is 40 bytes (16 base + cbSize + 22 ext);
      // threshold matches utils/wavio.py so native and Python agree on
      // truncated extension headers (both reject them)
      if (fmt->format == kExtensible && take >= 40) {
        fmt->format = rd_u16(b + 24);  // first 2 bytes of SubFormat GUID
      }
      have_fmt = true;
    } else if (std::memcmp(cid, "data", 4) == 0) {
      *data = raw + body;
      *data_len = take;
      have_data = true;
    }
    pos = body + size + (size & 1);  // word alignment
  }
  if (!have_fmt || !have_data) {
    *err = "WAV missing fmt/data chunk";
    return false;
  }
  if (fmt->channels == 0) {
    *err = "WAV has zero channels";
    return false;
  }
  // a zero rate divides by zero in the resampler's gcd reduction and an
  // absurd one demands a multi-billion-tap filter design — both are corrupt
  // headers; fail the file, never the process (2 MHz covers every real
  // audio format with wide margin)
  if (fmt->sample_rate == 0 || fmt->sample_rate > 2000000u) {
    *err = "implausible WAV sample rate";
    return false;
  }
  return true;
}

// Decode interleaved sample frames to mono float32 (mean over channels).
// ``max_frames`` bounds the decode (crop-early: callers that don't resample
// never touch bytes past the analysis window).
bool decode_mono(const Fmt& fmt, const uint8_t* data, size_t len,
                 std::vector<float>* out, std::string* err,
                 size_t max_frames = SIZE_MAX) {
  const int ch = fmt.channels;
  const int bytes = fmt.bits / 8;
  if (bytes == 0) {
    *err = "zero bit depth";
    return false;
  }
  const size_t frame_bytes = static_cast<size_t>(bytes) * ch;
  size_t frames = len / frame_bytes;
  if (frames > max_frames) frames = max_frames;
  out->resize(frames);
  const float inv_ch = 1.0f / static_cast<float>(ch);

  auto fail = [&](const char* m) {
    *err = m;
    return false;
  };

  if (fmt.format == kFloat) {
    if (fmt.bits == 32) {
      for (size_t i = 0; i < frames; ++i) {
        const uint8_t* f = data + i * frame_bytes;
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) {
          float v;
          std::memcpy(&v, f + c * 4, 4);
          acc += v;
        }
        (*out)[i] = acc * inv_ch;
      }
    } else if (fmt.bits == 64) {
      for (size_t i = 0; i < frames; ++i) {
        const uint8_t* f = data + i * frame_bytes;
        double acc = 0.0;
        for (int c = 0; c < ch; ++c) {
          double v;
          std::memcpy(&v, f + c * 8, 8);
          acc += v;
        }
        (*out)[i] = static_cast<float>(acc * inv_ch);
      }
    } else {
      return fail("unsupported float bit depth");
    }
    return true;
  }
  if (fmt.format != kPcm) return fail("unsupported WAV format tag");

  switch (fmt.bits) {
    case 8:
      for (size_t i = 0; i < frames; ++i) {
        const uint8_t* f = data + i * frame_bytes;
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += (static_cast<float>(f[c]) - 128.0f) / 128.0f;
        (*out)[i] = acc * inv_ch;
      }
      return true;
    case 16:
      for (size_t i = 0; i < frames; ++i) {
        const uint8_t* f = data + i * frame_bytes;
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) {
          int16_t v = static_cast<int16_t>(rd_u16(f + c * 2));
          acc += static_cast<float>(v) / 32768.0f;
        }
        (*out)[i] = acc * inv_ch;
      }
      return true;
    case 24:
      for (size_t i = 0; i < frames; ++i) {
        const uint8_t* f = data + i * frame_bytes;
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) {
          const uint8_t* s = f + c * 3;
          int32_t v = static_cast<int32_t>(s[0]) | (static_cast<int32_t>(s[1]) << 8) |
                      (static_cast<int32_t>(s[2]) << 16);
          if (v >= (1 << 23)) v -= (1 << 24);
          acc += static_cast<float>(v) / 8388608.0f;
        }
        (*out)[i] = acc * inv_ch;
      }
      return true;
    case 32:
      for (size_t i = 0; i < frames; ++i) {
        const uint8_t* f = data + i * frame_bytes;
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) {
          int32_t v = static_cast<int32_t>(rd_u32(f + c * 4));
          acc += static_cast<float>(v) / 2147483648.0f;
        }
        (*out)[i] = acc * inv_ch;
      }
      return true;
    default:
      return fail("unsupported PCM bit depth");
  }
}

// --- Kaiser-windowed polyphase resampler ------------------------------------
//
// Same math as scipy.signal.resample_poly(x, up, down) with its default
// ('kaiser', 5.0) window — which is also this package's Python fallback
// (utils/wavio.resample), so native and Python decode paths now agree to
// float32 rounding instead of the old linear-interp ~1% drift. (The
// reference resamples via librosa.load's soxr [map_detector_core.py:227];
// a Kaiser polyphase FIR is the same filter family soxr implements.)

double bessel_i0(double x) {
  // power series sum_k ((x/2)^k / k!)^2; converges to double precision
  const double hx = 0.5 * x;
  double term = 1.0, sum = 1.0;
  for (int k = 1; k < 200; ++k) {
    term *= hx / k;
    const double add = term * term;
    sum += add;
    if (add < sum * 1e-18) break;
  }
  return sum;
}

// firwin(2*half_len+1, 1/max_rate, window=('kaiser', 5.0)), normalized to
// unit DC gain, then scaled by `up` (resample_poly's h *= up).
std::vector<double> design_resample_fir(int up, int down) {
  const int max_rate = up > down ? up : down;
  const double f_c = 1.0 / max_rate;
  const int half_len = 10 * max_rate;
  const int numtaps = 2 * half_len + 1;
  const double alpha = 0.5 * (numtaps - 1);
  const double beta = 5.0;
  const double i0b = bessel_i0(beta);
  std::vector<double> h(numtaps);
  double sum = 0.0;
  for (int i = 0; i < numtaps; ++i) {
    const double m = i - alpha;
    const double x = f_c * m;
    const double sinc = x == 0.0 ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    const double r = m / alpha;
    const double w = bessel_i0(beta * std::sqrt(1.0 - r * r)) / i0b;
    h[i] = f_c * sinc * w;
    sum += h[i];
  }
  for (double& v : h) v = v / sum * up;
  return h;
}

struct ResampleFilter {
  int up = 1, down = 1;
  int n_pre_pad = 0;    // leading zeros (group-delay alignment, scipy)
  int n_pre_remove = 0; // leading outputs dropped
  std::vector<double> h;  // WITHOUT the pre-pad; indexed via n_pre_pad offset
};

// one filter per (up, down) pair, shared across the decode thread pool
const ResampleFilter* get_resample_filter(int up, int down) {
  static std::mutex mu;
  static std::vector<ResampleFilter*> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto* f : cache)
    if (f->up == up && f->down == down) return f;
  auto* f = new ResampleFilter();
  f->up = up;
  f->down = down;
  f->h = design_resample_fir(up, down);
  const int half_len = 10 * (up > down ? up : down);
  f->n_pre_pad = down - half_len % down;
  f->n_pre_remove = (half_len + f->n_pre_pad) / down;
  cache.push_back(f);
  return f;
}

bool resample_poly_kaiser(const std::vector<float>& in, uint32_t sr_in,
                          uint32_t sr_out, std::vector<float>* out,
                          std::string* err) {
  if (sr_in == sr_out || in.empty()) {
    *out = in;
    return true;
  }
  uint32_t a = sr_in, b = sr_out;
  while (b) { const uint32_t t = a % b; a = b; b = t; }
  const uint32_t up_u = sr_out / a, down_u = sr_in / a;
  // filter length is 20*max(up,down)+1 taps: bound it so a co-prime header
  // rate can cost at most ~2.6M taps of one-time (cached) design work, and
  // the int32 tap math below can never overflow
  if ((up_u > down_u ? up_u : down_u) > (1u << 17)) {
    *err = "unsupported resample ratio (filter too long)";
    return false;
  }
  const int up = static_cast<int>(up_u);
  const int down = static_cast<int>(down_u);
  const ResampleFilter* f = get_resample_filter(up, down);
  const int64_t n_in = static_cast<int64_t>(in.size());
  const int64_t n_out = n_in * up / down + ((n_in * up) % down != 0);
  const int64_t taps = static_cast<int64_t>(f->h.size());
  out->resize(static_cast<size_t>(n_out));
  // y[t] = sum_i x[i] * h_pad[(t + n_pre_remove)*down - i*up], h_pad =
  // n_pre_pad zeros then h — evaluated polyphase: ~taps/up MACs per output
  for (int64_t t = 0; t < n_out; ++t) {
    const int64_t j = (t + f->n_pre_remove) * static_cast<int64_t>(down)
                      - f->n_pre_pad;  // index into h proper
    // need 0 <= j - i*up <= taps-1  ->  i in [ceil((j-taps+1)/up), floor(j/up)]
    int64_t i_lo = (j - taps + 1 + up - 1) / up;  // ceil for positive up
    if (j - taps + 1 <= 0) i_lo = (j - taps + 1) / up;  // floor-div fix
    if (i_lo < 0) i_lo = 0;
    int64_t i_hi = j >= 0 ? j / up : -1;
    if (i_hi > n_in - 1) i_hi = n_in - 1;
    double acc = 0.0;
    for (int64_t i = i_lo; i <= i_hi; ++i)
      acc += static_cast<double>(in[static_cast<size_t>(i)]) *
             f->h[static_cast<size_t>(j - i * up)];
    (*out)[static_cast<size_t>(t)] = static_cast<float>(acc);
  }
  return true;
}

// mmap'd read-only view (zero-copy: the decoder reads PCM straight from the
// page cache; fread's extra full-file copy measured ~25% of decode time on
// PCM16 chunks). Falls back with an error message on open/stat/map failure.
struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_ro(const char* path, std::string* err) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) {
      *err = "cannot open file";
      return false;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 0) {
      *err = "cannot stat file";
      return false;
    }
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      *err = "empty file";
      return false;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      *err = "mmap failed";
      return false;
    }
    data = static_cast<const uint8_t*>(p);
    // the decoder sweeps each mapping exactly once front-to-back; aggressive
    // readahead on cold-cache page-ins (measured on this host: cold mmap
    // 0.75-1.1 GB/s vs 1.25-1.36 GB/s O_DIRECT — scripts/probe_cold_io.py;
    // the hint narrows that gap for free, and decode stays CPU-bound either
    // way on a 1-core host, so no O_DIRECT path: measured negative)
    posix_madvise(p, size, POSIX_MADV_SEQUENTIAL);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<uint8_t*>(static_cast<const uint8_t*>(data)), size);
    if (fd >= 0) ::close(fd);
  }
};

// Direct-to-row decode for the dominant cases (no resample needed): writes
// at most num_samples frames straight into the batch row — no intermediate
// vector, tight loops the compiler auto-vectorizes. Returns false when the
// (format, channels) pair has no fast path (generic decode handles it).
bool decode_fast_to_row(const Fmt& fmt, const uint8_t* data, size_t len,
                        float* row, int64_t num_samples) {
  const size_t want = static_cast<size_t>(num_samples);
  if (fmt.format == kPcm && fmt.bits == 16 && fmt.channels == 1) {
    size_t frames = len / 2;
    if (frames > want) frames = want;
    constexpr float kInv = 1.0f / 32768.0f;
    for (size_t i = 0; i < frames; ++i) {
      int16_t v;
      std::memcpy(&v, data + 2 * i, 2);  // little-endian host
      row[i] = static_cast<float>(v) * kInv;
    }
    return true;
  }
  if (fmt.format == kPcm && fmt.bits == 16 && fmt.channels == 2) {
    size_t frames = len / 4;
    if (frames > want) frames = want;
    constexpr float kInv = 0.5f / 32768.0f;
    for (size_t i = 0; i < frames; ++i) {
      int16_t l, r;
      std::memcpy(&l, data + 4 * i, 2);
      std::memcpy(&r, data + 4 * i + 2, 2);
      row[i] = (static_cast<float>(l) + static_cast<float>(r)) * kInv;
    }
    return true;
  }
  if (fmt.format == kFloat && fmt.bits == 32 && fmt.channels == 1) {
    size_t frames = len / 4;
    if (frames > want) frames = want;
    if (frames) std::memcpy(row, data, frames * 4);
    return true;
  }
  return false;
}

void load_one(const char* path, int target_sr, int64_t num_samples, float* row,
              uint8_t* ok, char* err_out, int err_cap) {
  std::string err;
  std::vector<float> mono, res;
  Fmt fmt;
  const uint8_t* data = nullptr;
  size_t data_len = 0;

  std::memset(row, 0, sizeof(float) * static_cast<size_t>(num_samples));
  *ok = 0;
  MappedFile mf;
  if (!mf.open_ro(path, &err) ||
      !parse_wav(mf.data, mf.size, &fmt, &data, &data_len, &err)) {
    std::snprintf(err_out, err_cap, "%s", err.c_str());
    return;
  }
  const bool native_rate = static_cast<int>(fmt.sample_rate) == target_sr;
  if (native_rate && decode_fast_to_row(fmt, data, data_len, row, num_samples)) {
    *ok = 1;
    return;
  }
  // generic path; crop-early when no resample will run
  const size_t max_frames = native_rate ? static_cast<size_t>(num_samples) : SIZE_MAX;
  if (!decode_mono(fmt, data, data_len, &mono, &err, max_frames)) {
    std::snprintf(err_out, err_cap, "%s", err.c_str());
    return;
  }
  const std::vector<float>* src = &mono;
  if (!native_rate) {
    if (!resample_poly_kaiser(mono, fmt.sample_rate,
                              static_cast<uint32_t>(target_sr), &res, &err)) {
      std::snprintf(err_out, err_cap, "%s", err.c_str());
      return;
    }
    src = &res;
  }
  const size_t n = src->size() < static_cast<size_t>(num_samples)
                       ? src->size()
                       : static_cast<size_t>(num_samples);
  if (n) std::memcpy(row, src->data(), n * sizeof(float));
  *ok = 1;
}

}  // namespace

extern "C" {

// Decode n WAVs into rows of row_stride floats, each file's samples written
// at out[i*row_stride + col_offset .. +num_samples). Regions outside the
// sample window are left untouched (the caller provides a zeroed buffer) —
// this is how the TPU mel kernel's pre-padded phase layout is produced at
// zero extra host cost: the decoder memcpys into a preallocated row either
// way, so the write offset is free (vs ~2.2 GB/batch of device HBM traffic
// for the on-device jnp.pad it replaces). Returns the successful-row count.
int avld_load_wav_batch_strided(const char** paths, int n, int target_sr,
                                int64_t num_samples, float* out,
                                int64_t row_stride, int64_t col_offset,
                                uint8_t* ok, char* errs, int err_stride,
                                int num_threads) {
  if (n <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;

  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      load_one(paths[i], target_sr, num_samples,
               out + static_cast<size_t>(i) * row_stride + col_offset,
               ok + i, errs + static_cast<size_t>(i) * err_stride, err_stride);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(num_threads - 1);
  for (int t = 1; t < num_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();

  int good = 0;
  for (int i = 0; i < n; ++i) good += ok[i] ? 1 : 0;
  return good;
}

// Decode n WAVs into out[n * num_samples] (row-major), filling ok[n] and a
// fixed-stride error string table. Returns the number of successful rows.
int avld_load_wav_batch(const char** paths, int n, int target_sr, int64_t num_samples,
                        float* out, uint8_t* ok, char* errs, int err_stride,
                        int num_threads) {
  return avld_load_wav_batch_strided(paths, n, target_sr, num_samples, out,
                                     num_samples, 0, ok, errs, err_stride,
                                     num_threads);
}

// Introspection hook for the binding layer.
int avld_abi_version() { return 2; }

}  // extern "C"
