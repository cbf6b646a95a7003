// WAV audio file IO (RIFF PCM16/PCM32/float32).
//
// The reference declares a WAV header struct but never parses files
// (audio_spectrum.c:20-34); this implements the capability for real, as
// the host-side data loader feeding the device analysis pipelines.
//
// C ABI for ctypes: all functions return 0 / positive on success,
// negative error codes on failure.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

#pragma pack(push, 1)
struct RiffHeader {
  char riff[4];       // "RIFF"
  uint32_t size;
  char wave[4];       // "WAVE"
};
struct ChunkHeader {
  char id[4];
  uint32_t size;
};
struct FmtChunk {
  uint16_t format;        // 1 = PCM, 3 = IEEE float
  uint16_t channels;
  uint32_t sample_rate;
  uint32_t byte_rate;
  uint16_t block_align;
  uint16_t bits_per_sample;
};
#pragma pack(pop)

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrUnsupported = -3;
constexpr int kErrTruncated = -4;

struct WavInfo {
  FmtChunk fmt{};
  long data_offset = 0;
  long data_bytes = 0;
};

int parse_header(FILE* f, WavInfo* info) {
  RiffHeader rh;
  if (fread(&rh, sizeof(rh), 1, f) != 1) return kErrFormat;
  if (memcmp(rh.riff, "RIFF", 4) != 0 || memcmp(rh.wave, "WAVE", 4) != 0)
    return kErrFormat;
  bool have_fmt = false;
  ChunkHeader ch;
  while (fread(&ch, sizeof(ch), 1, f) == 1) {
    if (memcmp(ch.id, "fmt ", 4) == 0) {
      if (ch.size < sizeof(FmtChunk)) return kErrFormat;
      if (fread(&info->fmt, sizeof(FmtChunk), 1, f) != 1) return kErrFormat;
      if (ch.size > sizeof(FmtChunk))
        fseek(f, ch.size - sizeof(FmtChunk), SEEK_CUR);
      // Only byte-aligned PCM/float widths; anything else (including
      // 1..7-bit) would divide by bits/8 == 0 downstream.
      switch (info->fmt.bits_per_sample) {
        case 8: case 16: case 24: case 32: break;
        default: return kErrUnsupported;
      }
      have_fmt = true;
    } else if (memcmp(ch.id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = ch.size;
      if (!have_fmt) return kErrFormat;
      return 0;
    } else {
      fseek(f, ch.size + (ch.size & 1), SEEK_CUR);  // chunks are 2-aligned
    }
  }
  return kErrFormat;
}

}  // namespace

extern "C" {

// Fills sample_rate / channels / frames / bits; returns 0 or error.
int fftlab_wav_info(const char* path, int32_t* sample_rate,
                    int32_t* channels, int64_t* frames, int32_t* bits) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  WavInfo info;
  int rc = parse_header(f, &info);
  fclose(f);
  if (rc != 0) return rc;
  const FmtChunk& m = info.fmt;
  if (m.channels == 0 || m.bits_per_sample == 0) return kErrFormat;
  *sample_rate = (int32_t)m.sample_rate;
  *channels = (int32_t)m.channels;
  *bits = (int32_t)m.bits_per_sample;
  *frames = info.data_bytes / (m.channels * (m.bits_per_sample / 8));
  return 0;
}

// Reads up to max_samples interleaved samples as float32 in [-1, 1].
// Returns the number of samples read, or a negative error.
int64_t fftlab_wav_read_f32(const char* path, float* out,
                            int64_t max_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  WavInfo info;
  int rc = parse_header(f, &info);
  if (rc != 0) { fclose(f); return rc; }
  const FmtChunk& m = info.fmt;
  int bytes = m.bits_per_sample / 8;
  int64_t total = info.data_bytes / bytes;
  if (total > max_samples) total = max_samples;
  fseek(f, info.data_offset, SEEK_SET);
  int64_t got = 0;
  std::vector<uint8_t> buf(65536);
  while (got < total) {
    int64_t want = std::min<int64_t>((int64_t)(buf.size() / bytes),
                                     total - got);
    size_t nread = fread(buf.data(), bytes, (size_t)want, f);
    if (nread == 0) break;
    const uint8_t* p = buf.data();
    for (size_t i = 0; i < nread; ++i, p += bytes) {
      float v;
      if (m.format == 3 && m.bits_per_sample == 32) {
        memcpy(&v, p, 4);
      } else if (m.format == 1 && m.bits_per_sample == 16) {
        int16_t s; memcpy(&s, p, 2);
        v = (float)s / 32768.0f;
      } else if (m.format == 1 && m.bits_per_sample == 32) {
        int32_t s; memcpy(&s, p, 4);
        v = (float)((double)s / 2147483648.0);
      } else if (m.format == 1 && m.bits_per_sample == 8) {
        v = ((float)*p - 128.0f) / 128.0f;
      } else if (m.format == 1 && m.bits_per_sample == 24) {
        int32_t s = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                              (uint32_t)p[2] << 24) >> 8;
        v = (float)((double)s / 8388608.0);
      } else {
        fclose(f);
        return kErrUnsupported;
      }
      out[got++] = v;
    }
  }
  fclose(f);
  return got;
}

// Writes interleaved float32 samples as 16-bit PCM. Returns 0 or error.
int fftlab_wav_write_pcm16(const char* path, const float* data,
                           int64_t frames, int32_t channels,
                           int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return kErrOpen;
  int64_t nsamp = frames * channels;
  uint32_t data_bytes = (uint32_t)(nsamp * 2);
  RiffHeader rh{{'R','I','F','F'},
                (uint32_t)(4 + 8 + sizeof(FmtChunk) + 8 + data_bytes),
                {'W','A','V','E'}};
  fwrite(&rh, sizeof(rh), 1, f);
  ChunkHeader fc{{'f','m','t',' '}, sizeof(FmtChunk)};
  fwrite(&fc, sizeof(fc), 1, f);
  FmtChunk m{1, (uint16_t)channels, (uint32_t)sample_rate,
             (uint32_t)(sample_rate * channels * 2),
             (uint16_t)(channels * 2), 16};
  fwrite(&m, sizeof(m), 1, f);
  ChunkHeader dc{{'d','a','t','a'}, data_bytes};
  fwrite(&dc, sizeof(dc), 1, f);
  std::vector<int16_t> chunk(65536);
  int64_t done = 0;
  while (done < nsamp) {
    int64_t want = std::min<int64_t>((int64_t)chunk.size(), nsamp - done);
    for (int64_t i = 0; i < want; ++i) {
      float v = data[done + i];
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      float scaled = v * 32767.0f;
      chunk[(size_t)i] = (int16_t)(scaled >= 0 ? scaled + 0.5f
                                               : scaled - 0.5f);
    }
    fwrite(chunk.data(), 2, (size_t)want, f);
    done += want;
  }
  fclose(f);
  return 0;
}

}  // extern "C"
