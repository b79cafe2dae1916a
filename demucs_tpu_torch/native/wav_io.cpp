// Native WAV codec.
//
// Decoding is host-side work of the separation runtime (the reference
// decodes with libnyquist in C++, cli-apps/demucs.cpp:21-106): one pass
// over the payload converts PCM 8/16/24/32 or IEEE float32/float64
// straight into the planar (channels, frames) float32 layout the
// pipeline feeds the device, so the interleaved -> planar transpose
// happens during the width conversion instead of as a separate numpy
// pass. The encoder writes interleaved PCM16 from planar float32.
//
// Exported C ABI (bound with ctypes in demucs_tpu_torch/audio.py, which
// keeps a numpy path for hosts without g++):
//   wav_parse_header(buf, len, &channels, &rate, &bits, &tag,
//                    &frames, &data_off) -> 0 | error code
//   wav_decode_f32(buf, len, out[channels*frames]) -> 0 | error code
//   wav_encode_pcm16(planar, frames, channels, out) -> 0
//
// Error codes: 1 bad RIFF/WAVE, 2 missing fmt/data, 3 unsupported
// format. Chunk walking mirrors audio.py's numpy reader (pad byte on odd
// sizes, truncated trailing chunk tolerated).
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct WavInfo {
  int32_t channels = 0, rate = 0, bits = 0, tag = 0;
  int64_t frames = 0;
  uint64_t data_off = 0, data_len = 0;
};

uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

int parse(const uint8_t* buf, uint64_t len, WavInfo* w) {
  if (len < 12 || std::memcmp(buf, "RIFF", 4) != 0 ||
      std::memcmp(buf + 8, "WAVE", 4) != 0)
    return 1;
  uint64_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= len) {
    const uint8_t* cid = buf + pos;
    uint64_t size = rd32(buf + pos + 4);
    uint64_t body = pos + 8;
    uint64_t avail = len > body ? len - body : 0;
    uint64_t take = size < avail ? size : avail;
    if (std::memcmp(cid, "fmt ", 4) == 0 && take >= 16) {
      w->tag = rd16(buf + body);
      w->channels = rd16(buf + body + 2);
      w->rate = (int32_t)rd32(buf + body + 4);
      w->bits = rd16(buf + body + 14);
      if (w->tag == 0xFFFE && take >= 26)  // WAVE_FORMAT_EXTENSIBLE
        w->tag = rd16(buf + body + 24);
      have_fmt = true;
    } else if (std::memcmp(cid, "data", 4) == 0) {
      w->data_off = body;
      w->data_len = take;
      have_data = true;
    }
    pos = body + size + (size & 1);
  }
  if (!have_fmt || !have_data) return 2;
  if (w->channels <= 0) return 3;
  int64_t sample_bytes;
  if (w->tag == 1 && (w->bits == 8 || w->bits == 16 || w->bits == 24 ||
                      w->bits == 32))
    sample_bytes = w->bits / 8;
  else if (w->tag == 3 && (w->bits == 32 || w->bits == 64))
    sample_bytes = w->bits / 8;
  else
    return 3;
  w->frames = (int64_t)(w->data_len / (sample_bytes * w->channels));
  return 0;
}

// Decode interleaved sample i*C + c into planar out[c*frames + i].
template <typename Fn>
void deinterleave(const uint8_t* src, int64_t frames, int32_t ch,
                  int64_t stride, float* out, Fn cvt) {
  for (int32_t c = 0; c < ch; ++c) {
    float* dst = out + (int64_t)c * frames;
    const uint8_t* p = src + (int64_t)c * stride;
    for (int64_t i = 0; i < frames; ++i)
      dst[i] = cvt(p + i * stride * ch);
  }
}

}  // namespace

extern "C" {

int wav_parse_header(const uint8_t* buf, uint64_t len, int32_t* channels,
                     int32_t* rate, int32_t* bits, int32_t* tag,
                     int64_t* frames, uint64_t* data_off) {
  WavInfo w;
  int rc = parse(buf, len, &w);
  if (rc) return rc;
  *channels = w.channels;
  *rate = w.rate;
  *bits = w.bits;
  *tag = w.tag;
  *frames = w.frames;
  *data_off = w.data_off;
  return 0;
}

int wav_decode_f32(const uint8_t* buf, uint64_t len, float* out) {
  WavInfo w;
  int rc = parse(buf, len, &w);
  if (rc) return rc;
  const uint8_t* d = buf + w.data_off;
  const int64_t n = w.frames;
  const int32_t ch = w.channels;
  if (w.tag == 1 && w.bits == 8) {
    deinterleave(d, n, ch, 1, out, [](const uint8_t* p) {
      return ((float)*p - 128.0f) / 128.0f;
    });
  } else if (w.tag == 1 && w.bits == 16) {
    deinterleave(d, n, ch, 2, out, [](const uint8_t* p) {
      int16_t v;
      std::memcpy(&v, p, 2);
      return (float)v / 32768.0f;
    });
  } else if (w.tag == 1 && w.bits == 24) {
    deinterleave(d, n, ch, 3, out, [](const uint8_t* p) {
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      if (v & 0x800000) v -= 0x1000000;
      return (float)v / 8388608.0f;
    });
  } else if (w.tag == 1 && w.bits == 32) {
    deinterleave(d, n, ch, 4, out, [](const uint8_t* p) {
      int32_t v;
      std::memcpy(&v, p, 4);
      return (float)((double)v / 2147483648.0);
    });
  } else if (w.tag == 3 && w.bits == 32) {
    deinterleave(d, n, ch, 4, out, [](const uint8_t* p) {
      float v;
      std::memcpy(&v, p, 4);
      return v;
    });
  } else if (w.tag == 3 && w.bits == 64) {
    deinterleave(d, n, ch, 8, out, [](const uint8_t* p) {
      double v;
      std::memcpy(&v, p, 8);
      return (float)v;
    });
  } else {
    return 3;
  }
  return 0;
}

// Planar float32 (channels, frames) -> interleaved PCM16 with the same
// clip + round-half-to-even semantics as np.round(np.clip(x,-1,1)*32767).
int wav_encode_pcm16(const float* planar, int64_t frames, int32_t channels,
                     int16_t* out) {
  for (int32_t c = 0; c < channels; ++c) {
    const float* src = planar + (int64_t)c * frames;
    int16_t* dst = out + c;
    for (int64_t i = 0; i < frames; ++i) {
      float v = src[i];
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      // numpy rounds half to even; match it exactly.
      dst[(int64_t)i * channels] = (int16_t)std::nearbyint(v * 32767.0f);
    }
  }
  return 0;
}

}  // extern "C"
