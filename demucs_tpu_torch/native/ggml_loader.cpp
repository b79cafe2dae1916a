// Native ggml weight-file parser and fp16 -> fp32 widening.
//
// The byte-level work of reading a ggml file (the format of the
// reference's loader, src/model_load.cpp:50-118): record iteration over
// an in-memory blob, handing the caller zero-copy pointers to each
// tensor's name, shape and fp16 payload, with every length checked
// against the buffer; and the widening of fp16 to fp32. The names are
// mapped to modules on the Python side (params/schema.py).
//
// Built with g++ by demucs_tpu_torch/native/__init__.py and bound with
// ctypes in params/native_ggml.py; no Python headers needed.
#include <cstdint>
#include <cstring>

extern "C" {

// Visitor receives zero-copy pointers into the caller's buffer.
typedef void (*demucs_tensor_cb)(void *ctx, const char *name,
                                 int32_t name_len, int32_t n_dims,
                                 const int32_t *shape,
                                 const uint16_t *fp16_data, int64_t count);

// Returns the magic on success, -1 on malformed input.
int32_t demucs_ggml_parse(const uint8_t *buf, int64_t n,
                          demucs_tensor_cb cb, void *ctx) {
  if (n < 4) return -1;
  int32_t magic;
  std::memcpy(&magic, buf, 4);
  int64_t off = 4;
  while (off < n) {
    if (off + 8 > n) return -1;
    int32_t n_dims, name_len;
    std::memcpy(&n_dims, buf + off, 4);
    std::memcpy(&name_len, buf + off + 4, 4);
    off += 8;
    if (n_dims < 0 || n_dims > 8 || name_len < 0 || name_len > 4096)
      return -1;
    if (off + 4LL * n_dims + name_len > n) return -1;
    int32_t shape[8] = {0};
    int64_t count = 1;
    for (int i = 0; i < n_dims; ++i) {
      std::memcpy(&shape[i], buf + off, 4);
      off += 4;
      if (shape[i] < 0) return -1;
      // overflow guard: a crafted file must not wrap count negative and
      // slip past the bounds check below (max plausible tensor ~2^31)
      if (shape[i] > 0 && count > (int64_t{1} << 31) / shape[i]) return -1;
      count *= shape[i];
    }
    const char *name = reinterpret_cast<const char *>(buf + off);
    off += name_len;
    if (count > (n - off) / 2) return -1;
    cb(ctx, name, name_len, n_dims, shape,
       reinterpret_cast<const uint16_t *>(buf + off), count);
    off += 2 * count;
  }
  return magic;
}

// IEEE binary16 -> binary32 widening (branch-free; auto-vectorizes).
void demucs_fp16_to_fp32(const uint16_t *src, float *dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t h = src[i];
    uint32_t sign = (h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
      if (mant == 0) {
        bits = sign;  // +-0
      } else {        // subnormal: normalize
        int shift = 0;
        while (!(mant & 0x400)) { mant <<= 1; ++shift; }
        mant &= 0x3FF;
        bits = sign | ((127 - 15 + 1 - shift) << 23) | (mant << 13);
      }
    } else if (exp == 31) {
      bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
    } else {
      bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    dst[i] = f;
  }
}

}  // extern "C"
