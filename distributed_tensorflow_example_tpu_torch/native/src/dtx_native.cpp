// Native host-runtime helpers of the PyTorch port: its copy of the JAX
// package's native/src/dtx_native.cpp (the same C ABI, bit for bit the
// same results).
//
// The port's device compute runs on the card (PyTorch and the CUDA
// kernels under ops/csrc); this library covers host-side work the
// reference delegated to TensorFlow's C++ runtime:
//
//   - IDX image decode: uint8 -> float32 / 255 normalization;
//   - mini-batch index gather (the memcpy behind next_batch, the host
//     path's per-step batch);
//   - CRC32C (Castagnoli) for TFRecord-framed TensorBoard event files
//     (the C++ RecordWriter's checksum).
//
// Exposed as a plain C ABI consumed via ctypes (native/__init__.py),
// built with g++ at first use into build/native/.  Every entry point
// has a numpy / Python fallback in the package; the library is an
// acceleration, not a requirement.

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, polynomial 0x82F63B78), slicing-by-8.
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[8][256];
static bool kCrcInit = false;

static void crc_init() {
  if (kCrcInit) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = kCrcTable[0][i];
    for (int s = 1; s < 8; s++) {
      c = kCrcTable[0][c & 0xff] ^ (c >> 8);
      kCrcTable[s][i] = c;
    }
  }
  kCrcInit = true;
}

uint32_t dtx_crc32c(const uint8_t* data, size_t len) {
  crc_init();
  uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data, 8);
    crc ^= (uint32_t)chunk;
    uint32_t hi = (uint32_t)(chunk >> 32);
    crc = kCrcTable[7][crc & 0xff] ^ kCrcTable[6][(crc >> 8) & 0xff] ^
          kCrcTable[5][(crc >> 16) & 0xff] ^ kCrcTable[4][crc >> 24] ^
          kCrcTable[3][hi & 0xff] ^ kCrcTable[2][(hi >> 8) & 0xff] ^
          kCrcTable[1][(hi >> 16) & 0xff] ^ kCrcTable[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = kCrcTable[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// IDX decode: uint8 pixels -> float32 in [0, 1].
// ---------------------------------------------------------------------------

void dtx_u8_to_f32_scaled(const uint8_t* in, size_t n, float* out) {
  static float lut[256];
  static bool lut_init = false;
  if (!lut_init) {
    for (int i = 0; i < 256; i++) lut[i] = (float)i * (1.0f / 255.0f);
    lut_init = true;
  }
  for (size_t i = 0; i < n; i++) out[i] = lut[in[i]];
}

// ---------------------------------------------------------------------------
// Batch gather: out_img[i] = images[idx[i]], out_lbl[i] = labels[idx[i]].
// ---------------------------------------------------------------------------

void dtx_gather_batch(const float* images, const float* labels,
                      const int64_t* idx, int64_t n_idx,
                      int64_t img_dim, int64_t lbl_dim,
                      float* out_img, float* out_lbl) {
  for (int64_t i = 0; i < n_idx; i++) {
    const int64_t j = idx[i];
    std::memcpy(out_img + i * img_dim, images + j * img_dim,
                (size_t)img_dim * sizeof(float));
    std::memcpy(out_lbl + i * lbl_dim, labels + j * lbl_dim,
                (size_t)lbl_dim * sizeof(float));
  }
}

}  // extern "C"
