// sequitr_tpu_torch native runtime helpers (C++, ctypes ABI).
//
// The reference has no first-party native code (its native layer is the TF
// runtime; SURVEY.md §2 'Native compute layer'). This library covers the
// HOST-side hot loops that sit outside the device graph:
//   * union-find connected-component labelling (localization export),
//   * per-label centroid/area accumulation,
//   * crc32c (Castagnoli) for TFRecord framing at shard-write throughput.
//
// Build: see sequitr_tpu_torch/native.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// connected components: 4-connectivity, two-pass union-find over a 2D mask
// ---------------------------------------------------------------------------

static inline int32_t find_root(std::vector<int32_t>& parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];  // path halving
    x = parent[x];
  }
  return x;
}

// mask: h*w uint8 (nonzero = foreground); labels_out: h*w int32.
// Returns the number of components.
int32_t seq_label_components(const uint8_t* mask, int32_t h, int32_t w,
                             int32_t* labels_out) {
  std::vector<int32_t> parent(1, 0);  // 0 = background sentinel
  // first pass: provisional labels + unions
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = (int64_t)y * w + x;
      if (!mask[i]) {
        labels_out[i] = 0;
        continue;
      }
      const int32_t left = (x > 0) ? labels_out[i - 1] : 0;
      const int32_t up = (y > 0) ? labels_out[i - w] : 0;
      if (left && up) {
        int32_t rl = find_root(parent, left);
        int32_t ru = find_root(parent, up);
        int32_t r = rl < ru ? rl : ru;
        parent[rl] = r;
        parent[ru] = r;
        labels_out[i] = r;
      } else if (left || up) {
        labels_out[i] = left ? left : up;
      } else {
        const int32_t fresh = (int32_t)parent.size();
        parent.push_back(fresh);
        labels_out[i] = fresh;
      }
    }
  }
  // second pass: flatten + densify label ids to 1..n
  std::vector<int32_t> dense(parent.size(), 0);
  int32_t next = 0;
  for (int64_t i = 0; i < (int64_t)h * w; ++i) {
    if (!labels_out[i]) continue;
    const int32_t r = find_root(parent, labels_out[i]);
    if (!dense[r]) dense[r] = ++next;
    labels_out[i] = dense[r];
  }
  return next;
}

// Single-pass per-label feature extraction over an instance label map:
// pixel count, centroid, mean intensity and majority semantic class in ONE
// sweep (the serving pipeline's localization tail previously made four
// scipy passes per frame — sum, center_of_mass, mean, labeled_comprehension).
//   labels:    h*w int32 instance map (0 = background, 1..n_labels)
//   class_map: h*w int32 semantic classes (majority vote per instance)
//   intensity: h*w float32 or nullptr
//   counts buffer: caller-provided n_labels*n_classes int64 scratch
// Outputs: areas (int64), cy/cx/imean (double), cls_out (int32), all n_labels.
void seq_label_full_stats(const int32_t* labels, const int32_t* class_map,
                          const float* intensity, int32_t h, int32_t w,
                          int32_t n_labels, int32_t n_classes, int64_t* counts,
                          int64_t* areas, double* cy, double* cx, double* imean,
                          int32_t* cls_out) {
  std::memset(areas, 0, sizeof(int64_t) * n_labels);
  std::memset(cy, 0, sizeof(double) * n_labels);
  std::memset(cx, 0, sizeof(double) * n_labels);
  std::memset(imean, 0, sizeof(double) * n_labels);
  std::memset(counts, 0, sizeof(int64_t) * n_labels * n_classes);
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = (int64_t)y * w + x;
      const int32_t l = labels[i];
      if (l <= 0 || l > n_labels) continue;
      const int32_t k = l - 1;
      areas[k] += 1;
      cy[k] += y;
      cx[k] += x;
      if (intensity) imean[k] += intensity[i];
      const int32_t c = class_map[i];
      if (c >= 0 && c < n_classes) counts[(int64_t)k * n_classes + c] += 1;
    }
  }
  for (int32_t k = 0; k < n_labels; ++k) {
    if (areas[k]) {
      cy[k] /= (double)areas[k];
      cx[k] /= (double)areas[k];
      imean[k] /= (double)areas[k];
    }
    int64_t best = -1;
    int32_t best_c = 0;
    for (int32_t c = 0; c < n_classes; ++c) {
      const int64_t v = counts[(int64_t)k * n_classes + c];
      if (v > best) {
        best = v;
        best_c = c;
      }
    }
    cls_out[k] = best_c;
  }
}

// Volumetric variant: one sweep over a (Z, H, W) instance map. cz/cy/cx are
// centroid plane/row/col; other outputs as in seq_label_full_stats.
void seq_label_full_stats_3d(const int32_t* labels, const int32_t* class_map,
                             const float* intensity, int32_t z, int32_t h,
                             int32_t w, int32_t n_labels, int32_t n_classes,
                             int64_t* counts, int64_t* areas, double* cz,
                             double* cy, double* cx, double* imean,
                             int32_t* cls_out) {
  std::memset(areas, 0, sizeof(int64_t) * n_labels);
  std::memset(cz, 0, sizeof(double) * n_labels);
  std::memset(cy, 0, sizeof(double) * n_labels);
  std::memset(cx, 0, sizeof(double) * n_labels);
  std::memset(imean, 0, sizeof(double) * n_labels);
  std::memset(counts, 0, sizeof(int64_t) * n_labels * n_classes);
  for (int32_t p = 0; p < z; ++p) {
    for (int32_t y = 0; y < h; ++y) {
      for (int32_t x = 0; x < w; ++x) {
        const int64_t i = ((int64_t)p * h + y) * w + x;
        const int32_t l = labels[i];
        if (l <= 0 || l > n_labels) continue;
        const int32_t k = l - 1;
        areas[k] += 1;
        cz[k] += p;
        cy[k] += y;
        cx[k] += x;
        if (intensity) imean[k] += intensity[i];
        const int32_t c = class_map[i];
        if (c >= 0 && c < n_classes) counts[(int64_t)k * n_classes + c] += 1;
      }
    }
  }
  for (int32_t k = 0; k < n_labels; ++k) {
    if (areas[k]) {
      cz[k] /= (double)areas[k];
      cy[k] /= (double)areas[k];
      cx[k] /= (double)areas[k];
      imean[k] /= (double)areas[k];
    }
    int64_t best = -1;
    int32_t best_c = 0;
    for (int32_t c = 0; c < n_classes; ++c) {
      const int64_t v = counts[(int64_t)k * n_classes + c];
      if (v > best) {
        best = v;
        best_c = c;
      }
    }
    cls_out[k] = best_c;
  }
}

// ---------------------------------------------------------------------------
// Marker-seeded watershed (Meyer's flooding, 4-connectivity) over a 2D
// priority surface — the touching-cell splitter: flood DOWN the distance
// transform from its local maxima so each basin becomes one instance.
// (scikit-image is absent in this environment; this is the native
// equivalent of skimage.segmentation.watershed for our use.)
//   mask:     h*w uint8, nonzero = floodable foreground
//   priority: h*w float32 (e.g. the EDT); higher floods first
//   labels:   h*w int32 in/out — seeds 1..n on input, basins on output
// Pop order among equal priorities is FIFO (insertion counter), making
// the result deterministic for a given seed layout.
// ---------------------------------------------------------------------------

}  // extern "C" — template machinery below needs C++ linkage

namespace {
struct WsEntry {
  float prio;
  int64_t order;
  int64_t idx;
  int32_t label;
};
struct WsCmp {
  bool operator()(const WsEntry& a, const WsEntry& b) const {
    if (a.prio != b.prio) return a.prio < b.prio;  // max-heap on priority
    return a.order > b.order;                      // FIFO on ties
  }
};
}  // namespace

extern "C" void seq_watershed(const uint8_t* mask, const float* priority,
                              int32_t h, int32_t w, int32_t* labels) {
  std::priority_queue<WsEntry, std::vector<WsEntry>, WsCmp> heap;
  int64_t order = 0;
  const int64_t n = (int64_t)h * w;
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] > 0 && mask[i]) {
      heap.push({priority[i], order++, i, labels[i]});
    }
  }
  while (!heap.empty()) {
    const WsEntry e = heap.top();
    heap.pop();
    const int32_t y = (int32_t)(e.idx / w);
    const int32_t x = (int32_t)(e.idx % w);
    const int64_t nbrs[4] = {e.idx - w, e.idx + w, e.idx - 1, e.idx + 1};
    const bool ok[4] = {y > 0, y + 1 < h, x > 0, x + 1 < w};
    for (int k = 0; k < 4; ++k) {
      if (!ok[k]) continue;
      const int64_t j = nbrs[k];
      if (!mask[j] || labels[j] != 0) continue;
      labels[j] = e.label;
      heap.push({priority[j], order++, j, e.label});
    }
  }
}

// Volumetric variant: 6-connectivity over a (Z, H, W) grid — the
// localize_volume splitter for z-stacks.
extern "C" void seq_watershed_3d(const uint8_t* mask, const float* priority,
                                 int32_t z, int32_t h, int32_t w,
                                 int32_t* labels) {
  std::priority_queue<WsEntry, std::vector<WsEntry>, WsCmp> heap;
  int64_t order = 0;
  const int64_t plane = (int64_t)h * w;
  const int64_t n = (int64_t)z * plane;
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] > 0 && mask[i]) {
      heap.push({priority[i], order++, i, labels[i]});
    }
  }
  while (!heap.empty()) {
    const WsEntry e = heap.top();
    heap.pop();
    const int32_t p = (int32_t)(e.idx / plane);
    const int64_t rem = e.idx % plane;
    const int32_t y = (int32_t)(rem / w);
    const int32_t x = (int32_t)(rem % w);
    const int64_t nbrs[6] = {e.idx - plane, e.idx + plane, e.idx - w,
                             e.idx + w,     e.idx - 1,     e.idx + 1};
    const bool ok[6] = {p > 0, p + 1 < z, y > 0, y + 1 < h, x > 0, x + 1 < w};
    for (int k = 0; k < 6; ++k) {
      if (!ok[k]) continue;
      const int64_t j = nbrs[k];
      if (!mask[j] || labels[j] != 0) continue;
      labels[j] = e.label;
      heap.push({priority[j], order++, j, e.label});
    }
  }
}

extern "C" {

// ---------------------------------------------------------------------------
// TIFF LZW strip decode (MSB-first codes, ClearCode 256, EOI 257, libtiff
// "early change"). The pure-Python decoder in data/tiff.py measures ~2.4 s
// per 1024x1024 uint16 strip — far behind the serving rate — so compressed
// ingest routes here. Emission walks the code chain backwards into a stack
// buffer; max string length is bounded by the 4096-entry code space.
//
// Returns bytes written (<= n_dst; extra decoded bytes beyond n_dst are
// row padding and are dropped), or -1 on malformed input.
// ---------------------------------------------------------------------------

int64_t seq_lzw_decode(const uint8_t* src, int64_t n_src, uint8_t* dst,
                       int64_t n_dst) {
  constexpr int kClear = 256, kEoi = 257, kMaxCodes = 4096;
  int16_t prefix[kMaxCodes];
  uint8_t suffix[kMaxCodes];
  int32_t length[kMaxCodes];
  uint8_t firstb[kMaxCodes];
  uint8_t stackbuf[kMaxCodes + 4];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    suffix[i] = (uint8_t)i;
    length[i] = 1;
    firstb[i] = (uint8_t)i;
  }
  int next_code = 258;
  int nbits = 9;
  int prev = -1;
  bool started = false;
  int64_t bitpos = 0;
  const int64_t total_bits = n_src * 8;
  int64_t out = 0;
  while (bitpos + nbits <= total_bits && out < n_dst) {
    const int64_t byte0 = bitpos >> 3;
    uint32_t window = (uint32_t)src[byte0] << 16;
    if (byte0 + 1 < n_src) window |= (uint32_t)src[byte0 + 1] << 8;
    if (byte0 + 2 < n_src) window |= src[byte0 + 2];
    const int shift = 24 - nbits - (int)(bitpos & 7);
    const int code = (int)((window >> shift) & ((1u << nbits) - 1));
    bitpos += nbits;
    if (code == kEoi) break;
    if (code == kClear) {
      next_code = 258;
      nbits = 9;
      prev = -1;
      started = true;
      continue;
    }
    if (!started) return -1;  // stream must open with a clear code
    int32_t l;
    if (prev < 0) {
      if (code >= 256) return -1;
      l = 1;
      stackbuf[0] = (uint8_t)code;
    } else if (code < next_code) {
      l = length[code];
      int c = code;
      int32_t pos = l;
      while (c >= 0) {
        stackbuf[--pos] = suffix[c];
        c = prefix[c];
      }
      if (next_code < kMaxCodes) {
        prefix[next_code] = (int16_t)prev;
        suffix[next_code] = stackbuf[0];
        length[next_code] = length[prev] + 1;
        firstb[next_code] = firstb[prev];
        ++next_code;
      }
    } else if (code == next_code && next_code < kMaxCodes) {
      // the KwKwK case: current string = prev + first byte of prev
      l = length[prev] + 1;
      int c = prev;
      int32_t pos = l - 1;
      while (c >= 0) {
        stackbuf[--pos] = suffix[c];
        c = prefix[c];
      }
      stackbuf[l - 1] = firstb[prev];
      prefix[next_code] = (int16_t)prev;
      suffix[next_code] = firstb[prev];
      length[next_code] = l;
      firstb[next_code] = firstb[prev];
      ++next_code;
    } else {
      return -1;  // code beyond the table: corrupt strip
    }
    const int64_t n = (out + l <= n_dst) ? l : n_dst - out;
    std::memcpy(dst + out, stackbuf, (size_t)n);
    out += n;
    prev = code;
    // early change: widen one code EARLIER than vanilla LZW (libtiff)
    if (next_code == (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  return out;
}

// ---------------------------------------------------------------------------
// crc32c (Castagnoli) — slice-by-8 table-driven
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[8][256];
static bool crc_init_done = false;

static void crc_init() {
  if (crc_init_done) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kCrcTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int s = 1; s < 8; ++s)
      kCrcTable[s][i] =
          (kCrcTable[s - 1][i] >> 8) ^ kCrcTable[0][kCrcTable[s - 1][i] & 0xFF];
  crc_init_done = true;
}

uint32_t seq_crc32c(const uint8_t* data, int64_t n) {
  crc_init();
  uint32_t crc = 0xFFFFFFFFu;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data + i, 8);
    chunk ^= crc;  // little-endian host assumed (x86/arm LE)
    crc = kCrcTable[7][chunk & 0xFF] ^ kCrcTable[6][(chunk >> 8) & 0xFF] ^
          kCrcTable[5][(chunk >> 16) & 0xFF] ^ kCrcTable[4][(chunk >> 24) & 0xFF] ^
          kCrcTable[3][(chunk >> 32) & 0xFF] ^ kCrcTable[2][(chunk >> 40) & 0xFF] ^
          kCrcTable[1][(chunk >> 48) & 0xFF] ^ kCrcTable[0][(chunk >> 56) & 0xFF];
  }
  for (; i < n; ++i) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ data[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
