// The PTX operations of csrc/conv3x3.cu, csrc/histogram.cu and csrc/qconv.cu on the CPU, as
// the PTX manual defines them. cp.async copies are carried out as late as the
// program allows: when the thread waits for their group. A tile that is read
// without that wait (and a barrier) holds the poison of emu_launch, not data.
#pragma once

#include "cuda_bf16.h"

// griddepcontrol: launches run one after another here, so a dependent launch
// always finds the launch it depends on finished
inline void grid_dependency_wait() {}
inline void allow_dependent_launch() {}
inline unsigned take_ticket(unsigned* ticket) { return std::atomic_ref<unsigned>(*ticket).fetch_add(1); }

namespace emu_ptx {
struct Copy {
  void* dst;
  const void* src;
  bool valid;
};
inline thread_local std::deque<std::vector<Copy>> groups;  // committed, in order
inline thread_local std::vector<Copy> open_group;
inline uint16_t half_of(uint32_t r, int e) { return static_cast<uint16_t>(r >> (16 * e)); }
}  // namespace emu_ptx

inline void cp_async_16(void* dst, const void* src, bool valid) {
  emu_ptx::open_group.push_back({dst, src, valid});
}
inline void cp_async_commit() {
  emu_ptx::groups.push_back(std::move(emu_ptx::open_group));
  emu_ptx::open_group.clear();
}
inline void cp_async_wait(int pending) {
  while (static_cast<int>(emu_ptx::groups.size()) > pending) {
    for (const emu_ptx::Copy& c : emu_ptx::groups.front()) {
      if (c.valid) {
        std::memcpy(c.dst, c.src, 16);
      } else {
        std::memset(c.dst, 0, 16);
      }
    }
    emu_ptx::groups.pop_front();
  }
}

inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
}

// An mbarrier in its 8 bytes: bit 63 the phase, bits 48-62 the count, bits
// 32-47 the arrivals still missing in this phase, the low word the bytes
// still expected (signed: bytes may land before they are announced).
namespace emu_ptx {
inline void mbar_update(uint64_t* bar, int arrivals, int32_t bytes) {
  std::atomic_ref<uint64_t> word(*bar);
  uint64_t old = word.load(), next;
  do {
    const uint64_t phase = old >> 63, count = (old >> 48) & 0x7fff;
    uint64_t missing = ((old >> 32) & 0xffff) - arrivals;
    const int32_t tx = static_cast<int32_t>(old & 0xffffffffu) + bytes;
    const bool done = missing == 0 && tx == 0;
    if (done) missing = count;
    next = (phase ^ done) << 63 | count << 48 | missing << 32 | static_cast<uint32_t>(tx);
  } while (!word.compare_exchange_weak(old, next));
}
}  // namespace emu_ptx
inline void mbar_init(uint64_t* bar, int count) {
  std::atomic_ref<uint64_t>(*bar).store(static_cast<uint64_t>(count) << 48 |
                                        static_cast<uint64_t>(count) << 32);
}
inline void fence_barrier_init() {}
inline void mbar_arrive(uint64_t* bar) { emu_ptx::mbar_update(bar, 1, 0); }
inline void mbar_arrive_expect(uint64_t* bar, int bytes) { emu_ptx::mbar_update(bar, 1, bytes); }
inline bool mbar_try_wait(uint64_t* bar, int parity) {
  if (static_cast<int>(std::atomic_ref<uint64_t>(*bar).load() >> 63) != parity) return true;
  // a pause long enough that the kernel's bound on its tries (which ends in
  // __trap) stands for minutes, however busy the machine is
  std::this_thread::sleep_for(std::chrono::microseconds(20));
  return false;
}

// The box at (c0, c1, c2): rows of box[0] elements, zeros outside the tensor,
// laid down densely from dst with the 16-byte chunks of every row exchanged
// as the map's swizzle says (chunk index XOR address bits 7..).
inline void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, uint64_t* bar) {
  const uint32_t row_bytes = map->box[0] * 2;
  const uintptr_t mask = map->swizzle_bytes ? map->swizzle_bytes / 16 - 1 : 0;
  if (map->swizzle_bytes && reinterpret_cast<uintptr_t>(dst) % (8 * map->swizzle_bytes)) std::abort();
  std::vector<unsigned char> row(row_bytes);
  int32_t landed = 0;
  for (uint32_t k = 0; k < map->box[2]; ++k)
    for (uint32_t j = 0; j < map->box[1]; ++j) {
      const long long i1 = c1 + static_cast<long long>(j), i2 = c2 + static_cast<long long>(k);
      const bool inside = i1 >= 0 && i2 >= 0 && i1 < static_cast<long long>(map->dims[1]) &&
                          i2 < static_cast<long long>(map->dims[2]);
      for (uint32_t i = 0; i < map->box[0]; ++i) {
        const long long i0 = c0 + static_cast<long long>(i);
        uint16_t v = 0;
        if (inside && i0 >= 0 && i0 < static_cast<long long>(map->dims[0])) {
          std::memcpy(&v, map->base + i0 * 2 + i1 * map->strides[1] + i2 * map->strides[2], 2);
        }
        std::memcpy(row.data() + 2 * i, &v, 2);
      }
      unsigned char* out = static_cast<unsigned char*>(dst) + (k * map->box[1] + j) * row_bytes;
      for (uint32_t chunk = 0; chunk < row_bytes / 16; ++chunk) {
        const uintptr_t at = reinterpret_cast<uintptr_t>(out) + 16 * chunk;
        std::memcpy(reinterpret_cast<void*>(at ^ (((at >> 7) & mask) << 4)), row.data() + 16 * chunk, 16);
      }
      landed += row_bytes;
    }
  emu_ptx::mbar_update(bar, 0, -landed);
}

// The box at (c0, c1, c2) from its swizzled place in shared memory to the
// tensor; what lies outside is dropped.
inline void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  const uint32_t row_bytes = map->box[0] * 2;
  const uintptr_t mask = map->swizzle_bytes ? map->swizzle_bytes / 16 - 1 : 0;
  if (map->swizzle_bytes && reinterpret_cast<uintptr_t>(src) % (8 * map->swizzle_bytes)) std::abort();
  for (uint32_t k = 0; k < map->box[2]; ++k)
    for (uint32_t j = 0; j < map->box[1]; ++j) {
      const long long i1 = c1 + static_cast<long long>(j), i2 = c2 + static_cast<long long>(k);
      if (i1 < 0 || i2 < 0 || i1 >= static_cast<long long>(map->dims[1]) ||
          i2 >= static_cast<long long>(map->dims[2])) {
        continue;
      }
      const unsigned char* in = static_cast<const unsigned char*>(src) + (k * map->box[1] + j) * row_bytes;
      for (uint32_t i = 0; i < map->box[0]; ++i) {
        const long long i0 = c0 + static_cast<long long>(i);
        if (i0 < 0 || i0 >= static_cast<long long>(map->dims[0])) continue;
        const uintptr_t at = reinterpret_cast<uintptr_t>(in) + 2 * i;
        std::memcpy(map->base + i0 * 2 + i1 * map->strides[1] + i2 * map->strides[2],
                    reinterpret_cast<const void*>(at ^ (((at >> 7) & mask) << 4)), 2);
      }
    }
}
inline void bulk_commit() {}
inline void bulk_wait_read() {}
inline void fence_proxy_async() {}

// lanes 8i .. 8i+7 give the rows of block i; lane 4g + t gets [g][2t..2t+1]
inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  ::emu::Warp& w = *::emu::warp;
  const int g = ::emu::lane >> 2, t = ::emu::lane & 3;
  w.addr[::emu::lane] = row;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const uint16_t* p = static_cast<const uint16_t*>(w.addr[8 * i + g]);
    r[i] = p[2 * t] | (static_cast<uint32_t>(p[2 * t + 1]) << 16);
  }
  w.bar.arrive_and_wait();
}
// ... or, transposed, [2t][g] and [2t+1][g]
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  ::emu::Warp& w = *::emu::warp;
  const int g = ::emu::lane >> 2, t = ::emu::lane & 3;
  w.addr[::emu::lane] = row;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const uint16_t* p0 = static_cast<const uint16_t*>(w.addr[8 * i + 2 * t]);
    const uint16_t* p1 = static_cast<const uint16_t*>(w.addr[8 * i + 2 * t + 1]);
    r[i] = p0[g] | (static_cast<uint32_t>(p1[g]) << 16);
  }
  w.bar.arrive_and_wait();
}
inline void stmatrix_x4(void* row, const uint32_t (&r)[4]) {
  ::emu::Warp& w = *::emu::warp;
  const int g = ::emu::lane >> 2, t = ::emu::lane & 3;
  w.addr[::emu::lane] = row;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    uint16_t* p = static_cast<uint16_t*>(const_cast<void*>(w.addr[8 * i + g]));
    p[2 * t] = emu_ptx::half_of(r[i], 0);
    p[2 * t + 1] = emu_ptx::half_of(r[i], 1);
  }
  w.bar.arrive_and_wait();
}
inline void stmatrix_x4_trans(void* row, const uint32_t (&r)[4]) {
  ::emu::Warp& w = *::emu::warp;
  const int g = ::emu::lane >> 2, t = ::emu::lane & 3;
  w.addr[::emu::lane] = row;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    static_cast<uint16_t*>(const_cast<void*>(w.addr[8 * i + 2 * t]))[g] = emu_ptx::half_of(r[i], 0);
    static_cast<uint16_t*>(const_cast<void*>(w.addr[8 * i + 2 * t + 1]))[g] = emu_ptx::half_of(r[i], 1);
  }
  w.bar.arrive_and_wait();
}

// D (16 x 8) += A (16 x 16) * B (16 x 8), the m16n8k16 fragment layout
inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  ::emu::Warp& w = *::emu::warp;
  const int g = ::emu::lane >> 2, t = ::emu::lane & 3;
  for (int i = 0; i < 4; ++i) w.regs[::emu::lane][i] = a[i];
  for (int i = 0; i < 2; ++i) w.regs[::emu::lane][4 + i] = b[i];
  w.bar.arrive_and_wait();
  auto bf = [](uint16_t h) { return __bfloat162float(__nv_bfloat16{h}); };
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 16; ++k) {
      const int kl = (k % 8) / 2, e = k % 2, hi = k / 8;
      const float av = bf(emu_ptx::half_of(w.regs[4 * (row % 8) + kl][2 * hi + row / 8], e));
      const float bv = bf(emu_ptx::half_of(w.regs[4 * col + kl][4 + hi], e));
      s = fmaf(av, bv, s);
    }
    d[i] = s;
  }
  w.bar.arrive_and_wait();
}

// dp4a.s32.s32 (csrc/qconv.cu's __dp4a): the four signed bytes of a times
// those of b, summed into c; the sum wraps modulo 2^32 as the int32 add does
inline int __dp4a(int a, int b, int c) {
  int64_t s = c;
  for (int k = 0; k < 4; ++k) {
    s += static_cast<int64_t>(static_cast<int8_t>(a >> (8 * k))) * static_cast<int8_t>(b >> (8 * k));
  }
  return static_cast<int>(static_cast<uint32_t>(static_cast<uint64_t>(s)));
}
