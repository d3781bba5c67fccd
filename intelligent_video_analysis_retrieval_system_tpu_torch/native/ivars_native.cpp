// Copy of intelligent_video_analysis_retrieval_system_tpu/native/ivars_native.cpp
// (host C++: hashing, bf16 codecs, the .flat/.flat8 files). Keep the two in step.
// ivars_native: host-side native kernels for the TPU retrieval framework.
//
// The reference offloaded all native work to third-party wheels (FAISS,
// OpenCV, h5py — SURVEY.md §2.2). Here the host-side hot paths are
// first-party C++ behind a C ABI (consumed via ctypes):
//
//   - content hashing for the build journal (SHA-256, multithreaded over
//     files; replaces hashlib in RAGBuilder's scan — reference
//     unified_index.py:733-757),
//   - exact inner-product top-k on CPU (blocked, multithreaded, unrolled;
//     the device-less fallback for UnifiedIndex.search — replaces FAISS
//     IndexFlatIP semantics, core.py:1198-1234),
//   - bf16 <-> f32 row codecs for the container's raw-bits storage,
//   - flat-file embedding dump/mmap-load for zero-copy startup.
//
// Build: g++ -O3 -march=native -shared -fPIC (driven by native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// SHA-256 (public-domain style implementation, compact)
// ---------------------------------------------------------------------------

namespace {

struct Sha256Ctx {
  uint32_t state[8];
  uint64_t bitlen;
  uint8_t buffer[64];
  size_t buflen;
};

constexpr uint32_t kK[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, uint32_t n) { return (x >> n) | (x << (32 - n)); }

void sha256_init(Sha256Ctx* c) {
  c->state[0] = 0x6a09e667; c->state[1] = 0xbb67ae85;
  c->state[2] = 0x3c6ef372; c->state[3] = 0xa54ff53a;
  c->state[4] = 0x510e527f; c->state[5] = 0x9b05688c;
  c->state[6] = 0x1f83d9ab; c->state[7] = 0x5be0cd19;
  c->bitlen = 0;
  c->buflen = 0;
}

void sha256_block(Sha256Ctx* c, const uint8_t* p) {
  uint32_t w[64];
  for (int i = 0; i < 16; ++i)
    w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
           (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
  for (int i = 16; i < 64; ++i) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = c->state[0], b = c->state[1], d2 = c->state[2], d = c->state[3];
  uint32_t e = c->state[4], f = c->state[5], g = c->state[6], h = c->state[7];
  for (int i = 0; i < 64; ++i) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + kK[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & d2) ^ (b & d2);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = d2; d2 = b; b = a; a = t1 + t2;
  }
  c->state[0] += a; c->state[1] += b; c->state[2] += d2; c->state[3] += d;
  c->state[4] += e; c->state[5] += f; c->state[6] += g; c->state[7] += h;
}

void sha256_update(Sha256Ctx* c, const uint8_t* data, size_t len) {
  c->bitlen += uint64_t(len) * 8;
  while (len > 0) {
    size_t take = 64 - c->buflen;
    if (take > len) take = len;
    std::memcpy(c->buffer + c->buflen, data, take);
    c->buflen += take;
    data += take;
    len -= take;
    if (c->buflen == 64) {
      sha256_block(c, c->buffer);
      c->buflen = 0;
    }
  }
}

void sha256_final(Sha256Ctx* c, uint8_t out[32]) {
  uint64_t bitlen = c->bitlen;
  uint8_t pad = 0x80;
  sha256_update(c, &pad, 1);
  uint8_t zero = 0;
  while (c->buflen != 56) sha256_update(c, &zero, 1);
  uint8_t lenbuf[8];  // original message length, captured before padding
  for (int i = 0; i < 8; ++i) lenbuf[i] = uint8_t(bitlen >> (56 - 8 * i));
  sha256_update(c, lenbuf, 8);
  for (int i = 0; i < 8; ++i) {
    out[i * 4] = uint8_t(c->state[i] >> 24);
    out[i * 4 + 1] = uint8_t(c->state[i] >> 16);
    out[i * 4 + 2] = uint8_t(c->state[i] >> 8);
    out[i * 4 + 3] = uint8_t(c->state[i]);
  }
}

const char* kHex = "0123456789abcdef";

int hash_one_file(const char* path, char* out_hex16) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  Sha256Ctx ctx;
  sha256_init(&ctx);
  std::vector<uint8_t> buf(1 << 20);
  size_t n;
  while ((n = std::fread(buf.data(), 1, buf.size(), f)) > 0)
    sha256_update(&ctx, buf.data(), n);
  std::fclose(f);
  uint8_t digest[32];
  sha256_final(&ctx, digest);
  for (int i = 0; i < 8; ++i) {  // first 16 hex chars (8 bytes)
    out_hex16[i * 2] = kHex[digest[i] >> 4];
    out_hex16[i * 2 + 1] = kHex[digest[i] & 0xF];
  }
  return 0;
}

}  // namespace

// hash_files: hash `count` files with `threads` workers.
// paths: array of C strings; out: count*16 chars (no NULs between entries);
// ok: per-file status (0 = success). Returns number of failures.
int ivars_hash_files(const char** paths, int count, char* out, int8_t* ok,
                     int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= count) break;
      int rc = hash_one_file(paths[i], out + size_t(i) * 16);
      ok[i] = int8_t(rc == 0 ? 0 : 1);
      if (rc != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  int nt = threads < count ? threads : (count > 0 ? count : 1);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

// ---------------------------------------------------------------------------
// Exact inner-product top-k (CPU fallback of the Pallas kernel)
// ---------------------------------------------------------------------------

namespace {

struct Heap {
  // min-heap of (score, id) with fixed capacity k
  float* scores;
  int32_t* ids;
  int k;
  int size = 0;

  void push(float s, int32_t id) {
    if (size < k) {
      scores[size] = s;
      ids[size] = id;
      ++size;
      int i = size - 1;
      while (i > 0) {
        int parent = (i - 1) / 2;
        if (scores[parent] <= scores[i]) break;
        std::swap(scores[parent], scores[i]);
        std::swap(ids[parent], ids[i]);
        i = parent;
      }
    } else if (s > scores[0]) {
      scores[0] = s;
      ids[0] = id;
      int i = 0;
      while (true) {
        int l = 2 * i + 1, r = 2 * i + 2, smallest = i;
        if (l < size && scores[l] < scores[smallest]) smallest = l;
        if (r < size && scores[r] < scores[smallest]) smallest = r;
        if (smallest == i) break;
        std::swap(scores[smallest], scores[i]);
        std::swap(ids[smallest], ids[i]);
        i = smallest;
      }
    }
  }
};

}  // namespace

// x: (n, d) row-major f32; q: (b, d); out_scores/out_ids: (b, k) sorted desc.
void ivars_topk_ip(const float* x, int64_t n, int d, const float* q, int b,
                   int k, float* out_scores, int32_t* out_ids, int threads) {
  if (threads < 1) threads = 1;
  if (k > n) k = int(n);
  std::atomic<int> next_query(0);
  auto worker = [&]() {
    std::vector<float> heap_scores(k);
    std::vector<int32_t> heap_ids(k);
    while (true) {
      int qi = next_query.fetch_add(1);
      if (qi >= b) break;
      const float* qrow = q + size_t(qi) * d;
      Heap heap{heap_scores.data(), heap_ids.data(), k, 0};
      for (int64_t i = 0; i < n; ++i) {
        const float* xrow = x + size_t(i) * d;
        float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
        int j = 0;
        for (; j + 4 <= d; j += 4) {
          acc0 += xrow[j] * qrow[j];
          acc1 += xrow[j + 1] * qrow[j + 1];
          acc2 += xrow[j + 2] * qrow[j + 2];
          acc3 += xrow[j + 3] * qrow[j + 3];
        }
        float acc = acc0 + acc1 + acc2 + acc3;
        for (; j < d; ++j) acc += xrow[j] * qrow[j];
        heap.push(acc, int32_t(i));
      }
      // heap-sort into descending order
      float* os = out_scores + size_t(qi) * k;
      int32_t* oi = out_ids + size_t(qi) * k;
      int filled = heap.size;
      for (int slot = filled - 1; slot >= 0; --slot) {
        os[slot] = heap.scores[0];
        oi[slot] = heap.ids[0];
        heap.scores[0] = heap.scores[heap.size - 1];
        heap.ids[0] = heap.ids[heap.size - 1];
        heap.size -= 1;
        int i2 = 0;
        while (true) {
          int l = 2 * i2 + 1, r = 2 * i2 + 2, smallest = i2;
          if (l < heap.size && heap.scores[l] < heap.scores[smallest]) smallest = l;
          if (r < heap.size && heap.scores[r] < heap.scores[smallest]) smallest = r;
          if (smallest == i2) break;
          std::swap(heap.scores[smallest], heap.scores[i2]);
          std::swap(heap.ids[smallest], heap.ids[i2]);
          i2 = smallest;
        }
      }
      for (int slot = filled; slot < k; ++slot) {
        os[slot] = -3.402823e38f;
        oi[slot] = -1;
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = threads < b ? threads : (b > 0 ? b : 1);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// bf16 codecs (container raw-bits storage)
// ---------------------------------------------------------------------------

void ivars_f32_to_bf16(const float* in, uint16_t* out, int64_t count) {
  for (int64_t i = 0; i < count; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &in[i], 4);
    uint32_t rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16;
    out[i] = uint16_t(rounded);
  }
}

void ivars_bf16_to_f32(const uint16_t* in, float* out, int64_t count) {
  for (int64_t i = 0; i < count; ++i) {
    uint32_t bits = uint32_t(in[i]) << 16;
    std::memcpy(&out[i], &bits, 4);
  }
}

// ---------------------------------------------------------------------------
// Flat embedding file: header (magic, n, d, dtype code) + raw rows.
// dtype code: 0 = bf16 bits (u16), 2 = f32.
// ---------------------------------------------------------------------------

struct FlatHeader {
  char magic[8];  // "IVARSFLT"
  int64_t n;
  int32_t d;
  int32_t dtype_code;
};

int ivars_flat_write(const char* path, const void* rows, int64_t n, int d,
                     int dtype_code) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  FlatHeader h;
  std::memcpy(h.magic, "IVARSFLT", 8);
  h.n = n;
  h.d = d;
  h.dtype_code = dtype_code;
  size_t elem = dtype_code == 2 ? 4 : 2;
  int rc = 0;
  if (std::fwrite(&h, sizeof(h), 1, f) != 1) rc = -2;
  if (rc == 0 &&
      std::fwrite(rows, elem, size_t(n) * d, f) != size_t(n) * d)
    rc = -3;
  std::fclose(f);
  return rc;
}

// Returns an mmap'd pointer to the rows (caller later passes it to
// ivars_flat_close with the mapped length). Fills n/d/dtype_code.
void* ivars_flat_open(const char* path, int64_t* n, int32_t* d,
                      int32_t* dtype_code, int64_t* map_len) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || size_t(st.st_size) < sizeof(FlatHeader)) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return nullptr;
  FlatHeader* h = static_cast<FlatHeader*>(base);
  if (std::memcmp(h->magic, "IVARSFLT", 8) != 0) {
    munmap(base, size_t(st.st_size));
    return nullptr;
  }
  *n = h->n;
  *d = h->d;
  *dtype_code = h->dtype_code;
  *map_len = st.st_size;
  return static_cast<uint8_t*>(base) + sizeof(FlatHeader);
}

void ivars_flat_close(void* rows_ptr, int64_t map_len) {
  if (rows_ptr == nullptr) return;
  void* base = static_cast<uint8_t*>(rows_ptr) - sizeof(FlatHeader);
  munmap(base, size_t(map_len));
}

}  // extern "C"
