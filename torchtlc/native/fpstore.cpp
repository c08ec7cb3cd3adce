// Host-authoritative fingerprint store - the OffHeapDiskFPSet analog.
//
// TLC keeps its 64-bit fingerprint set in an off-heap open-addressing table
// that spills to disk (the reference TLC run's MC.out:5).
// This is the native tier of the TPU engine's hybrid mode: the device does
// expansion + in-batch dedup, and streams candidate fingerprints here for
// authoritative dedup when the state space exceeds device HBM.
//
// Design: open-addressing (triangular probing, power-of-two capacity) over
// a mmap'd file, 8 bytes per entry (the full 64-bit fingerprint; 0 is the
// empty sentinel, and the real fingerprint 0 is tracked by a header flag so
// no two fingerprints are ever conflated). The mmap IS the
// persistence: checkpointing the store is an fsync + header write, and the
// OS pages cold regions to disk under memory pressure - the same
// "off-heap + disk spill" behavior OffHeapDiskFPSet implements by hand.
// Grows by rehash-doubling at 60% load.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint64_t magic;     // "JAXTLCFP"
  uint64_t capacity;  // slots (power of two)
  uint64_t count;     // fingerprints stored (including the zero fp)
  uint64_t has_zero;  // the fingerprint 0 itself (0 is the slot sentinel)
};

constexpr uint64_t kMagic = 0x4a4158544c434650ull;

struct Store {
  int fd = -1;
  Header *hdr = nullptr;    // mmap base
  uint64_t *slots = nullptr;  // hdr + 1
  std::string path;
};

inline uint64_t home_slot(uint64_t fp, uint64_t cap) {
  // The host tier keeps its own avalanche hash + triangular probing,
  // deliberately independent of the device table's bucketized layout
  // (../engine/fpset.py): the two stores never exchange slot indices,
  // only membership verdicts.
  uint32_t lo = static_cast<uint32_t>(fp);
  uint32_t hi = static_cast<uint32_t>(fp >> 32);
  uint32_t h = (lo ^ (hi * 0x9E3779B1u)) * 0x85EBCA6Bu;
  h ^= h >> 15;
  return h & (cap - 1);
}

bool map_file(Store *s, uint64_t capacity, bool create) {
  uint64_t bytes = sizeof(Header) + capacity * sizeof(uint64_t);
  if (create && ftruncate(s->fd, static_cast<off_t>(bytes)) != 0) return false;
  void *base = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, s->fd, 0);
  if (base == MAP_FAILED) return false;
  s->hdr = static_cast<Header *>(base);
  s->slots = reinterpret_cast<uint64_t *>(s->hdr + 1);
  if (create) {
    s->hdr->magic = kMagic;
    s->hdr->capacity = capacity;
    s->hdr->count = 0;
    s->hdr->has_zero = 0;
  }
  return true;
}

void unmap(Store *s) {
  if (s->hdr) {
    munmap(s->hdr, sizeof(Header) + s->hdr->capacity * sizeof(uint64_t));
    s->hdr = nullptr;
    s->slots = nullptr;
  }
}

// insert fp (nonzero); returns true if newly inserted
bool insert_one(uint64_t *slots, uint64_t cap, uint64_t fp, uint64_t *count) {
  uint64_t sl = home_slot(fp, cap);
  uint64_t step = 1;
  for (;;) {
    uint64_t v = slots[sl];
    if (v == 0) {
      slots[sl] = fp;
      ++*count;
      return true;
    }
    if (v == fp) return false;
    sl = (sl + step) & (cap - 1);
    ++step;
  }
}

bool grow(Store *s) {
  uint64_t old_cap = s->hdr->capacity;
  uint64_t new_cap = old_cap * 2;
  std::string tmp = s->path + ".grow";
  int nfd = open(tmp.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (nfd < 0) return false;
  Store ns;
  ns.fd = nfd;
  ns.path = tmp;
  if (!map_file(&ns, new_cap, /*create=*/true)) {
    close(nfd);
    return false;
  }
  uint64_t cnt = 0;
  for (uint64_t i = 0; i < old_cap; i++) {
    uint64_t v = s->slots[i];
    if (v != 0) insert_one(ns.slots, new_cap, v, &cnt);
  }
  ns.hdr->count = cnt + s->hdr->has_zero;
  ns.hdr->has_zero = s->hdr->has_zero;
  unmap(s);
  close(s->fd);
  s->fd = -1;  // fps_close must not double-close on a failure below
  unmap(&ns);
  close(nfd);
  if (rename(tmp.c_str(), s->path.c_str()) != 0) return false;
  s->fd = open(s->path.c_str(), O_RDWR, 0644);
  if (s->fd < 0) return false;
  return map_file(s, new_cap, /*create=*/false);
}

}  // namespace

extern "C" {

void *fps_open(const char *path, uint64_t initial_capacity) {
  Store *s = new Store();
  s->path = path;
  bool exists = access(path, F_OK) == 0;
  s->fd = open(path, O_RDWR | O_CREAT, 0644);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  if (exists) {
    struct stat st;
    fstat(s->fd, &st);
    if (st.st_size >= static_cast<off_t>(sizeof(Header))) {
      Header h;
      if (pread(s->fd, &h, sizeof(h), 0) == sizeof(h) && h.magic == kMagic) {
        if (!map_file(s, h.capacity, /*create=*/false)) {
          close(s->fd);
          delete s;
          return nullptr;
        }
        return s;
      }
    }
  }
  uint64_t cap = 64;
  while (cap < initial_capacity) cap <<= 1;
  if (!map_file(s, cap, /*create=*/true)) {
    close(s->fd);
    delete s;
    return nullptr;
  }
  return s;
}

// lo/hi: n fingerprint word lanes; mask in: candidate flags, out: is_new
int fps_insert_batch(void *handle, const uint32_t *lo, const uint32_t *hi,
                     uint8_t *mask, int64_t n) {
  Store *s = static_cast<Store *>(handle);
  for (int64_t i = 0; i < n; i++) {
    if (!mask[i]) continue;
    if (s->hdr->count * 10 >= s->hdr->capacity * 6) {  // grow at 60% load
      if (!grow(s)) return -1;
    }
    uint64_t fp = (static_cast<uint64_t>(hi[i]) << 32) | lo[i];
    if (fp == 0) {  // 0 is the slot sentinel; track it in the header
      mask[i] = s->hdr->has_zero ? 0 : 1;
      if (!s->hdr->has_zero) {
        s->hdr->has_zero = 1;
        ++s->hdr->count;
      }
      continue;
    }
    mask[i] = insert_one(s->slots, s->hdr->capacity, fp, &s->hdr->count) ? 1 : 0;
  }
  return 0;
}

uint64_t fps_count(void *handle) {
  return static_cast<Store *>(handle)->hdr->count;
}

uint64_t fps_capacity(void *handle) {
  return static_cast<Store *>(handle)->hdr->capacity;
}

int fps_sync(void *handle) {
  Store *s = static_cast<Store *>(handle);
  uint64_t bytes = sizeof(Header) + s->hdr->capacity * sizeof(uint64_t);
  return msync(s->hdr, bytes, MS_SYNC);
}

void fps_close(void *handle) {
  Store *s = static_cast<Store *>(handle);
  unmap(s);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

}  // extern "C"
