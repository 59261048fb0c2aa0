// Tiered sample cache + host-side image ops for the data layer.
//
// Reference roles this plays (host C++ equivalents, SURVEY §2.2):
//  - PMEM/memkind allocator (pmem/PersistentMemoryAllocator.java:37-43,
//    feature/pmem/NativeArray.scala): an off-GC tiered byte store for
//    samples — here DRAM up to a budget, LRU-spilled to disk files, feeding
//    the device without Python-heap pressure.
//  - OpenCV JNI preprocessing (feature/image/OpenCVMethod.scala): resize /
//    crop / channel-normalize on raw float images, multithread-friendly
//    (no GIL: callers run it from Python worker threads).
//
// Pure C ABI so Python binds with ctypes (no pybind11 needed).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
    std::vector<uint8_t> data;           // empty when spilled
    size_t nbytes = 0;
    bool on_disk = false;
    std::list<uint64_t>::iterator lru_it;
};

struct Cache {
    size_t capacity;
    size_t used = 0;
    std::string spill_dir;
    std::unordered_map<uint64_t, Entry> entries;
    std::list<uint64_t> lru;             // front = most recent
    std::mutex mu;
    uint64_t hits = 0, misses = 0, spills = 0;

    std::string path_for(uint64_t id) const {
        return spill_dir + "/sample_" + std::to_string(id) + ".bin";
    }
};

bool write_file(const std::string& path, const uint8_t* data, size_t n) {
    FILE* f = std::fopen(path.c_str(), "wb");
    if (!f) return false;
    size_t w = std::fwrite(data, 1, n, f);
    std::fclose(f);
    return w == n;
}

bool read_file(const std::string& path, uint8_t* out, size_t n) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    size_t r = std::fread(out, 1, n, f);
    std::fclose(f);
    return r == n;
}

// Evict least-recently-used DRAM entries until `needed` bytes fit.
// Caller holds the lock.
bool make_room(Cache* c, size_t needed) {
    if (needed > c->capacity) return false;
    while (c->used + needed > c->capacity && !c->lru.empty()) {
        uint64_t victim = c->lru.back();
        auto it = c->entries.find(victim);
        if (it == c->entries.end() || it->second.on_disk) {
            c->lru.pop_back();
            continue;
        }
        Entry& e = it->second;
        if (!write_file(c->path_for(victim), e.data.data(), e.nbytes))
            return false;
        c->used -= e.nbytes;
        e.data.clear();
        e.data.shrink_to_fit();
        e.on_disk = true;
        c->spills++;
        c->lru.pop_back();
    }
    return c->used + needed <= c->capacity;
}

}  // namespace

extern "C" {

void* zoo_cache_create(size_t capacity_bytes, const char* spill_dir) {
    Cache* c = new Cache();
    c->capacity = capacity_bytes;
    c->spill_dir = spill_dir ? spill_dir : ".";
    return c;
}

void zoo_cache_destroy(void* handle) {
    Cache* c = static_cast<Cache*>(handle);
    for (auto& kv : c->entries) {
        if (kv.second.on_disk) std::remove(c->path_for(kv.first).c_str());
    }
    delete c;
}

// Returns 0 on success.
int zoo_cache_put(void* handle, uint64_t id, const uint8_t* data,
                  size_t nbytes) {
    Cache* c = static_cast<Cache*>(handle);
    std::lock_guard<std::mutex> lock(c->mu);
    auto old = c->entries.find(id);
    if (old != c->entries.end()) {
        if (!old->second.on_disk) {
            c->used -= old->second.nbytes;
            c->lru.erase(old->second.lru_it);
        } else {
            std::remove(c->path_for(id).c_str());
        }
        c->entries.erase(old);
    }
    Entry e;
    e.nbytes = nbytes;
    if (make_room(c, nbytes)) {
        e.data.assign(data, data + nbytes);
        c->used += nbytes;
        c->lru.push_front(id);
        e.lru_it = c->lru.begin();
    } else {
        if (!write_file(c->path_for(id), data, nbytes)) return -1;
        e.on_disk = true;
        c->spills++;
    }
    c->entries.emplace(id, std::move(e));
    return 0;
}

// Returns the sample size, or -1 if missing / -2 on IO error.
int64_t zoo_cache_get(void* handle, uint64_t id, uint8_t* out,
                      size_t out_capacity) {
    Cache* c = static_cast<Cache*>(handle);
    std::lock_guard<std::mutex> lock(c->mu);
    auto it = c->entries.find(id);
    if (it == c->entries.end()) {
        c->misses++;
        return -1;
    }
    Entry& e = it->second;
    if (e.nbytes > out_capacity) return -2;
    if (e.on_disk) {
        c->misses++;
        if (!read_file(c->path_for(id), out, e.nbytes)) return -2;
        // promote back to DRAM when it fits
        if (make_room(c, e.nbytes)) {
            e.data.assign(out, out + e.nbytes);
            e.on_disk = false;
            c->used += e.nbytes;
            c->lru.push_front(id);
            e.lru_it = c->lru.begin();
            std::remove(c->path_for(id).c_str());
        }
    } else {
        c->hits++;
        std::memcpy(out, e.data.data(), e.nbytes);
        c->lru.erase(e.lru_it);
        c->lru.push_front(id);
        e.lru_it = c->lru.begin();
    }
    return static_cast<int64_t>(e.nbytes);
}

int64_t zoo_cache_size(void* handle, uint64_t id) {
    Cache* c = static_cast<Cache*>(handle);
    std::lock_guard<std::mutex> lock(c->mu);
    auto it = c->entries.find(id);
    return it == c->entries.end() ? -1
                                  : static_cast<int64_t>(it->second.nbytes);
}

// Drop one entry (DRAM bytes and/or spill file).  Returns 0 when the
// entry existed, -1 when absent.  The sharded ingest layer uses this to
// release staged shards on evict() without tearing down the cache.
int zoo_cache_remove(void* handle, uint64_t id) {
    Cache* c = static_cast<Cache*>(handle);
    std::lock_guard<std::mutex> lock(c->mu);
    auto it = c->entries.find(id);
    if (it == c->entries.end()) return -1;
    Entry& e = it->second;
    if (e.on_disk) {
        std::remove(c->path_for(id).c_str());
    } else {
        c->used -= e.nbytes;
        c->lru.erase(e.lru_it);
    }
    c->entries.erase(it);
    return 0;
}

uint64_t zoo_cache_count(void* handle) {
    Cache* c = static_cast<Cache*>(handle);
    std::lock_guard<std::mutex> lock(c->mu);
    return c->entries.size();
}

// Ground-truth recount for the memory ledger's leak sentinel:
// walk the entry map under the lock and re-derive the DRAM
// byte total from scratch, alongside the incrementally-maintained
// `used` counter read in the SAME critical section — the Python-side
// reconcile compares the pair with no cross-call race window.
// out4: [book_used, recounted_dram_bytes, dram_entries, spilled_entries]
void zoo_cache_recount(void* handle, uint64_t* out4) {
    Cache* c = static_cast<Cache*>(handle);
    std::lock_guard<std::mutex> lock(c->mu);
    uint64_t recounted = 0, dram = 0, spilled = 0;
    for (const auto& kv : c->entries) {
        if (kv.second.on_disk) {
            spilled++;
        } else {
            recounted += kv.second.nbytes;
            dram++;
        }
    }
    out4[0] = c->used;
    out4[1] = recounted;
    out4[2] = dram;
    out4[3] = spilled;
}

// stats: [dram_used, capacity, hits, misses, spills]
void zoo_cache_stats(void* handle, uint64_t* out5) {
    Cache* c = static_cast<Cache*>(handle);
    std::lock_guard<std::mutex> lock(c->mu);
    out5[0] = c->used;
    out5[1] = c->capacity;
    out5[2] = c->hits;
    out5[3] = c->misses;
    out5[4] = c->spills;
}

// ---- image preprocessing (CHW-agnostic: operates on HWC float32) ----------

// Bilinear resize HWC float32.
void zoo_image_resize_bilinear(const float* src, int64_t sh, int64_t sw,
                               int64_t ch, float* dst, int64_t dh,
                               int64_t dw) {
    const float sy = dh > 1 ? float(sh - 1) / float(dh - 1) : 0.f;
    const float sx = dw > 1 ? float(sw - 1) / float(dw - 1) : 0.f;
    for (int64_t y = 0; y < dh; ++y) {
        float fy = y * sy;
        int64_t y0 = static_cast<int64_t>(fy);
        int64_t y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
        float wy = fy - y0;
        for (int64_t x = 0; x < dw; ++x) {
            float fx = x * sx;
            int64_t x0 = static_cast<int64_t>(fx);
            int64_t x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
            float wx = fx - x0;
            for (int64_t c = 0; c < ch; ++c) {
                float v00 = src[(y0 * sw + x0) * ch + c];
                float v01 = src[(y0 * sw + x1) * ch + c];
                float v10 = src[(y1 * sw + x0) * ch + c];
                float v11 = src[(y1 * sw + x1) * ch + c];
                float top = v00 + wx * (v01 - v00);
                float bot = v10 + wx * (v11 - v10);
                dst[(y * dw + x) * ch + c] = top + wy * (bot - top);
            }
        }
    }
}

// Center/offset crop HWC float32.
void zoo_image_crop(const float* src, int64_t sh, int64_t sw, int64_t ch,
                    int64_t oy, int64_t ox, float* dst, int64_t dh,
                    int64_t dw) {
    for (int64_t y = 0; y < dh; ++y) {
        const float* row = src + ((y + oy) * sw + ox) * ch;
        std::memcpy(dst + y * dw * ch, row, sizeof(float) * dw * ch);
    }
}

// Per-channel normalize in place: (x - mean[c]) / std[c].
void zoo_image_normalize(float* img, int64_t h, int64_t w, int64_t ch,
                         const float* mean, const float* stddev) {
    int64_t n = h * w;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t c = 0; c < ch; ++c) {
            img[i * ch + c] = (img[i * ch + c] - mean[c]) / stddev[c];
        }
    }
}

// CRC-32C (Castagnoli), slicing-by-8: the TFRecord framing checksum.  The
// data layer verifies every shard it ingests, so this sits on the ingest
// hot path (the python fallback is ~100x slower).
static uint32_t kCrcTables[8][256];
static bool crc_tables_ready = [] {
  for (int i = 0; i < 256; ++i) {
    uint32_t crc = static_cast<uint32_t>(i);
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ (crc & 1 ? 0x82F63B78u : 0u);
    kCrcTables[0][i] = crc;
  }
  for (int t = 1; t < 8; ++t)
    for (int i = 0; i < 256; ++i)
      kCrcTables[t][i] =
          (kCrcTables[t - 1][i] >> 8) ^ kCrcTables[0][kCrcTables[t - 1][i] & 0xFF];
  return true;
}();

uint32_t zoo_crc32c(const uint8_t* data, size_t len) {
  (void)crc_tables_ready;
  uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data, 8);
    chunk ^= crc;
    crc = kCrcTables[7][chunk & 0xFF] ^ kCrcTables[6][(chunk >> 8) & 0xFF] ^
          kCrcTables[5][(chunk >> 16) & 0xFF] ^ kCrcTables[4][(chunk >> 24) & 0xFF] ^
          kCrcTables[3][(chunk >> 32) & 0xFF] ^ kCrcTables[2][(chunk >> 40) & 0xFF] ^
          kCrcTables[1][(chunk >> 48) & 0xFF] ^ kCrcTables[0][(chunk >> 56) & 0xFF];
    data += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ kCrcTables[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
