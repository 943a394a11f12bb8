// dclip_native: host-side native runtime for dclip_tpu_torch, a copy of
// dclip_tpu/native/dclip_native.cc, so both packages read one store layout.
//
// Two components, each replacing a third-party native dependency of the
// reference (SURVEY.md §2.4):
//
// 1. KVStore — an append-only, mmap-read, hash-indexed binary record store.
//    Replaces the reference's dbm/ndbm out-of-core caches
//    (train_contrastive_teacher.py:19-95, CLIP_image_distillation.py:150-263)
//    and the >1GB pickle->dbm conversion dance: O(1) mmap open (no
//    deserialization), single-writer appends, explicit sync with an
//    atomically swapped index, and crash safety (an unsynced tail is
//    ignored on reopen because the header's index pointer still references
//    the last synced index).
//
//    File layout (two files):
//      <path>:      [magic 'DCS1' u32 | u32 pad]
//                   [record: u32 key_len | key bytes | u64 val_len | val]*
//                   (append-only; a crash leaves at most a dangling tail)
//      <path>.idx:  [magic | u32 pad | u64 data_end | u64 n_records]
//                   [(u64 key_hash | u64 record_off)*]
//                   (rewritten atomically on sync; reopen trusts only the
//                   data_end it records, so an unsynced tail is ignored)
//
// 2. topk_ip — multithreaded exact top-k inner-product search over an
//    [N, D] float32 matrix. Replaces FAISS IndexFlatIP
//    (compute_faiss.py:26-27, image_tokenizer.py:260-262) for HOST-side
//    consumers (offline cache builds, CPU-only corpus tooling); the
//    device path is the matmul in dclip_tpu_torch.ops.knn.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libdclip_native.so dclip_native.cc -lpthread
// Built into native/_build/ and loaded via ctypes (dclip_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x31534344;  // 'DCS1' little-endian

struct DataHeader {
  uint32_t magic;
  uint32_t reserved;
};

struct IndexHeader {
  uint32_t magic;
  uint32_t reserved;
  uint64_t data_end;
  uint64_t n_records;
};

uint64_t fnv1a(const char* data, uint64_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (uint64_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

struct Store {
  std::string path;
  bool writable = false;
  FILE* f = nullptr;                      // write handle (append)
  const char* map = nullptr;              // read mmap
  size_t map_size = 0;
  int fd = -1;
  std::unordered_multimap<uint64_t, uint64_t> index;  // hash -> record off
  uint64_t data_end = sizeof(DataHeader);  // next record offset
  std::mutex mu;

  ~Store() {
    if (map) munmap(const_cast<char*>(map), map_size);
    if (fd >= 0) close(fd);
    if (f) fclose(f);
  }

  bool remap() {
    if (map) {
      munmap(const_cast<char*>(map), map_size);
      map = nullptr;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(DataHeader))
      return false;
    map_size = st.st_size;
    void* m = mmap(nullptr, map_size, PROT_READ, MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) return false;
    map = static_cast<const char*>(m);
    return true;
  }

  // Writer-side reads: appends go through FILE* and are not yet visible in
  // the read mmap; flush + remap when an offset beyond the map is probed.
  void ensure_visible(uint64_t off_end) {
    if (off_end > map_size && writable && f) {
      fflush(f);
      remap();
    }
  }

  const char* record_at(uint64_t off, uint32_t* key_len, const char** key,
                        uint64_t* val_len) const {
    if (off + 4 > map_size) return nullptr;
    std::memcpy(key_len, map + off, 4);
    const char* k = map + off + 4;
    uint64_t voff = off + 4 + *key_len;
    if (voff + 8 > map_size) return nullptr;
    std::memcpy(val_len, map + voff, 8);
    const char* v = map + voff + 8;
    if (voff + 8 + *val_len > map_size) return nullptr;
    *key = k;
    return v;
  }
};

}  // namespace

extern "C" {

// ---- KVStore ---------------------------------------------------------------

void* dcs_open(const char* path, int writable) {
  auto* s = new Store();
  s->path = path;
  s->writable = writable != 0;
  struct stat st;
  bool exists = stat(path, &st) == 0 && st.st_size >= (off_t)sizeof(DataHeader);

  if (s->writable) {
    s->f = fopen(path, exists ? "r+b" : "w+b");
    if (!s->f) { delete s; return nullptr; }
    if (!exists) {
      DataHeader h{kMagic, 0};
      fwrite(&h, sizeof(h), 1, s->f);
      fflush(s->f);
    }
  }
  s->fd = open(path, O_RDONLY);
  if (s->fd < 0 || !s->remap()) { delete s; return nullptr; }
  {
    DataHeader h;
    std::memcpy(&h, s->map, sizeof(h));
    if (h.magic != kMagic) { delete s; return nullptr; }
  }

  // Load the synced index from the sidecar (absent for a fresh store).
  std::string idx_path = s->path + ".idx";
  FILE* fi = fopen(idx_path.c_str(), "rb");
  if (fi) {
    IndexHeader ih;
    if (fread(&ih, sizeof(ih), 1, fi) == 1 && ih.magic == kMagic) {
      s->data_end = ih.data_end;
      for (uint64_t i = 0; i < ih.n_records; ++i) {
        uint64_t hash, off;
        if (fread(&hash, 8, 1, fi) != 1 || fread(&off, 8, 1, fi) != 1) break;
        s->index.emplace(hash, off);
      }
    }
    fclose(fi);
  }
  return s;
}

int64_t dcs_count(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  return static_cast<int64_t>(s->index.size());
}

// Append (or logically overwrite) one record. Visible to get() after sync.
int dcs_put(void* handle, const char* key, uint64_t key_len,
            const char* val, uint64_t val_len) {
  auto* s = static_cast<Store*>(handle);
  if (!s->writable) return -1;
  std::lock_guard<std::mutex> lock(s->mu);
  uint64_t off = s->data_end;
  if (fseeko(s->f, off, SEEK_SET) != 0) return -2;
  uint32_t kl = static_cast<uint32_t>(key_len);
  if (fwrite(&kl, 4, 1, s->f) != 1) return -3;
  if (key_len && fwrite(key, key_len, 1, s->f) != 1) return -3;
  if (fwrite(&val_len, 8, 1, s->f) != 1) return -3;
  if (val_len && fwrite(val, val_len, 1, s->f) != 1) return -3;
  s->data_end = off + 4 + key_len + 8 + val_len;
  uint64_t h = fnv1a(key, key_len);
  // Overwrite semantics: drop older offsets for the SAME key only (a
  // colliding hash with a different key must survive).
  s->ensure_visible(off);  // make prior records readable for key compare
  auto range = s->index.equal_range(h);
  for (auto it = range.first; it != range.second;) {
    uint32_t kl;
    uint64_t vl;
    const char* k;
    const char* v = s->record_at(it->second, &kl, &k, &vl);
    if (v && kl == key_len && std::memcmp(k, key, key_len) == 0) {
      it = s->index.erase(it);
    } else {
      ++it;
    }
  }
  s->index.emplace(h, off);
  return 0;
}

// Publish: flush data, then atomically swap the sidecar index.
int dcs_sync(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s->writable) return -1;
  std::lock_guard<std::mutex> lock(s->mu);
  fflush(s->f);
  fsync(fileno(s->f));
  std::string idx_path = s->path + ".idx";
  std::string tmp_path = idx_path + ".tmp";
  FILE* fi = fopen(tmp_path.c_str(), "wb");
  if (!fi) return -2;
  IndexHeader ih{kMagic, 0, s->data_end, s->index.size()};
  bool ok = fwrite(&ih, sizeof(ih), 1, fi) == 1;
  for (const auto& kv : s->index) {
    if (!ok) break;
    ok = fwrite(&kv.first, 8, 1, fi) == 1 && fwrite(&kv.second, 8, 1, fi) == 1;
  }
  ok = (fflush(fi) == 0) && ok;
  fsync(fileno(fi));
  fclose(fi);
  if (!ok || rename(tmp_path.c_str(), idx_path.c_str()) != 0) return -3;
  return s->remap() ? 0 : -4;
}

// Returns value length, or -1 if absent. If out != null, copies min(cap, len).
int64_t dcs_get(void* handle, const char* key, uint64_t key_len,
                char* out, uint64_t cap) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  s->ensure_visible(s->data_end);
  uint64_t h = fnv1a(key, key_len);
  auto range = s->index.equal_range(h);
  for (auto it = range.first; it != range.second; ++it) {
    uint32_t kl;
    uint64_t vl;
    const char* k;
    const char* v = s->record_at(it->second, &kl, &k, &vl);
    if (!v) continue;
    if (kl == key_len && std::memcmp(k, key, key_len) == 0) {
      if (out && cap) std::memcpy(out, v, std::min(vl, cap));
      return static_cast<int64_t>(vl);
    }
  }
  return -1;
}

// Dump ALL keys in one call as [u32 len][key bytes]* records. Returns the
// total byte size (call with out=null to size the buffer). O(n) — the
// per-index dcs_key_at advances a hashtable iterator from begin each call
// and is O(n^2) for a full enumeration; use this for bulk listing.
int64_t dcs_keys_dump(void* handle, char* out, uint64_t cap) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  s->ensure_visible(s->data_end);
  uint64_t total = 0;
  uint64_t written = 0;
  for (const auto& kv : s->index) {
    uint32_t kl;
    uint64_t vl;
    const char* k;
    if (!s->record_at(kv.second, &kl, &k, &vl)) continue;
    total += 4 + kl;
    if (out && written + 4 + kl <= cap) {
      std::memcpy(out + written, &kl, 4);
      std::memcpy(out + written + 4, k, kl);
      written += 4 + kl;
    }
  }
  return static_cast<int64_t>(total);
}

// Iterate keys: writes the i-th key into out (cap bytes), returns key length
// or -1 when i is out of range. Order is unspecified but stable per open.
int64_t dcs_key_at(void* handle, uint64_t i, char* out, uint64_t cap) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  s->ensure_visible(s->data_end);
  if (i >= s->index.size()) return -1;
  auto it = s->index.begin();
  std::advance(it, i);
  uint32_t kl;
  uint64_t vl;
  const char* k;
  if (!s->record_at(it->second, &kl, &k, &vl)) return -1;
  if (out && cap) std::memcpy(out, k, std::min<uint64_t>(kl, cap));
  return kl;
}

void dcs_close(void* handle) { delete static_cast<Store*>(handle); }

// ---- exact top-k inner product ----------------------------------------------

// queries [Q, D], store [N, D], both row-major float32.
// out_scores [Q, k], out_idx [Q, k] (descending). Multithreaded over queries.
void dcs_topk_ip(const float* queries, int64_t q, const float* store,
                 int64_t n, int64_t d, int64_t k, float* out_scores,
                 int32_t* out_idx, int32_t n_threads) {
  k = std::min<int64_t>(k, n);
  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min<int32_t>(n_threads, q));

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<std::pair<float, int32_t>> heap;
    heap.reserve(k + 1);
    for (;;) {
      int64_t qi = next.fetch_add(1);
      if (qi >= q) return;
      const float* qv = queries + qi * d;
      heap.clear();
      // min-heap of size k on (score, -idx) so ties keep the lowest index
      // (FAISS tie behavior).
      auto cmp = [](const std::pair<float, int32_t>& a,
                    const std::pair<float, int32_t>& b) {
        if (a.first != b.first) return a.first > b.first;
        return a.second < b.second;
      };
      for (int64_t i = 0; i < n; ++i) {
        const float* sv = store + i * d;
        float acc = 0.f;
        for (int64_t j = 0; j < d; ++j) acc += qv[j] * sv[j];
        if ((int64_t)heap.size() < k) {
          heap.emplace_back(acc, static_cast<int32_t>(i));
          std::push_heap(heap.begin(), heap.end(), cmp);
        } else if (acc > heap.front().first) {
          std::pop_heap(heap.begin(), heap.end(), cmp);
          heap.back() = {acc, static_cast<int32_t>(i)};
          std::push_heap(heap.begin(), heap.end(), cmp);
        }
      }
      std::sort_heap(heap.begin(), heap.end(), cmp);
      // sort_heap with this cmp leaves ascending-by-cmp => descending score.
      for (int64_t j = 0; j < k; ++j) {
        out_scores[qi * k + j] = heap[j].first;
        out_idx[qi * k + j] = heap[j].second;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
