// Native read-only LMDB B+tree reader (no liblmdb dependency).
//
// C++ counterpart of parseq_tpu_torch/data/lmdb.py:LmdbReader — same on-disk
// format understanding (LMDB 0.9.x data format, 4096-byte pages, 64-bit
// layout): meta-page selection by txnid, branch/leaf binary search,
// overflow-page values. Exposed through a C ABI consumed via ctypes
// (parseq_tpu_torch/data/native/__init__.py, built into build/native/ by
// utils/native_build.py; a copy of parseq_tpu/data/native/lmdb_reader.cpp);
// the Python mmap reader remains the
// fallback when the toolchain is unavailable.
//
// The hot use case is the dataset label-preprocessing scan
// (dataset.py:_preprocess_labels): millions of point lookups per LMDB,
// where Python-level page walking dominates.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;
constexpr uint16_t P_BRANCH = 0x01;
constexpr uint16_t P_LEAF = 0x02;
constexpr uint16_t P_META = 0x08;
constexpr uint16_t F_BIGDATA = 0x01;
constexpr uint64_t P_INVALID = ~0ULL;
constexpr size_t PAGE_HDR = 16;
constexpr size_t NODE_HDR = 8;

#pragma pack(push, 1)
struct PageHeader {
  uint64_t pgno;
  uint16_t pad;
  uint16_t flags;
  uint16_t lower;
  uint16_t upper;
};

struct Db {
  uint32_t pad;
  uint16_t flags;
  uint16_t depth;
  uint64_t branch_pages;
  uint64_t leaf_pages;
  uint64_t overflow_pages;
  uint64_t entries;
  uint64_t root;
};

struct Meta {
  uint32_t magic;
  uint32_t version;
  int64_t address;
  uint64_t mapsize;
  Db dbs[2];
  uint64_t last_pg;
  uint64_t txnid;
};

struct Node {
  uint16_t lo;
  uint16_t hi;
  uint16_t flags;
  uint16_t ksize;
};
#pragma pack(pop)

struct Reader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  size_t page_size = 4096;
  uint64_t root = P_INVALID;
  uint64_t entries = 0;
};

inline const PageHeader* page(const Reader* r, uint64_t pgno) {
  return reinterpret_cast<const PageHeader*>(r->map + pgno * r->page_size);
}

inline unsigned numkeys(const PageHeader* p) {
  return (p->lower - PAGE_HDR) >> 1;
}

inline const Node* node(const Reader* r, const PageHeader* p, unsigned idx) {
  const uint16_t* ptrs =
      reinterpret_cast<const uint16_t*>(reinterpret_cast<const uint8_t*>(p) + PAGE_HDR);
  return reinterpret_cast<const Node*>(reinterpret_cast<const uint8_t*>(p) + ptrs[idx]);
}

inline const uint8_t* node_key(const Node* n) {
  return reinterpret_cast<const uint8_t*>(n) + NODE_HDR;
}

inline uint64_t branch_pgno(const Node* n) {
  return uint64_t(n->lo) | (uint64_t(n->hi) << 16) | (uint64_t(n->flags) << 32);
}

int key_cmp(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
  size_t m = alen < blen ? alen : blen;
  int c = memcmp(a, b, m);
  if (c) return c;
  return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

}  // namespace

extern "C" {

void* parseq_lmdb_open(const char* path) {
  Reader* r = new Reader();
  r->fd = ::open(path, O_RDONLY);
  if (r->fd < 0) { delete r; return nullptr; }
  struct stat st;
  if (fstat(r->fd, &st) != 0 || st.st_size < 8192) { ::close(r->fd); delete r; return nullptr; }
  r->size = size_t(st.st_size);
  void* m = mmap(nullptr, r->size, PROT_READ, MAP_SHARED, r->fd, 0);
  if (m == MAP_FAILED) { ::close(r->fd); delete r; return nullptr; }
  r->map = static_cast<const uint8_t*>(m);

  uint64_t best_txn = 0;
  bool found = false;
  for (int pg = 0; pg < 2; ++pg) {
    const PageHeader* ph = reinterpret_cast<const PageHeader*>(r->map + pg * 4096);
    if (!(ph->flags & P_META)) continue;
    const Meta* meta = reinterpret_cast<const Meta*>(r->map + pg * 4096 + PAGE_HDR);
    if (meta->magic != kMagic || meta->version != kVersion) continue;
    if (!found || meta->txnid > best_txn) {
      found = true;
      best_txn = meta->txnid;
      r->page_size = meta->dbs[0].pad ? meta->dbs[0].pad : 4096;
      r->root = meta->dbs[1].root;
      r->entries = meta->dbs[1].entries;
    }
  }
  if (!found) { munmap(m, r->size); ::close(r->fd); delete r; return nullptr; }
  return r;
}

void parseq_lmdb_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->map) munmap(const_cast<uint8_t*>(r->map), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

uint64_t parseq_lmdb_entries(void* handle) {
  return static_cast<Reader*>(handle)->entries;
}

// Returns a pointer into the mmap (valid until close) or nullptr; *vlen set.
const uint8_t* parseq_lmdb_get(void* handle, const uint8_t* key, size_t klen,
                               size_t* vlen) {
  const Reader* r = static_cast<const Reader*>(handle);
  if (!r || r->root == P_INVALID) return nullptr;
  uint64_t pgno = r->root;
  for (;;) {
    const PageHeader* p = page(r, pgno);
    unsigned n = numkeys(p);
    if (p->flags & P_BRANCH) {
      // last child whose key <= target; entry 0 has an empty key
      unsigned lo = 1, hi = n - 1, child = 0;
      while (lo <= hi && hi < n) {
        unsigned mid = (lo + hi) / 2;
        const Node* nd = node(r, p, mid);
        if (key_cmp(node_key(nd), nd->ksize, key, klen) <= 0) {
          child = mid;
          lo = mid + 1;
        } else {
          if (mid == 0) break;
          hi = mid - 1;
        }
      }
      pgno = branch_pgno(node(r, p, child));
    } else if (p->flags & P_LEAF) {
      int lo = 0, hi = int(n) - 1;
      while (lo <= hi) {
        int mid = (lo + hi) / 2;
        const Node* nd = node(r, p, mid);
        int c = key_cmp(node_key(nd), nd->ksize, key, klen);
        if (c == 0) {
          size_t dsize = size_t(nd->lo) | (size_t(nd->hi) << 16);
          *vlen = dsize;
          if (nd->flags & F_BIGDATA) {
            uint64_t ovpg;
            memcpy(&ovpg, node_key(nd) + nd->ksize, 8);
            return r->map + ovpg * r->page_size + PAGE_HDR;
          }
          return node_key(nd) + nd->ksize;
        }
        if (c < 0) lo = mid + 1; else hi = mid - 1;
      }
      return nullptr;
    } else {
      return nullptr;
    }
  }
}

}  // extern "C"
