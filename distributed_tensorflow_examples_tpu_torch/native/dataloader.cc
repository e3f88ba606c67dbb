// Native data-loader core: the tf.data C++ runtime role (SURVEY.md §2c T7,
// §1 L0).  The PyTorch port's own copy of the JAX package's
// native/dataloader.cc, the same code and the same dtx_dl_* C ABI, linked
// into the port's one native library beside accumulator.cc and
// ps_server.cc.  Python orchestrates (shard discovery, epoch
// configuration, numpy views); the hot path — file IO, record shuffling,
// batch assembly — runs here on a worker-thread pool feeding a bounded ring
// buffer, so a 1-GIL Python process can keep an accelerator's infeed busy.
//
// Shard format "DTXRAW1\n" (written by data/native_loader.py::write_raw_shards):
//   magic[8]            "DTXRAW1\n"
//   u32 n_fields
//   per field: u8 name_len, name bytes, u8 dtype (0=u8,1=i32,2=f32),
//              u8 ndim, u32 dims[ndim]          (per-RECORD shape)
//   u64 n_records
//   data: record-major — for each record, each field's elements contiguous.
//
// Concurrency model: a shared epoch cursor hands whole chunks to workers;
// each worker reads its chunk, shuffles records within it (seeded,
// per-chunk), assembles fixed-size batches and blocks pushing them into the
// ring (backpressure).  Per-chunk remainders are dropped when
// drop_remainder, else emitted as short batches.  `repeat` reshuffles the
// chunk order each epoch (seed + epoch).  All dtx_dl_* entry points are a
// C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// Hard caps on untrusted header values: a corrupt or hostile
// shard must fail cleanly in read_header, not drive record_bytes/n_records
// arithmetic into overflow or a near-SIZE_MAX resize that std::bad_alloc-
// terminates the noexcept worker thread.
constexpr uint64_t kMaxRecordBytes = 1ull << 30;  // 1 GiB per record
constexpr uint64_t kMaxRecords = 1ull << 40;      // per shard
constexpr uint64_t kMaxShardBytes = 1ull << 40;   // 1 TiB mapped per shard

struct Field {
  std::string name;
  uint8_t dtype = 0;  // 0=u8, 1=i32, 2=f32
  std::vector<uint32_t> dims;
  size_t record_elems = 1;
  size_t elem_size = 1;
  size_t record_bytes() const { return record_elems * elem_size; }
};

struct Header {
  std::vector<Field> fields;
  uint64_t n_records = 0;
  size_t data_offset = 0;
  size_t record_bytes = 0;
};

bool same_schema(const Header& a, const Header& b) {
  // record_bytes alone is NOT enough: shards with reordered/retyped fields
  // of equal total size would be silently misparsed into scrambled batches.
  if (a.fields.size() != b.fields.size()) return false;
  for (size_t i = 0; i < a.fields.size(); ++i) {
    const Field &x = a.fields[i], &y = b.fields[i];
    if (x.name != y.name || x.dtype != y.dtype || x.dims != y.dims)
      return false;
  }
  return true;
}

bool read_header(FILE* f, Header* h) {
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "DTXRAW1\n", 8) != 0)
    return false;
  uint32_t n_fields = 0;
  if (fread(&n_fields, 4, 1, f) != 1 || n_fields == 0 || n_fields > 64)
    return false;
  h->fields.clear();
  h->record_bytes = 0;
  for (uint32_t i = 0; i < n_fields; ++i) {
    Field fd;
    uint8_t name_len = 0, ndim = 0;
    if (fread(&name_len, 1, 1, f) != 1) return false;
    std::vector<char> name(name_len);
    if (name_len && fread(name.data(), 1, name_len, f) != name_len)
      return false;
    fd.name.assign(name.begin(), name.end());
    if (fread(&fd.dtype, 1, 1, f) != 1 || fd.dtype > 2) return false;
    fd.elem_size = fd.dtype == 0 ? 1 : 4;
    if (fread(&ndim, 1, 1, f) != 1 || ndim > 8) return false;
    fd.record_elems = 1;
    for (uint8_t d = 0; d < ndim; ++d) {
      uint32_t dim = 0;
      if (fread(&dim, 4, 1, f) != 1) return false;
      // Overflow-checked product; cap keeps record_bytes arithmetic sane.
      if (dim != 0 && fd.record_elems > kMaxRecordBytes / dim) return false;
      fd.dims.push_back(dim);
      fd.record_elems *= dim;
    }
    if (fd.record_bytes() > kMaxRecordBytes ||
        h->record_bytes > kMaxRecordBytes - fd.record_bytes())
      return false;
    h->record_bytes += fd.record_bytes();
    h->fields.push_back(std::move(fd));
  }
  if (fread(&h->n_records, 8, 1, f) != 1) return false;
  if (h->n_records > kMaxRecords ||
      (h->record_bytes != 0 &&
       h->n_records > kMaxShardBytes / h->record_bytes))
    return false;
  h->data_offset = static_cast<size_t>(ftell(f));
  // The caps alone still admit process-killing allocations (a header may
  // CLAIM up to kMaxShardBytes): the claimed payload must actually exist
  // in the file before anyone sizes a buffer from it.
  if (fseek(f, 0, SEEK_END) != 0) return false;
  long end = ftell(f);
  if (end < 0) return false;
  uint64_t avail = (uint64_t)end - (uint64_t)h->data_offset;
  if ((uint64_t)end < (uint64_t)h->data_offset ||
      h->n_records * (uint64_t)h->record_bytes > avail)
    return false;
  if (fseek(f, (long)h->data_offset, SEEK_SET) != 0) return false;
  return true;
}

struct Batch {
  std::vector<uint8_t> data;  // field-major: all of field0's rows, then field1...
  int n_records = 0;
};

struct Loader {
  std::vector<std::string> paths;
  Header schema;  // from the first shard; all shards must match
  int batch = 0;
  int capacity = 0;
  uint64_t seed = 0;
  bool repeat = false;
  bool drop_remainder = true;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Batch> ring;
  size_t cursor = 0;  // next chunk index within the epoch order
  std::vector<uint32_t> order;
  uint64_t epoch = 0;
  int active_workers = 0;
  bool done = false;     // no more batches will ever arrive
  bool shutdown = false;
  std::atomic<int64_t> produced{0};
  std::string error;
  std::vector<std::thread> workers;

  void reshuffle_locked() {
    order.resize(paths.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (uint32_t)i;
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (epoch + 1));
    for (size_t i = order.size(); i > 1; --i) {
      size_t j = rng() % i;
      std::swap(order[i - 1], order[j]);
    }
  }

  // Returns the chunk path to process next, or empty when the (non-repeat)
  // epoch supply is exhausted.
  bool next_chunk(std::string* path, uint64_t* chunk_seed) {
    std::unique_lock<std::mutex> lk(mu);
    if (shutdown) return false;
    if (cursor >= order.size()) {
      if (!repeat) return false;
      ++epoch;
      cursor = 0;
      reshuffle_locked();
    }
    uint32_t idx = order[cursor++];
    *path = paths[idx];
    *chunk_seed = seed ^ (epoch << 32) ^ idx;
    return true;
  }

  void push(Batch&& b) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return (int)ring.size() < capacity || shutdown; });
    if (shutdown) return;
    ring.push_back(std::move(b));
    produced.fetch_add(1);
    cv_pop.notify_one();
  }

  void worker_main() {
    std::string path;
    uint64_t chunk_seed;
    while (next_chunk(&path, &chunk_seed)) {
      FILE* f = fopen(path.c_str(), "rb");
      if (!f) {
        std::lock_guard<std::mutex> lk(mu);
        error = "cannot open " + path;
        break;
      }
      Header h;
      if (!read_header(f, &h) || !same_schema(h, schema)) {
        fclose(f);
        std::lock_guard<std::mutex> lk(mu);
        error = "bad/mismatched shard header: " + path;
        break;
      }
      size_t n = (size_t)h.n_records;
      if (n < (size_t)batch && drop_remainder) {
        // Routine short TAIL shard: emits nothing, skip it (documented
        // drop-remainder semantics).  The no-shard-can-ever-emit case is
        // rejected up front in dtx_dl_new, so this cannot busy-spin.
        fclose(f);
        continue;
      }
      std::vector<uint8_t> raw(n * h.record_bytes);
      if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
        fclose(f);
        std::lock_guard<std::mutex> lk(mu);
        error = "short read: " + path;
        break;
      }
      fclose(f);

      std::vector<uint32_t> idx(n);
      for (size_t i = 0; i < n; ++i) idx[i] = (uint32_t)i;
      std::mt19937_64 rng(chunk_seed);
      for (size_t i = n; i > 1; --i) std::swap(idx[i - 1], idx[rng() % i]);

      // Field offsets within one packed record.
      std::vector<size_t> foff(schema.fields.size());
      size_t off = 0;
      for (size_t fi = 0; fi < schema.fields.size(); ++fi) {
        foff[fi] = off;
        off += schema.fields[fi].record_bytes();
      }

      for (size_t start = 0; start < n; start += batch) {
        size_t bn = std::min((size_t)batch, n - start);
        if (bn < (size_t)batch && drop_remainder) break;
        Batch b;
        b.n_records = (int)bn;
        b.data.resize(bn * schema.record_bytes);
        // Assemble field-major so each field is one contiguous numpy view.
        size_t out = 0;
        for (size_t fi = 0; fi < schema.fields.size(); ++fi) {
          size_t fb = schema.fields[fi].record_bytes();
          for (size_t r = 0; r < bn; ++r) {
            const uint8_t* src =
                raw.data() + (size_t)idx[start + r] * schema.record_bytes +
                foff[fi];
            memcpy(b.data.data() + out, src, fb);
            out += fb;
          }
        }
        push(std::move(b));
        {
          std::lock_guard<std::mutex> lk(mu);
          if (shutdown) return;
        }
      }
    }
    std::lock_guard<std::mutex> lk(mu);
    if (--active_workers == 0 && !repeat) {
      done = true;
      cv_pop.notify_all();
    }
    if (!error.empty()) {
      done = true;
      cv_pop.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* dtx_dl_new(const char** paths, int n_paths, int batch, int n_workers,
                 int capacity, uint64_t seed, int repeat, int drop_remainder) {
  if (n_paths <= 0 || batch <= 0) return nullptr;
  auto* L = new Loader();
  for (int i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  // Validate every shard's header up front: schemas must agree, and at
  // least one shard must be able to emit a full batch — otherwise a
  // repeat=true worker pool would busy-spin producing nothing while the
  // consumer times out "starved".
  uint64_t max_records = 0;
  for (int i = 0; i < n_paths; ++i) {
    FILE* f = fopen(L->paths[i].c_str(), "rb");
    Header h;
    if (!f || !read_header(f, &h)) {
      if (f) fclose(f);
      delete L;
      return nullptr;
    }
    fclose(f);
    if (i == 0) {
      L->schema = h;
    } else if (!same_schema(h, L->schema)) {
      delete L;
      return nullptr;
    }
    if (h.n_records > max_records) max_records = h.n_records;
  }
  if (drop_remainder && max_records < (uint64_t)batch) {
    delete L;
    return nullptr;
  }
  L->batch = batch;
  L->capacity = capacity > 0 ? capacity : 4;
  L->seed = seed;
  L->repeat = repeat != 0;
  L->drop_remainder = drop_remainder != 0;
  L->reshuffle_locked();
  int nw = n_workers > 0 ? n_workers : 2;
  if (nw > n_paths) nw = n_paths;
  L->active_workers = nw;
  for (int i = 0; i < nw; ++i)
    L->workers.emplace_back([L] { L->worker_main(); });
  return L;
}

// Schema as a compact text description Python parses:
// "name:dtype:dim0xdim1,...;name2:..." — dtype in {u8,i32,f32}.
int dtx_dl_schema(void* h, char* out, int cap) {
  auto* L = static_cast<Loader*>(h);
  std::string s;
  const char* dt[] = {"u8", "i32", "f32"};
  for (auto& f : L->schema.fields) {
    if (!s.empty()) s += ";";
    s += f.name + ":" + dt[f.dtype] + ":";
    if (f.dims.empty()) s += "-";
    for (size_t i = 0; i < f.dims.size(); ++i) {
      if (i) s += "x";
      s += std::to_string(f.dims[i]);
    }
  }
  if ((int)s.size() + 1 > cap) return -1;
  memcpy(out, s.c_str(), s.size() + 1);
  return (int)s.size();
}

int64_t dtx_dl_batch_bytes(void* h) {
  auto* L = static_cast<Loader*>(h);
  return (int64_t)L->batch * (int64_t)L->schema.record_bytes;
}

// Pops one batch into `out` (caller allocates dtx_dl_batch_bytes()).
// Returns n_records (>0), 0 on end-of-data, -1 on timeout, -2 on error.
int dtx_dl_next(void* h, uint8_t* out, int timeout_ms) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  bool ok = L->cv_pop.wait_for(
      lk, std::chrono::milliseconds(timeout_ms),
      [&] { return !L->ring.empty() || L->done || L->shutdown; });
  if (!ok) return -1;
  if (!L->error.empty()) return -2;
  if (L->ring.empty()) return 0;  // done/shutdown and drained
  Batch b = std::move(L->ring.front());
  L->ring.pop_front();
  L->cv_push.notify_one();
  lk.unlock();
  memcpy(out, b.data.data(), b.data.size());
  return b.n_records;
}

int dtx_dl_error(void* h, char* out, int cap) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(L->mu);
  if ((int)L->error.size() + 1 > cap) return -1;
  memcpy(out, L->error.c_str(), L->error.size() + 1);
  return (int)L->error.size();
}

int64_t dtx_dl_produced(void* h) {
  return static_cast<Loader*>(h)->produced.load();
}

void dtx_dl_free(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->shutdown = true;
    L->cv_push.notify_all();
    L->cv_pop.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
