// wrfio — native netCDF-classic I/O backend with an asynchronous writer pool
// (the port's copy of the JAX package's io/native/wrfio.cpp: the same
// format, so that a file written by either package reads in the other).
//
// Equivalent of the reference's native I/O stack:
//   * external/io_netcdf/wrf_io.F90 + the C netCDF library beneath it
//     (canonical WRF paths; SURVEY.md §2.4 "I/O layer", ≈20k LoC) — here a
//     self-contained netCDF-3 (CDF-1/CDF-2 64-bit-offset) writer/reader,
//     because this environment ships no netCDF library;
//   * frame/module_io_quilt.F quilted-I/O server ranks (SURVEY.md §2.4) —
//     here a dedicated C++ writer-thread pool: the Python side enqueues
//     a fully-built in-memory file and returns immediately, so the device
//     never waits on disk; wrfio_drain() is the end-of-run barrier.
//
// File format: NetCDF Classic as specified by the public CDF-1/CDF-2 grammar
// (magic "CDF\x01"/"CDF\x02"; big-endian; name/value fields padded to 4-byte
// boundaries; CDF-2 widens var `begin` offsets to 64 bit). Readable by any
// netCDF implementation — tests cross-validate against scipy.io.netcdf_file.
//
// Exposed as a flat extern "C" API consumed via ctypes (no pybind11 in this
// environment): create/def_dim/put_att/put_var/write{,_async}/drain plus a
// reader (open/inq/get). All handles are opaque int64 ids, thread-safe.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- constants
enum NcType : int32_t {
  NC_BYTE = 1, NC_CHAR = 2, NC_SHORT = 3, NC_INT = 4,
  NC_FLOAT = 5, NC_DOUBLE = 6,
};
constexpr int32_t TAG_DIMENSION = 0x0A;
constexpr int32_t TAG_VARIABLE  = 0x0B;
constexpr int32_t TAG_ATTRIBUTE = 0x0C;

size_t type_size(int32_t t) {
  switch (t) {
    case NC_BYTE: case NC_CHAR: return 1;
    case NC_SHORT: return 2;
    case NC_INT: case NC_FLOAT: return 4;
    case NC_DOUBLE: return 8;
  }
  return 0;
}

// ------------------------------------------------------- big-endian packing
void be32(std::string& b, uint32_t v) {
  b.push_back(char(v >> 24)); b.push_back(char(v >> 16));
  b.push_back(char(v >> 8)); b.push_back(char(v));
}
void be64(std::string& b, uint64_t v) {
  be32(b, uint32_t(v >> 32)); be32(b, uint32_t(v));
}
uint32_t rd32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
uint64_t rd64(const uint8_t* p) {
  return (uint64_t(rd32(p)) << 32) | rd32(p + 4);
}

void pad4(std::string& b) { while (b.size() % 4) b.push_back('\0'); }

void put_name(std::string& b, const std::string& name) {
  be32(b, uint32_t(name.size()));
  b.append(name);
  pad4(b);
}

// Byte-swap a typed buffer into big-endian on the way out (x86 is LE).
void swap_out(std::string& b, const void* data, size_t n, size_t esize) {
  const uint8_t* s = static_cast<const uint8_t*>(data);
  size_t off = b.size();
  b.resize(off + n * esize);
  char* d = &b[off];
  if (esize == 1) { std::memcpy(d, s, n); return; }
  for (size_t i = 0; i < n; ++i)
    for (size_t j = 0; j < esize; ++j)
      d[i * esize + j] = char(s[i * esize + (esize - 1 - j)]);
}
void swap_in(void* dst, const uint8_t* src, size_t n, size_t esize) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  if (esize == 1) { std::memcpy(d, src, n); return; }
  for (size_t i = 0; i < n; ++i)
    for (size_t j = 0; j < esize; ++j)
      d[i * esize + j] = src[i * esize + (esize - 1 - j)];
}

// ----------------------------------------------------------------- builders
struct Att {
  std::string name;
  int32_t type;
  std::string text;           // NC_CHAR payload
  std::vector<double> nums;   // numeric payload (stored widest, cast on write)
};

struct Var {
  std::string name;
  int32_t type;
  std::vector<int32_t> dimids;
  std::vector<Att> atts;
  std::string data;           // big-endian payload, pre-swapped at put time
  uint64_t begin = 0;
};

struct FileBuilder {
  std::vector<std::pair<std::string, int32_t>> dims;
  std::vector<Att> gatts;
  std::vector<Var> vars;
  std::map<std::string, size_t> var_index;
  std::string error;

  void emit_atts(std::string& h, const std::vector<Att>& atts) const {
    if (atts.empty()) { be32(h, 0); be32(h, 0); return; }
    be32(h, TAG_ATTRIBUTE); be32(h, uint32_t(atts.size()));
    for (const auto& a : atts) {
      put_name(h, a.name);
      be32(h, uint32_t(a.type));
      if (a.type == NC_CHAR) {
        be32(h, uint32_t(a.text.size()));
        h.append(a.text);
        pad4(h);
      } else {
        be32(h, uint32_t(a.nums.size()));
        for (double v : a.nums) {
          if (a.type == NC_DOUBLE) swap_out(h, &v, 1, 8);
          else if (a.type == NC_FLOAT) { float f = float(v); swap_out(h, &f, 1, 4); }
          else { int32_t i = int32_t(v); swap_out(h, &i, 1, 4); }
        }
        pad4(h);
      }
    }
  }

  // Serialize the whole file (header + data). CDF-2 (64-bit offsets).
  std::string build() {
    std::string h;
    h.append("CDF\x02", 4);
    be32(h, 0);  // numrecs: no record dimension (all fields fixed-size)
    if (dims.empty()) { be32(h, 0); be32(h, 0); }
    else {
      be32(h, TAG_DIMENSION); be32(h, uint32_t(dims.size()));
      for (const auto& d : dims) { put_name(h, d.first); be32(h, uint32_t(d.second)); }
    }
    emit_atts(h, gatts);

    // var list: first pass with dummy begins to size the header, second pass
    // with real offsets (begin widths are fixed, so the size is stable).
    auto emit_vars = [&](std::string& out) {
      if (vars.empty()) { be32(out, 0); be32(out, 0); return; }
      be32(out, TAG_VARIABLE); be32(out, uint32_t(vars.size()));
      for (const auto& v : vars) {
        put_name(out, v.name);
        be32(out, uint32_t(v.dimids.size()));
        for (int32_t d : v.dimids) be32(out, uint32_t(d));
        emit_atts(out, v.atts);
        be32(out, uint32_t(v.type));
        size_t vsize = v.data.size();
        while (vsize % 4) ++vsize;
        be32(out, uint32_t(vsize > 0xFFFFFFFFu ? 0xFFFFFFFFu : vsize));
        be64(out, v.begin);
      }
    };
    std::string probe = h;
    emit_vars(probe);
    uint64_t off = probe.size();
    for (auto& v : vars) {
      v.begin = off;
      size_t vsize = v.data.size();
      while (vsize % 4) ++vsize;
      off += vsize;
    }
    emit_vars(h);
    for (const auto& v : vars) {
      h.append(v.data);
      pad4(h);
    }
    return h;
  }
};

// ------------------------------------------------------------------- reader
struct ReadVar {
  int32_t type;
  std::vector<int32_t> dimids;
  uint64_t begin;
  uint64_t nelems;
};

struct FileReader {
  std::string bytes;
  std::vector<std::pair<std::string, int32_t>> dims;
  std::vector<Att> gatts;
  std::vector<std::pair<std::string, ReadVar>> vars;
  std::map<std::string, size_t> var_index;
  std::string error;

  const uint8_t* p(size_t off) const {
    return reinterpret_cast<const uint8_t*>(bytes.data()) + off;
  }

  bool parse() {
    if (bytes.size() < 8 || std::memcmp(bytes.data(), "CDF", 3) != 0)
      { error = "not a CDF file"; return false; }
    int version = bytes[3];
    if (version != 1 && version != 2) { error = "unsupported CDF version"; return false; }
    size_t off = 8;  // skip magic + numrecs
    auto name_at = [&](std::string& out) {
      uint32_t n = rd32(p(off)); off += 4;
      out.assign(bytes.data() + off, n);
      off += n; while (off % 4) ++off;
    };
    auto parse_atts = [&](std::vector<Att>& atts) {
      uint32_t tag = rd32(p(off)); off += 4;
      uint32_t cnt = rd32(p(off)); off += 4;
      if (tag != TAG_ATTRIBUTE) return;
      for (uint32_t i = 0; i < cnt; ++i) {
        Att a; name_at(a.name);
        a.type = int32_t(rd32(p(off))); off += 4;
        uint32_t n = rd32(p(off)); off += 4;
        size_t es = type_size(a.type);
        if (a.type == NC_CHAR) a.text.assign(bytes.data() + off, n);
        else for (uint32_t k = 0; k < n; ++k) {
          double v = 0;
          if (a.type == NC_DOUBLE) { swap_in(&v, p(off + 8 * k), 1, 8); }
          else if (a.type == NC_FLOAT) { float f; swap_in(&f, p(off + 4 * k), 1, 4); v = f; }
          else if (a.type == NC_INT) { int32_t x; swap_in(&x, p(off + 4 * k), 1, 4); v = x; }
          else if (a.type == NC_SHORT) { int16_t x; swap_in(&x, p(off + 2 * k), 1, 2); v = x; }
          a.nums.push_back(v);
        }
        off += n * es; while (off % 4) ++off;
        atts.push_back(std::move(a));
      }
    };
    // dim list
    uint32_t tag = rd32(p(off)); off += 4;
    uint32_t cnt = rd32(p(off)); off += 4;
    if (tag == TAG_DIMENSION)
      for (uint32_t i = 0; i < cnt; ++i) {
        std::string nm; name_at(nm);
        int32_t len = int32_t(rd32(p(off))); off += 4;
        dims.emplace_back(nm, len);
      }
    parse_atts(gatts);
    tag = rd32(p(off)); off += 4;
    cnt = rd32(p(off)); off += 4;
    if (tag == TAG_VARIABLE)
      for (uint32_t i = 0; i < cnt; ++i) {
        std::string nm; name_at(nm);
        ReadVar v;
        uint32_t nd = rd32(p(off)); off += 4;
        for (uint32_t k = 0; k < nd; ++k) { v.dimids.push_back(int32_t(rd32(p(off)))); off += 4; }
        std::vector<Att> va; parse_atts(va);
        v.type = int32_t(rd32(p(off))); off += 4;
        off += 4;  // vsize (recomputed from dims)
        if (version == 2) { v.begin = rd64(p(off)); off += 8; }
        else { v.begin = rd32(p(off)); off += 4; }
        v.nelems = 1;
        for (int32_t d : v.dimids) v.nelems *= uint64_t(dims[d].second);
        var_index[nm] = vars.size();
        vars.emplace_back(nm, v);
      }
    return true;
  }
};

// ------------------------------------------------------- handle bookkeeping
std::mutex g_mu;
std::map<int64_t, std::unique_ptr<FileBuilder>> g_builders;
std::map<int64_t, std::unique_ptr<FileReader>> g_readers;
int64_t g_next = 1;

FileBuilder* builder(int64_t h) {
  std::lock_guard<std::mutex> l(g_mu);
  auto it = g_builders.find(h);
  return it == g_builders.end() ? nullptr : it->second.get();
}
FileReader* reader(int64_t h) {
  std::lock_guard<std::mutex> l(g_mu);
  auto it = g_readers.find(h);
  return it == g_readers.end() ? nullptr : it->second.get();
}

// ------------------------------------------------- quilt: async writer pool
// Dedicated writer threads (module_io_quilt.F analog): compute enqueues a
// finished file and returns; drain() is the completion barrier.
struct Quilt {
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::deque<std::pair<std::string, std::string>> q;  // (path, bytes)
  int in_flight = 0;
  std::atomic<int> errors{0};
  std::vector<std::thread> workers;
  bool stop = false;

  void ensure_workers(int n = 2) {
    std::lock_guard<std::mutex> l(mu);
    while (int(workers.size()) < n) {
      workers.emplace_back([this] { run(); });
      // Detached: drain() is the lifetime barrier; joinable threads would
      // terminate() at static destruction when the process exits.
      workers.back().detach();
    }
  }
  void run() {
    for (;;) {
      std::pair<std::string, std::string> job;
      {
        std::unique_lock<std::mutex> l(mu);
        cv_work.wait(l, [this] { return stop || !q.empty(); });
        if (stop && q.empty()) return;
        job = std::move(q.front());
        q.pop_front();
        ++in_flight;
      }
      if (!write_file(job.first, job.second)) errors.fetch_add(1);
      {
        std::lock_guard<std::mutex> l(mu);
        --in_flight;
      }
      cv_done.notify_all();
    }
  }
  static bool write_file(const std::string& path, const std::string& bytes) {
    std::FILE* f = std::fopen(path.c_str(), "wb");
    if (!f) return false;
    size_t n = std::fwrite(bytes.data(), 1, bytes.size(), f);
    std::fclose(f);
    return n == bytes.size();
  }
  void submit(std::string path, std::string bytes) {
    ensure_workers();
    {
      std::lock_guard<std::mutex> l(mu);
      q.emplace_back(std::move(path), std::move(bytes));
    }
    cv_work.notify_one();
  }
  int drain() {
    std::unique_lock<std::mutex> l(mu);
    cv_done.wait(l, [this] { return q.empty() && in_flight == 0; });
    return errors.exchange(0);
  }
};
// Heap-allocated and deliberately leaked: a static Quilt's destructor would
// destroy the condition variables while detached workers still wait on them
// (observed as a hang at interpreter exit); process teardown reaps the
// threads, drain() is the durability barrier.
Quilt& g_quilt = *new Quilt;

}  // namespace

// ==================================================================== C API
extern "C" {

int64_t wrfio_create() {
  std::lock_guard<std::mutex> l(g_mu);
  int64_t h = g_next++;
  g_builders[h] = std::make_unique<FileBuilder>();
  return h;
}

// Returns the dim id, or -1 on error.
int32_t wrfio_def_dim(int64_t h, const char* name, int32_t len) {
  FileBuilder* b = builder(h);
  if (!b || len <= 0) return -1;
  b->dims.emplace_back(name, len);
  return int32_t(b->dims.size() - 1);
}

int32_t wrfio_put_att_text(int64_t h, const char* var, const char* name,
                           const char* value) {
  FileBuilder* b = builder(h);
  if (!b) return -1;
  Att a; a.name = name; a.type = NC_CHAR; a.text = value;
  if (var == nullptr || var[0] == '\0') { b->gatts.push_back(std::move(a)); return 0; }
  auto it = b->var_index.find(var);
  if (it == b->var_index.end()) return -1;
  b->vars[it->second].atts.push_back(std::move(a));
  return 0;
}

int32_t wrfio_put_att_double(int64_t h, const char* var, const char* name,
                             double value) {
  FileBuilder* b = builder(h);
  if (!b) return -1;
  Att a; a.name = name; a.type = NC_DOUBLE; a.nums = {value};
  if (var == nullptr || var[0] == '\0') { b->gatts.push_back(std::move(a)); return 0; }
  auto it = b->var_index.find(var);
  if (it == b->var_index.end()) return -1;
  b->vars[it->second].atts.push_back(std::move(a));
  return 0;
}

// type: one of NcType; data is host-order, swapped here.
int32_t wrfio_put_var(int64_t h, const char* name, int32_t type,
                      int32_t ndims, const int32_t* dimids,
                      const void* data) {
  FileBuilder* b = builder(h);
  if (!b) return -1;
  size_t es = type_size(type);
  if (es == 0) return -1;
  Var v; v.name = name; v.type = type;
  uint64_t n = 1;
  for (int32_t i = 0; i < ndims; ++i) {
    int32_t d = dimids[i];
    if (d < 0 || size_t(d) >= b->dims.size()) return -1;
    v.dimids.push_back(d);
    n *= uint64_t(b->dims[d].second);
  }
  v.data.reserve(n * es);
  swap_out(v.data, data, n, es);
  b->var_index[v.name] = b->vars.size();
  b->vars.push_back(std::move(v));
  return 0;
}

// Synchronous write; returns 0 on success. Frees the handle.
int32_t wrfio_write(int64_t h, const char* path) {
  FileBuilder* b = builder(h);
  if (!b) return -1;
  std::string bytes = b->build();
  bool ok = Quilt::write_file(path, bytes);
  std::lock_guard<std::mutex> l(g_mu);
  g_builders.erase(h);
  return ok ? 0 : -2;
}

// Asynchronous write through the quilt pool; the handle is consumed.
int32_t wrfio_write_async(int64_t h, const char* path) {
  FileBuilder* b = builder(h);
  if (!b) return -1;
  std::string bytes = b->build();
  {
    std::lock_guard<std::mutex> l(g_mu);
    g_builders.erase(h);
  }
  g_quilt.submit(path, std::move(bytes));
  return 0;
}

// Barrier: waits for all pending async writes; returns the number of failed
// writes since the previous drain (0 = all landed).
int32_t wrfio_drain() { return g_quilt.drain(); }

void wrfio_free(int64_t h) {
  std::lock_guard<std::mutex> l(g_mu);
  g_builders.erase(h);
  g_readers.erase(h);
}

// ---------------------------------------------------------------- reader
int64_t wrfio_open(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  auto r = std::make_unique<FileReader>();
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  r->bytes.resize(size_t(sz));
  size_t n = std::fread(&r->bytes[0], 1, size_t(sz), f);
  std::fclose(f);
  if (n != size_t(sz) || !r->parse()) return -2;
  std::lock_guard<std::mutex> l(g_mu);
  int64_t h = g_next++;
  g_readers[h] = std::move(r);
  return h;
}

int32_t wrfio_inq_nvars(int64_t h) {
  FileReader* r = reader(h);
  return r ? int32_t(r->vars.size()) : -1;
}

// Copies the i-th var name into buf (cap bytes incl. NUL); returns name len.
int32_t wrfio_var_name(int64_t h, int32_t i, char* buf, int32_t cap) {
  FileReader* r = reader(h);
  if (!r || i < 0 || size_t(i) >= r->vars.size()) return -1;
  const std::string& nm = r->vars[i].first;
  std::snprintf(buf, size_t(cap), "%s", nm.c_str());
  return int32_t(nm.size());
}

// Shape/type query: fills type, ndims, and up to 8 dim lengths.
int32_t wrfio_inq_var(int64_t h, const char* name, int32_t* type,
                      int32_t* ndims, int64_t* dimlens) {
  FileReader* r = reader(h);
  if (!r) return -1;
  auto it = r->var_index.find(name);
  if (it == r->var_index.end()) return -1;
  const ReadVar& v = r->vars[it->second].second;
  *type = v.type;
  *ndims = int32_t(v.dimids.size());
  for (size_t k = 0; k < v.dimids.size() && k < 8; ++k)
    dimlens[k] = r->dims[v.dimids[k]].second;
  return 0;
}

// Reads the full variable into out (host byte order). Caller sizes out from
// wrfio_inq_var.
int32_t wrfio_get_var(int64_t h, const char* name, void* out) {
  FileReader* r = reader(h);
  if (!r) return -1;
  auto it = r->var_index.find(name);
  if (it == r->var_index.end()) return -1;
  const ReadVar& v = r->vars[it->second].second;
  size_t es = type_size(v.type);
  if (v.begin + v.nelems * es > r->bytes.size()) return -2;
  swap_in(out, r->p(v.begin), v.nelems, es);
  return 0;
}

// Global double attribute lookup (scalar metadata: _time_s, _step_idx...).
int32_t wrfio_get_att_double(int64_t h, const char* name, double* out) {
  FileReader* r = reader(h);
  if (!r) return -1;
  for (const auto& a : r->gatts)
    if (a.name == name && !a.nums.empty()) { *out = a.nums[0]; return 0; }
  return -1;
}

}  // extern "C"
