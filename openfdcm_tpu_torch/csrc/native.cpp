// The port's native host runtime, behind a plain C interface (loaded with
// ctypes by openfdcm_tpu_torch/native.py; no CPython API):
//
//   * the binary line-file codec with its zlib envelope (reference
//     core/serialization.h:42-150 and the packio envelope):
//     fdcm_native_loads, fdcm_native_dumps, fdcm_native_read_file;
//   * a threaded batch loader: fdcm_native_read_batch;
//   * DefaultSearch pair generation (reference
//     src/searchstrategies/defaultsearch.cpp:29-49: a stable argsort by
//     length, the closest-length binary search, a centered window):
//     fdcm_native_default_search_pairs.
//
// Every entry returns 0 on success, else nonzero with a message in err.
// Buffers it hands back are malloc'd; the caller frees them with
// fdcm_native_free.  Built with g++ -O2 -std=c++17 -shared -fPIC ... -lz
// -lpthread at first use.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iterator>
#include <numeric>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr char kSignature[8] = {'O', 'P', 'E', 'N', 'F', 'D', 'C', 'M'};
constexpr size_t kHeaderSize = 45;                       // LinesSerialHeader
constexpr size_t kEnvelopeSize = 16 + 2 + 4 + 1 + 8 + 8;
constexpr uint64_t kMaxBody = 1ull << 30;                // ~64M lines

template <typename T>
void put_le(std::string& out, T v) {
  unsigned char buf[sizeof(T)];
  std::memcpy(buf, &v, sizeof(T));                       // x86: little-endian
  out.append(reinterpret_cast<char*>(buf), sizeof(T));
}

template <typename T>
T get_le(const unsigned char* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

// The body: the 45-byte header (serialization.h:59-80), then the records.
std::string serialize_body(const float* data, uint64_t n_lines, uint16_t yday,
                           uint16_t year) {
  std::string body;
  body.reserve(kHeaderSize + n_lines * 16);
  put_le<uint16_t>(body, 0);
  put_le<uint32_t>(body, 0);
  put_le<uint16_t>(body, 0);
  put_le<uint16_t>(body, 0);
  body.append(8, '\0');
  put_le<uint16_t>(body, 0);  // version major
  put_le<uint16_t>(body, 8);  // version minor
  put_le<uint16_t>(body, 0);  // version patch
  put_le<uint16_t>(body, yday);
  put_le<uint16_t>(body, year);
  put_le<uint16_t>(body, static_cast<uint16_t>(kHeaderSize));
  put_le<uint32_t>(body, static_cast<uint32_t>(kHeaderSize));
  body.push_back('\0');       // line data format 0
  put_le<uint16_t>(body, 16); // record length: 4 x f32
  put_le<uint64_t>(body, n_lines);
  body.append(reinterpret_cast<const char*>(data), n_lines * 16);
  return body;
}

std::string envelope(const std::string& body, bool compress) {
  std::string out(kSignature, 8);
  out.append(8, '\0');
  put_le<uint16_t>(out, 0);
  put_le<uint32_t>(out, 2);
  if (!compress) {
    out.push_back('\0');
    put_le<uint64_t>(out, body.size());
    put_le<uint64_t>(out, body.size());
    return out + body;
  }
  uLongf len = compressBound(body.size());
  std::string comp(len, '\0');
  if (compress2(reinterpret_cast<Bytef*>(&comp[0]), &len,
                reinterpret_cast<const Bytef*>(body.data()), body.size(),
                Z_DEFAULT_COMPRESSION) != Z_OK)
    throw std::runtime_error("zlib compression failed");
  comp.resize(len);
  out.push_back('\x01');
  put_le<uint64_t>(out, body.size());
  put_le<uint64_t>(out, comp.size());
  return out + comp;
}

// A whole line file's records as float32 (x1, y1, x2, y2) quadruples.
std::vector<float> parse_lines(const unsigned char* data, size_t size) {
  if (size < kEnvelopeSize || std::memcmp(data, kSignature, 8) != 0)
    throw std::runtime_error("not an OPENFDCM line file (bad signature)");
  const unsigned char flag = data[22];
  const uint64_t usz = get_le<uint64_t>(data + 23);
  const uint64_t csz = get_le<uint64_t>(data + 31);
  // compare against the bytes left, so a crafted csz cannot wrap
  if (csz > size - kEnvelopeSize)
    throw std::runtime_error("corrupt line file (truncated)");
  if (usz > kMaxBody)
    throw std::runtime_error("corrupt line file (unreasonable size)");
  std::string inflated;
  const unsigned char* body = data + kEnvelopeSize;
  uint64_t body_size = csz;
  if (flag) {
    inflated.resize(usz);
    uLongf len = usz;
    if (uncompress(reinterpret_cast<Bytef*>(&inflated[0]), &len, body, csz) !=
            Z_OK || len != usz)
      throw std::runtime_error("corrupt line file (zlib)");
    body = reinterpret_cast<const unsigned char*>(inflated.data());
    body_size = usz;
  } else if (csz != usz) {
    throw std::runtime_error("corrupt line file (size mismatch)");
  }
  if (body_size < kHeaderSize)
    throw std::runtime_error("corrupt line file (short body)");
  const uint16_t record_len = get_le<uint16_t>(body + 35);
  const uint64_t n = get_le<uint64_t>(body + 37);
  if (body[34] != 0 || record_len != 16)
    throw std::runtime_error("Line data format not recognized, found <" +
                             std::to_string(record_len) + ">");
  if (n > (body_size - kHeaderSize) / 16)
    throw std::runtime_error("corrupt line file (short payload)");
  std::vector<float> out(n * 4);
  std::memcpy(out.data(), body + kHeaderSize, n * 16);
  return out;
}

std::vector<float> read_lines(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open file: " + path);
  const std::string raw((std::istreambuf_iterator<char>(f)),
                        std::istreambuf_iterator<char>());
  return parse_lines(reinterpret_cast<const unsigned char*>(raw.data()),
                     raw.size());
}

// A malloc'd copy of v (never null), for the caller to free.
template <typename T>
T* handed_back(const std::vector<T>& v) {
  T* p = static_cast<T*>(std::malloc(std::max<size_t>(1, v.size() * sizeof(T))));
  if (!p) throw std::bad_alloc();
  if (!v.empty()) std::memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

}  // namespace

extern "C" {

void fdcm_native_free(void* p) { std::free(p); }

// data: a whole line file.  *out: n * 4 floats.
int fdcm_native_loads(const unsigned char* data, uint64_t size, float** out,
                      uint64_t* n, char* err, int errlen) {
  try {
    const std::vector<float> lines = parse_lines(data, size);
    *out = handed_back(lines);
    *n = lines.size() / 4;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// lines: n * 4 floats.  yday, year: the header's date fields.
int fdcm_native_dumps(const float* lines, uint64_t n, int compress, int yday,
                      int year, unsigned char** out, uint64_t* out_size,
                      char* err, int errlen) {
  try {
    const std::string blob =
        envelope(serialize_body(lines, n, static_cast<uint16_t>(yday),
                                static_cast<uint16_t>(year)),
                 compress != 0);
    *out = handed_back(std::vector<unsigned char>(blob.begin(), blob.end()));
    *out_size = blob.size();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

int fdcm_native_read_file(const char* path, float** out, uint64_t* n, char* err,
                          int errlen) {
  try {
    const std::vector<float> lines = read_lines(path);
    *out = handed_back(lines);
    *n = lines.size() / 4;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string(path) + ": " + e.what());
    return 1;
  }
}

// Reads n_files files on num_threads threads (0: one per core), each thread
// taking the next unread file.  outs[i], counts[i]: file i's records and
// line count.  On a failure nothing is handed back and err names the first
// failed file in order.
int fdcm_native_read_batch(const char* const* paths, int64_t n_files,
                           int num_threads, float** outs, uint64_t* counts,
                           char* err, int errlen) {
  std::vector<std::vector<float>> lines(n_files);
  std::vector<std::string> errors(n_files);
  if (num_threads <= 0)
    num_threads = static_cast<int>(std::max(1u, std::thread::hardware_concurrency()));
  const int64_t workers = std::max<int64_t>(1, std::min<int64_t>(num_threads, n_files));
  std::atomic<int64_t> next{0};
  auto work = [&]() {
    for (int64_t i = next.fetch_add(1); i < n_files; i = next.fetch_add(1)) {
      try {
        lines[i] = read_lines(paths[i]);
      } catch (const std::exception& e) {
        errors[i] = std::string(paths[i]) + ": " + e.what();
      }
    }
  };
  try {
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < workers; ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("read_batch: ") + e.what());
    return 1;
  }
  for (int64_t i = 0; i < n_files; ++i) {
    if (!errors[i].empty()) {
      set_error(err, errlen, errors[i]);
      return 1;
    }
  }
  int64_t done = 0;
  try {
    for (; done < n_files; ++done) {
      outs[done] = handed_back(lines[done]);
      counts[done] = lines[done].size() / 4;
    }
  } catch (const std::exception& e) {
    for (int64_t i = 0; i < done; ++i) std::free(outs[i]);
    set_error(err, errlen, std::string("read_batch: ") + e.what());
    return 1;
  }
  return 0;
}

// DefaultSearch pairs of one template against one scene by line length:
// the max_tmpl longest template lines (stable, descending), each with the
// max_scene scene lines around its closest length in the stable descending
// scene order (the reference's binarySearch, core/math.h:137-146: the first
// length <= value, or its predecessor when that is strictly closer).
// *out: n_pairs (template line, position in the caller's scene order) int32
// pairs.
int fdcm_native_default_search_pairs(const float* tl, int64_t nt,
                                     const float* sl, int64_t ns,
                                     int64_t max_tmpl, int64_t max_scene,
                                     int32_t** out, int64_t* n_pairs, char* err,
                                     int errlen) {
  try {
    std::vector<int64_t> order_t(nt), order_s(ns);
    std::iota(order_t.begin(), order_t.end(), 0);
    std::iota(order_s.begin(), order_s.end(), 0);
    std::stable_sort(order_t.begin(), order_t.end(),
                     [&](int64_t a, int64_t b) { return tl[a] > tl[b]; });
    std::stable_sort(order_s.begin(), order_s.end(),
                     [&](int64_t a, int64_t b) { return sl[a] > sl[b]; });
    std::vector<float> sorted_s(ns);
    for (int64_t i = 0; i < ns; ++i) sorted_s[i] = sl[order_s[i]];

    std::vector<int32_t> pairs;
    const int64_t t_count = std::min(nt, max_tmpl);
    for (int64_t ti = 0; ti < t_count; ++ti) {
      const int64_t t = order_t[ti];
      const float value = tl[t];
      int64_t lo = 0, hi = ns;  // first index with sorted_s <= value
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (sorted_s[mid] > value) lo = mid + 1; else hi = mid;
      }
      int64_t c;
      if (lo == 0) c = 0;
      else if (lo == ns) c = ns - 1;
      else c = std::fabs(value - sorted_s[lo]) < std::fabs(value - sorted_s[lo - 1])
                   ? lo : lo - 1;
      int64_t begin = std::max<int64_t>(0, c - max_scene / 2);
      const int64_t end = std::min(begin + max_scene, ns);
      begin = std::max<int64_t>(0, end - max_scene);
      for (int64_t i = begin; i < end; ++i) {
        pairs.push_back(static_cast<int32_t>(t));
        pairs.push_back(static_cast<int32_t>(order_s[i]));
      }
    }
    *out = handed_back(pairs);
    *n_pairs = static_cast<int64_t>(pairs.size() / 2);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("default_search_pairs: ") + e.what());
    return 1;
  }
}

}  // extern "C"
