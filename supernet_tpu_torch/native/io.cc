// Native data-pipeline runtime: threaded shard streaming + batch assembly.
//
// The reference feeds training through tf.data's C++ runtime
// (interleave/shuffle/batch/prefetch(AUTOTUNE), Brats.py:538-555); its
// pickle decode, however, bounces through a tf.py_function into the Python
// interpreter for every shard (Brats_functions.py:549-562). This library is
// the framework's native equivalent: shards are .npy pairs (x: float32
// [N,H,W,C], y: int32 [N,H,W]) read and assembled into fixed-size batches by
// a background thread, with a bounded prefetch queue and a sample-level
// shuffle buffer (default 1000, matching Brats.py:549). Python talks to it
// through a minimal ctypes C ABI (supernet_tpu/native/__init__.py); batches
// land in caller-provided pinned buffers ready for jax.device_put.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread io.cc -o libsupernet_io.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- npy I/O

struct NpyArray {
  std::vector<int64_t> shape;
  std::string dtype;  // "<f4" or "<i4"
  std::vector<char> data;
};

bool parse_npy_header(FILE* f, NpyArray* out) {
  char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t len16;
    if (fread(&len16, 2, 1, f) != 1) return false;
    header_len = len16;
  } else {
    if (fread(&header_len, 4, 1, f) != 1) return false;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  auto find_val = [&](const std::string& key) -> std::string {
    size_t p = header.find("'" + key + "'");
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    return header.substr(p + 1);
  };
  std::string descr = find_val("descr");
  size_t q1 = descr.find('\'');
  size_t q2 = descr.find('\'', q1 + 1);
  out->dtype = descr.substr(q1 + 1, q2 - q1 - 1);
  if (find_val("fortran_order").find("True") != std::string::npos) return false;

  std::string shp = find_val("shape");
  size_t lp = shp.find('('), rp = shp.find(')');
  std::string dims = shp.substr(lp + 1, rp - lp - 1);
  out->shape.clear();
  const char* s = dims.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    out->shape.push_back(strtoll(s, const_cast<char**>(&s), 10));
  }
  return true;
}

bool load_npy(const std::string& path, NpyArray* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  if (!parse_npy_header(f, out)) {
    fclose(f);
    return false;
  }
  int64_t n = 1;
  for (int64_t d : out->shape) n *= d;
  int itemsize = (out->dtype == "<f4" || out->dtype == "<i4") ? 4 : 0;
  if (!itemsize) {
    fclose(f);
    return false;
  }
  out->data.resize(n * itemsize);
  bool ok = fread(out->data.data(), 1, out->data.size(), f) ==
            out->data.size();
  fclose(f);
  return ok;
}

// ------------------------------------------------------------------ loader

struct Batch {
  std::vector<float> x;
  std::vector<int32_t> y;
};

struct Loader {
  std::vector<std::string> x_files, y_files;
  int batch_size = 0;
  int shuffle_buffer = 1000;
  bool shuffle = true;
  bool drop_remainder = true;
  int prefetch_depth = 4;

  // per-sample element counts (from the first shard header)
  int64_t x_elems = 0, y_elems = 0;
  std::vector<int64_t> x_shape, y_shape;  // per-sample shapes

  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<std::unique_ptr<Batch>> queue;
  bool epoch_done = true;
  std::atomic<bool> stop{false};
  std::thread worker;
  std::string error;

  ~Loader() {
    stop.store(true);
    cv_put.notify_all();
    cv_get.notify_all();
    if (worker.joinable()) worker.join();
  }

  void fail(const std::string& msg) {
    std::lock_guard<std::mutex> l(mu);
    error = msg;
    epoch_done = true;
    cv_get.notify_all();
  }

  void push(std::unique_ptr<Batch> b) {
    std::unique_lock<std::mutex> l(mu);
    cv_put.wait(l, [&] {
      return stop.load() || (int)queue.size() < prefetch_depth;
    });
    if (stop.load()) return;
    queue.push_back(std::move(b));
    cv_get.notify_one();
  }

  void run_epoch(uint64_t seed) {
    std::mt19937_64 rng(seed);
    std::vector<size_t> order(x_files.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = i;
    if (shuffle) std::shuffle(order.begin(), order.end(), rng);

    // sample shuffle buffer: pairs of flat sample payloads
    std::vector<std::pair<std::vector<float>, std::vector<int32_t>>> buf;
    buf.reserve(shuffle_buffer);
    auto batch = std::make_unique<Batch>();
    batch->x.reserve(batch_size * x_elems);
    batch->y.reserve(batch_size * y_elems);
    int in_batch = 0;

    auto emit = [&](const float* xs, const int32_t* ys) {
      batch->x.insert(batch->x.end(), xs, xs + x_elems);
      batch->y.insert(batch->y.end(), ys, ys + y_elems);
      if (++in_batch == batch_size) {
        push(std::move(batch));
        batch = std::make_unique<Batch>();
        batch->x.reserve(batch_size * x_elems);
        batch->y.reserve(batch_size * y_elems);
        in_batch = 0;
      }
    };
    auto drain_one = [&](size_t k) {
      auto& s = buf[k];
      emit(s.first.data(), s.second.data());
      if (k != buf.size() - 1) buf[k] = std::move(buf.back());
      buf.pop_back();
    };

    for (size_t fi : order) {
      if (stop.load()) return;
      NpyArray xa, ya;
      if (!load_npy(x_files[fi], &xa) || xa.dtype != "<f4") {
        fail("bad x shard: " + x_files[fi]);
        return;
      }
      if (!load_npy(y_files[fi], &ya) || ya.dtype != "<i4") {
        fail("bad y shard: " + y_files[fi]);
        return;
      }
      int64_t n = xa.shape.empty() ? 0 : xa.shape[0];
      const float* xp = reinterpret_cast<const float*>(xa.data.data());
      const int32_t* yp = reinterpret_cast<const int32_t*>(ya.data.data());
      for (int64_t i = 0; i < n && !stop.load(); i++) {
        const float* xs = xp + i * x_elems;
        const int32_t* ys = yp + i * y_elems;
        if (!shuffle) {
          emit(xs, ys);
          continue;
        }
        buf.emplace_back(std::vector<float>(xs, xs + x_elems),
                         std::vector<int32_t>(ys, ys + y_elems));
        if ((int)buf.size() >= shuffle_buffer) {
          drain_one(rng() % buf.size());
        }
      }
    }
    while (!buf.empty() && !stop.load()) drain_one(rng() % buf.size());
    if (!drop_remainder && in_batch > 0 && !stop.load()) {
      push(std::move(batch));
    }
    std::lock_guard<std::mutex> l(mu);
    epoch_done = true;
    cv_get.notify_all();
  }
};

}  // namespace

extern "C" {

// files: n pairs "x_path\ny_path" joined by '\x1f' separators.
void* sn_open(const char* file_list, int batch_size, int shuffle_buffer,
              int shuffle, int drop_remainder, int prefetch_depth) {
  auto* L = new Loader();
  L->batch_size = batch_size;
  L->shuffle_buffer = shuffle_buffer > 0 ? shuffle_buffer : 1;
  L->shuffle = shuffle != 0;
  L->drop_remainder = drop_remainder != 0;
  L->prefetch_depth = prefetch_depth > 0 ? prefetch_depth : 2;

  std::string all(file_list);
  size_t pos = 0;
  std::vector<std::string> parts;
  while (pos <= all.size()) {
    size_t nxt = all.find('\x1f', pos);
    if (nxt == std::string::npos) nxt = all.size();
    if (nxt > pos) parts.push_back(all.substr(pos, nxt - pos));
    pos = nxt + 1;
  }
  if (parts.empty() || parts.size() % 2 != 0) {
    delete L;
    return nullptr;
  }
  for (size_t i = 0; i < parts.size(); i += 2) {
    L->x_files.push_back(parts[i]);
    L->y_files.push_back(parts[i + 1]);
  }

  // probe shapes from the first shard headers
  FILE* fx = fopen(L->x_files[0].c_str(), "rb");
  FILE* fy = fopen(L->y_files[0].c_str(), "rb");
  NpyArray hx, hy;
  bool ok = fx && fy && parse_npy_header(fx, &hx) &&
            parse_npy_header(fy, &hy) && hx.shape.size() >= 2 &&
            hy.shape.size() >= 2;
  if (fx) fclose(fx);
  if (fy) fclose(fy);
  if (!ok) {
    delete L;
    return nullptr;
  }
  L->x_shape.assign(hx.shape.begin() + 1, hx.shape.end());
  L->y_shape.assign(hy.shape.begin() + 1, hy.shape.end());
  L->x_elems = 1;
  for (int64_t d : L->x_shape) L->x_elems *= d;
  L->y_elems = 1;
  for (int64_t d : L->y_shape) L->y_elems *= d;
  return L;
}

// dims_out must hold 16 int64s: [x_rank, x_dims..., y_rank, y_dims...]
void sn_shapes(void* h, int64_t* dims_out) {
  auto* L = static_cast<Loader*>(h);
  int64_t* p = dims_out;
  *p++ = (int64_t)L->x_shape.size();
  for (int64_t d : L->x_shape) *p++ = d;
  *p++ = (int64_t)L->y_shape.size();
  for (int64_t d : L->y_shape) *p++ = d;
}

void sn_start_epoch(void* h, uint64_t seed) {
  auto* L = static_cast<Loader*>(h);
  // The previous epoch's worker may still be alive and blocked in push()
  // if the consumer abandoned iteration mid-epoch (e.g. an early break):
  // tell it to stop before joining, else this join deadlocks.
  if (L->worker.joinable()) {
    L->stop.store(true);
    L->cv_put.notify_all();
    L->cv_get.notify_all();
    L->worker.join();
    L->stop.store(false);
  }
  {
    std::lock_guard<std::mutex> l(L->mu);
    L->queue.clear();
    L->epoch_done = false;
    L->error.clear();
  }
  L->worker = std::thread([L, seed] { L->run_epoch(seed); });
}

// Returns the number of samples in the batch (0 = epoch exhausted,
// -1 = error). x_out/y_out must hold batch_size * elems values.
int sn_next(void* h, float* x_out, int32_t* y_out) {
  auto* L = static_cast<Loader*>(h);
  std::unique_ptr<Batch> b;
  {
    std::unique_lock<std::mutex> l(L->mu);
    L->cv_get.wait(l, [&] {
      return L->stop.load() || !L->queue.empty() || L->epoch_done;
    });
    if (!L->error.empty()) return -1;
    if (L->queue.empty()) return 0;
    b = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_put.notify_one();
  }
  memcpy(x_out, b->x.data(), b->x.size() * sizeof(float));
  memcpy(y_out, b->y.data(), b->y.size() * sizeof(int32_t));
  return (int)(b->y.size() / L->y_elems);
}

const char* sn_error(void* h) {
  auto* L = static_cast<Loader*>(h);
  return L->error.c_str();
}

void sn_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
