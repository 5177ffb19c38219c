// Native packed-dataset loader.
//
// The data-plane runtime component: multi-threaded prefetching reader for
// LITPKDS chunk files (fastmax_tpu_torch/data/packed_dataset.py documents the
// format). Replaces the role of torch DataLoader worker processes in the
// reference's input pipeline (lit_gpt/packed_dataset.py consumed through
// torch IterableDataset workers) with an in-process C++ thread pool:
// chunks are mmap'd, block order is shuffled per epoch with a
// SplitMix64-seeded LCG, and decoded int32 blocks are staged in a bounded
// ring buffer so tokenization-side stalls never block the training step.
//
// C ABI (consumed by ctypes in fastmax_tpu_torch/native/loader.py):
//   void* pl_open(const char** files, int n_files, long block_size,
//                 long n_prefetch, unsigned long seed, int shuffle, int wrap);
//   long  pl_next(void* handle, int* out /* block_size ints */);
//   void  pl_close(void* handle);
//
// Built at first use by fastmax_tpu_torch/native/loader.py (g++ -O3 -shared -fPIC)
// into fastmax_tpu_torch/_build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[] = "LITPKDS";
constexpr size_t kHeaderSize = 24;

struct Chunk {
  void* map = nullptr;
  size_t bytes = 0;
  const uint8_t* data = nullptr;  // past header
  int dtype_code = 0;
  int64_t n_tokens = 0;
};

int dtype_size(int code) {
  switch (code) {
    case 1: case 2: return 1;   // uint8 / int8
    case 3: case 8: return 2;   // int16 / uint16
    case 4: case 6: return 4;   // int32 / float32
    case 5: case 7: return 8;   // int64 / float64
  }
  return 0;
}

uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

struct Loader {
  std::vector<std::string> files;
  int64_t block_size;
  uint64_t seed;
  bool shuffle;
  bool wrap;

  std::deque<std::vector<int32_t>> ring;
  size_t ring_cap;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  std::atomic<bool> done{false}, stop{false};
  std::thread worker;

  ~Loader() {
    stop = true;
    not_full.notify_all();
    not_empty.notify_all();
    if (worker.joinable()) worker.join();
  }

  bool open_chunk(const std::string& path, Chunk& c) {
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || (size_t)st.st_size <= kHeaderSize) {
      ::close(fd);
      return false;
    }
    void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) return false;
    const uint8_t* p = static_cast<const uint8_t*>(m);
    if (memcmp(p, kMagic, 7) != 0) {
      munmap(m, st.st_size);
      return false;
    }
    c.map = m;
    c.bytes = st.st_size;
    c.dtype_code = p[15];
    int esize = dtype_size(c.dtype_code);
    if (esize == 0) {
      munmap(m, st.st_size);
      return false;
    }
    c.data = p + kHeaderSize;
    c.n_tokens = (st.st_size - kHeaderSize) / esize;
    return true;
  }

  void decode_block(const Chunk& c, int64_t offset, int32_t* out) {
    int esize = dtype_size(c.dtype_code);
    const uint8_t* src = c.data + offset * esize;
    switch (c.dtype_code) {
      case 1:
        for (int64_t i = 0; i < block_size; ++i) out[i] = src[i];
        break;
      case 2: {
        const int8_t* s = reinterpret_cast<const int8_t*>(src);
        for (int64_t i = 0; i < block_size; ++i) out[i] = s[i];
        break;
      }
      case 8: {
        const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
        for (int64_t i = 0; i < block_size; ++i) out[i] = s[i];
        break;
      }
      case 4: {
        memcpy(out, src, block_size * sizeof(int32_t));
        break;
      }
      case 3: {
        const int16_t* s = reinterpret_cast<const int16_t*>(src);
        for (int64_t i = 0; i < block_size; ++i) out[i] = s[i];
        break;
      }
      case 5: {
        const int64_t* s = reinterpret_cast<const int64_t*>(src);
        for (int64_t i = 0; i < block_size; ++i) out[i] = (int32_t)s[i];
        break;
      }
      default:
        memset(out, 0, block_size * sizeof(int32_t));
    }
  }

  void run() {
    uint64_t rng = seed;
    do {
      for (size_t fi = 0; fi < files.size() && !stop; ++fi) {
        Chunk c;
        if (!open_chunk(files[fi], c)) continue;
        int64_t n_blocks = c.n_tokens / block_size;
        std::vector<int64_t> order(n_blocks);
        for (int64_t i = 0; i < n_blocks; ++i) order[i] = i;
        if (shuffle) {
          for (int64_t i = n_blocks - 1; i > 0; --i) {
            int64_t j = (int64_t)(splitmix64(rng) % (uint64_t)(i + 1));
            std::swap(order[i], order[j]);
          }
        }
        for (int64_t b = 0; b < n_blocks && !stop; ++b) {
          std::vector<int32_t> block(block_size);
          decode_block(c, order[b] * block_size, block.data());
          std::unique_lock<std::mutex> lk(mu);
          not_full.wait(lk, [&] { return ring.size() < ring_cap || stop; });
          if (stop) break;
          ring.push_back(std::move(block));
          not_empty.notify_one();
        }
        munmap(c.map, c.bytes);
      }
    } while (wrap && !stop);
    done = true;
    not_empty.notify_all();
  }
};

}  // namespace

extern "C" {

void* pl_open(const char** files, int n_files, long block_size,
              long n_prefetch, unsigned long seed, int shuffle, int wrap) {
  auto* l = new Loader();
  for (int i = 0; i < n_files; ++i) l->files.emplace_back(files[i]);
  l->block_size = block_size;
  l->ring_cap = n_prefetch > 0 ? (size_t)n_prefetch : 8;
  l->seed = seed ? seed : 0x1234abcdULL;
  l->shuffle = shuffle != 0;
  l->wrap = wrap != 0;
  l->worker = std::thread([l] { l->run(); });
  return l;
}

long pl_next(void* handle, int32_t* out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->not_empty.wait(lk, [&] { return !l->ring.empty() || l->done || l->stop; });
  if (l->ring.empty()) return 0;  // exhausted (no wrap)
  std::vector<int32_t> block = std::move(l->ring.front());
  l->ring.pop_front();
  l->not_full.notify_one();
  lk.unlock();
  memcpy(out, block.data(), block.size() * sizeof(int32_t));
  return (long)block.size();
}

void pl_close(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
