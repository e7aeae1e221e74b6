// Page-cache readahead pool of the port's weight stream (a copy of the JAX
// package's native/fileprefetch.cpp pool).
//
// The loader reads one layer file per shard. While one shard is read, this
// pool asks the kernel to read the next shard's files ahead with
// posix_fadvise(WILLNEED): the readahead runs as DMA into the page cache,
// costs the caller's threads next to nothing, and degrades to a no-op on a
// filesystem that ignores the advice.
//
// A plain C interface for ctypes; built with g++ on first use by
// flexible_llm_sharding_tpu_torch/utils/native.py, which falls back to the
// same fadvise from Python where no compiler exists.

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Pool {
  std::vector<std::thread> workers;
  std::queue<std::string> jobs;
  std::mutex mu;
  std::condition_variable cv;        // workers wait for jobs
  std::condition_variable idle_cv;   // fp_wait_all waits for drain
  size_t inflight = 0;               // queued + running jobs (under mu)
  bool stop = false;

  explicit Pool(int n_threads) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : workers) t.join();
  }

  void submit(std::string path) {
    {
      std::lock_guard<std::mutex> lock(mu);
      jobs.push(std::move(path));
      ++inflight;
    }
    cv.notify_one();
  }

  void wait_all() {
    std::unique_lock<std::mutex> lock(mu);
    idle_cv.wait(lock, [this] { return inflight == 0; });
  }

  void run() {
    for (;;) {
      std::string path;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [this] { return stop || !jobs.empty(); });
        if (stop && jobs.empty()) return;
        path = std::move(jobs.front());
        jobs.pop();
      }
      warm(path.c_str());
      {
        std::lock_guard<std::mutex> lock(mu);
        --inflight;
        if (inflight == 0) idle_cv.notify_all();
      }
    }
  }

  static void warm(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return;  // missing file: loader will raise a real error later
#ifdef POSIX_FADV_WILLNEED
    // Kernel readahead only, no userspace read loop: the copy would take a
    // core from the loader.
    posix_fadvise(fd, 0, 0, POSIX_FADV_WILLNEED);
#endif
    close(fd);
  }
};

}  // namespace

extern "C" {

void* fp_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new Pool(n_threads);
}

void fp_prefetch(void* handle, const char* path) {
  static_cast<Pool*>(handle)->submit(path);
}

void fp_wait_all(void* handle) { static_cast<Pool*>(handle)->wait_all(); }

void fp_destroy(void* handle) { delete static_cast<Pool*>(handle); }

}  // extern "C"
