// Native frame pipeline: async prefetching reader + write-behind writer.
//
// The reference round-trips every frame through cv2.imread/imwrite on the
// main thread (reference: ofgen_keyframe_inpaint.py:417-439,
// ofgen_pixel_inpaint.py:332-356), stalling the accelerator on host IO.
// This C++ runtime keeps a ring of page-aligned buffers, a read-ahead
// thread that streams raw frame blobs from the workspace, and a writer
// thread that retires outputs off the critical path — so device steps
// overlap host IO. Exposed through a plain C ABI for ctypes.
//
// Frame files: <dir>/<index:05d>.raw, H*W*C uint8, row-major.
//
// The JAX package's native/frameloader.cpp with one change: fp_flush
// also waits for the write the writer thread has taken off the queue
// (``writing``), so a frame put before a flush reads back after it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> data;
};

struct Pipe {
  std::string dir;
  int num_frames = 0;
  size_t frame_bytes = 0;
  int prefetch = 8;

  // reader state
  std::map<int, Frame> cache;
  std::deque<int> cache_order;
  std::atomic<int> cursor{0};
  std::mutex mu;
  std::condition_variable cv;

  // writer state
  std::deque<std::pair<int, Frame>> write_queue;
  std::mutex wmu;
  std::condition_variable wcv;
  int writing = 0;  // writes taken off the queue, not yet on disk
  std::atomic<bool> stop{false};
  std::atomic<long> frames_read{0};
  std::atomic<long> frames_written{0};
  std::atomic<long> cache_hits{0};

  std::thread reader;
  std::thread writer;
};

std::string frame_path(const Pipe* p, int idx) {
  char buf[32];
  std::snprintf(buf, sizeof(buf), "/%05d.raw", idx);
  return p->dir + buf;
}

bool read_file(const std::string& path, uint8_t* dst, size_t n) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  size_t got = std::fread(dst, 1, n, f);
  std::fclose(f);
  return got == n;
}

void reader_loop(Pipe* p) {
  while (!p->stop.load()) {
    int base = p->cursor.load();
    int fetched = 0;
    for (int i = base; i < std::min(base + p->prefetch, p->num_frames);
         ++i) {
      {
        std::lock_guard<std::mutex> lk(p->mu);
        if (p->cache.count(i)) continue;
      }
      Frame fr;
      fr.data.resize(p->frame_bytes);
      if (!read_file(frame_path(p, i), fr.data.data(), p->frame_bytes))
        continue;
      {
        std::lock_guard<std::mutex> lk(p->mu);
        p->cache.emplace(i, std::move(fr));
        p->cache_order.push_back(i);
        // bound the cache to 2x the prefetch window
        while ((int)p->cache_order.size() > 2 * p->prefetch) {
          p->cache.erase(p->cache_order.front());
          p->cache_order.pop_front();
        }
      }
      p->frames_read.fetch_add(1);
      ++fetched;
      p->cv.notify_all();
    }
    if (fetched == 0) {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv.wait_for(lk, std::chrono::milliseconds(20));
    }
  }
}

void writer_loop(Pipe* p) {
  for (;;) {
    std::pair<int, Frame> item;
    {
      std::unique_lock<std::mutex> lk(p->wmu);
      p->wcv.wait(lk, [&] {
        return p->stop.load() || !p->write_queue.empty();
      });
      if (p->write_queue.empty()) {
        if (p->stop.load()) return;
        continue;
      }
      item = std::move(p->write_queue.front());
      p->write_queue.pop_front();
      ++p->writing;
    }
    FILE* f = std::fopen(frame_path(p, item.first).c_str(), "wb");
    if (f) {
      std::fwrite(item.second.data.data(), 1, p->frame_bytes, f);
      std::fclose(f);
      p->frames_written.fetch_add(1);
    }
    {
      std::lock_guard<std::mutex> lk(p->wmu);
      --p->writing;
    }
    p->wcv.notify_all();
  }
}

}  // namespace

extern "C" {

void* fp_open(const char* dir, int num_frames, long frame_bytes,
              int prefetch) {
  Pipe* p = new Pipe();
  p->dir = dir;
  p->num_frames = num_frames;
  p->frame_bytes = (size_t)frame_bytes;
  p->prefetch = prefetch > 0 ? prefetch : 8;
  p->reader = std::thread(reader_loop, p);
  p->writer = std::thread(writer_loop, p);
  return p;
}

// Blocking fetch of frame idx into out; returns 0 on success.
int fp_get(void* h, int idx, uint8_t* out) {
  Pipe* p = (Pipe*)h;
  if (idx < 0 || idx >= p->num_frames) return -1;
  p->cursor.store(idx);
  p->cv.notify_all();
  {
    std::unique_lock<std::mutex> lk(p->mu);
    auto it = p->cache.find(idx);
    if (it != p->cache.end()) {
      std::memcpy(out, it->second.data.data(), p->frame_bytes);
      p->cache_hits.fetch_add(1);
      return 0;
    }
  }
  // not prefetched yet: read synchronously (also covers random access)
  return read_file(frame_path(p, idx), out, p->frame_bytes) ? 0 : -2;
}

// Queue an async write of frame idx (copies the buffer).
int fp_put(void* h, int idx, const uint8_t* data) {
  Pipe* p = (Pipe*)h;
  Frame fr;
  fr.data.assign(data, data + p->frame_bytes);
  {
    std::lock_guard<std::mutex> lk(p->wmu);
    p->write_queue.emplace_back(idx, std::move(fr));
  }
  p->wcv.notify_all();
  return 0;
}

// Block until all queued writes are on disk.
void fp_flush(void* h) {
  Pipe* p = (Pipe*)h;
  std::unique_lock<std::mutex> lk(p->wmu);
  p->wcv.wait(lk, [&] {
    return p->write_queue.empty() && p->writing == 0;
  });
}

void fp_stats(void* h, long* reads, long* writes, long* hits) {
  Pipe* p = (Pipe*)h;
  *reads = p->frames_read.load();
  *writes = p->frames_written.load();
  *hits = p->cache_hits.load();
}

void fp_close(void* h) {
  Pipe* p = (Pipe*)h;
  {
    std::lock_guard<std::mutex> lk(p->wmu);
    p->stop.store(true);
  }
  p->cv.notify_all();
  p->wcv.notify_all();
  if (p->reader.joinable()) p->reader.join();
  if (p->writer.joinable()) p->writer.join();
  delete p;
}

// Page-aligned buffer helpers (zero-copy friendly for device_put).
uint8_t* fp_alloc(long nbytes) {
  void* ptr = nullptr;
  if (posix_memalign(&ptr, 4096, (size_t)nbytes) != 0) return nullptr;
  return (uint8_t*)ptr;
}

void fp_free(uint8_t* ptr) { free(ptr); }

}  // extern "C"
