// Host-side prefetch ring for the data pipeline (the PyTorch port's copy of
// the JAX package's native/prefetch.cpp, same C ABI and behaviour).
//
// A fixed-capacity ring buffer and a pool of worker threads that run opaque
// producer jobs (a Python dataset's __getitem__, through a ctypes callback)
// ahead of the consumer, bounded by the capacity: the role torch
// DataLoader workers play for the reference, which ships num_workers=0.
//
// Exposed as a C ABI for ctypes. Payloads are integer tokens into a
// registry on the Python side, so no Python object crosses the ABI: the
// producer callback runs with the GIL (ctypes takes it around the
// callback), the hand-off and the back-pressure waits run without it.
//
// Built at first use by audio_motion_avatar_tpu_torch/data/prefetch.py
// (g++ -O2 -fPIC -shared -std=c++17 -pthread) into build/host/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

typedef uint64_t (*producer_fn)(uint64_t index, void* ctx);

struct Ring {
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  std::deque<std::pair<uint64_t, uint64_t>> items;  // (index, token)
  size_t capacity = 0;
  uint64_t next_index = 0;       // next index to hand to a worker
  uint64_t total = 0;            // number of items to produce
  std::atomic<uint64_t> produced{0};
  std::atomic<bool> stop{false};
  producer_fn producer = nullptr;
  void* ctx = nullptr;
  std::vector<std::thread> workers;
};

static void worker_loop(Ring* r) {
  for (;;) {
    uint64_t idx;
    {
      std::unique_lock<std::mutex> lk(r->mu);
      if (r->stop.load() || r->next_index >= r->total) return;
      idx = r->next_index++;
      // back-pressure: wait until there is room for our future item
      r->not_full.wait(lk, [&] {
        return r->stop.load() || r->items.size() < r->capacity;
      });
      if (r->stop.load()) return;
    }
    // produce OUTSIDE the lock (the callback re-acquires the GIL itself)
    uint64_t token = r->producer(idx, r->ctx);
    {
      std::lock_guard<std::mutex> lk(r->mu);
      if (r->stop.load()) return;
      r->items.emplace_back(idx, token);
      r->produced.fetch_add(1);
    }
    r->not_empty.notify_one();
  }
}

Ring* ring_create(uint64_t total, uint64_t capacity, uint64_t num_workers,
                  producer_fn producer, void* ctx) {
  Ring* r = new Ring();
  r->capacity = capacity;
  r->total = total;
  r->producer = producer;
  r->ctx = ctx;
  for (uint64_t i = 0; i < num_workers; ++i) {
    r->workers.emplace_back(worker_loop, r);
  }
  return r;
}

// Blocks until an item is available (any order); returns token, sets *index.
// Returns UINT64_MAX when the ring is exhausted or stopped.
uint64_t ring_pop(Ring* r, uint64_t* index) {
  std::unique_lock<std::mutex> lk(r->mu);
  r->not_empty.wait(lk, [&] {
    return r->stop.load() || !r->items.empty() ||
           (r->produced.load() >= r->total && r->items.empty());
  });
  if (r->items.empty()) {
    *index = UINT64_MAX;
    return UINT64_MAX;
  }
  auto item = r->items.front();
  r->items.pop_front();
  r->not_full.notify_one();
  *index = item.first;
  return item.second;
}

void ring_stop(Ring* r) {
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop.store(true);
  }
  r->not_empty.notify_all();
  r->not_full.notify_all();
}

void ring_destroy(Ring* r) {
  ring_stop(r);
  for (auto& t : r->workers) {
    if (t.joinable()) t.join();
  }
  delete r;
}

uint64_t ring_size(Ring* r) {
  std::lock_guard<std::mutex> lk(r->mu);
  return r->items.size();
}

}  // extern "C"
