// Native batch-gather engine for paddle_tpu.io.DataLoader.
//
// Reference analog: the C++ data plane of paddle/fluid/framework/data_feed.cc
// and the DataLoader worker pool — the host-side hot loop of training input
// pipelines. Here the engine owns a pool of pthreads that gather rows of a
// caller-held contiguous array into double-buffered batch buffers ahead of
// consumption, delivering batches strictly in submission order.
//
// Contract (all functions thread-safe w.r.t. one engine):
//   pt_dl_create(data, n_rows, row_bytes, n_threads, depth) -> handle
//       `data` must stay valid until pt_dl_destroy (Python holds the array).
//       depth bounds in-flight + finished-but-unconsumed batches (memory cap).
//   pt_dl_submit(h, idx, n)   enqueue one batch (row indices); returns 0, or
//                             -1 after close / bad index.
//   pt_dl_acquire(h, &ptr)    block until the NEXT batch (submission order) is
//                             ready; returns its row count, ptr to its bytes.
//                             Returns -1 once closed and fully drained.
//                             The pointer stays valid until the following
//                             acquire (one-slot consumer ownership).
//   pt_dl_release(h)          optional early recycle of the acquired buffer.
//   pt_dl_close(h)            no more submissions; workers drain then exit.
//   pt_dl_destroy(h)          join threads, free everything.
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Job {
  int64_t seq;
  std::vector<int64_t> idx;
};

struct Engine {
  const uint8_t* data = nullptr;
  int64_t n_rows = 0;
  int64_t row_bytes = 0;
  int depth = 2;

  std::mutex m;
  std::condition_variable cv_worker;    // jobs available / room to work
  std::condition_variable cv_consumer;  // finished batch available
  std::deque<Job> jobs;
  std::map<int64_t, std::pair<std::vector<uint8_t>, int64_t>> done;  // seq -> (buf, rows)
  int64_t next_submit = 0;
  int64_t next_deliver = 0;
  int64_t in_flight = 0;
  bool closed = false;
  bool dead = false;
  std::vector<uint8_t> current;  // consumer-owned slot
  std::vector<std::thread> threads;
};

void worker_main(Engine* e) {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(e->m);
      e->cv_worker.wait(lk, [e] {
        // bound finished-but-unconsumed memory: only start a job when its
        // result will be within `depth` of the consumer's cursor
        return e->dead ||
               (!e->jobs.empty() &&
                e->jobs.front().seq < e->next_deliver + e->depth);
      });
      if (e->dead) return;
      if (e->jobs.empty() ||
          e->jobs.front().seq >= e->next_deliver + e->depth)
        continue;
      job = std::move(e->jobs.front());
      e->jobs.pop_front();
      e->in_flight++;
    }
    std::vector<uint8_t> buf(job.idx.size() * e->row_bytes);
    for (size_t r = 0; r < job.idx.size(); ++r) {
      std::memcpy(buf.data() + r * e->row_bytes,
                  e->data + job.idx[r] * e->row_bytes,
                  static_cast<size_t>(e->row_bytes));
    }
    {
      std::unique_lock<std::mutex> lk(e->m);
      e->done.emplace(job.seq,
                      std::make_pair(std::move(buf),
                                     static_cast<int64_t>(job.idx.size())));
      e->in_flight--;
      e->cv_consumer.notify_all();
    }
  }
}

}  // namespace

extern "C" {

void* pt_dl_create(const void* data, int64_t n_rows, int64_t row_bytes,
                   int n_threads, int depth) {
  if (data == nullptr || n_rows < 0 || row_bytes <= 0) return nullptr;
  Engine* e = new Engine();
  e->data = static_cast<const uint8_t*>(data);
  e->n_rows = n_rows;
  e->row_bytes = row_bytes;
  e->depth = depth < 1 ? 1 : depth;
  int t = n_threads < 1 ? 1 : (n_threads > 64 ? 64 : n_threads);
  e->threads.reserve(t);
  for (int i = 0; i < t; ++i) e->threads.emplace_back(worker_main, e);
  return e;
}

int pt_dl_submit(void* h, const int64_t* idx, int64_t n) {
  Engine* e = static_cast<Engine*>(h);
  if (e == nullptr || n < 0) return -1;
  Job job;
  job.idx.assign(idx, idx + n);
  for (int64_t i = 0; i < n; ++i)
    if (idx[i] < 0 || idx[i] >= e->n_rows) return -1;
  std::unique_lock<std::mutex> lk(e->m);
  if (e->closed || e->dead) return -1;
  job.seq = e->next_submit++;
  e->jobs.push_back(std::move(job));
  e->cv_worker.notify_all();
  return 0;
}

int64_t pt_dl_acquire(void* h, const void** out_ptr) {
  Engine* e = static_cast<Engine*>(h);
  *out_ptr = nullptr;
  std::unique_lock<std::mutex> lk(e->m);
  // recycle the previous slot and wake workers whose depth window moved
  e->current.clear();
  e->current.shrink_to_fit();
  for (;;) {
    auto it = e->done.find(e->next_deliver);
    if (it != e->done.end()) {
      e->current = std::move(it->second.first);
      int64_t rows = it->second.second;
      e->done.erase(it);
      e->next_deliver++;
      e->cv_worker.notify_all();
      *out_ptr = e->current.data();
      return rows;
    }
    bool drained = e->closed && e->jobs.empty() && e->in_flight == 0 &&
                   e->done.empty();
    if (drained || e->dead) return -1;
    e->cv_consumer.wait(lk);
  }
}

void pt_dl_release(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::unique_lock<std::mutex> lk(e->m);
  e->current.clear();
  e->current.shrink_to_fit();
}

void pt_dl_close(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::unique_lock<std::mutex> lk(e->m);
  e->closed = true;
  e->cv_worker.notify_all();
  e->cv_consumer.notify_all();
}

void pt_dl_destroy(void* h) {
  Engine* e = static_cast<Engine*>(h);
  {
    std::unique_lock<std::mutex> lk(e->m);
    e->dead = true;
    e->cv_worker.notify_all();
    e->cv_consumer.notify_all();
  }
  for (auto& t : e->threads) t.join();
  delete e;
}

}  // extern "C"
