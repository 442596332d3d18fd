// Native batch-staging core: threaded gather/assemble with a reusable
// buffer arena, delivered in deterministic submission order.
//
// The PyTorch port's copy of the JAX package's stager: the equivalent of
// the reference's tf.data C++ runtime hot path
// (dataset kernels behind `tensorflow/python/data`, SURVEY.md §2.3 "tf.data
// runtime" row): the per-step work of turning a shuffled index list into a
// contiguous batch buffer is parallel memcpy that must not hold the Python
// GIL. Python submits index arrays; worker threads gather records from an
// in-memory source into pooled buffers; the consumer blocks on the next
// batch *in submission order* (determinism contract — multi-host SPMD
// requires every process to see identical batch streams).
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

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
  uint64_t seq;
  std::vector<uint64_t> indices;
};

class Stager {
 public:
  Stager(const uint8_t* source, uint64_t num_records, uint64_t record_bytes,
         uint64_t batch_size, int num_threads, int pool_size)
      : source_(source),
        num_records_(num_records),
        record_bytes_(record_bytes),
        batch_size_(batch_size),
        batch_bytes_(record_bytes * batch_size) {
    if (pool_size < 2) pool_size = 2;
    arena_.resize(static_cast<size_t>(pool_size) * batch_bytes_);
    for (int i = 0; i < pool_size; ++i)
      free_bufs_.push_back(arena_.data() + static_cast<size_t>(i) * batch_bytes_);
    if (num_threads < 1) num_threads = 1;
    for (int i = 0; i < num_threads; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Stager() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      closed_ = true;
    }
    cv_work_.notify_all();
    cv_done_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Returns 0 on success, -1 if out-of-range index or closed.
  int Submit(const uint64_t* indices) {
    std::lock_guard<std::mutex> lk(mu_);
    if (closed_) return -1;
    // Validate before claiming a sequence number: a rejected submit must
    // not leave a gap Acquire would wait on forever.
    for (uint64_t r = 0; r < batch_size_; ++r)
      if (indices[r] >= num_records_) return -1;
    Job j;
    j.seq = next_seq_++;
    j.indices.assign(indices, indices + batch_size_);
    jobs_.push_back(std::move(j));
    cv_work_.notify_one();
    return 0;
  }

  // Blocks until the next batch (submission order) is assembled; returns
  // the buffer pointer, or nullptr if closed with no pending work.
  uint8_t* Acquire() {
    std::unique_lock<std::mutex> lk(mu_);
    uint64_t want = next_deliver_;
    cv_done_.wait(lk, [&] {
      return done_.count(want) > 0 || (closed_ && done_.count(want) == 0 &&
                                       jobs_.empty() && in_flight_ == 0);
    });
    auto it = done_.find(want);
    if (it == done_.end()) return nullptr;
    uint8_t* buf = it->second;
    done_.erase(it);
    ++next_deliver_;
    return buf;
  }

  // Returns a buffer to the pool once the consumer is finished with it.
  void Release(uint8_t* buf) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      free_bufs_.push_back(buf);
    }
    cv_work_.notify_one();
  }

  uint64_t batch_bytes() const { return batch_bytes_; }

 private:
  void WorkerLoop() {
    for (;;) {
      Job job;
      uint8_t* buf = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        // A job is claimed only together with a buffer, so jobs acquire
        // buffers in seq order — otherwise later-seq jobs could absorb
        // the whole pool while the next-to-deliver job starves and the
        // consumer (who would Release) blocks in Acquire: deadlock.
        cv_work_.wait(lk, [&] {
          return closed_ || (!jobs_.empty() && !free_bufs_.empty());
        });
        if (jobs_.empty() || free_bufs_.empty()) return;  // closing
        job = std::move(jobs_.front());
        jobs_.pop_front();
        buf = free_bufs_.back();
        free_bufs_.pop_back();
        ++in_flight_;
      }
      // The gather itself: GIL-free parallel memcpy.
      for (uint64_t r = 0; r < batch_size_; ++r) {
        std::memcpy(buf + r * record_bytes_,
                    source_ + job.indices[r] * record_bytes_, record_bytes_);
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[job.seq] = buf;
        --in_flight_;
      }
      cv_done_.notify_all();
    }
  }

  const uint8_t* source_;
  const uint64_t num_records_, record_bytes_, batch_size_, batch_bytes_;
  std::vector<uint8_t> arena_;
  std::vector<uint8_t*> free_bufs_;
  std::deque<Job> jobs_;
  std::map<uint64_t, uint8_t*> done_;
  uint64_t next_seq_ = 0, next_deliver_ = 0;
  int in_flight_ = 0;
  bool closed_ = false;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* ttd_stager_create(const uint8_t* source, uint64_t num_records,
                        uint64_t record_bytes, uint64_t batch_size,
                        int num_threads, int pool_size) {
  return new Stager(source, num_records, record_bytes, batch_size,
                    num_threads, pool_size);
}

int ttd_stager_submit(void* s, const uint64_t* indices) {
  return static_cast<Stager*>(s)->Submit(indices);
}

uint8_t* ttd_stager_acquire(void* s) {
  return static_cast<Stager*>(s)->Acquire();
}

void ttd_stager_release(void* s, uint8_t* buf) {
  static_cast<Stager*>(s)->Release(buf);
}

uint64_t ttd_stager_batch_bytes(void* s) {
  return static_cast<Stager*>(s)->batch_bytes();
}

void ttd_stager_destroy(void* s) { delete static_cast<Stager*>(s); }

}  // extern "C"
