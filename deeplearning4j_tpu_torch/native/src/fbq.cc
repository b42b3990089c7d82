// FancyBlockingQueue: one logical queue, N registered consumers, every
// consumer sees every message exactly once.
//
// Reference analog: optimize/solvers/accumulation/FancyBlockingQueue.java
// (288 LoC, SURVEY.md §5 race-detection row) — the bespoke concurrency
// structure DL4J uses to fan encoded gradient messages out to all workers.
// Re-implemented natively (pthread mutex/condvar via std::mutex) with an
// int64 token payload; the Python binding maps tokens to objects.

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Fbq {
  std::mutex mu;
  std::condition_variable cv_put;   // signalled when space may be available
  std::condition_variable cv_take;  // signalled when messages arrive
  std::deque<int64_t> buf;          // messages, oldest first
  int64_t head_seq = 0;             // sequence number of buf.front()
  std::vector<int64_t> cursor;      // per-consumer next sequence to read
  size_t capacity;
  bool closed = false;

  explicit Fbq(size_t cap) : capacity(cap) {}

  int64_t min_cursor() const {
    int64_t m = INT64_MAX;
    for (int64_t c : cursor) m = c < m ? c : m;
    return cursor.empty() ? head_seq + (int64_t)buf.size() : m;
  }

  void gc_locked() {
    // drop messages every consumer has read
    int64_t m = min_cursor();
    while (!buf.empty() && head_seq < m) {
      buf.pop_front();
      ++head_seq;
      cv_put.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* dl4j_fbq_create(int64_t capacity) {
  return new Fbq((size_t)(capacity > 0 ? capacity : 1));
}

void dl4j_fbq_destroy(void* h) { delete (Fbq*)h; }

// Register a consumer; returns its id. Consumers registered after messages
// were published only see messages from their registration point on.
int64_t dl4j_fbq_register(void* h) {
  Fbq* q = (Fbq*)h;
  std::lock_guard<std::mutex> lk(q->mu);
  q->cursor.push_back(q->head_seq + (int64_t)q->buf.size());
  return (int64_t)q->cursor.size() - 1;
}

// Blocking put; returns 0 on success, -1 if closed.
int dl4j_fbq_put(void* h, int64_t token, int64_t timeout_ms) {
  Fbq* q = (Fbq*)h;
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [q] { return q->closed || q->buf.size() < q->capacity; };
  if (timeout_ms < 0) {
    q->cv_put.wait(lk, pred);
  } else if (!q->cv_put.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                 pred)) {
    return -2;  // timed out
  }
  if (q->closed) return -1;
  q->buf.push_back(token);
  q->cv_take.notify_all();
  return 0;
}

// Poll next message for `consumer`; returns 0 and writes *out on success,
// -1 if closed and drained, -2 on timeout.
int dl4j_fbq_poll(void* h, int64_t consumer, int64_t timeout_ms,
                  int64_t* out) {
  Fbq* q = (Fbq*)h;
  std::unique_lock<std::mutex> lk(q->mu);
  auto have = [q, consumer] {
    return q->closed ||
           q->cursor[consumer] < q->head_seq + (int64_t)q->buf.size();
  };
  if (timeout_ms < 0) {
    q->cv_take.wait(lk, have);
  } else if (!q->cv_take.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                  have)) {
    return -2;
  }
  int64_t seq = q->cursor[consumer];
  if (seq >= q->head_seq + (int64_t)q->buf.size()) return -1;  // closed+drained
  *out = q->buf[(size_t)(seq - q->head_seq)];
  q->cursor[consumer] = seq + 1;
  q->gc_locked();
  return 0;
}

// How many messages consumer has yet to read.
int64_t dl4j_fbq_pending(void* h, int64_t consumer) {
  Fbq* q = (Fbq*)h;
  std::lock_guard<std::mutex> lk(q->mu);
  return q->head_seq + (int64_t)q->buf.size() - q->cursor[consumer];
}

void dl4j_fbq_close(void* h) {
  Fbq* q = (Fbq*)h;
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->cv_put.notify_all();
  q->cv_take.notify_all();
}

}  // extern "C"
