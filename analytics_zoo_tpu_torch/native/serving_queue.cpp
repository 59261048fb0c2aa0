// Dynamic micro-batching request queue for the serving/inference layer.
//
// Reference role: InferenceModel's BlockingQueue of N model copies
// (zoo/.../pipeline/inference/InferenceModel.scala:33,791-838) and the
// Flink batch regrouping (serving/engine/FlinkInference.scala:46-56).
// On an accelerator, concurrency comes from coalescing many single requests into ONE
// batched device execution, so the native piece is a multi-producer
// blocking queue with batch-pop (wait up to a deadline, return up to
// max_batch requests) plus a completion table the producers block on.
// All waits run outside the Python GIL (ctypes releases it), so client
// threads and the device loop never contend on interpreter locks.
//
// C ABI only (no pybind11 needed); handles are opaque pointers.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Payload {
  uint64_t id;
  std::vector<uint8_t> data;
};

// PARTITIONED request plane (the fleet tier): each
// engine replica pops its own partition deque, so M replicas consume
// M disjoint streams through ONE queue handle.  The legacy
// unpartitioned API is partition 0.  One cv_req serves every
// partition: a push notify_all wakes all blocked poppers and the
// wrong-partition ones re-check their predicate and go back to sleep
// — at fleet scale (a handful of replicas) that beats a cv per
// partition, whose create/destroy would have to be coordinated with
// concurrent waiters.
struct Queue {
  std::mutex mu;
  std::condition_variable cv_req;    // signalled on new request
  std::condition_variable cv_done;   // signalled on completion
  std::unordered_map<uint64_t, std::deque<Payload>> parts;
  // poppers blocked inside pop_batch_part per partition: drop_part may
  // ERASE a partition node only when nobody holds a reference to its
  // deque across a cv wait (else the per-stream GC path — one
  // partition per LLM token stream — would leak one map node per
  // stream ever touched)
  std::unordered_map<uint64_t, int> part_waiters;
  std::unordered_map<uint64_t, std::vector<uint8_t>> done;
  uint64_t total_enqueued = 0;
  uint64_t total_completed = 0;
  uint64_t depth = 0;                // live entries across partitions
  uint64_t max_depth = 0;
  bool closed = false;
};

}  // namespace

extern "C" {

void* zoo_queue_create() { return new Queue(); }

void zoo_queue_destroy(void* h) { delete static_cast<Queue*>(h); }

void zoo_queue_close(void* h) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->cv_req.notify_all();
  q->cv_done.notify_all();
}

// Enqueue one request into a partition. Returns 0, or -1 if closed.
int zoo_queue_push_part(void* h, uint64_t part, uint64_t id,
                        const uint8_t* data, size_t len) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  if (q->closed) return -1;
  q->parts[part].push_back({id, std::vector<uint8_t>(data, data + len)});
  q->total_enqueued++;
  q->depth++;
  if (q->depth > q->max_depth) q->max_depth = q->depth;
  q->cv_req.notify_all();
  return 0;
}

// Legacy unpartitioned push = partition 0.
int zoo_queue_push(void* h, uint64_t id, const uint8_t* data, size_t len) {
  return zoo_queue_push_part(h, 0, id, data, len);
}

// Pop up to max_batch requests from ONE partition, waiting up to
// timeout_ms for the FIRST one (once one is present, whatever else is
// queued in that partition is taken immediately — the classic adaptive-
// batching policy).  Writes ids into out_ids, payload sizes into
// out_sizes.  Returns the count (0 on timeout, -1 if closed and the
// partition is drained).  Payload bytes are fetched per-id with
// zoo_queue_fetch.
int64_t zoo_queue_pop_batch_part(void* h, uint64_t part, int64_t max_batch,
                                 int64_t timeout_ms, uint64_t* out_ids,
                                 int64_t* out_sizes) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  std::deque<Payload>& reqs = q->parts[part];
  if (reqs.empty()) {
    q->part_waiters[part]++;
    q->cv_req.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                       [&] { return !reqs.empty() || q->closed; });
    if (--q->part_waiters[part] == 0) q->part_waiters.erase(part);
  }
  if (reqs.empty()) {
    // nothing to take: drop the (possibly just-created) empty node
    // unless another popper still references it — the parts map stays
    // bounded by ACTIVE partitions, not partitions ever polled
    if (q->part_waiters.find(part) == q->part_waiters.end())
      q->parts.erase(part);
    return q->closed ? -1 : 0;
  }
  int64_t n = 0;
  while (!reqs.empty() && n < max_batch) {
    Payload& p = reqs.front();
    out_ids[n] = p.id;
    out_sizes[n] = static_cast<int64_t>(p.data.size());
    // move payload into the done-table slot keyed by ~id (staging area)
    q->done[~p.id] = std::move(p.data);
    reqs.pop_front();
    q->depth--;
    n++;
  }
  return n;
}

// Legacy unpartitioned pop = partition 0.
int64_t zoo_queue_pop_batch(void* h, int64_t max_batch, int64_t timeout_ms,
                            uint64_t* out_ids, int64_t* out_sizes) {
  return zoo_queue_pop_batch_part(h, 0, max_batch, timeout_ms, out_ids,
                                  out_sizes);
}

// Drop one partition's pending entries (stream GC — the token-stream
// delete_stream role).  Returns how many entries were discarded.
int64_t zoo_queue_drop_part(void* h, uint64_t part) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  auto it = q->parts.find(part);
  if (it == q->parts.end()) return 0;
  int64_t n = static_cast<int64_t>(it->second.size());
  q->depth -= static_cast<uint64_t>(n);
  auto w = q->part_waiters.find(part);
  if (w == q->part_waiters.end() || w->second == 0) {
    // no popper holds a reference across a cv wait: ERASE the node —
    // per-stream partitions (LLM token streams mint one per uri) must
    // not accumulate one empty map node per stream ever served
    if (w != q->part_waiters.end()) q->part_waiters.erase(w);
    q->parts.erase(it);
  } else {
    // a blocked popper references this deque: clearing is the most we
    // may do without dangling it
    it->second.clear();
  }
  return n;
}

// Copy a staged request payload (written by pop_batch) and drop it.
// Returns copied size or -1 if missing.
int64_t zoo_queue_fetch(void* h, uint64_t id, uint8_t* out, size_t cap) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  auto it = q->done.find(~id);
  if (it == q->done.end()) return -1;
  size_t n = it->second.size();
  if (n > cap) return -1;
  std::memcpy(out, it->second.data(), n);
  q->done.erase(it);
  return static_cast<int64_t>(n);
}

// Publish a completion payload for a request id.
int zoo_queue_complete(void* h, uint64_t id, const uint8_t* data,
                       size_t len) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->done[id] = std::vector<uint8_t>(data, data + len);
  q->total_completed++;
  q->cv_done.notify_all();
  return 0;
}

// Block until the completion for `id` exists (or timeout). Returns its
// size (result stays until fetched), 0 on timeout, -1 if closed.
int64_t zoo_queue_wait(void* h, uint64_t id, int64_t timeout_ms) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  bool ok = q->cv_done.wait_for(
      lk, std::chrono::milliseconds(timeout_ms),
      [q, id] { return q->done.count(id) > 0 || q->closed; });
  auto it = q->done.find(id);
  if (it != q->done.end()) return static_cast<int64_t>(it->second.size());
  return (q->closed) ? -1 : 0;
}

// Copy a completion payload out and drop it. Returns size or -1.
int64_t zoo_queue_take(void* h, uint64_t id, uint8_t* out, size_t cap) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  auto it = q->done.find(id);
  if (it == q->done.end()) return -1;
  size_t n = it->second.size();
  if (n > cap) return -1;
  std::memcpy(out, it->second.data(), n);
  q->done.erase(it);
  return static_cast<int64_t>(n);
}

// stats: [enqueued, completed, current_depth, max_depth] — depth counts
// live entries across ALL partitions
void zoo_queue_stats(void* h, uint64_t* out4) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  out4[0] = q->total_enqueued;
  out4[1] = q->total_completed;
  out4[2] = q->depth;
  out4[3] = q->max_depth;
}

}  // extern "C"
