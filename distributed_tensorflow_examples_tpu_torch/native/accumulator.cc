// Gradient accumulator + token queue host service (C ABI, loaded via ctypes).
//
// The PyTorch port's own copy of the JAX package's native/accumulator.cc,
// the same code: the counterpart of the reference's native sync-PS machinery
// (SURVEY.md section 2b D5/D12): TF's C++ ConditionalAccumulator
// (common_runtime/conditional_accumulator.h) averages `num_required`
// gradients per variable while dropping gradients computed against a stale
// parameter version, and SyncReplicasOptimizer's chief queue-runner
// (sync_replicas_optimizer.py:340) hands out per-step tokens that gate the
// workers.  Here the same two primitives coordinate worker threads that
// compute gradients on the GPU (parallel/async_ps.py); the hot compute path
// never enters this file — it stays in the workers' forward and backward.
//
// Semantics mirrored from the reference design:
// - apply(step): accepted only if step >= current global step ("staleness
//   drop", conditional_accumulator_base.h TryApplyGrad); accepted grads sum.
// - take(num_required): blocks until that many fresh grads, returns their
//   average, resets the sum, and is fenced by the global step the caller
//   then advances.
// - token queue: chief pushes N tokens tagged with the new global step;
//   each worker pops one to proceed (sync_replicas_optimizer.py:399).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <new>
#include <vector>

namespace {

// Timed condvar waits go through a SYSTEM_CLOCK wait_until, not wait_for:
// libstdc++'s wait_for lowers to pthread_cond_clockwait(CLOCK_MONOTONIC),
// which older ThreadSanitizer runtimes (gcc 10's libtsan) do not
// intercept — the sanitizer then never sees the mutex release inside the
// wait, and the TSAN gate (tools/tsan_step.py) drowns every blocking op
// in false double-lock/race reports.  pthread_cond_timedwait (the
// system_clock path) is intercepted everywhere.  These waits are short
// re-issued chunks (the client re-polls on -3), so a wall-clock jump
// merely stretches or clips ONE chunk — never correctness.
template <typename Pred>
bool timed_wait(std::condition_variable& cv,
                std::unique_lock<std::mutex>& lock, int64_t timeout_ms,
                Pred pred) {
  return cv.wait_until(lock,
                       std::chrono::system_clock::now() +
                           std::chrono::milliseconds(timeout_ms),
                       pred);
}

// Tagged-op dedup (fault recovery): a client that loses its connection
// mid-op replays the op after reconnecting; a per-worker monotone sequence
// number makes the replay idempotent — the server records the highest seq
// it has processed per worker and answers "duplicate" for anything at or
// below it, so a gradient that DID land before the drop is never applied
// twice (the replay analog of the reference's stale-gradient drop).
struct DedupTable {
  std::map<int64_t, int64_t> last_seq;  // worker -> highest processed seq
  int64_t deduped = 0;

  // True (and counted) when (worker, seq) was already processed.  Does NOT
  // record — callers record() only once the op will actually be processed,
  // so a check on a path that later bails (timeout, cancel) cannot turn a
  // future legitimate replay into a false duplicate.  Owner's mutex held.
  bool check_duplicate(int64_t worker, int64_t seq) {
    auto it = last_seq.find(worker);
    if (it != last_seq.end() && seq <= it->second) {
      ++deduped;
      return true;
    }
    return false;
  }

  void record(int64_t worker, int64_t seq) { last_seq[worker] = seq; }

  // Replication (r12) export/import: the table IS the replay-idempotence
  // state, so a backup must mirror it for at-most-once to survive a
  // failover.  Owner's mutex held by the callers below.
  int64_t export_to(int64_t* workers, int64_t* seqs, int64_t cap) const {
    int64_t i = 0;
    for (const auto& kv : last_seq) {
      if (i >= cap) return -1;  // caller re-sizes and retries
      workers[i] = kv.first;
      seqs[i] = kv.second;
      ++i;
    }
    return i;
  }

  void import_from(int64_t n, const int64_t* workers, const int64_t* seqs) {
    for (int64_t i = 0; i < n; ++i) last_seq[workers[i]] = seqs[i];
  }

  // Forget a worker's history: a RESTARTED worker process (fresh client,
  // fresh 0-based sequence counter, same worker id) announces itself so
  // its new stream is not answered "duplicate" against its dead
  // incarnation's sequences.  Replays within one client lifetime are
  // unaffected (the client resets only at construction).
  void reset_worker(int64_t worker) { last_seq.erase(worker); }
};

struct Accumulator {
  std::mutex mu;
  std::condition_variable cv;
  std::vector<float> sum;
  int64_t count = 0;
  int64_t global_step = 0;
  int64_t dropped = 0;  // stale-gradient counter (observability)
  DedupTable dedup;
  bool cancelled = false;

  explicit Accumulator(int64_t n) : sum(static_cast<size_t>(n), 0.0f) {}
};

struct TokenQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<int64_t> tokens;  // each token carries the global step it blesses
  bool cancelled = false;
};

// FIFO of whole gradients for TRUE-async apply (W2): unlike the summing
// accumulator, each pushed gradient is popped and applied individually —
// the Send/Recv rendezvous role of the reference's worker->PS push
// (rpc_rendezvous_mgr.h), with an optional staleness gate.
struct GradQueue {
  std::mutex mu;
  std::condition_variable cv;       // signalled on push (pop waiters)
  std::condition_variable cv_space; // signalled on pop (push waiters)
  size_t n_elems;
  size_t capacity;  // bound on queued gradients: push blocks when full
  std::deque<std::pair<int64_t, std::vector<float>>> q;  // (local_step, grad)
  int64_t min_step = 0;  // staleness gate: pushes below this are dropped
  int64_t dropped = 0;
  DedupTable dedup;
  bool cancelled = false;

  GradQueue(int64_t n, int64_t cap)
      : n_elems(static_cast<size_t>(n)), capacity(static_cast<size_t>(cap)) {}
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Accumulator
// ---------------------------------------------------------------------------

void* acc_new(int64_t num_elems) {
  if (num_elems <= 0) return nullptr;
  return new (std::nothrow) Accumulator(num_elems);
}

void acc_free(void* h) { delete static_cast<Accumulator*>(h); }

int64_t acc_num_elems(void* h) {
  return static_cast<int64_t>(static_cast<Accumulator*>(h)->sum.size());
}

// Returns 1 if accepted, 0 if dropped as stale (local_step < global_step).
int acc_apply(void* h, int64_t local_step, const float* grad) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  if (local_step < a->global_step) {
    ++a->dropped;
    return 0;
  }
  for (size_t i = 0; i < a->sum.size(); ++i) a->sum[i] += grad[i];
  ++a->count;
  a->cv.notify_all();
  return 1;
}

// Fault-tolerant apply: like acc_apply, but tagged with (worker, seq) so a
// client replaying the op after a connection drop gets "duplicate" (2)
// instead of double-counting its gradient.  Returns 1 accepted, 0 dropped
// stale, 2 duplicate replay.  seq must be monotone per worker per logical
// apply (retries of ONE apply reuse its seq).  The seq is recorded even
// for stale drops, so a replayed drop answers 2 and the dropped counter
// stays exact.
int acc_apply_tagged(void* h, int64_t local_step, int64_t worker, int64_t seq,
                     const float* grad) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  if (a->dedup.check_duplicate(worker, seq)) return 2;
  a->dedup.record(worker, seq);
  if (local_step < a->global_step) {
    ++a->dropped;
    return 0;
  }
  for (size_t i = 0; i < a->sum.size(); ++i) a->sum[i] += grad[i];
  ++a->count;
  a->cv.notify_all();
  return 1;
}

int64_t acc_deduped(void* h) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return a->dedup.deduped;
}

void acc_reset_worker(void* h, int64_t worker) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  a->dedup.reset_worker(worker);
}

// --- replication mirror/state ops (r12) -------------------------------------
// A backup replica mirrors an accumulator's COORDINATION state — dedup
// table, staleness gate, counters — not its transient sum (in-flight
// aggregations keep the existing at-most-once posture; the chief's
// stall-repush heals their loss).  acc_mirror_tagged is the payload-less
// form of acc_apply_tagged the primary forwards: same dedup/staleness
// bookkeeping, same return codes, nothing summed.

int acc_mirror_tagged(void* h, int64_t local_step, int64_t worker,
                      int64_t seq) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  if (a->dedup.check_duplicate(worker, seq)) return 2;
  a->dedup.record(worker, seq);
  if (local_step < a->global_step) {
    ++a->dropped;
    return 0;
  }
  return 1;
}

int64_t acc_global_step(void* h) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return a->global_step;
}

int64_t acc_dedup_export(void* h, int64_t* workers, int64_t* seqs,
                         int64_t cap) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return a->dedup.export_to(workers, seqs, cap);
}

int64_t acc_dedup_size(void* h) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return static_cast<int64_t>(a->dedup.last_seq.size());
}

// Restore a synced-from-peer accumulator's coordination state (REPL_SYNC
// install path; runs before the restarted server accepts connections).
void acc_restore(void* h, int64_t global_step, int64_t dropped,
                 int64_t deduped, int64_t n, const int64_t* workers,
                 const int64_t* seqs) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  a->global_step = global_step;
  a->dropped = dropped;
  a->dedup.deduped = deduped;
  a->dedup.import_from(n, workers, seqs);
}

// Deadline-bounded take (fault recovery: a waiter must be able to notice a
// dead peer instead of blocking forever).  timeout_ms <= 0 blocks forever.
// Returns the number averaged, -1 on cancel, -3 on timeout (the caller
// re-issues — the wait itself mutates nothing).
int64_t acc_take_timed(void* h, int64_t num_required, int64_t timeout_ms,
                       float* out) {
  auto* a = static_cast<Accumulator*>(h);
  std::unique_lock<std::mutex> lock(a->mu);
  auto ready = [&] { return a->cancelled || a->count >= num_required; };
  if (timeout_ms <= 0) {
    a->cv.wait(lock, ready);
  } else if (!timed_wait(a->cv, lock, timeout_ms, ready)) {
    return -3;
  }
  if (a->cancelled) return -1;
  const float inv = 1.0f / static_cast<float>(a->count);
  for (size_t i = 0; i < a->sum.size(); ++i) {
    out[i] = a->sum[i] * inv;
    a->sum[i] = 0.0f;
  }
  const int64_t n = a->count;
  a->count = 0;
  return n;
}

// Blocks until `num_required` fresh gradients accumulated (or cancel);
// writes their average to `out` and resets.  Returns the number averaged,
// or -1 on cancellation.
int64_t acc_take(void* h, int64_t num_required, float* out) {
  return acc_take_timed(h, num_required, 0, out);
}

void acc_set_global_step(void* h, int64_t step) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  a->global_step = step;
}

int64_t acc_dropped(void* h) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return a->dropped;
}

int64_t acc_count(void* h) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  return a->count;
}

void acc_cancel(void* h) {
  auto* a = static_cast<Accumulator*>(h);
  std::lock_guard<std::mutex> lock(a->mu);
  a->cancelled = true;
  a->cv.notify_all();
}

// ---------------------------------------------------------------------------
// Token queue
// ---------------------------------------------------------------------------

void* tq_new() { return new (std::nothrow) TokenQueue(); }

void tq_free(void* h) { delete static_cast<TokenQueue*>(h); }

void tq_push(void* h, int64_t step, int64_t n) {
  auto* q = static_cast<TokenQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  for (int64_t i = 0; i < n; ++i) q->tokens.push_back(step);
  q->cv.notify_all();
}

// Deadline-bounded pop: timeout_ms <= 0 blocks forever; returns the
// token's step, -1 on cancel, -3 on timeout (no token consumed).
int64_t tq_pop_timed(void* h, int64_t timeout_ms) {
  auto* q = static_cast<TokenQueue*>(h);
  std::unique_lock<std::mutex> lock(q->mu);
  auto ready = [&] { return q->cancelled || !q->tokens.empty(); };
  if (timeout_ms <= 0) {
    q->cv.wait(lock, ready);
  } else if (!timed_wait(q->cv, lock, timeout_ms, ready)) {
    return -3;
  }
  if (q->cancelled && q->tokens.empty()) return -1;
  const int64_t step = q->tokens.front();
  q->tokens.pop_front();
  return step;
}

// Blocks until a token is available; returns its step, or -1 on cancel.
int64_t tq_pop(void* h) { return tq_pop_timed(h, 0); }

int64_t tq_size(void* h) {
  auto* q = static_cast<TokenQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return static_cast<int64_t>(q->tokens.size());
}

void tq_cancel(void* h) {
  auto* q = static_cast<TokenQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  q->cancelled = true;
  q->cv.notify_all();
}

// ---------------------------------------------------------------------------
// Gradient queue (true-async path)
// ---------------------------------------------------------------------------

// capacity bounds queued gradients (backpressure: push blocks while full).
void* gq_new(int64_t num_elems, int64_t capacity) {
  if (num_elems <= 0 || capacity <= 0) return nullptr;
  return new (std::nothrow) GradQueue(num_elems, capacity);
}

void gq_free(void* h) { delete static_cast<GradQueue*>(h); }

// Returns 1 if enqueued, 0 if dropped as stale (local_step < min_step),
// -1 if cancelled while waiting for space.  Blocks while the queue is full
// (backpressure on fast workers — bounds memory to capacity gradients).
int gq_push(void* h, int64_t local_step, const float* grad) {
  auto* q = static_cast<GradQueue*>(h);
  std::unique_lock<std::mutex> lock(q->mu);
  q->cv_space.wait(lock,
                   [&] { return q->cancelled || q->q.size() < q->capacity; });
  if (q->cancelled) return -1;
  if (local_step < q->min_step) {
    ++q->dropped;
    return 0;
  }
  q->q.emplace_back(local_step, std::vector<float>(grad, grad + q->n_elems));
  q->cv.notify_all();
  return 1;
}

// Fault-tolerant push: tagged with (worker, seq) like acc_apply_tagged, so
// a post-reconnect replay of a push that DID land is not enqueued (and
// hence applied) twice.  Bounded wait for space — timeout_ms <= 0 blocks
// like gq_push — so a client deadline can't strand the serving thread in
// an unbounded full-queue wait.  Returns 1 enqueued, 0 dropped stale,
// 2 duplicate replay, -1 cancelled, -3 timed out waiting for space.
int gq_push_tagged(void* h, int64_t local_step, int64_t worker, int64_t seq,
                   int64_t timeout_ms, const float* grad) {
  auto* q = static_cast<GradQueue*>(h);
  std::unique_lock<std::mutex> lock(q->mu);
  // Duplicate check BEFORE the space wait: a replay of a push that already
  // landed needs no space and must answer immediately — against a
  // persistently full queue it would otherwise poll until the client's
  // stall budget expired for a gradient already delivered.
  if (q->dedup.check_duplicate(worker, seq)) return 2;
  auto ready = [&] { return q->cancelled || q->q.size() < q->capacity; };
  if (timeout_ms <= 0) {
    q->cv_space.wait(lock, ready);
  } else if (!timed_wait(q->cv_space, lock, timeout_ms, ready)) {
    return -3;
  }
  if (q->cancelled) return -1;
  // Re-check: the wait released the mutex, so a racing replay of the same
  // (worker, seq) may have been processed meanwhile.
  if (q->dedup.check_duplicate(worker, seq)) return 2;
  q->dedup.record(worker, seq);
  if (local_step < q->min_step) {
    ++q->dropped;
    return 0;
  }
  q->q.emplace_back(local_step, std::vector<float>(grad, grad + q->n_elems));
  q->cv.notify_all();
  return 1;
}

int64_t gq_deduped(void* h) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return q->dedup.deduped;
}

void gq_reset_worker(void* h, int64_t worker) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  q->dedup.reset_worker(worker);
}

// --- replication mirror/state ops (r12) — see acc_mirror_tagged -------------
// Queue CONTENTS are not mirrored (in-flight gradients keep the existing
// at-most-once posture); the dedup table and staleness gate are, so a push
// replayed against the surviving replica after a failover is answered
// "duplicate", never applied twice.

int gq_mirror_tagged(void* h, int64_t local_step, int64_t worker,
                     int64_t seq) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  if (q->dedup.check_duplicate(worker, seq)) return 2;
  q->dedup.record(worker, seq);
  if (local_step < q->min_step) {
    ++q->dropped;
    return 0;
  }
  return 1;
}

int64_t gq_min_step(void* h) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return q->min_step;
}

int64_t gq_capacity(void* h) {
  return static_cast<int64_t>(static_cast<GradQueue*>(h)->capacity);
}

int64_t gq_dedup_export(void* h, int64_t* workers, int64_t* seqs,
                        int64_t cap) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return q->dedup.export_to(workers, seqs, cap);
}

int64_t gq_dedup_size(void* h) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return static_cast<int64_t>(q->dedup.last_seq.size());
}

void gq_restore(void* h, int64_t min_step, int64_t dropped, int64_t deduped,
                int64_t n, const int64_t* workers, const int64_t* seqs) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  q->min_step = min_step;
  q->dropped = dropped;
  q->dedup.deduped = deduped;
  q->dedup.import_from(n, workers, seqs);
}

// Deadline-bounded pop: timeout_ms <= 0 blocks forever; returns the
// gradient's local_step, -1 on cancel+drained, -3 on timeout.
int64_t gq_pop_timed(void* h, int64_t timeout_ms, float* out) {
  auto* q = static_cast<GradQueue*>(h);
  std::unique_lock<std::mutex> lock(q->mu);
  auto ready = [&] { return q->cancelled || !q->q.empty(); };
  if (timeout_ms <= 0) {
    q->cv.wait(lock, ready);
  } else if (!timed_wait(q->cv, lock, timeout_ms, ready)) {
    return -3;
  }
  if (q->q.empty()) return -1;  // cancelled and drained
  auto& front = q->q.front();
  std::memcpy(out, front.second.data(), q->n_elems * sizeof(float));
  const int64_t step = front.first;
  q->q.pop_front();
  q->cv_space.notify_all();
  return step;
}

// Blocks for the oldest gradient; writes it to `out` and returns its
// local_step, or -1 on cancellation.
int64_t gq_pop(void* h, float* out) { return gq_pop_timed(h, 0, out); }

void gq_set_min_step(void* h, int64_t step) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  q->min_step = step;
}

int64_t gq_dropped(void* h) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return q->dropped;
}

int64_t gq_num_elems(void* h) {
  return static_cast<int64_t>(static_cast<GradQueue*>(h)->n_elems);
}

int64_t gq_size(void* h) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  return static_cast<int64_t>(q->q.size());
}

void gq_cancel(void* h) {
  auto* q = static_cast<GradQueue*>(h);
  std::lock_guard<std::mutex> lock(q->mu);
  q->cancelled = true;
  q->cv.notify_all();
  q->cv_space.notify_all();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parameter store (cross-process PS role): chief publishes (step, params),
// workers fetch the latest snapshot — the variable-hosting half of the
// reference's PS task (SURVEY.md D3), serving reads the way worker->PS
// variable fetches did (section 3.1 hot path).
// ---------------------------------------------------------------------------

namespace {

struct ParamStore {
  std::mutex mu;
  std::vector<float> data;
  int64_t step = -1;  // -1 = never published

  explicit ParamStore(int64_t n) : data(static_cast<size_t>(n), 0.0f) {}
};

}  // namespace

extern "C" {

void* pstore_new(int64_t num_elems) {
  if (num_elems <= 0) return nullptr;
  return new (std::nothrow) ParamStore(num_elems);
}

void pstore_free(void* h) { delete static_cast<ParamStore*>(h); }

int64_t pstore_num_elems(void* h) {
  return static_cast<int64_t>(static_cast<ParamStore*>(h)->data.size());
}

void pstore_set(void* h, int64_t step, const float* data) {
  auto* p = static_cast<ParamStore*>(h);
  std::lock_guard<std::mutex> lock(p->mu);
  std::memcpy(p->data.data(), data, p->data.size() * sizeof(float));
  p->step = step;
}

// Copies the latest snapshot into `out`; returns its step (-1 if never set).
int64_t pstore_get(void* h, float* out) {
  auto* p = static_cast<ParamStore*>(h);
  std::lock_guard<std::mutex> lock(p->mu);
  std::memcpy(out, p->data.data(), p->data.size() * sizeof(float));
  return p->step;
}

// The published step without touching the data (-1 = never set): the
// server peeks this before sizing a response buffer, so an unchanged-step
// pull never allocates (or zero-fills) an O(params) vector.
int64_t pstore_step(void* h) {
  auto* p = static_cast<ParamStore*>(h);
  std::lock_guard<std::mutex> lock(p->mu);
  return p->step;
}

// Ranged pull (r15 live resharding): copies elements [start, start+count)
// of the snapshot into `out` (caller pre-clamps the range to the object's
// size — the wire layer's ranged REPL_SYNC does); returns the step.  A
// new-layout shard assembling its slice from several old shards pulls
// exactly the overlap from each, never a full O(params) copy per source.
int64_t pstore_get_range(void* h, int64_t start, int64_t count, float* out) {
  auto* p = static_cast<ParamStore*>(h);
  std::lock_guard<std::mutex> lock(p->mu);
  const int64_t n = static_cast<int64_t>(p->data.size());
  int64_t lo = start < 0 ? 0 : (start > n ? n : start);
  int64_t c = count < 0 ? 0 : count;
  // Overflow-safe clamp: lo is within [0, n], so n - lo cannot wrap.
  if (c > n - lo) c = n - lo;
  if (c > 0)
    std::memcpy(out, p->data.data() + lo,
                static_cast<size_t>(c) * sizeof(float));
  return p->step;
}

// Versioned pull: copies the snapshot into `out` ONLY when its step is
// newer than `have_step`; returns the current step either way.  The caller
// holding a cached copy of step `have_step` learns "unchanged" for the
// price of the returned step — the transport layer turns that into a
// header-only response (the PSTORE_GET_IF_NEWER wire op).
int64_t pstore_get_if_newer(void* h, int64_t have_step, float* out) {
  auto* p = static_cast<ParamStore*>(h);
  std::lock_guard<std::mutex> lock(p->mu);
  if (p->step > have_step)
    std::memcpy(out, p->data.data(), p->data.size() * sizeof(float));
  return p->step;
}

}  // extern "C"
