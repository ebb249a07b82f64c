// Group-commit WAL sink: the native IO runtime under runtime/wal.py.
//
// The reference's durability layer is etcd, whose raft log batches many
// proposals into one fsync (wal.Save group commit). The Python WAL fsyncs
// per record; this sink restores the etcd behavior: appenders ENQUEUE
// records (cheap, in rv order under the store lock) and WAIT for a
// durability ticket; a dedicated committer thread drains the queue, writes
// everything pending, fsyncs ONCE, and advances the durable generation.
// A 512-record bulk bind costs one fsync instead of 512.
//
// C ABI (ctypes-loaded from kubernetes_tpu/native/__init__.py):
//   wal_open(path, do_fsync) -> handle
//   wal_enqueue(h, data, len) -> ticket (uint64)
//   wal_wait(h, ticket) -> 0|-1    blocks until ticket durable (-1: IO err)
//   wal_flush(h) -> 0|-1           blocks until everything durable
//   wal_fsync_count(h) -> uint64   committer fsyncs so far (stats/tests)
//   wal_close(h)

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct WalSink {
  int fd = -1;
  bool do_fsync = true;
  std::mutex mu;
  std::condition_variable cv_work;   // committer wakes on new records
  std::condition_variable cv_done;   // waiters wake on durability advance
  std::vector<std::string> pending;  // records not yet written
  uint64_t enqueued = 0;             // tickets handed out
  uint64_t durable = 0;              // highest durable ticket
  uint64_t fsyncs = 0;
  bool failed = false;  // unrecoverable IO error; waiters unblock with -1
  bool closing = false;
  std::thread committer;

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv_work.wait(lk, [&] { return !pending.empty() || closing; });
      if (pending.empty() && closing) return;
      std::vector<std::string> batch;
      batch.swap(pending);
      uint64_t batch_hi = enqueued;
      lk.unlock();
      // one writev-style pass + one fsync for the whole batch
      std::string buf;
      size_t total = 0;
      for (const auto& r : batch) total += r.size();
      buf.reserve(total);
      for (const auto& r : batch) buf.append(r);
      const char* p = buf.data();
      size_t left = buf.size();
      while (left > 0) {
        ssize_t n = ::write(fd, p, left);
        if (n < 0) {
          if (errno == EINTR) continue;
          break;  // disk error: mark failed below; waiters get -1
        }
        p += n;
        left -= static_cast<size_t>(n);
      }
      bool ok = (left == 0);
      if (ok && do_fsync) ok = (::fsync(fd) == 0);
      lk.lock();
      if (do_fsync) fsyncs++;
      if (ok) {
        durable = batch_hi;
      } else {
        failed = true;  // fail-stop: the Python layer raises OSError
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* wal_open(const char* path, int do_fsync) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  auto* s = new WalSink();
  s->fd = fd;
  s->do_fsync = do_fsync != 0;
  s->committer = std::thread([s] { s->run(); });
  return s;
}

uint64_t wal_enqueue(void* h, const char* data, uint64_t len) {
  auto* s = static_cast<WalSink*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->pending.emplace_back(data, static_cast<size_t>(len));
  uint64_t ticket = ++s->enqueued;
  s->cv_work.notify_one();
  return ticket;
}

int wal_wait(void* h, uint64_t ticket) {
  auto* s = static_cast<WalSink*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_done.wait(lk, [&] {
    return s->durable >= ticket || s->failed || s->closing;
  });
  return (s->durable >= ticket) ? 0 : -1;
}

int wal_flush(void* h) {
  auto* s = static_cast<WalSink*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  uint64_t target = s->enqueued;
  s->cv_done.wait(lk, [&] {
    return s->durable >= target || s->failed || s->closing;
  });
  return (s->durable >= target) ? 0 : -1;
}

uint64_t wal_fsync_count(void* h) {
  auto* s = static_cast<WalSink*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->fsyncs;
}

void wal_close(void* h) {
  auto* s = static_cast<WalSink*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
    s->cv_work.notify_all();
  }
  s->committer.join();
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->cv_done.notify_all();  // release any stragglers
  }
  ::close(s->fd);
  delete s;
}

}  // extern "C"
