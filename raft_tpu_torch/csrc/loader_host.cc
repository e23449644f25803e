// Prefetching batch file loader of the port's `io` module (its own copy of
// the JAX package's native ring reader): a reader thread pread()s batches
// of a row-major on-disk array into a ring of `depth` buffers ahead of
// the consumer.
//
// Built with the system C++ compiler into raft_tpu_torch/_build/ at first
// use (raft_tpu_torch/native), loaded with ctypes; a plain C interface.
// `io.FileBatchLoader`'s memmap path is its twin, which the CPU tests hold
// it against byte for byte.

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// prefetching batch file loader (batch_load_iterator host-IO role,
// spatial/knn/detail/ann_utils.cuh:388): a reader thread pread()s fixed-row
// batches of a row-major on-disk array into a ring of `depth` buffers ahead
// of the consumer, so disk/page-cache latency overlaps the device work of
// streamed index builds. The consumer acquires batches strictly in order
// and each buffer stays valid until `depth - 1` further acquires.
// ---------------------------------------------------------------------------

namespace {

struct RtLoader {
  int fd = -1;
  int64_t data_off = 0, row_bytes = 0, n_rows = 0, batch_rows = 0;
  int64_t depth = 0, n_batches = 0;
  std::vector<std::vector<uint8_t>> bufs;
  std::vector<int64_t> slot_batch;  // batch FILLED in each slot; -1 = free
  int64_t next_acquire = 0;  // next batch the consumer gets
  int64_t next_release = 0;  // oldest unreleased batch
  bool stop = false;
  int32_t err = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::thread th;
};

void rt_loader_run(RtLoader* L) {
  for (int64_t b = 0; b < L->n_batches; ++b) {
    int64_t slot = b % L->depth;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      // wait until the slot's previous occupant (batch b - depth) is
      // released; reader stays exactly `depth` batches ahead at most
      L->cv.wait(lk, [&] { return L->stop || b - L->next_release < L->depth; });
      if (L->stop) return;
    }
    int64_t lo = b * L->batch_rows;
    int64_t rows = std::min(L->batch_rows, L->n_rows - lo);
    int64_t want = rows * L->row_bytes;
    int64_t off = L->data_off + lo * L->row_bytes;
    uint8_t* dst = L->bufs[slot].data();
    int64_t got = 0;
    while (got < want) {
      ssize_t r = pread(L->fd, dst + got, want - got, off + got);
      if (r <= 0) {
        std::lock_guard<std::mutex> lk(L->mu);
        L->err = -2;  // short read / IO error
        L->cv.notify_all();
        return;
      }
      got += r;
    }
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->slot_batch[slot] = b;
      L->cv.notify_all();
    }
  }
}

}  // namespace

extern "C" {

// Open a loader over a row-major array stored at `data_off` in `path`.
// Returns an opaque handle (close with rt_loader_close) or nullptr.
void* rt_loader_open(const char* path, int64_t data_off, int64_t row_bytes,
                     int64_t n_rows, int64_t batch_rows, int64_t depth) {
  if (row_bytes <= 0 || n_rows < 0 || batch_rows <= 0 || data_off < 0)
    return nullptr;
  if (depth < 2) depth = 2;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  RtLoader* L = new RtLoader();
  L->fd = fd;
  L->data_off = data_off;
  L->row_bytes = row_bytes;
  L->n_rows = n_rows;
  L->batch_rows = batch_rows;
  L->depth = depth;
  L->n_batches = n_rows ? (n_rows + batch_rows - 1) / batch_rows : 0;
  L->bufs.assign(depth, {});
  for (auto& b : L->bufs) b.resize(static_cast<size_t>(batch_rows * row_bytes));
  L->slot_batch.assign(depth, -1);
  L->th = std::thread(rt_loader_run, L);
  return L;
}

// Blocks until the next batch is resident; *ptr_out receives its buffer.
// Returns the batch's valid row count, 0 past the last batch, or a
// negative error. The buffer stays valid until the consumer releases it
// (rt_loader_release frees oldest-first) AND the reader laps the ring;
// the Python wrapper holds depth-1 slots so views outlive the current
// iteration by depth-2 more. All buffers die at rt_loader_close.
int64_t rt_loader_acquire(void* handle, uint8_t** ptr_out) {
  RtLoader* L = static_cast<RtLoader*>(handle);
  if (!L || !ptr_out) return -1;
  if (L->next_acquire >= L->n_batches) return 0;
  int64_t b = L->next_acquire;
  int64_t slot = b % L->depth;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv.wait(lk, [&] { return L->err != 0 || L->slot_batch[slot] == b; });
  if (L->err != 0) return L->err;
  L->next_acquire = b + 1;
  *ptr_out = L->bufs[slot].data();
  return std::min(L->batch_rows, L->n_rows - b * L->batch_rows);
}

// Releases the oldest unreleased batch's slot back to the reader.
int32_t rt_loader_release(void* handle) {
  RtLoader* L = static_cast<RtLoader*>(handle);
  if (!L) return -1;
  std::lock_guard<std::mutex> lk(L->mu);
  if (L->next_release >= L->next_acquire) return -1;  // nothing outstanding
  L->slot_batch[L->next_release % L->depth] = -1;
  L->next_release++;
  L->cv.notify_all();
  return 0;
}

void rt_loader_close(void* handle) {
  RtLoader* L = static_cast<RtLoader*>(handle);
  if (!L) return;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv.notify_all();
  }
  if (L->th.joinable()) L->th.join();
  if (L->fd >= 0) close(L->fd);
  delete L;
}

}  // extern "C"
