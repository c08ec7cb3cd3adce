// Disk-backed BFS frontier queue - the DiskStateQueue analog.
//
// TLC's frontier FIFO spills to disk (DiskStateQueue,
// the reference TLC run's MC.out:5) so exhaustive runs are
// bounded by disk, not RAM. This is the native tier for the hybrid engine:
// fixed-size encoded-state records, strict FIFO, file-backed with a small
// write buffer. Levels are fenced by the *caller* (the record layout is
// opaque here), so BFS depth accounting stays exact.
//
// C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

struct Queue {
  FILE *f = nullptr;
  uint64_t record_bytes = 0;
  uint64_t head = 0;  // records popped
  uint64_t tail = 0;  // records pushed
  std::string path;
};

}  // namespace

extern "C" {

void *sq_open(const char *path, uint64_t record_bytes) {
  Queue *q = new Queue();
  q->path = path;
  q->record_bytes = record_bytes;
  q->f = fopen(path, "w+b");
  if (!q->f) {
    delete q;
    return nullptr;
  }
  setvbuf(q->f, nullptr, _IOFBF, 1 << 20);
  return q;
}

// reopen an existing queue file WITHOUT truncation, restoring the
// head/tail cursors a checkpoint recorded (the -recover path)
void *sq_open_at(const char *path, uint64_t record_bytes, uint64_t head,
                 uint64_t tail) {
  Queue *q = new Queue();
  q->path = path;
  q->record_bytes = record_bytes;
  q->f = fopen(path, "r+b");
  if (!q->f) {
    delete q;
    return nullptr;
  }
  setvbuf(q->f, nullptr, _IOFBF, 1 << 20);
  q->head = head;
  q->tail = tail;
  return q;
}

// flush buffered writes to the file (checkpoint barrier)
int sq_sync(void *handle) {
  Queue *q = static_cast<Queue *>(handle);
  return fflush(q->f) ? -1 : 0;
}

uint64_t sq_head(void *handle) { return static_cast<Queue *>(handle)->head; }

int sq_push(void *handle, const void *records, int64_t n) {
  Queue *q = static_cast<Queue *>(handle);
  if (fseeko(q->f, static_cast<off_t>(q->tail * q->record_bytes), SEEK_SET))
    return -1;
  if (fwrite(records, q->record_bytes, static_cast<size_t>(n), q->f) !=
      static_cast<size_t>(n))
    return -1;
  q->tail += static_cast<uint64_t>(n);
  return 0;
}

// pops up to max_n records into out; returns the number popped
int64_t sq_pop(void *handle, void *out, int64_t max_n) {
  Queue *q = static_cast<Queue *>(handle);
  uint64_t avail = q->tail - q->head;
  uint64_t take = avail < static_cast<uint64_t>(max_n)
                      ? avail
                      : static_cast<uint64_t>(max_n);
  if (take == 0) return 0;
  if (fflush(q->f)) return -1;
  if (fseeko(q->f, static_cast<off_t>(q->head * q->record_bytes), SEEK_SET))
    return -1;
  if (fread(out, q->record_bytes, take, q->f) != take) return -1;
  q->head += take;
  return static_cast<int64_t>(take);
}

uint64_t sq_len(void *handle) {
  Queue *q = static_cast<Queue *>(handle);
  return q->tail - q->head;
}

uint64_t sq_tail(void *handle) { return static_cast<Queue *>(handle)->tail; }

// own_file: remove the backing file (set for library-created temp files;
// caller-owned paths are left in place)
void sq_close(void *handle, int own_file) {
  Queue *q = static_cast<Queue *>(handle);
  if (q->f) fclose(q->f);
  if (own_file) remove(q->path.c_str());
  delete q;
}

}  // extern "C"
