// Shared internals of the native event log (record layout + handle), used
// by eventlog.cc (storage engine) and ratings.cc (training-infeed scan).
// See eventlog.cc for the format documentation.

#ifndef PIO_EVENTLOG_INTERNAL_H_
#define PIO_EVENTLOG_INTERNAL_H_

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace pio {

constexpr uint32_t kHeaderSize = 80;
constexpr uint32_t kFlagTombstone = 1u;

#pragma pack(push, 1)
struct RecordHeader {
  uint32_t record_len;
  uint32_t flags;
  int64_t event_time_ms;
  int64_t creation_time_ms;
  uint64_t etype_hash;
  uint64_t entity_hash;
  uint64_t event_hash;
  uint64_t ttype_hash;
  uint64_t target_hash;
  uint64_t id_hash;
  uint32_t payload_len;
  uint32_t reserved;
};
#pragma pack(pop)

static_assert(sizeof(RecordHeader) == kHeaderSize, "header must be 80 bytes");

struct Handle {
  int fd = -1;
  int64_t size = 0;       // committed (validated) file size
  int64_t n_records = 0;  // records incl. tombstones
  std::mutex mu;
  std::string path;
};

// RAII advisory whole-file lock (cross-process append serialization).
struct FileLock {
  int fd;
  bool held;
  explicit FileLock(int fd_) : fd(fd_), held(flock(fd_, LOCK_EX) == 0) {}
  ~FileLock() {
    if (held) flock(fd, LOCK_UN);
  }
};

// Validate records in [from, file_size); set *committed to the offset of the
// first invalid byte and *count to the number of valid records seen. Returns
// false when the file could not be inspected at all (mmap failure) — callers
// must NOT truncate in that case.
inline bool validate_range(int fd, int64_t file_size, int64_t from,
                           int64_t* committed, int64_t* count) {
  *committed = from;
  *count = 0;
  if (file_size - from < (int64_t)kHeaderSize) return true;
  void* map = mmap(nullptr, (size_t)file_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) return false;
  const uint8_t* base = (const uint8_t*)map;
  int64_t off = from;
  while (off + (int64_t)kHeaderSize <= file_size) {
    RecordHeader h;
    memcpy(&h, base + off, kHeaderSize);
    if (h.record_len < kHeaderSize || h.record_len % 8 != 0 ||
        off + (int64_t)h.record_len > file_size ||
        h.payload_len > h.record_len - kHeaderSize) {
      break;
    }
    off += h.record_len;
    (*count)++;
  }
  munmap(map, (size_t)file_size);
  *committed = off;
  return true;
}

// Pick up records appended through other handles/processes (O_APPEND writers
// on the same file): extend h->size over any newly committed tail. Caller
// must hold h->mu. On inspection failure the old bound is kept (safe: scans
// just miss the newest records until the next successful refresh).
inline void refresh_size(Handle* h) {
  struct stat st;
  if (fstat(h->fd, &st) != 0) return;
  if ((int64_t)st.st_size <= h->size) return;
  int64_t committed, count;
  if (validate_range(h->fd, (int64_t)st.st_size, h->size, &committed, &count)) {
    h->size = committed;
    h->n_records += count;
  }
}

}  // namespace pio

#endif  // PIO_EVENTLOG_INTERNAL_H_
