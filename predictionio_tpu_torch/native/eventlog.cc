// Native append-only event log with mmap bulk scans.
//
// The storage-plane replacement for the reference's HBase events backend
// (data/src/main/scala/io/prediction/data/storage/hbase/: HBEventsUtil.scala
// row-key + scan push-down, HBLEvents.scala point ops, HBPEvents.scala bulk
// region scans). Where the reference pushes SingleColumnValueFilter/time-range
// predicates to regionservers (HBEventsUtil.scala:280-404), this log stores
// fixed 80-byte numeric headers per record and scans them with mmap at memory
// bandwidth; only records surviving the numeric prefilter have their JSON
// payload decoded by the Python layer (which also re-verifies exact string
// matches, so 64-bit hash collisions cannot produce wrong results for
// inserts; tombstone matching is hash-exact only).
//
// Record layout (little-endian, 8-byte aligned):
//   u32 record_len        total bytes incl. header, multiple of 8
//   u32 flags             bit0 = tombstone (delete marker)
//   i64 event_time_ms
//   i64 creation_time_ms
//   u64 etype_hash        fnv1a64(entityType)
//   u64 entity_hash       fnv1a64(entityType \0 entityId)
//   u64 event_hash        fnv1a64(event name)
//   u64 ttype_hash        fnv1a64(targetEntityType), 0 when no target
//   u64 target_hash       fnv1a64(targetType \0 targetId), 0 when no target
//   u64 id_hash           fnv1a64(event_id string)
//   u32 payload_len       JSON payload bytes (record_len - 80 >= payload_len)
//   u32 reserved
//   u8  payload[...]      UTF-8 JSON (the event's wire-format dict)
//
// A tombstone record carries the id_hash of the deleted event; it is always
// appended after the insert it deletes, so a single forward pass that
// collects candidate matches and the tombstone set, then filters, is exact.
//
// Concurrency: appends are serialized by a per-handle mutex within a
// process and an advisory flock(2) across processes (multiple handles on
// one log — the event server + `pio import` coexistence case). The lock
// makes the append's write(2) + rollback atomic with respect to other
// writers, and open-time torn-tail truncation can never clip a record
// another live process is mid-appending. Scans take no lock: they bound
// themselves to the last validated size, so a concurrent append is either
// fully visible or not yet scanned. Open truncates any torn tail left by a
// crashed process (under the same lock).
//
// Multi-writer scaling happens a level up (storage/native_events.py): N
// ingest processes each append to their own segment FILE of the same app
// (this library sees each segment as an independent log, so per-file flock
// is uncontended), and reads merge segments. The Python layer keeps the
// ordering invariant that makes merged tombstone filtering exact: segments
// hold only fresh-id inserts; tombstones and same-id re-inserts live in
// the primary log only (see evlog_tombstones below).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "eventlog_internal.h"

using pio::FileLock;
using pio::Handle;
using pio::kFlagTombstone;
using pio::kHeaderSize;
using pio::RecordHeader;
using pio::refresh_size;
using pio::validate_range;

namespace {

struct Match {
  int64_t time_ms;
  int64_t off;  // payload offset in file
  int64_t len;  // payload length
  uint64_t id_hash;
};

}  // namespace

extern "C" {

uint64_t evlog_fnv1a64(const uint8_t* data, int64_t len) {
  uint64_t h = 14695981039346656037ull;
  for (int64_t i = 0; i < len; i++) {
    h ^= (uint64_t)data[i];
    h *= 1099511628211ull;
  }
  return h ? h : 1;  // 0 is reserved for "absent / don't care"
}

void* evlog_open(const char* path) {
  int fd = open(path, O_RDWR | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  // Exclusive lock: no other process is mid-append while we validate (and
  // possibly truncate) the tail, so an in-flight record can't be clipped.
  FileLock lock(fd);
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  auto* h = new Handle();
  h->fd = fd;
  h->path = path;
  if (!validate_range(fd, (int64_t)st.st_size, 0, &h->size, &h->n_records)) {
    // Could not inspect the file (mmap failure): refuse to open rather than
    // risk truncating valid data on a transient error.
    close(fd);
    delete h;
    return nullptr;
  }
  if (h->size < (int64_t)st.st_size) {
    // torn tail from a crash: drop it
    if (ftruncate(fd, (off_t)h->size) != 0) { /* keep going; scans use h->size */ }
  }
  return h;
}

void evlog_close(void* vh) {
  auto* h = (Handle*)vh;
  if (!h) return;
  if (h->fd >= 0) close(h->fd);
  delete h;
}

int64_t evlog_count(void* vh) { return ((Handle*)vh)->n_records; }
int64_t evlog_size(void* vh) { return ((Handle*)vh)->size; }

int evlog_sync(void* vh) {
  auto* h = (Handle*)vh;
  std::lock_guard<std::mutex> lock(h->mu);
  return fdatasync(h->fd) == 0 ? 0 : -errno;
}

namespace {

// Fill one record header (shared by single and batch append paths).
void fill_header(RecordHeader* hdr, uint32_t flags, int64_t event_time_ms,
                 int64_t creation_time_ms, uint64_t etype_hash,
                 uint64_t entity_hash, uint64_t event_hash,
                 uint64_t ttype_hash, uint64_t target_hash, uint64_t id_hash,
                 uint32_t payload_len) {
  memset(hdr, 0, sizeof(*hdr));
  hdr->record_len = kHeaderSize + ((payload_len + 7u) & ~7u);
  hdr->flags = flags;
  hdr->event_time_ms = event_time_ms;
  hdr->creation_time_ms = creation_time_ms;
  hdr->etype_hash = etype_hash;
  hdr->entity_hash = entity_hash;
  hdr->event_hash = event_hash;
  hdr->ttype_hash = ttype_hash;
  hdr->target_hash = target_hash;
  hdr->id_hash = id_hash;
  hdr->payload_len = payload_len;
}

// Append a pre-serialized run of n_new records under the handle mutex +
// advisory file lock: full-write-or-rollback, then fold any foreign
// appends into the handle's size/count accounting. Returns the file
// offset where the run begins, or -errno.
int64_t append_locked(Handle* h, const uint8_t* data, int64_t total,
                      int64_t n_new) {
  std::lock_guard<std::mutex> lock(h->mu);
  FileLock flock_guard(h->fd);  // serialize with other processes' appends
  ssize_t written = 0;
  while (written < (ssize_t)total) {
    ssize_t w = write(h->fd, data + written, (size_t)total - written);
    if (w <= 0) {
      int saved = errno ? errno : EIO;
      if (written > 0) {
        // Partial write: under the file lock no other writer can
        // interleave, so the last `written` bytes are exactly ours —
        // roll them back.
        struct stat st;
        if (fstat(h->fd, &st) == 0) {
          if (ftruncate(h->fd, (off_t)(st.st_size - written)) != 0) {
            /* scans remain bounded by validated sizes */
          }
        }
      }
      return -(int64_t)saved;
    }
    written += w;
  }
  // Our run ends at the current file end (O_APPEND). Fold in anything
  // other writers appended before us as well.
  struct stat st;
  if (fstat(h->fd, &st) != 0) {
    h->size += total;  // fallback: at least account for our own write
    h->n_records += n_new;
    return h->size - total;
  }
  int64_t end = (int64_t)st.st_size;
  if (end - total > h->size) {
    int64_t committed, count;
    if (validate_range(h->fd, end - total, h->size, &committed, &count)) {
      h->n_records += count;
    }
  }
  h->size = end;
  h->n_records += n_new;
  return end - total;
}

}  // namespace

// Append one record. Returns payload offset in file, or -errno.
int64_t evlog_append(void* vh, uint32_t flags, int64_t event_time_ms,
                     int64_t creation_time_ms, uint64_t etype_hash,
                     uint64_t entity_hash, uint64_t event_hash,
                     uint64_t ttype_hash, uint64_t target_hash,
                     uint64_t id_hash, const uint8_t* payload,
                     uint32_t payload_len) {
  auto* h = (Handle*)vh;
  uint32_t record_len = kHeaderSize + ((payload_len + 7u) & ~7u);
  std::vector<uint8_t> buf(record_len, 0);
  RecordHeader hdr;
  fill_header(&hdr, flags, event_time_ms, creation_time_ms, etype_hash,
              entity_hash, event_hash, ttype_hash, target_hash, id_hash,
              payload_len);
  memcpy(buf.data(), &hdr, kHeaderSize);
  if (payload_len) memcpy(buf.data() + kHeaderSize, payload, payload_len);
  int64_t start = append_locked(h, buf.data(), record_len, 1);
  if (start < 0) return start;
  return start + (int64_t)kHeaderSize;
}

// Append a batch of insert records under ONE lock acquisition and ONE
// write(2): the bulk-import fast path (`pio import`, PEvents.write parity —
// the reference batches via saveAsNewAPIHadoopDataset, HBPEvents.scala:
// 166-184). payload_blob holds all payloads concatenated; payload_ends[i]
// is the exclusive end offset of payload i. All records are plain inserts
// (flags=0). Returns the number appended (== n), or -errno; on a partial
// write the whole batch is rolled back (truncate under the lock), so the
// batch is atomic with respect to durability.
int64_t evlog_append_batch(void* vh, int64_t n, const int64_t* event_time_ms,
                           const int64_t* creation_time_ms,
                           const uint64_t* etype_hash,
                           const uint64_t* entity_hash,
                           const uint64_t* event_hash,
                           const uint64_t* ttype_hash,
                           const uint64_t* target_hash,
                           const uint64_t* id_hash,
                           const uint8_t* payload_blob,
                           const int64_t* payload_ends) {
  auto* h = (Handle*)vh;
  // serialize every record into one contiguous buffer
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t start = i == 0 ? 0 : payload_ends[i - 1];
    uint32_t plen = (uint32_t)(payload_ends[i] - start);
    total += kHeaderSize + ((plen + 7u) & ~7u);
  }
  std::vector<uint8_t> buf((size_t)total, 0);
  int64_t off = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t start = i == 0 ? 0 : payload_ends[i - 1];
    uint32_t plen = (uint32_t)(payload_ends[i] - start);
    RecordHeader hdr;
    fill_header(&hdr, 0, event_time_ms[i], creation_time_ms[i],
                etype_hash[i], entity_hash[i], event_hash[i], ttype_hash[i],
                target_hash[i], id_hash[i], plen);
    memcpy(buf.data() + off, &hdr, kHeaderSize);
    if (plen) memcpy(buf.data() + off + kHeaderSize, payload_blob + start, plen);
    off += hdr.record_len;
  }

  int64_t start = append_locked(h, buf.data(), total, n);
  if (start < 0) return start;
  return n;
}

// Bulk scan with predicate push-down. Any hash argument of 0 means "any";
// start_ms/until_ms of INT64_MIN/INT64_MAX mean unbounded; has_target:
// -1 any, 0 must-have-no-target, 1 must-have-target. Matches are sorted by
// (event_time_ms, file offset) ascending. Returns the total number of
// matches; only the first `cap` (payload offset, payload len, event time
// ms, id hash) tuples are written to out_off/out_len/out_time/out_id
// (out_id may be null when the caller does not need cross-segment
// tombstone filtering). Call again with a larger cap if truncated.
int64_t evlog_scan(void* vh, int64_t start_ms, int64_t until_ms,
                   uint64_t etype_hash, uint64_t entity_hash,
                   const uint64_t* event_hashes, int32_t n_event_hashes,
                   uint64_t ttype_hash, uint64_t target_hash,
                   int32_t has_target, int64_t* out_off, int64_t* out_len,
                   int64_t* out_time, uint64_t* out_id, int64_t cap) {
  auto* h = (Handle*)vh;
  int64_t size;
  {
    std::lock_guard<std::mutex> lock(h->mu);
    refresh_size(h);
    size = h->size;
  }
  if (size < (int64_t)kHeaderSize) return 0;
  void* map = mmap(nullptr, (size_t)size, PROT_READ, MAP_SHARED, h->fd, 0);
  if (map == MAP_FAILED) return -(int64_t)errno;
  madvise(map, (size_t)size, MADV_SEQUENTIAL);
  const uint8_t* base = (const uint8_t*)map;

  std::unordered_set<uint64_t> ev_set;
  for (int32_t i = 0; i < n_event_hashes; i++) ev_set.insert(event_hashes[i]);
  // Order-sensitive tombstones: a delete marker only kills records appended
  // BEFORE it, so an id re-inserted after a delete stays live (matching the
  // upsert semantics of the SQLite backend). live_by_id tracks, per id_hash,
  // the indices of not-yet-killed matches.
  std::vector<Match> matches;
  std::vector<bool> dead_flags;
  std::unordered_map<uint64_t, std::vector<size_t>> live_by_id;

  int64_t off = 0;
  while (off + (int64_t)kHeaderSize <= size) {
    RecordHeader hd;
    memcpy(&hd, base + off, kHeaderSize);
    if (hd.record_len < kHeaderSize || off + (int64_t)hd.record_len > size)
      break;  // defensive; open() validated the tail
    if (hd.flags & kFlagTombstone) {
      auto it = live_by_id.find(hd.id_hash);
      if (it != live_by_id.end()) {
        for (size_t i : it->second) dead_flags[i] = true;
        live_by_id.erase(it);
      }
    } else {
      bool ok = hd.event_time_ms >= start_ms && hd.event_time_ms < until_ms;
      if (ok && etype_hash && hd.etype_hash != etype_hash) ok = false;
      if (ok && entity_hash && hd.entity_hash != entity_hash) ok = false;
      if (ok && n_event_hashes > 0 && !ev_set.count(hd.event_hash)) ok = false;
      if (ok && ttype_hash && hd.ttype_hash != ttype_hash) ok = false;
      if (ok && target_hash && hd.target_hash != target_hash) ok = false;
      if (ok && has_target == 0 && hd.ttype_hash != 0) ok = false;
      if (ok && has_target == 1 && hd.ttype_hash == 0) ok = false;
      if (ok) {
        live_by_id[hd.id_hash].push_back(matches.size());
        matches.push_back({hd.event_time_ms, off + (int64_t)kHeaderSize,
                           (int64_t)hd.payload_len, hd.id_hash});
        dead_flags.push_back(false);
      }
    }
    off += hd.record_len;
  }
  munmap(map, (size_t)size);

  {
    std::vector<Match> alive;
    alive.reserve(matches.size());
    for (size_t i = 0; i < matches.size(); i++) {
      if (!dead_flags[i]) alive.push_back(matches[i]);
    }
    matches.swap(alive);
  }
  std::stable_sort(matches.begin(), matches.end(),
                   [](const Match& a, const Match& b) {
                     return a.time_ms != b.time_ms ? a.time_ms < b.time_ms
                                                   : a.off < b.off;
                   });
  int64_t n = (int64_t)matches.size();
  int64_t write_n = std::min(n, cap);
  for (int64_t i = 0; i < write_n; i++) {
    out_off[i] = matches[i].off;
    out_len[i] = matches[i].len;
    out_time[i] = matches[i].time_ms;
    if (out_id) out_id[i] = matches[i].id_hash;
  }
  return n;
}

// All tombstone id hashes in the log (the primary log's delete/upsert
// markers). Multi-segment reads subtract this set from secondary-segment
// matches: segments hold only fresh-id inserts (ids that did not exist
// before being appended there and are never re-inserted there), so ANY
// tombstone for an id kills that id's segment records — no ordering
// needed across files. Returns the total count; fills up to cap.
int64_t evlog_tombstones(void* vh, uint64_t* out, int64_t cap) {
  auto* h = (Handle*)vh;
  int64_t size;
  {
    std::lock_guard<std::mutex> lock(h->mu);
    refresh_size(h);
    size = h->size;
  }
  if (size < (int64_t)kHeaderSize) return 0;
  void* map = mmap(nullptr, (size_t)size, PROT_READ, MAP_SHARED, h->fd, 0);
  if (map == MAP_FAILED) return -(int64_t)errno;
  madvise(map, (size_t)size, MADV_SEQUENTIAL);
  const uint8_t* base = (const uint8_t*)map;
  int64_t n = 0;
  int64_t off = 0;
  while (off + (int64_t)kHeaderSize <= size) {
    RecordHeader hd;
    memcpy(&hd, base + off, kHeaderSize);
    if (hd.record_len < kHeaderSize || off + (int64_t)hd.record_len > size)
      break;
    if (hd.flags & kFlagTombstone) {
      if (n < cap && out) out[n] = hd.id_hash;
      n++;
    }
    off += hd.record_len;
  }
  munmap(map, (size_t)size);
  return n;
}

// Latest record with the given id_hash. Returns 1 and fills
// out_off/out_len (payload) when the latest is a live record, -1 when the
// latest is a tombstone (deleted — multi-segment readers stop here rather
// than probing other segments), 0 when the id never appears.
int32_t evlog_get(void* vh, uint64_t id_hash, int64_t* out_off,
                  int64_t* out_len) {
  auto* h = (Handle*)vh;
  int64_t size;
  {
    std::lock_guard<std::mutex> lock(h->mu);
    refresh_size(h);
    size = h->size;
  }
  if (size < (int64_t)kHeaderSize) return 0;
  void* map = mmap(nullptr, (size_t)size, PROT_READ, MAP_SHARED, h->fd, 0);
  if (map == MAP_FAILED) return 0;
  const uint8_t* base = (const uint8_t*)map;
  int64_t found_off = -1, found_len = 0;
  bool dead = false, seen = false;
  int64_t off = 0;
  while (off + (int64_t)kHeaderSize <= size) {
    RecordHeader hd;
    memcpy(&hd, base + off, kHeaderSize);
    if (hd.record_len < kHeaderSize || off + (int64_t)hd.record_len > size)
      break;
    if (hd.id_hash == id_hash) {
      seen = true;
      if (hd.flags & kFlagTombstone) {
        dead = true;
      } else {
        found_off = off + (int64_t)kHeaderSize;
        found_len = (int64_t)hd.payload_len;
        dead = false;
      }
    }
    off += hd.record_len;
  }
  munmap(map, (size_t)size);
  if (!seen) return 0;
  if (found_off < 0 || dead) return -1;
  *out_off = found_off;
  *out_len = found_len;
  return 1;
}

}  // extern "C"
