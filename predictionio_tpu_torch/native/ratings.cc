// Native training-infeed scan: event log -> dense rating triples.
//
// The reference's training read path hands Spark executors raw HBase rows
// that user DataSource code re-parses per event on the JVM
// (HBPEvents.scala:91-97 + the template's DataSource.scala:25-55). At 20M
// events the equivalent per-event Python decode costs minutes; this scan
// does the whole DataSource inner loop natively in one pass over the mmap'd
// log:
//
//   header prefilter (event-name hashes, tombstones)  ->
//   minimal JSON field extraction (entityId, targetEntityId,
//   properties.<prop>)  ->
//   first-occurrence id interning into dense int32 indices
//
// and returns int32/float32 arrays plus the two unique-id string pools.
// Python materializes only the unique ids (~1e5 objects), never the 20M
// per-event strings. Ordering matches evlog_scan: (event_time_ms, offset)
// ascending, so index assignment is identical to the Python streaming path
// run over the same scan.
//
// Value rules mirror the recommendation template's rate/buy pattern-match:
// per event-name either "read numeric property <prop_name>" or a fixed
// value. A record whose payload's "event" string does not byte-match the
// expected name for its header hash is skipped (the same 64-bit
// hash-collision re-verification the Python scan layer performs).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_map>
#include <vector>

#include <sys/mman.h>

#include "eventlog_internal.h"

using pio::Handle;
using pio::kFlagTombstone;
using pio::kHeaderSize;
using pio::RecordHeader;
using pio::refresh_size;

namespace {

// ---------------------------------------------------------------------------
// Minimal JSON walker: enough to pull two string fields and one numeric
// property out of a trusted wire-format event dict (the log only ever stores
// payloads our own writer serialized; malformed payloads are skipped).
// ---------------------------------------------------------------------------
struct JsonCursor {
  const char* p;
  const char* end;
  bool ok = true;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      p++;
  }
  bool at(char c) {
    skip_ws();
    return p < end && *p == c;
  }
  bool eat(char c) {
    skip_ws();
    if (p < end && *p == c) {
      p++;
      return true;
    }
    ok = false;
    return false;
  }
  // Parse a JSON string starting at '"'; append decoded bytes to out.
  bool parse_string(std::string* out) {
    if (!eat('"')) return false;
    // fast path: span to the closing quote contains no escapes
    {
      const char* q =
          (const char*)memchr(p, '"', (size_t)(end - p));
      if (q == nullptr) { ok = false; return false; }
      if (memchr(p, '\\', (size_t)(q - p)) == nullptr) {
        if (out) out->append(p, (size_t)(q - p));
        p = q + 1;
        return true;
      }
    }
    while (p < end) {
      char c = *p++;
      if (c == '"') return true;
      if (c != '\\') {
        if (out) out->push_back(c);
        continue;
      }
      if (p >= end) break;
      char e = *p++;
      switch (e) {
        case '"': if (out) out->push_back('"'); break;
        case '\\': if (out) out->push_back('\\'); break;
        case '/': if (out) out->push_back('/'); break;
        case 'b': if (out) out->push_back('\b'); break;
        case 'f': if (out) out->push_back('\f'); break;
        case 'n': if (out) out->push_back('\n'); break;
        case 'r': if (out) out->push_back('\r'); break;
        case 't': if (out) out->push_back('\t'); break;
        case 'u': {
          if (end - p < 4) { ok = false; return false; }
          unsigned cp = 0;
          for (int i = 0; i < 4; i++) {
            char h = *p++;
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= (unsigned)(h - '0');
            else if (h >= 'a' && h <= 'f') cp |= (unsigned)(h - 'a' + 10);
            else if (h >= 'A' && h <= 'F') cp |= (unsigned)(h - 'A' + 10);
            else { ok = false; return false; }
          }
          // UTF-8 encode (surrogate pairs: encode each half as-is is wrong,
          // but our writer never emits raw surrogates — json.dumps uses
          // ensure_ascii=False or pairs; handle pairs correctly anyway).
          if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 && p[0] == '\\' &&
              p[1] == 'u') {
            unsigned lo = 0;
            const char* q = p + 2;
            bool good = true;
            for (int i = 0; i < 4; i++) {
              char h = q[i];
              lo <<= 4;
              if (h >= '0' && h <= '9') lo |= (unsigned)(h - '0');
              else if (h >= 'a' && h <= 'f') lo |= (unsigned)(h - 'a' + 10);
              else if (h >= 'A' && h <= 'F') lo |= (unsigned)(h - 'A' + 10);
              else { good = false; break; }
            }
            if (good && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              p += 6;
            }
          }
          if (out) {
            if (cp < 0x80) out->push_back((char)cp);
            else if (cp < 0x800) {
              out->push_back((char)(0xC0 | (cp >> 6)));
              out->push_back((char)(0x80 | (cp & 0x3F)));
            } else if (cp < 0x10000) {
              out->push_back((char)(0xE0 | (cp >> 12)));
              out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
              out->push_back((char)(0x80 | (cp & 0x3F)));
            } else {
              out->push_back((char)(0xF0 | (cp >> 18)));
              out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
              out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
              out->push_back((char)(0x80 | (cp & 0x3F)));
            }
          }
          break;
        }
        default:
          ok = false;
          return false;
      }
    }
    ok = false;
    return false;
  }
  // Skip any JSON value.
  bool skip_value() {
    skip_ws();
    if (p >= end) { ok = false; return false; }
    char c = *p;
    if (c == '"') return parse_string(nullptr);
    if (c == '{' || c == '[') {
      char open = c, close = (c == '{') ? '}' : ']';
      int depth = 0;
      bool in_str = false;
      while (p < end) {
        char d = *p++;
        if (in_str) {
          if (d == '\\') { if (p < end) p++; }
          else if (d == '"') in_str = false;
        } else {
          if (d == '"') in_str = true;
          else if (d == open) depth++;
          else if (d == close) {
            if (--depth == 0) return true;
          }
        }
      }
      ok = false;
      return false;
    }
    // number / true / false / null
    while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != ' ' &&
           *p != '\t' && *p != '\n' && *p != '\r')
      p++;
    return true;
  }
  bool parse_number(double* out) {
    // Locale-independent: strtod honors LC_NUMERIC (a host process that
    // setlocale()d to a comma-decimal locale would silently truncate
    // "4.5" at the dot), so parse the JSON number grammar by hand.
    skip_ws();
    const char* q = p;
    bool neg = false;
    if (q < end && (*q == '-' || *q == '+')) { neg = (*q == '-'); q++; }
    double v = 0.0;
    const char* digits_start = q;
    while (q < end && *q >= '0' && *q <= '9') v = v * 10.0 + (*q++ - '0');
    if (q == digits_start) { ok = false; return false; }
    if (q < end && *q == '.') {
      q++;
      double scale = 0.1;
      while (q < end && *q >= '0' && *q <= '9') {
        v += (*q++ - '0') * scale;
        scale *= 0.1;
      }
    }
    if (q < end && (*q == 'e' || *q == 'E')) {
      q++;
      bool eneg = false;
      if (q < end && (*q == '-' || *q == '+')) { eneg = (*q == '-'); q++; }
      int ex = 0;
      const char* exp_start = q;
      while (q < end && *q >= '0' && *q <= '9') ex = ex * 10 + (*q++ - '0');
      if (q == exp_start) { ok = false; return false; }
      double f = 1.0;
      for (int i = 0; i < ex && i < 350; i++) f *= 10.0;
      v = eneg ? v / f : v * f;
    }
    *out = neg ? -v : v;
    p = q;
    return true;
  }
};

struct ParsedEvent {
  // Reused across records: clear() keeps string capacity, so steady-state
  // parsing allocates nothing for repeat-length ids.
  std::string event;
  std::string entity_id;
  std::string target_id;
  bool has_target = false;
  double prop_val = 0.0;
  bool has_prop = false;

  void reset() {
    event.clear();
    entity_id.clear();
    target_id.clear();
    has_target = false;
    prop_val = 0.0;
    has_prop = false;
  }
};

// Allocation-free key scan: copy the next JSON string into buf (cap bytes)
// IF it contains no escapes and fits; otherwise fall back to full parse
// into spill. Returns length, or -1 on error; *spilled set when fallback.
int key_scan(JsonCursor* c, char* buf, int cap, std::string* spill,
             bool* spilled) {
  *spilled = false;
  c->skip_ws();
  if (c->p >= c->end || *c->p != '"') { c->ok = false; return -1; }
  const char* q = c->p + 1;
  int n = 0;
  while (q < c->end && n < cap) {
    char ch = *q;
    if (ch == '"') {
      memcpy(buf, c->p + 1, (size_t)n);
      c->p = q + 1;
      return n;
    }
    if (ch == '\\') break;  // escaped key: rare — full parse
    q++;
    n++;
  }
  spill->clear();
  if (!c->parse_string(spill)) return -1;
  *spilled = true;
  return (int)spill->size();
}

// Walk the top-level object, extracting event/entityId/targetEntityId and
// properties.<prop_name>. Returns false on malformed payload.
bool parse_event_payload(const char* data, int64_t len, const char* prop_name,
                         size_t prop_len, ParsedEvent* out,
                         std::string* scratch) {
  JsonCursor c{data, data + len};
  if (!c.eat('{')) return false;
  if (c.at('}')) return true;
  char kbuf[40];
  while (c.ok) {
    bool spilled;
    int klen = key_scan(&c, kbuf, (int)sizeof(kbuf), scratch, &spilled);
    if (klen < 0) return false;
    const char* key = spilled ? scratch->data() : kbuf;
    if (!c.eat(':')) return false;
    if (klen == 5 && memcmp(key, "event", 5) == 0) {
      if (!c.parse_string(&out->event)) return false;
    } else if (klen == 8 && memcmp(key, "entityId", 8) == 0) {
      if (!c.parse_string(&out->entity_id)) return false;
    } else if (klen == 14 && memcmp(key, "targetEntityId", 14) == 0) {
      if (c.at('n')) {  // null
        if (!c.skip_value()) return false;
      } else {
        if (!c.parse_string(&out->target_id)) return false;
        out->has_target = true;
      }
    } else if (klen == 10 && memcmp(key, "properties", 10) == 0 &&
               prop_len > 0) {
      // descend one level looking for prop_name
      if (!c.eat('{')) return false;
      if (!c.at('}')) {
        while (c.ok) {
          int plen = key_scan(&c, kbuf, (int)sizeof(kbuf), scratch, &spilled);
          if (plen < 0) return false;
          const char* pkey = spilled ? scratch->data() : kbuf;
          if (!c.eat(':')) return false;
          if ((size_t)plen == prop_len &&
              memcmp(pkey, prop_name, prop_len) == 0) {
            if (!c.parse_number(&out->prop_val)) return false;
            out->has_prop = true;
          } else {
            if (!c.skip_value()) return false;
          }
          if (c.at(',')) { c.eat(','); continue; }
          break;
        }
      }
      if (!c.eat('}')) return false;
    } else {
      if (!c.skip_value()) return false;
    }
    if (c.at(',')) { c.eat(','); continue; }
    break;
  }
  return c.eat('}');
}

// First-occurrence string interner (dense index assignment). Lookups take
// the caller's reusable buffer by reference — repeat ids (the overwhelming
// majority at 145 ratings/user) allocate nothing.
struct Interner {
  std::unordered_map<std::string, int32_t> map;
  std::deque<std::string> order;  // index -> id string

  int32_t index(const std::string& s) {
    auto it = map.find(s);
    if (it != map.end()) return it->second;
    int32_t idx = (int32_t)order.size();
    order.push_back(s);
    map.emplace(order.back(), idx);
    return idx;
  }
};

struct HeaderMatch {
  int64_t time_ms;
  int64_t off;
  int64_t len;
  int32_t rule;  // index into the value-rule arrays
};

struct RatingsResult {
  std::vector<int32_t> users;
  std::vector<int32_t> items;
  std::vector<float> vals;
  Interner user_ix;
  Interner item_ix;
  int32_t error = 0;  // counts of skipped malformed payloads
};

}  // namespace

extern "C" {

// Scan the log for live records whose event hash is one of event_hashes.
// Per event i: value_is_prop[i] != 0 -> read properties.<prop_name>
// (required; missing -> record skipped + counted in *out_bad), else the
// fixed value fixed_vals[i]. event_names is the concatenation of the
// expected event-name strings (NUL-separated, n entries) for exact
// re-verification against the payload. Records without a target entity are
// skipped. Returns an opaque result handle (free with evlog_ratings_free),
// or nullptr on mmap failure. The number of ratings is written to *out_n.
void* evlog_ratings_scan(void* vh, const uint64_t* event_hashes,
                         const int32_t* value_is_prop,
                         const double* fixed_vals, int32_t n_events,
                         const char* event_names, const char* prop_name,
                         int64_t* out_n, int64_t* out_bad) {
  auto* h = (Handle*)vh;
  *out_n = 0;
  *out_bad = 0;
  int64_t size;
  {
    std::lock_guard<std::mutex> lock(h->mu);
    refresh_size(h);
    size = h->size;
  }
  auto* res = new RatingsResult();
  if (size < (int64_t)kHeaderSize) return res;
  void* map = mmap(nullptr, (size_t)size, PROT_READ, MAP_SHARED, h->fd, 0);
  if (map == MAP_FAILED) {
    delete res;
    return nullptr;
  }
  madvise(map, (size_t)size, MADV_SEQUENTIAL);
  const uint8_t* base = (const uint8_t*)map;

  // split the NUL-separated expected names
  std::vector<std::string> names;
  {
    const char* q = event_names;
    for (int32_t i = 0; i < n_events; i++) {
      names.emplace_back(q);
      q += names.back().size() + 1;
    }
  }
  std::unordered_map<uint64_t, int32_t> rule_of;
  for (int32_t i = 0; i < n_events; i++) rule_of.emplace(event_hashes[i], i);

  // pass 1: header walk — live matches with order-sensitive tombstones.
  // Fast path first: training logs almost never contain deletes, so walk
  // without per-id liveness tracking; on the first tombstone, restart with
  // the exact (order-sensitive) tracking walk.
  std::vector<HeaderMatch> matches;
  bool has_tombstone = false;
  {
    int64_t off = 0;
    while (off + (int64_t)kHeaderSize <= size) {
      RecordHeader hd;
      memcpy(&hd, base + off, kHeaderSize);
      if (hd.record_len < kHeaderSize || off + (int64_t)hd.record_len > size)
        break;
      if (hd.flags & kFlagTombstone) {
        has_tombstone = true;
        break;
      }
      if (hd.ttype_hash != 0) {  // target required
        auto it = rule_of.find(hd.event_hash);
        if (it != rule_of.end()) {
          matches.push_back({hd.event_time_ms, off + (int64_t)kHeaderSize,
                             (int64_t)hd.payload_len, it->second});
        }
      }
      off += hd.record_len;
    }
  }
  if (has_tombstone) {
    matches.clear();
    std::vector<bool> dead;
    std::unordered_map<uint64_t, std::vector<size_t>> live_by_id;
    int64_t off = 0;
    while (off + (int64_t)kHeaderSize <= size) {
      RecordHeader hd;
      memcpy(&hd, base + off, kHeaderSize);
      if (hd.record_len < kHeaderSize || off + (int64_t)hd.record_len > size)
        break;
      if (hd.flags & kFlagTombstone) {
        auto it = live_by_id.find(hd.id_hash);
        if (it != live_by_id.end()) {
          for (size_t i : it->second) dead[i] = true;
          live_by_id.erase(it);
        }
      } else if (hd.ttype_hash != 0) {
        auto it = rule_of.find(hd.event_hash);
        if (it != rule_of.end()) {
          live_by_id[hd.id_hash].push_back(matches.size());
          matches.push_back({hd.event_time_ms, off + (int64_t)kHeaderSize,
                             (int64_t)hd.payload_len, it->second});
          dead.push_back(false);
        }
      }
      off += hd.record_len;
    }
    std::vector<HeaderMatch> alive;
    alive.reserve(matches.size());
    for (size_t i = 0; i < matches.size(); i++)
      if (!dead[i]) alive.push_back(matches[i]);
    matches.swap(alive);
  }
  std::stable_sort(matches.begin(), matches.end(),
                   [](const HeaderMatch& a, const HeaderMatch& b) {
                     return a.time_ms != b.time_ms ? a.time_ms < b.time_ms
                                                   : a.off < b.off;
                   });

  // pass 2: payload parse + interning, in scan order
  res->users.reserve(matches.size());
  res->items.reserve(matches.size());
  res->vals.reserve(matches.size());
  ParsedEvent ev;
  std::string scratch;
  const size_t prop_len = prop_name ? strlen(prop_name) : 0;
  for (const auto& m : matches) {
    ev.reset();
    bool want_prop = value_is_prop[m.rule] != 0;
    if (!parse_event_payload((const char*)base + m.off, m.len,
                             want_prop ? prop_name : nullptr,
                             want_prop ? prop_len : 0, &ev, &scratch)) {
      (*out_bad)++;
      continue;
    }
    if (ev.event != names[(size_t)m.rule]) continue;  // hash collision
    if (!ev.has_target) continue;  // header said target; payload disagrees
    float v;
    if (want_prop) {
      if (!ev.has_prop) {
        (*out_bad)++;
        continue;
      }
      v = (float)ev.prop_val;
    } else {
      v = (float)fixed_vals[m.rule];
    }
    res->users.push_back(res->user_ix.index(ev.entity_id));
    res->items.push_back(res->item_ix.index(ev.target_id));
    res->vals.push_back(v);
  }
  munmap(map, (size_t)size);
  *out_n = (int64_t)res->users.size();
  return res;
}

int64_t evlog_ratings_n_users(void* vr) {
  return (int64_t)((RatingsResult*)vr)->user_ix.order.size();
}
int64_t evlog_ratings_n_items(void* vr) {
  return (int64_t)((RatingsResult*)vr)->item_ix.order.size();
}

// Copy the rating triples into caller-allocated arrays of length *out_n.
void evlog_ratings_fill(void* vr, int32_t* users, int32_t* items,
                        float* vals) {
  auto* r = (RatingsResult*)vr;
  memcpy(users, r->users.data(), r->users.size() * sizeof(int32_t));
  memcpy(items, r->items.data(), r->items.size() * sizeof(int32_t));
  memcpy(vals, r->vals.data(), r->vals.size() * sizeof(float));
}

// Unique-id pools: total byte length of all ids concatenated (no
// separators); fill writes the bytes plus per-id end offsets (int64[n]).
static int64_t pool_bytes(const Interner& ix) {
  int64_t total = 0;
  for (const auto& s : ix.order) total += (int64_t)s.size();
  return total;
}
static void pool_fill(const Interner& ix, uint8_t* buf, int64_t* ends) {
  int64_t off = 0;
  int64_t i = 0;
  for (const auto& s : ix.order) {
    memcpy(buf + off, s.data(), s.size());
    off += (int64_t)s.size();
    ends[i++] = off;
  }
}

int64_t evlog_ratings_user_pool_bytes(void* vr) {
  return pool_bytes(((RatingsResult*)vr)->user_ix);
}
int64_t evlog_ratings_item_pool_bytes(void* vr) {
  return pool_bytes(((RatingsResult*)vr)->item_ix);
}
void evlog_ratings_user_pool_fill(void* vr, uint8_t* buf, int64_t* ends) {
  pool_fill(((RatingsResult*)vr)->user_ix, buf, ends);
}
void evlog_ratings_item_pool_fill(void* vr, uint8_t* buf, int64_t* ends) {
  pool_fill(((RatingsResult*)vr)->item_ix, buf, ends);
}

void evlog_ratings_free(void* vr) { delete (RatingsResult*)vr; }

}  // extern "C"
