// Native BGZF/BAM codec for bsseqconsensusreads_tpu.
//
// The reference delegates its hot record I/O to C (htslib via pysam and
// samtools; SURVEY.md §2.2). This is the framework's equivalent: a zlib-based
// BGZF stream codec plus a columnar record parser that converts the BAM
// alignment stream straight into flat arrays (positions, flags, base codes,
// quals, cigars, MI/RX tags) so the Python layer never touches per-record
// objects on the hot path. Exposed as a plain C ABI for ctypes
// (bsseqconsensusreads_tpu/io/native.py); the pure-Python codec remains the
// fallback.
//
// Build: make -C native   (produces libbamio.so)

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

constexpr size_t kMaxBlock = 65536;

// FNV-1a 64-bit over raw bytes — the one byte-loop hash in this file,
// shared by the grouper's `flushed` reappearance set and the encode
// scan's qname/RX tables. The flushed set exists ONLY for the
// refragmented diagnostic counter, but it must remember every family
// ever closed: as std::string entries it would grow to ~3 GB over a
// 100M-read run (38M keys x ~80 B of node+SSO+malloc); 8-byte hashes
// cut that ~4x, and a collision (p ~ 4e-5 at 38M keys) can only nudge
// a counter, never the grouping.
inline uint64_t fnv1a64(const uint8_t* p, size_t n) {
  uint64_t h = 14695981039346656037ull;
  for (size_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

inline uint64_t fnv1a64(const std::string& s) {
  return fnv1a64(reinterpret_cast<const uint8_t*>(s.data()), s.size());
}

struct MtInflate;

struct Reader {
  FILE* fh = nullptr;
  std::vector<uint8_t> carry;  // decompressed bytes not yet consumed
  size_t carry_off = 0;
  std::vector<uint8_t> pending;  // parsed-but-unreturned record body
  bool last_block_empty = false;
  bool eof = false;
  std::string err;
  MtInflate* mt = nullptr;  // parallel-inflate pipeline (bamio_open_mt)
};

struct Writer {
  FILE* fh = nullptr;
  std::vector<uint8_t> buf;
  int level = 6;
  std::string err;
};

bool compress_block(const uint8_t* data, size_t n, int level,
                    std::vector<uint8_t>& out, std::string& err);

// Shared BGZF payload chunking: fill `buf` to exactly 65280 bytes, then
// hand off via flush() (which must leave buf ready for refill). One source
// of truth for the block-boundary invariant both writers' byte-identical
// guarantee rests on.
template <typename FlushFn>
int buffered_write(std::vector<uint8_t>& buf, const uint8_t* data, int64_t n,
                   FlushFn flush) {
  int64_t off = 0;
  while (off < n) {
    size_t room = 65280 - buf.size();
    size_t take = size_t(n - off) < room ? size_t(n - off) : room;
    buf.insert(buf.end(), data + off, data + off + take);
    off += take;
    if (buf.size() == 65280) {
      if (!flush()) return -1;
    }
  }
  return 0;
}

// ---- multi-threaded BGZF writer ----
//
// BGZF parallelizes trivially: each 64 KB block compresses independently
// and the file is their in-order concatenation, so a worker pool behind
// the same 65280-byte chunking produces BYTE-IDENTICAL output to the
// single-threaded writer (tests/test_native.py asserts it). The submitting
// thread drains completed jobs from the queue front in submission order;
// a bounded queue applies backpressure so memory stays O(threads) blocks.

struct MtJob {
  std::vector<uint8_t> raw;    // uncompressed payload
  std::vector<uint8_t> block;  // finished on-disk block
  bool claimed = false;
  bool done = false;
  bool failed = false;
  std::string err;
};

struct MtWriter {
  FILE* fh = nullptr;
  int level = 6;
  std::string err;
  std::vector<uint8_t> buf;
  std::deque<std::unique_ptr<MtJob>> queue;  // submission order
  std::mutex mu;
  std::condition_variable cv_work;  // workers wait: unclaimed job / stop
  std::condition_variable cv_done;  // submitter waits: front done / room
  std::vector<std::thread> workers;
  bool stop = false;
  size_t max_queue = 16;

  ~MtWriter() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }
};

void mt_worker(MtWriter* w) {
  for (;;) {
    MtJob* job = nullptr;
    {
      std::unique_lock<std::mutex> lk(w->mu);
      w->cv_work.wait(lk, [&] {
        if (w->stop) return true;
        for (auto& j : w->queue)
          if (!j->claimed) return true;
        return false;
      });
      if (w->stop) return;
      for (auto& j : w->queue)
        if (!j->claimed) {
          j->claimed = true;
          job = j.get();
          break;
        }
    }
    if (!job) continue;
    std::string err;
    const bool ok =
        compress_block(job->raw.data(), job->raw.size(), w->level, job->block, err);
    {
      std::lock_guard<std::mutex> lk(w->mu);
      job->done = true;
      job->failed = !ok;
      job->err = err;
    }
    w->cv_done.notify_all();
  }
}

// Write out every completed job at the queue front; when `all`, wait for
// the whole queue to drain. Returns false (setting w->err) on any failure.
bool mt_drain(MtWriter* w, bool all) {
  std::unique_lock<std::mutex> lk(w->mu);
  for (;;) {
    while (!w->queue.empty() && w->queue.front()->done) {
      std::unique_ptr<MtJob> job = std::move(w->queue.front());
      w->queue.pop_front();
      if (job->failed) {
        w->err = job->err;
        return false;
      }
      lk.unlock();  // fwrite outside the lock: workers keep compressing
      const bool ok =
          fwrite(job->block.data(), 1, job->block.size(), w->fh) ==
          job->block.size();
      lk.lock();
      if (!ok) {
        w->err = "write failed";
        return false;
      }
    }
    const bool blocked =
        all ? !w->queue.empty()
            : (w->queue.size() >= w->max_queue && !w->queue.front()->done);
    if (!blocked) return true;
    w->cv_done.wait(lk, [&] {
      return !w->queue.empty() && w->queue.front()->done;
    });
  }
}

bool mt_submit(MtWriter* w, std::vector<uint8_t>&& payload) {
  if (!mt_drain(w, false)) return false;  // backpressure + in-order writes
  {
    std::lock_guard<std::mutex> lk(w->mu);
    auto job = std::make_unique<MtJob>();
    job->raw = std::move(payload);
    w->queue.push_back(std::move(job));
  }
  w->cv_work.notify_one();
  return true;
}

const uint8_t kEofBlock[28] = {0x1f, 0x8b, 0x08, 0x04, 0,    0,    0,    0,
                               0,    0xff, 0x06, 0x00, 0x42, 0x43, 0x02, 0x00,
                               0x1b, 0x00, 0x03, 0x00, 0,    0,    0,    0,
                               0,    0,    0,    0};

// nt16 code -> framework base code (A=0 C=1 G=2 T=3 N/other=4)
const int8_t kNt16ToCode[16] = {4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4};

// One on-disk BGZF block, fetched but not yet inflated.
struct RawBlock {
  std::vector<uint8_t> cdata;
  uint32_t crc = 0;
  uint32_t isize = 0;
};

// Read the next block's compressed payload from the stream. Sequential —
// one caller at a time owns the FILE*. `last_empty` is the EOF-marker
// state (BGZF ends with an empty block): carried across calls, validated
// when fread hits EOF. Returns 1 = block fetched, 0 = clean EOF,
// -1 = error (err set).
int fetch_raw_block(FILE* fh, RawBlock& b, bool& last_empty,
                    std::string& err) {
  uint8_t head[12];
  size_t got = fread(head, 1, 12, fh);
  if (got == 0) {
    if (!last_empty) {
      err = "BGZF EOF marker missing (file truncated?)";
      return -1;
    }
    return 0;
  }
  if (got < 12 || head[0] != 0x1f || head[1] != 0x8b || head[2] != 8 ||
      !(head[3] & 4)) {
    err = "not a BGZF stream";
    return -1;
  }
  uint16_t xlen = uint16_t(head[10]) | (uint16_t(head[11]) << 8);
  std::vector<uint8_t> extra(xlen);
  if (fread(extra.data(), 1, xlen, fh) != xlen) {
    err = "truncated BGZF extra field";
    return -1;
  }
  int bsize = -1;
  for (size_t off = 0; off + 4 <= extra.size();) {
    uint8_t si1 = extra[off], si2 = extra[off + 1];
    uint16_t slen = uint16_t(extra[off + 2]) | (uint16_t(extra[off + 3]) << 8);
    if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
      bsize = (int(extra[off + 4]) | (int(extra[off + 5]) << 8)) + 1;
      break;
    }
    off += 4 + slen;
  }
  if (bsize < 0) {
    err = "BGZF block missing BC subfield";
    return -1;
  }
  long cdata_len = long(bsize) - 12 - xlen - 8;
  if (cdata_len < 0) {
    err = "corrupt BGZF BSIZE";
    return -1;
  }
  b.cdata.resize(cdata_len);
  uint8_t tail[8];
  if (fread(b.cdata.data(), 1, cdata_len, fh) != size_t(cdata_len) ||
      fread(tail, 1, 8, fh) != 8) {
    err = "truncated BGZF block";
    return -1;
  }
  b.crc = uint32_t(tail[0]) | (uint32_t(tail[1]) << 8) |
          (uint32_t(tail[2]) << 16) | (uint32_t(tail[3]) << 24);
  b.isize = uint32_t(tail[4]) | (uint32_t(tail[5]) << 8) |
            (uint32_t(tail[6]) << 16) | (uint32_t(tail[7]) << 24);
  if (b.isize > kMaxBlock) {
    // untrusted 32-bit field: bounding it here keeps a corrupt block from
    // driving huge allocations (fatal in a worker thread, where bad_alloc
    // would escape to std::terminate instead of an IOError)
    err = "corrupt BGZF ISIZE";
    return -1;
  }
  last_empty = (b.isize == 0);
  return 1;
}

// Inflate + CRC-check one fetched block into out[b.isize]. Pure function
// of the block — safe from any thread.
bool inflate_block(const RawBlock& b, uint8_t* out, std::string& err) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) {
    err = "inflateInit failed";
    return false;
  }
  zs.next_in = const_cast<uint8_t*>(b.cdata.data());
  zs.avail_in = uInt(b.cdata.size());
  zs.next_out = out;
  zs.avail_out = b.isize;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || zs.total_out != b.isize) {
    err = "BGZF inflate failed / ISIZE mismatch";
    return false;
  }
  if (crc32(0L, out, b.isize) != b.crc) {
    err = "BGZF CRC mismatch";
    return false;
  }
  return true;
}

// --- multi-threaded inflate pipeline (the read-side twin of MtWriter) ----
// The consumer thread fetches compressed blocks sequentially (cheap — page
// cache memcpys) into a bounded in-order queue; workers inflate+CRC them
// concurrently; delivery pops strictly in fetch order, so the decompressed
// stream is byte-identical to the single-threaded path.

struct InflJob {
  RawBlock raw;
  std::vector<uint8_t> out;
  bool done = false;
  std::string err;  // non-empty = this block failed
};

struct MtInflate {
  std::mutex mu;
  std::condition_variable cv_work;  // workers: todo became non-empty / stop
  std::condition_variable cv_done;  // consumer: a job completed
  std::deque<std::shared_ptr<InflJob>> order;  // delivery order, in flight
  std::deque<std::shared_ptr<InflJob>> todo;   // not yet taken by a worker
  std::vector<std::thread> workers;
  bool stop = false;
  bool fetch_eof = false;     // no more blocks will be fetched
  std::string fetch_err;      // terminal fetch error (delivered last)
  size_t window = 32;         // max blocks in flight (~4 MB ceiling)
};

void mt_inflate_worker(MtInflate* m) {
  std::unique_lock<std::mutex> lk(m->mu);
  while (true) {
    m->cv_work.wait(lk, [&] { return m->stop || !m->todo.empty(); });
    if (m->todo.empty()) return;  // stop && drained
    std::shared_ptr<InflJob> job = m->todo.front();
    m->todo.pop_front();
    lk.unlock();
    std::string err;
    job->out.resize(job->raw.isize);
    bool ok = job->raw.isize == 0 ||
              inflate_block(job->raw, job->out.data(), err);
    lk.lock();
    if (!ok) job->err = err;
    job->done = true;
    m->cv_done.notify_all();
  }
}

// Top the fetch window back up. Runs on the consumer thread (sole owner of
// the FILE*); locks only around queue mutation, never around fread.
void mt_fill(Reader* r) {
  MtInflate* m = r->mt;
  while (true) {
    {
      std::lock_guard<std::mutex> lk(m->mu);
      if (m->fetch_eof || m->order.size() >= m->window) return;
    }
    auto job = std::make_shared<InflJob>();
    std::string err;
    int rc = fetch_raw_block(r->fh, job->raw, r->last_block_empty, err);
    std::lock_guard<std::mutex> lk(m->mu);
    if (rc <= 0) {
      m->fetch_eof = true;
      if (rc < 0) m->fetch_err = err;
      return;
    }
    m->order.push_back(job);
    m->todo.push_back(job);
    m->cv_work.notify_one();
  }
}

// MT replacement for the synchronous block append below: deliver the next
// inflated block, in fetch order, into the carry.
bool mt_next_block(Reader* r) {
  MtInflate* m = r->mt;
  mt_fill(r);
  std::shared_ptr<InflJob> job;
  {
    std::unique_lock<std::mutex> lk(m->mu);
    if (m->order.empty()) {
      if (!m->fetch_err.empty()) {
        r->err = m->fetch_err;
        return false;
      }
      r->eof = true;
      return true;
    }
    job = m->order.front();
    m->cv_done.wait(lk, [&] { return job->done; });
    m->order.pop_front();
  }
  if (!job->err.empty()) {
    r->err = job->err;
    return false;
  }
  if (r->carry_off > 0) {  // compact the carry before appending
    r->carry.erase(r->carry.begin(), r->carry.begin() + r->carry_off);
    r->carry_off = 0;
  }
  size_t old = r->carry.size();
  r->carry.resize(old + job->out.size());
  if (!job->out.empty())
    memcpy(r->carry.data() + old, job->out.data(), job->out.size());
  mt_fill(r);  // keep workers busy while the parser chews this block
  return true;
}

bool read_block(Reader* r) {
  if (r->mt) return mt_next_block(r);
  RawBlock b;
  int rc = fetch_raw_block(r->fh, b, r->last_block_empty, r->err);
  if (rc < 0) return false;
  if (rc == 0) {
    r->eof = true;
    return true;
  }
  // compact the carry before appending
  if (r->carry_off > 0) {
    r->carry.erase(r->carry.begin(), r->carry.begin() + r->carry_off);
    r->carry_off = 0;
  }
  size_t old = r->carry.size();
  r->carry.resize(old + b.isize);
  if (b.isize > 0 && !inflate_block(b, r->carry.data() + old, r->err))
    return false;
  return true;
}

// ensure >= n unconsumed bytes in carry; false on eof-before-n or error
bool ensure(Reader* r, size_t n) {
  while (r->carry.size() - r->carry_off < n) {
    if (r->eof) return false;
    if (!read_block(r)) return false;
  }
  return true;
}

// Compress one payload into a complete on-disk BGZF block (header +
// deflate stream + crc/isize tail). Pure function of (data, level) — the
// single-threaded and multi-threaded writers produce identical bytes.
bool compress_block(const uint8_t* data, size_t n, int level,
                    std::vector<uint8_t>& out, std::string& err) {
  std::vector<uint8_t> cdata(kMaxBlock);
  for (int attempt_level = level;; attempt_level = 0) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, attempt_level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK) {
      err = "deflateInit failed";
      return false;
    }
    zs.next_in = const_cast<uint8_t*>(data);
    zs.avail_in = uInt(n);
    zs.next_out = cdata.data();
    zs.avail_out = uInt(cdata.size());
    int rc = deflate(&zs, Z_FINISH);
    size_t clen = zs.total_out;
    deflateEnd(&zs);
    if (rc != Z_STREAM_END) {
      if (attempt_level != 0) continue;  // retry stored
      err = "deflate failed";
      return false;
    }
    size_t bsize = clen + 12 + 6 + 8;
    if (bsize > 65536) {
      if (attempt_level != 0) continue;
      err = "block too large even stored";
      return false;
    }
    uint8_t head[18] = {0x1f, 0x8b, 8,    4,    0, 0, 0, 0, 0,
                        0xff, 6,    0,    0x42, 0x43, 2, 0, 0, 0};
    uint16_t bs = uint16_t(bsize - 1);
    head[16] = uint8_t(bs & 0xff);
    head[17] = uint8_t(bs >> 8);
    uint32_t crc = crc32(0L, data, n);
    uint8_t tail[8] = {uint8_t(crc), uint8_t(crc >> 8), uint8_t(crc >> 16),
                       uint8_t(crc >> 24), uint8_t(n), uint8_t(n >> 8),
                       uint8_t(n >> 16), uint8_t(n >> 24)};
    out.clear();
    out.reserve(18 + clen + 8);
    out.insert(out.end(), head, head + 18);
    out.insert(out.end(), cdata.data(), cdata.data() + clen);
    out.insert(out.end(), tail, tail + 8);
    return true;
  }
}

bool flush_block(Writer* w, const uint8_t* data, size_t n) {
  std::vector<uint8_t> block;
  if (!compress_block(data, n, w->level, block, w->err)) return false;
  if (fwrite(block.data(), 1, block.size(), w->fh) != block.size()) {
    w->err = "write failed";
    return false;
  }
  return true;
}

inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// Extract a Z-type tag's value into out (NUL-terminated, truncated to w-1).
// graftguard: a tag that IS present but malformed — wrong type (not
// Z/H), empty value, or non-printable bytes — must be distinguishable
// from an absent tag, or the strict native path silently accepts
// records the Python engine refuses (faults.guard record_violation
// 'tag-shape'). Present-but-malformed writes this sentinel byte into
// the fixed-width slot; absent stays "" (faults.guard.TAG_MALFORMED
// mirrors the value).
static const char kTagMalformed = '\x01';

void find_z_tag(const uint8_t* tags, size_t n, const char* key, char* out,
                int w) {
  out[0] = '\0';
  size_t off = 0;
  while (off + 3 <= n) {
    char t0 = char(tags[off]), t1 = char(tags[off + 1]);
    char tc = char(tags[off + 2]);
    bool hit = (t0 == key[0] && t1 == key[1]);
    off += 3;
    size_t len = 0;
    switch (tc) {
      case 'A': case 'c': case 'C': len = 1; break;
      case 's': case 'S': len = 2; break;
      case 'i': case 'I': case 'f': len = 4; break;
      case 'Z': case 'H': {
        size_t e = off;
        while (e < n && tags[e] != 0) e++;
        if (hit) {
          size_t cnt = e - off;
          bool printable = cnt > 0;
          for (size_t i = off; i < e && printable; i++)
            printable = tags[i] >= 0x21 && tags[i] <= 0x7E;
          if (!printable) {
            out[0] = kTagMalformed;
            out[1] = '\0';
            return;
          }
          if (cnt > size_t(w - 1)) cnt = w - 1;
          memcpy(out, tags + off, cnt);
          out[cnt] = '\0';
          return;
        }
        off = e + 1;
        continue;
      }
      case 'B': {
        if (off + 5 > n) return;
        if (hit) {
          out[0] = kTagMalformed;
          out[1] = '\0';
          return;
        }
        char sub = char(tags[off]);
        uint32_t cnt = rd_u32(tags + off + 1);
        size_t esz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
        off += 5 + size_t(cnt) * esz;
        continue;
      }
      default:
        return;  // unknown tag type: stop scanning
    }
    if (hit) {  // present under a non-string type: malformed
      out[0] = kTagMalformed;
      out[1] = '\0';
      return;
    }
    off += len;
  }
}

// Locate the cd/ce/cB consensus per-base B-array tags in one tag-region
// walk (the duplex stage threads these raw molecular depths/errors/base
// histograms through to fgbio-unit ad/bd + exact-ce output,
// pipeline.calling._duplex_sidecar). Any integer subtype is accepted;
// values are widened/clamped to u16 at copy time.
struct BTagRef {
  const uint8_t* data = nullptr;
  uint32_t cnt = 0;
  char sub = 0;
};

// aux_len flag bit: the record's aux span carries the cB histogram
// (4n extra u16 after cd/ce). Mirrored in pipeline/ingest.py.
constexpr int32_t kAuxHasCb = 1 << 30;

void find_cdce_tags(const uint8_t* tags, size_t n, BTagRef& cd, BTagRef& ce,
                    BTagRef& cb) {
  size_t off = 0;
  while (off + 3 <= n) {
    char t0 = char(tags[off]), t1 = char(tags[off + 1]);
    char tc = char(tags[off + 2]);
    off += 3;
    switch (tc) {
      case 'A': case 'c': case 'C': off += 1; continue;
      case 's': case 'S': off += 2; continue;
      case 'i': case 'I': case 'f': off += 4; continue;
      case 'Z': case 'H': {
        while (off < n && tags[off] != 0) off++;
        off++;
        continue;
      }
      case 'B': {
        if (off + 5 > n) return;
        char sub = char(tags[off]);
        uint32_t cnt = rd_u32(tags + off + 1);
        size_t esz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
        if (off + 5 + size_t(cnt) * esz > n) return;
        if (t0 == 'c' && sub != 'f') {
          if (t1 == 'd') cd = BTagRef{tags + off + 5, cnt, sub};
          else if (t1 == 'e') ce = BTagRef{tags + off + 5, cnt, sub};
          else if (t1 == 'B') cb = BTagRef{tags + off + 5, cnt, sub};
        }
        off += 5 + size_t(cnt) * esz;
        continue;
      }
      default:
        return;  // unknown tag type: stop scanning
    }
  }
}

inline uint16_t btag_u16(const BTagRef& t, uint32_t i) {
  switch (t.sub) {
    case 'c': {
      int8_t v;
      std::memcpy(&v, t.data + i, 1);
      return uint16_t(v < 0 ? 0 : v);
    }
    case 'C':
      return t.data[i];
    case 's': {
      int16_t v;
      std::memcpy(&v, t.data + i * 2, 2);
      return uint16_t(v < 0 ? 0 : v);
    }
    case 'S': {
      uint16_t v;
      std::memcpy(&v, t.data + i * 2, 2);
      return v;
    }
    default: {  // i / I
      int32_t v;
      std::memcpy(&v, t.data + i * 4, 4);
      if (v < 0) v = 0;
      if (v > 65535) v = 65535;
      return uint16_t(v);
    }
  }
}

// ---- shared columnar record emission --------------------------------------

}  // namespace (reopened below: the stream reader is part of the C ABI)

extern "C" int64_t bamio_read(Reader* r, uint8_t* buf, int64_t n);

namespace {

// Output arrays + cursors for one columnar batch (the bamio_parse_records2
// surface). emit_record_body decodes one raw record body into the next slot.
struct ColumnarOut {
  int32_t* ref_id;
  int32_t* pos;
  uint16_t* flag;
  uint8_t* mapq;
  int32_t* l_seq;
  int32_t* next_ref;
  int32_t* next_pos;
  int32_t* tlen;
  uint16_t* n_cigar;
  uint8_t* seq_codes;
  uint8_t* quals;
  int64_t var_cap;
  int64_t* var_off;
  uint32_t* cigar;
  int64_t cigar_cap;
  int64_t* cigar_off;
  char* qname;
  int qname_w;
  char* mi;
  int mi_w;
  char* rx;
  int rx_w;
  int64_t max_records;
  int64_t vused = 0, cused = 0, nrec = 0;
  int32_t* ref_span;
  int32_t* left_clip;
  int32_t* right_clip;
  uint8_t* cigar_flags;
  // cd/ce aux planes: per record, cd values then ce values (aux_len[i]
  // u16 each) at aux[aux_off[i]]; aux_len 0 = tags absent/unusable.
  // aux_cap = 2 * var_cap keeps "fits in var" implying "fits in aux"
  // whenever cnt <= l_seq (larger counts are treated as absent).
  uint16_t* aux = nullptr;
  int64_t aux_cap = 0;
  int64_t* aux_off = nullptr;
  int32_t* aux_len = nullptr;
  int64_t aux_used = 0;
};

bool record_fits(const uint8_t* p, ColumnarOut& o) {
  int32_t lseq = rd_i32(p + 16);
  uint16_t ncig = rd_u16(p + 12);
  return o.nrec < o.max_records && o.vused + lseq <= o.var_cap &&
         o.cused + ncig <= o.cigar_cap;
}

void emit_record_body(const uint8_t* p, size_t bs, ColumnarOut& o) {
  const int64_t nrec = o.nrec;
  int32_t lseq = rd_i32(p + 16);
  uint16_t ncig = rd_u16(p + 12);
  uint8_t l_qname = p[8];
  o.ref_id[nrec] = rd_i32(p + 0);
  o.pos[nrec] = rd_i32(p + 4);
  o.mapq[nrec] = p[9];
  o.n_cigar[nrec] = ncig;
  o.flag[nrec] = rd_u16(p + 14);
  o.l_seq[nrec] = lseq;
  o.next_ref[nrec] = rd_i32(p + 20);
  o.next_pos[nrec] = rd_i32(p + 24);
  o.tlen[nrec] = rd_i32(p + 28);
  size_t off = 32;
  {
    size_t cnt = l_qname - 1;
    if (cnt > size_t(o.qname_w - 1)) cnt = o.qname_w - 1;
    memcpy(o.qname + nrec * o.qname_w, p + off, cnt);
    o.qname[nrec * o.qname_w + cnt] = '\0';
  }
  off += l_qname;
  memcpy(o.cigar + o.cused, p + off, size_t(ncig) * 4);
  o.cigar_off[nrec] = o.cused;
  {
    int32_t rspan = 0;
    uint8_t cf = 0;
    const uint32_t* cg = o.cigar + o.cused;
    for (uint16_t k = 0; k < ncig; k++) {
      uint32_t op = cg[k] & 0xF, len = cg[k] >> 4;
      switch (op) {
        case 0: case 7: case 8: rspan += int32_t(len); break;  // M,=,X
        case 2: rspan += int32_t(len); cf |= 1; break;         // D
        case 3: rspan += int32_t(len); break;                  // N
        case 1: cf |= 1; break;                                // I
        case 5: cf |= 2; break;                                // H
        default: break;                                        // S,P
      }
    }
    int32_t lcl = 0, rcl = 0;
    if (ncig) {
      if ((cg[0] & 0xF) == 4) lcl = int32_t(cg[0] >> 4);
      if ((cg[ncig - 1] & 0xF) == 4) rcl = int32_t(cg[ncig - 1] >> 4);
    }
    o.ref_span[nrec] = rspan;
    o.left_clip[nrec] = lcl;
    o.right_clip[nrec] = rcl;
    o.cigar_flags[nrec] = cf;
  }
  o.cused += ncig;
  off += size_t(ncig) * 4;
  o.var_off[nrec] = o.vused;
  const uint8_t* sp = p + off;
  for (int32_t i = 0; i < lseq; i++) {
    uint8_t b = sp[i >> 1];
    uint8_t code = (i & 1) ? (b & 0xf) : (b >> 4);
    o.seq_codes[o.vused + i] = uint8_t(kNt16ToCode[code]);
  }
  off += (lseq + 1) / 2;
  memcpy(o.quals + o.vused, p + off, lseq);
  off += lseq;
  o.vused += lseq;
  find_z_tag(p + off, bs - off, "MI", o.mi + nrec * o.mi_w, o.mi_w);
  find_z_tag(p + off, bs - off, "RX", o.rx + nrec * o.rx_w, o.rx_w);
  if (o.aux != nullptr) {
    o.aux_off[nrec] = o.aux_used;
    o.aux_len[nrec] = 0;
    BTagRef cd, ce, cb;
    find_cdce_tags(p + off, bs - off, cd, ce, cb);
    if (cd.data && ce.data && cd.cnt == ce.cnt && cd.cnt &&
        int64_t(cd.cnt) <= int64_t(lseq) &&
        o.aux_used + 2 * int64_t(cd.cnt) <= o.aux_cap) {
      uint16_t* dst = o.aux + o.aux_used;
      for (uint32_t i = 0; i < cd.cnt; i++) dst[i] = btag_u16(cd, i);
      dst += cd.cnt;
      for (uint32_t i = 0; i < ce.cnt; i++) dst[i] = btag_u16(ce, i);
      o.aux_len[nrec] = int32_t(cd.cnt);
      o.aux_used += 2 * int64_t(cd.cnt);
      // cB histogram plane (4n values) appended when present + well
      // formed; flagged via kAuxHasCb in aux_len (the layout stays
      // [cd(n); ce(n)] for rows without it)
      if (cb.data && cb.cnt == 4 * cd.cnt &&
          o.aux_used + 4 * int64_t(cd.cnt) <= o.aux_cap) {
        dst += ce.cnt;
        for (uint32_t i = 0; i < cb.cnt; i++) dst[i] = btag_u16(cb, i);
        o.aux_len[nrec] |= kAuxHasCb;
        o.aux_used += 4 * int64_t(cd.cnt);
      }
    }
  }
  o.nrec++;
}

// graftguard structural validation: a record whose declared field
// lengths cannot fit its block size must be refused HERE — every
// downstream consumer (emit_record_body, ref_end_of_body, the tag
// walkers) indexes the body by these fields and would read past the
// buffer on a length-field lie. Byte-identical rule + message to the
// Python mirror (faults.guard.check_record_body) so both decode
// engines refuse the same record at the same index.
const char* body_check(const uint8_t* p, size_t bs) {
  static const char* kCorrupt = "corrupt record body (field/length mismatch)";
  if (bs < 32) return kCorrupt;
  uint8_t l_qname = p[8];
  uint16_t ncig = rd_u16(p + 12);
  int32_t lseq = rd_i32(p + 16);
  if (l_qname < 1 || lseq < 0) return kCorrupt;
  int64_t need = 32 + int64_t(l_qname) + 4 * int64_t(ncig) +
                 (int64_t(lseq) + 1) / 2 + int64_t(lseq);
  if (need > int64_t(bs)) return kCorrupt;
  return nullptr;
}

// Read one raw record body (sans block_size) from the stream.
// Returns 1 ok, 0 clean EOF, -1 error (r->err set).
int read_record_body(Reader* r, std::vector<uint8_t>& body) {
  uint8_t szbuf[4];
  int64_t got = bamio_read(r, szbuf, 4);
  if (got == 0) return 0;
  if (got != 4) {
    r->err = r->err.empty() ? "truncated record size" : r->err;
    return -1;
  }
  int32_t bs = rd_i32(szbuf);
  if (bs < 32 || bs > (1 << 28)) {
    r->err = "corrupt record size";
    return -1;
  }
  body.resize(bs);
  if (bamio_read(r, body.data(), bs) != bs) {
    r->err = r->err.empty() ? "truncated record body" : r->err;
    return -1;
  }
  const char* reason = body_check(body.data(), body.size());
  if (reason != nullptr) {
    r->err = reason;
    return -1;
  }
  return 1;
}

// ---- streaming coordinate MI-grouper --------------------------------------
//
// C-side equivalent of pipeline.calling.stream_mi_groups grouping
// 'coordinate' (flush a family once the sweep passes margin bases beyond
// its last read; insertion-ordered open set exactly like a Python dict;
// refragmented families counted, missing MI is an error). Families come
// back as CONTIGUOUS record runs inside otherwise-normal columnar batches,
// so the Python layer does no per-record grouping work at all.

struct OpenGroup {
  std::vector<std::vector<uint8_t>> bodies;
  int32_t ref_id = -1;
  int64_t max_end = -1;
  std::string key;
  bool live = true;
};

struct Grouper {
  int64_t margin = 10000;
  int64_t stride = 2500;
  bool strip = false;
  // adjacent mode (margin < 0 at bamio_group_start): groups are
  // delimited by MI change alone — exact for MI-contiguous input
  // whatever the template geometry (a cross-contig or wide-insert pair
  // would trip the coordinate sweep's position heuristics)
  bool adjacent = false;
  // insertion-ordered open set: slots + key->slot map; dead slots are
  // compacted during sweeps (mirrors Python dict iteration order)
  std::vector<OpenGroup> open;
  std::unordered_map<std::string, size_t> index;
  std::deque<OpenGroup> ready;
  std::unordered_set<uint64_t> flushed;
  int64_t refragmented = 0;
  int32_t last_ref = -1;
  int64_t last_pos = -(int64_t(1) << 62);
  bool source_done = false;
  std::string err;
};

int64_t ref_end_of_body(const uint8_t* p) {
  int64_t pos = rd_i32(p + 4);
  uint16_t ncig = rd_u16(p + 12);
  uint8_t l_qname = p[8];
  const uint8_t* cg = p + 32 + l_qname;
  int64_t span = 0;
  for (uint16_t k = 0; k < ncig; k++) {
    uint32_t v = rd_u32(cg + 4 * k);
    uint32_t op = v & 0xF;
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += v >> 4;
  }
  return pos + span;
}

// Full-length Z-tag lookup with a found flag (find_z_tag cannot
// distinguish an absent tag from an empty value, and its fixed-width
// output would truncate long grouping keys into silent merges).
bool z_tag_find(const uint8_t* tags, size_t n, const char* key,
                std::string& out) {
  size_t off = 0;
  while (off + 3 <= n) {
    char t0 = char(tags[off]), t1 = char(tags[off + 1]);
    char tc = char(tags[off + 2]);
    off += 3;
    size_t len = 0;
    switch (tc) {
      case 'A': case 'c': case 'C': len = 1; break;
      case 's': case 'S': len = 2; break;
      case 'i': case 'I': case 'f': len = 4; break;
      case 'Z': case 'H': {
        size_t e = off;
        while (e < n && tags[e] != 0) e++;
        if (t0 == key[0] && t1 == key[1]) {
          out.assign(reinterpret_cast<const char*>(tags + off), e - off);
          return true;
        }
        off = e + 1;
        continue;
      }
      case 'B': {
        if (off + 5 > n) return false;
        char sub = char(tags[off]);
        uint32_t cnt = rd_u32(tags + off + 1);
        size_t esz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
        off += 5 + size_t(cnt) * esz;
        continue;
      }
      default:
        return false;  // unknown tag type: stop scanning
    }
    off += len;
  }
  return false;
}

// MI key of one record body; returns false when the tag is ABSENT (an
// empty value is a legal key, matching the Python streamer).
bool mi_key_of_body(const uint8_t* p, size_t bs, bool strip,
                    std::string& key) {
  uint16_t ncig = rd_u16(p + 12);
  int32_t lseq = rd_i32(p + 16);
  uint8_t l_qname = p[8];
  size_t off = 32 + l_qname + size_t(ncig) * 4 + (lseq + 1) / 2 + lseq;
  if (off >= bs) return false;
  if (!z_tag_find(p + off, bs - off, "MI", key)) return false;
  if (strip) {
    size_t slash = key.find('/');
    if (slash != std::string::npos) key.resize(slash);
  }
  return true;
}

void grouper_sweep(Grouper& g, int32_t ref_id, int64_t pos) {
  // flush done groups in insertion order, then compact dead slots
  bool any_dead = false;
  for (auto& og : g.open) {
    if (!og.live) continue;
    if (og.ref_id != ref_id || og.max_end + g.margin < pos) {
      g.flushed.insert(fnv1a64(og.key));
      g.index.erase(og.key);
      og.live = false;
      g.ready.push_back(std::move(og));
      any_dead = true;
    }
  }
  if (any_dead) {
    std::vector<OpenGroup> kept;
    kept.reserve(g.open.size());
    for (auto& og : g.open)
      if (og.live) {
        g.index[og.key] = kept.size();
        kept.push_back(std::move(og));
      }
    g.open.swap(kept);
  }
  g.last_ref = ref_id;
  g.last_pos = pos;
}

// Feed one record; returns false on missing MI (g.err set to the qname).
bool grouper_feed(Grouper& g, std::vector<uint8_t>&& body) {
  const uint8_t* p = body.data();
  std::string key;
  if (!mi_key_of_body(p, body.size(), g.strip, key)) {
    uint8_t l_qname = p[8];
    g.err.assign(reinterpret_cast<const char*>(p + 32),
                 l_qname ? l_qname - 1 : 0);
    return false;
  }
  int32_t ref_id = rd_i32(p + 0);
  int64_t pos = rd_i32(p + 4);
  if (g.adjacent) {
    if (!g.open.empty() && g.index.find(key) == g.index.end()) {
      // MI changed: flush every live group (at most one in this mode)
      for (auto& og : g.open)
        if (og.live) {
          g.flushed.insert(fnv1a64(og.key));
          og.live = false;
          g.ready.push_back(std::move(og));
        }
      g.open.clear();
      g.index.clear();
    }
  } else if (pos >= 0 && !g.open.empty() &&
             (ref_id != g.last_ref || pos - g.last_pos >= g.stride)) {
    grouper_sweep(g, ref_id, pos);
  }
  auto it = g.index.find(key);
  if (it == g.index.end()) {
    if (g.flushed.count(fnv1a64(key))) g.refragmented++;
    g.index[key] = g.open.size();
    g.open.emplace_back();
    g.open.back().key = key;
    it = g.index.find(key);
  }
  OpenGroup& og = g.open[it->second];
  if (pos >= 0 && !g.adjacent) {  // adjacent mode never reads max_end
    int64_t end = ref_end_of_body(p);
    if (og.max_end < 0 || og.ref_id != ref_id) {
      og.ref_id = ref_id;
      og.max_end = end;
    } else if (end > og.max_end) {
      og.max_end = end;
    }
  }
  og.bodies.push_back(std::move(body));
  return true;
}

}  // namespace

extern "C" {

Reader* bamio_open(const char* path, char* err, int errlen) {
  Reader* r = new Reader();
  r->fh = fopen(path, "rb");
  if (!r->fh) {
    snprintf(err, errlen, "cannot open %s", path);
    delete r;
    return nullptr;
  }
  return r;
}

// Open with `threads` parallel inflate workers (<=1 = plain bamio_open).
// The handle is interchangeable with bamio_open's everywhere (bamio_read,
// the columnar parsers, the grouper): only block decompression changes,
// the delivered byte stream is identical.
Reader* bamio_open_mt(const char* path, int threads, char* err, int errlen) {
  Reader* r = bamio_open(path, err, errlen);
  if (!r || threads <= 1) return r;
  r->mt = new MtInflate();
  for (int i = 0; i < threads; i++)
    r->mt->workers.emplace_back(mt_inflate_worker, r->mt);
  return r;
}

// Read up to n decompressed bytes. Returns bytes read (0 at EOF), -1 error.
int64_t bamio_read(Reader* r, uint8_t* buf, int64_t n) {
  int64_t total = 0;
  while (total < n) {
    size_t avail = r->carry.size() - r->carry_off;
    if (avail == 0) {
      if (r->eof) break;
      if (!read_block(r)) return -1;
      continue;
    }
    size_t take = size_t(n - total) < avail ? size_t(n - total) : avail;
    memcpy(buf + total, r->carry.data() + r->carry_off, take);
    r->carry_off += take;
    total += take;
  }
  return total;
}

const char* bamio_error(Reader* r) { return r->err.c_str(); }

void bamio_close(Reader* r) {
  if (r->mt) {
    {
      std::lock_guard<std::mutex> lk(r->mt->mu);
      r->mt->stop = true;
      r->mt->todo.clear();  // abandoned work: nothing will be delivered
    }
    r->mt->cv_work.notify_all();
    for (auto& t : r->mt->workers) t.join();
    delete r->mt;
  }
  if (r->fh) fclose(r->fh);
  delete r;
}

// Parse up to max_records alignment records into columnar arrays.
// Fixed per-record: ref_id, pos, flag, mapq, l_seq, next_ref, next_pos, tlen,
// n_cigar. Variable: seq codes + quals at var_off[i] (l_seq[i] bytes each,
// capacity var_cap), cigar ops at cigar_off[i] (n_cigar u32), qname/mi/rx
// fixed-width NUL-terminated strings. Also emits the per-record CIGAR
// digest the Python hot loops otherwise recompute per record: ref_span
// (reference bases consumed: M/D/N/=/X), left_clip/right_clip (terminal
// softclip lengths), cigar_flags (bit0 = has I/D, bit1 = has hardclip).
// Returns records parsed, -1 on error. Stops early (returning fewer) when
// a capacity would be exceeded; the blocking record is buffered internally
// and returned by the next call. (The numeric suffix versions the
// signature: loading a stale .so fails symbol lookup and triggers a
// rebuild instead of corrupting memory through a mismatched call. "3"
// added the cd/ce aux planes with per-record aux_off/aux_len; "4" appends
// the optional 4n cB histogram run, flagged via kAuxHasCb in aux_len —
// size aux_cap at 6*var_cap u16 elements so a var-capacity fit implies an
// aux fit even when every record carries cB. See ColumnarOut.)
int64_t bamio_parse_records4(
    Reader* r, int64_t max_records,
    int32_t* ref_id, int32_t* pos, uint16_t* flag, uint8_t* mapq,
    int32_t* l_seq, int32_t* next_ref, int32_t* next_pos, int32_t* tlen,
    uint16_t* n_cigar,
    uint8_t* seq_codes, uint8_t* quals, int64_t var_cap, int64_t* var_off,
    uint32_t* cigar, int64_t cigar_cap, int64_t* cigar_off,
    char* qname, int qname_w, char* mi, int mi_w, char* rx, int rx_w,
    int32_t* ref_span, int32_t* left_clip, int32_t* right_clip,
    uint8_t* cigar_flags,
    uint16_t* aux, int64_t aux_cap, int64_t* aux_off, int32_t* aux_len) {
  ColumnarOut o{ref_id, pos, flag, mapq, l_seq, next_ref, next_pos, tlen,
                n_cigar, seq_codes, quals, var_cap, var_off, cigar,
                cigar_cap, cigar_off, qname, qname_w, mi, mi_w, rx, rx_w,
                max_records, 0, 0, 0,
                ref_span, left_clip, right_clip, cigar_flags,
                aux, aux_cap, aux_off, aux_len};
  std::vector<uint8_t> body;
  while (o.nrec < max_records) {
    if (!r->pending.empty()) {
      body.swap(r->pending);
      r->pending.clear();
    } else {
      int rc = read_record_body(r, body);
      if (rc == 0) break;
      if (rc < 0)
        // mid-batch corruption: hand the already-parsed prefix back so
        // the caller can account the exact failing record index; the
        // pending error stays in r->err (bamio_error) and the caller
        // must not parse again. A clean leading failure keeps -1.
        return o.nrec > 0 ? o.nrec : -1;
    }
    if (!record_fits(body.data(), o)) {
      r->pending.swap(body);  // doesn't fit: hand back next call
      break;
    }
    emit_record_body(body.data(), body.size(), o);
  }
  return o.nrec;
}

Writer* bamio_create(const char* path, int level, char* err, int errlen) {
  Writer* w = new Writer();
  w->fh = fopen(path, "wb");
  w->level = level;
  if (!w->fh) {
    snprintf(err, errlen, "cannot create %s", path);
    delete w;
    return nullptr;
  }
  w->buf.reserve(65280);
  return w;
}

int bamio_write(Writer* w, const uint8_t* data, int64_t n) {
  return buffered_write(w->buf, data, n, [&] {
    if (!flush_block(w, w->buf.data(), w->buf.size())) return false;
    w->buf.clear();
    return true;
  });
}

const char* bamio_writer_error(Writer* w) { return w->err.c_str(); }

int bamio_finish(Writer* w) {
  int rc = 0;
  if (!w->buf.empty()) {
    if (!flush_block(w, w->buf.data(), w->buf.size())) rc = -1;
    w->buf.clear();
  }
  if (rc == 0 && fwrite(kEofBlock, 1, 28, w->fh) != 28) rc = -1;
  if (fclose(w->fh) != 0) rc = -1;
  w->fh = nullptr;
  delete w;
  return rc;
}

// ---- multi-threaded writer ABI (byte-identical output to the above) ----

MtWriter* bamio_create_mt(const char* path, int level, int threads, char* err,
                          int errlen) {
  if (threads < 1) threads = 1;
  if (threads > 64) threads = 64;
  MtWriter* w = new MtWriter();
  w->fh = fopen(path, "wb");
  w->level = level;
  if (!w->fh) {
    snprintf(err, errlen, "cannot create %s", path);
    delete w;
    return nullptr;
  }
  w->buf.reserve(65280);
  w->max_queue = size_t(threads) * 4;
  for (int i = 0; i < threads; ++i)
    w->workers.emplace_back(mt_worker, w);
  return w;
}

int bamio_write_mt(MtWriter* w, const uint8_t* data, int64_t n) {
  if (!w->err.empty()) return -1;
  return buffered_write(w->buf, data, n, [&] {
    std::vector<uint8_t> payload;
    payload.reserve(65280);
    payload.swap(w->buf);
    w->buf.reserve(65280);
    return mt_submit(w, std::move(payload));
  });
}

const char* bamio_writer_error_mt(MtWriter* w) { return w->err.c_str(); }

int bamio_finish_mt(MtWriter* w) {
  // a recorded write/compress failure must fail the finish too — appending
  // the EOF marker to a truncated stream would make corruption look like a
  // validly terminated file
  int rc = w->err.empty() ? 0 : -1;
  if (rc == 0 && !w->buf.empty()) {
    if (!mt_submit(w, std::move(w->buf))) rc = -1;
  }
  if (rc == 0 && !mt_drain(w, true)) rc = -1;
  if (rc == 0 && fwrite(kEofBlock, 1, 28, w->fh) != 28) rc = -1;
  if (fclose(w->fh) != 0) rc = -1;
  w->fh = nullptr;
  delete w;  // joins workers
  return rc;
}

// ---- streaming coordinate MI-grouping (C ABI) -----------------------------

Grouper* bamio_group_start(int64_t margin, int strip) {
  Grouper* g = new Grouper();
  if (margin < 0) {  // sentinel: adjacent (MI-change-delimited) mode
    g->adjacent = true;
    margin = 0;
  }
  g->margin = margin;
  g->stride = margin / 4 > 0 ? margin / 4 : 1;
  g->strip = strip != 0;
  return g;
}

const char* bamio_group_error(Grouper* g) { return g->err.c_str(); }

int64_t bamio_group_refragmented(Grouper* g) { return g->refragmented; }

void bamio_group_free(Grouper* g) { delete g; }

// Grouped columnar parse: the bamio_parse_records4 output surface with
// records reordered into CONTIGUOUS whole-family runs (coordinate-sorted
// input; flush-margin semantics of pipeline.calling.stream_mi_groups
// 'coordinate', including insertion-order flushing and refragmentation
// counting). fam_nrec[i] records of family i are adjacent; fam_mi holds
// each family's (optionally /-stripped) MI key. Returns records emitted
// (0 = stream complete), -1 stream error (bamio_error), -2 record without
// an MI tag (bamio_group_error -> offending qname), -3 the next family
// alone exceeds a capacity (retry with larger buffers).
int64_t bamio_parse_grouped3(
    Reader* r, Grouper* g, int64_t max_records,
    int32_t* ref_id, int32_t* pos, uint16_t* flag, uint8_t* mapq,
    int32_t* l_seq, int32_t* next_ref, int32_t* next_pos, int32_t* tlen,
    uint16_t* n_cigar,
    uint8_t* seq_codes, uint8_t* quals, int64_t var_cap, int64_t* var_off,
    uint32_t* cigar, int64_t cigar_cap, int64_t* cigar_off,
    char* qname, int qname_w, char* mi, int mi_w, char* rx, int rx_w,
    int32_t* ref_span, int32_t* left_clip, int32_t* right_clip,
    uint8_t* cigar_flags,
    uint16_t* aux, int64_t aux_cap, int64_t* aux_off, int32_t* aux_len,
    char* fam_mi, int fam_mi_w, int32_t* fam_nrec, int64_t fam_cap,
    int64_t* n_fams) {
  ColumnarOut o{ref_id, pos, flag, mapq, l_seq, next_ref, next_pos, tlen,
                n_cigar, seq_codes, quals, var_cap, var_off, cigar,
                cigar_cap, cigar_off, qname, qname_w, mi, mi_w, rx, rx_w,
                max_records, 0, 0, 0,
                ref_span, left_clip, right_clip, cigar_flags,
                aux, aux_cap, aux_off, aux_len};
  std::vector<uint8_t> body;
  int64_t fams = 0;
  bool batch_full = false;
  while (!batch_full) {
    while (!g->ready.empty() && fams < fam_cap) {
      OpenGroup& og = g->ready.front();
      int64_t need_v = 0, need_c = 0;
      for (auto& b : og.bodies) {
        need_v += rd_i32(b.data() + 16);
        need_c += rd_u16(b.data() + 12);
      }
      if (o.nrec + int64_t(og.bodies.size()) > max_records ||
          o.vused + need_v > var_cap || o.cused + need_c > cigar_cap) {
        if (o.nrec == 0) return -3;  // one family bigger than the buffers
        batch_full = true;
        break;  // family stays queued for the next call
      }
      for (auto& b : og.bodies) emit_record_body(b.data(), b.size(), o);
      size_t cnt = og.key.size();
      if (cnt > size_t(fam_mi_w - 1)) cnt = size_t(fam_mi_w - 1);
      memcpy(fam_mi + fams * fam_mi_w, og.key.data(), cnt);
      fam_mi[fams * fam_mi_w + cnt] = '\0';
      fam_nrec[fams] = int32_t(og.bodies.size());
      fams++;
      g->ready.pop_front();
    }
    if (batch_full || o.nrec >= max_records || fams >= fam_cap) break;
    if (g->source_done && g->ready.empty()) break;
    if (g->source_done) continue;
    int rc = read_record_body(r, body);
    if (rc < 0) return -1;
    if (rc == 0) {
      g->source_done = true;
      // final flush: remaining open groups in insertion order
      for (auto& og : g->open)
        if (og.live) {
          og.live = false;
          g->ready.push_back(std::move(og));
        }
      g->open.clear();
      g->index.clear();
      continue;
    }
    if (!grouper_feed(*g, std::move(body))) return -2;
    body = std::vector<uint8_t>();  // reset the moved-from buffer
  }
  *n_fams = fams;
  return o.nrec;
}

}  // extern "C"

// ---- k-way raw-record merge (pipeline/extsort.py 'native' engine) ---------
//
// Merge sorted spill runs of encoded BAM records without any per-record
// Python: each run is an already-open Reader positioned just past its
// header, the output an already-open (single- or multi-threaded) BGZF
// writer. The comparator is EXACTLY pipeline.extsort.raw_coordinate_key's
// tuple order — (ref_id or 1<<30, pos or 1<<30, qname bytes, flag) — and
// ties prefer the LOWEST run index, matching heapq.merge's iterator-order
// stability, so the merged byte stream is identical to the Python
// engine's. Output rides the writer's normal 65280-byte block chunking,
// so the BGZF container is byte-identical too.

namespace {

struct MergeStream {
  Reader* r = nullptr;
  std::vector<uint8_t> rec;  // current record incl. its 4-byte prefix
  bool done = false;
  int64_t kref = 0, kpos = 0;
  int32_t qlen = 0;
  uint16_t kflag = 0;
};

// Pull the next record into s.rec; false on EOF or error (err set).
bool merge_advance(MergeStream& s, std::string& err) {
  uint8_t szbuf[4];
  int64_t got = bamio_read(s.r, szbuf, 4);
  if (got == 0) {
    s.done = true;
    return false;
  }
  if (got < 0) {
    err = s.r->err.empty() ? "read failed" : s.r->err;
    return false;
  }
  if (got < 4) {
    err = "truncated record size in spill run";
    return false;
  }
  int32_t bs;
  memcpy(&bs, szbuf, 4);
  if (bs < 32 || bs > (1 << 28)) {  // io/bam.py MIN/MAX_RECORD_SIZE
    err = "corrupt record size in spill run";
    return false;
  }
  s.rec.resize(size_t(bs) + 4);
  memcpy(s.rec.data(), szbuf, 4);
  if (bamio_read(s.r, s.rec.data() + 4, bs) != bs) {
    err = "truncated record body in spill run";
    return false;
  }
  const uint8_t* p = s.rec.data();
  int32_t ref, pos;
  memcpy(&ref, p + 4, 4);
  memcpy(&pos, p + 8, 4);
  s.kref = ref >= 0 ? ref : (int64_t(1) << 30);
  s.kpos = pos >= 0 ? pos : (int64_t(1) << 30);
  memcpy(&s.kflag, p + 18, 2);
  const int32_t lq = p[12];
  s.qlen = lq > 0 ? lq - 1 : 0;
  return true;
}

// strict-less on the raw_coordinate_key tuple (qname bytes compare like
// Python bytes: memcmp then shorter-prefix-first).
inline bool merge_less(const MergeStream& a, const MergeStream& b) {
  if (a.kref != b.kref) return a.kref < b.kref;
  if (a.kpos != b.kpos) return a.kpos < b.kpos;
  const int32_t n = a.qlen < b.qlen ? a.qlen : b.qlen;
  const int c = memcmp(a.rec.data() + 36, b.rec.data() + 36, size_t(n));
  if (c != 0) return c < 0;
  if (a.qlen != b.qlen) return a.qlen < b.qlen;
  return a.kflag < b.kflag;
}

}  // namespace

extern "C" {

// Merge n_runs sorted runs into `writer` (a Writer*, or an MtWriter* when
// writer_mt != 0 — its deflate worker pool is what the merge's BGZF
// compression rides on multi-core hosts). Readers must be positioned just
// past their BAM headers. Returns records written, or -1 with `err`
// filled. write_s (optional) accumulates the seconds spent inside the
// writer calls — the deflate/IO share of the merge, reported apart from
// the pure merge loop for the sort_write sub-attribution.
int64_t bamio_merge_runs(void** readers, int32_t n_runs, void* writer,
                         int32_t writer_mt, char* err, int32_t errlen,
                         double* write_s) {
  using clock = std::chrono::steady_clock;
  std::vector<MergeStream> streams(static_cast<size_t>(n_runs));
  std::string serr;
  for (int32_t i = 0; i < n_runs; ++i) {
    streams[size_t(i)].r = static_cast<Reader*>(readers[i]);
    if (!merge_advance(streams[size_t(i)], serr) &&
        !streams[size_t(i)].done) {
      snprintf(err, size_t(errlen), "run %d: %s", i, serr.c_str());
      return -1;
    }
  }
  std::vector<uint8_t> outbuf;
  outbuf.reserve(1 << 20);
  double wsec = 0.0;
  auto flush_out = [&]() -> bool {
    if (outbuf.empty()) return true;
    const auto t0 = clock::now();
    int rc;
    if (writer_mt)
      rc = bamio_write_mt(static_cast<MtWriter*>(writer), outbuf.data(),
                          int64_t(outbuf.size()));
    else
      rc = bamio_write(static_cast<Writer*>(writer), outbuf.data(),
                       int64_t(outbuf.size()));
    wsec += std::chrono::duration<double>(clock::now() - t0).count();
    outbuf.clear();
    return rc == 0;
  };
  int64_t n_out = 0;
  for (;;) {
    int32_t best = -1;
    for (int32_t i = 0; i < n_runs; ++i) {
      MergeStream& s = streams[size_t(i)];
      if (s.done) continue;
      if (best < 0 || merge_less(s, streams[size_t(best)])) best = i;
    }
    if (best < 0) break;
    MergeStream& s = streams[size_t(best)];
    outbuf.insert(outbuf.end(), s.rec.begin(), s.rec.end());
    ++n_out;
    if (outbuf.size() >= (1 << 20) && !flush_out()) {
      snprintf(err, size_t(errlen), "merge output write failed");
      return -1;
    }
    if (!merge_advance(s, serr) && !s.done) {
      snprintf(err, size_t(errlen), "run %d: %s", best, serr.c_str());
      return -1;
    }
  }
  if (!flush_out()) {
    snprintf(err, size_t(errlen), "merge output write failed");
    return -1;
  }
  if (write_s) *write_s = wsec;
  return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Molecular-encode digest: the C twin of the per-record pass in
// ops.encode.encode_molecular_families. The grouper above already hands
// families back as contiguous columnar runs; the scan below walks each run
// once, replicating the Python pass-1 semantics exactly (template pairing by
// fixed-width qname bytes with last-record-wins (qname, role) slots, RX
// majority with first-insertion tie-break, per-slot orientation votes,
// lo/hi window over every kept record), so the Python layer never touches
// individual records on the hot path. Fill then writes the [F, T, 2, W]
// tensors with straight memcpys.

namespace {

inline uint64_t enc_hash(const uint8_t* p, size_t n) {
  return fnv1a64(p, n);  // shared byte-loop hash (top of file)
}

// Fixed-width fields are NUL-padded from NUL-terminated values, so hashing
// and comparing strnlen+1 bytes is equivalent to the full width (the
// included NUL stops a prefix from matching a longer name) at a fraction
// of the byte work — qname_width is 256 for ~35-char names.
inline size_t enc_keylen(const uint8_t* p, size_t width) {
  size_t n = strnlen(reinterpret_cast<const char*>(p), width);
  return n < width ? n + 1 : width;
}

// Generation-stamped open-addressing scratch reused across families: reset()
// is O(1) except when capacity grows, so a 64k-record batch of small
// families pays no per-family clearing.
struct EncScratch {
  std::vector<int64_t> tbl_key;   // record index whose qname defines the entry
  std::vector<int32_t> tbl_ti;    // template row, -1 while est-only
  std::vector<uint32_t> tbl_gen;
  std::vector<int64_t> rtbl_key;  // record index whose RX defines the entry
  std::vector<int32_t> rtbl_idx;  // index into rx_* insertion-ordered lists
  std::vector<uint32_t> rtbl_gen;
  std::vector<int64_t> rx_count;
  std::vector<int64_t> rx_first;  // first record carrying this RX
  std::vector<int64_t> slot_rec;   // (ti, role) -> last record, -1 empty
  std::vector<uint8_t> slot_state;  // bit0 present, bit1 reverse-strand
  uint32_t gen = 0;
  size_t mask = 0;

  void reset(size_t nrec) {
    size_t cap = 16;
    while (cap < nrec * 2) cap <<= 1;
    if (cap > tbl_key.size()) {
      tbl_key.assign(cap, 0);
      tbl_ti.assign(cap, 0);
      tbl_gen.assign(cap, 0);
      rtbl_key.assign(cap, 0);
      rtbl_idx.assign(cap, 0);
      rtbl_gen.assign(cap, 0);
      gen = 0;
    }
    mask = tbl_key.size() - 1;
    gen++;
    rx_count.clear();
    rx_first.clear();
    slot_rec.clear();
    slot_state.clear();
  }
};

}  // namespace

extern "C" {

// Pass 1 over contiguous family runs [fam_start[f], fam_start[f]+fam_nrec[f]).
// Per record j: out_keep[j] 0 = dropped, 1 = direct-placed, 2 = pending
// indel (indel_policy 1 = 'align'); out_ti/out_role give the template slot.
// Per family f: out_lo/out_window (-1 when no record places), out_ntpl
// (distinct templates with a placed record — what encode materializes),
// out_ntpl_est (distinct qnames among hardclip/indel-kept records — the
// _kept_template_count the bucketed batcher and deep splitter use),
// out_rolerev (bit0/bit1 = majority reverse-orientation of role 0/1 slots),
// out_refid (last kept record's ref id), out_rx_rec (a record index whose RX
// is the family majority, -1 when none tagged). Returns 0.
int64_t bamio_encode_scan(
    int64_t n_fam, const int64_t* fam_start, const int32_t* fam_nrec,
    const uint16_t* flag, const int32_t* pos, const int32_t* ref_id,
    const int32_t* l_seq, const int64_t* var_off,
    const int32_t* left_clip, const int32_t* right_clip,
    const uint8_t* cigar_flags,
    const uint8_t* qname, int32_t qname_w,
    const uint8_t* rx, int32_t rx_w,
    int32_t indel_policy, int64_t indel_band,
    int64_t* out_lo, int64_t* out_window,
    int32_t* out_ntpl, int32_t* out_ntpl_est,
    uint8_t* out_rolerev, int32_t* out_refid, int64_t* out_rx_rec,
    int32_t* out_ti, uint8_t* out_role, uint8_t* out_keep) {
  (void)var_off;
  static thread_local EncScratch s;
  const bool drop_indels = indel_policy == 0;
  for (int64_t f = 0; f < n_fam; f++) {
    const int64_t start = fam_start[f];
    const int64_t nrec = fam_nrec[f];
    s.reset(size_t(nrec));
    int64_t lo = INT64_MAX, hi = INT64_MIN;
    int32_t refid = -1, ntpl = 0, est = 0;
    bool any = false;
    for (int64_t j = start; j < start + nrec; j++) {
      out_keep[j] = 0;
      out_ti[j] = -1;
      out_role[j] = 0;
      const uint8_t cf = cigar_flags[j];
      if (cf & 2) continue;  // hardclip: never encodes
      const bool has_indel = (cf & 1) != 0;
      if (has_indel && drop_indels) continue;
      // template entry (est counts it even when the read trims to nothing)
      const uint8_t* qn = qname + j * int64_t(qname_w);
      const size_t qlen = enc_keylen(qn, size_t(qname_w));
      size_t h = size_t(enc_hash(qn, qlen)) & s.mask;
      while (true) {
        if (s.tbl_gen[h] != s.gen) {
          s.tbl_gen[h] = s.gen;
          s.tbl_key[h] = j;
          s.tbl_ti[h] = -1;
          est++;
          break;
        }
        if (memcmp(qname + s.tbl_key[h] * int64_t(qname_w), qn, qlen) == 0)
          break;
        h = (h + 1) & s.mask;
      }
      const int64_t L =
          int64_t(l_seq[j]) - left_clip[j] - right_clip[j];
      if (L <= 0) continue;
      any = true;
      refid = ref_id[j];
      if (s.tbl_ti[h] < 0) {
        s.tbl_ti[h] = ntpl++;
        s.slot_rec.push_back(-1);
        s.slot_rec.push_back(-1);
        s.slot_state.push_back(0);
        s.slot_state.push_back(0);
      }
      const int32_t ti = s.tbl_ti[h];
      const int role = (flag[j] & 0x80) ? 1 : 0;  // FREAD2
      const size_t slot = size_t(ti) * 2 + size_t(role);
      if (s.slot_rec[slot] >= 0) out_keep[s.slot_rec[slot]] = 0;  // overwrite
      s.slot_rec[slot] = j;
      s.slot_state[slot] =
          uint8_t(1 | (((flag[j] >> 4) & 1) << 1));  // present | FREVERSE
      out_keep[j] = has_indel ? 2 : 1;
      out_ti[j] = ti;
      out_role[j] = uint8_t(role);
      // RX vote: absent/empty tag (NUL-led fixed-width field) not counted
      const uint8_t* rxp = rx + j * int64_t(rx_w);
      if (rxp[0] != 0) {
        const size_t rlen = enc_keylen(rxp, size_t(rx_w));
        size_t rh = size_t(enc_hash(rxp, rlen)) & s.mask;
        while (true) {
          if (s.rtbl_gen[rh] != s.gen) {
            s.rtbl_gen[rh] = s.gen;
            s.rtbl_key[rh] = j;
            s.rtbl_idx[rh] = int32_t(s.rx_count.size());
            s.rx_count.push_back(0);
            s.rx_first.push_back(j);
            break;
          }
          if (memcmp(rx + s.rtbl_key[rh] * int64_t(rx_w), rxp, rlen) == 0)
            break;
          rh = (rh + 1) & s.mask;
        }
        s.rx_count[size_t(s.rtbl_idx[rh])]++;
      }
      const int64_t p = pos[j];
      if (p < lo) lo = p;
      const int64_t e = p + L + (has_indel ? indel_band : 0);
      if (e > hi) hi = e;
    }
    out_lo[f] = any ? lo : -1;
    out_window[f] = any ? hi - lo : -1;
    out_ntpl[f] = ntpl;
    out_ntpl_est[f] = est;
    out_refid[f] = refid;
    // majority RX, ties to first inserted (Python max() over dict order)
    int64_t best = -1, best_n = 0;
    for (size_t k = 0; k < s.rx_count.size(); k++)
      if (s.rx_count[k] > best_n) {
        best_n = s.rx_count[k];
        best = s.rx_first[k];
      }
    out_rx_rec[f] = best;
    // per-role orientation vote over surviving (template, role) slots
    int votes[2][2] = {{0, 0}, {0, 0}};
    for (size_t k = 0; k < s.slot_state.size(); k++)
      if (s.slot_state[k] & 1) votes[k & 1][(s.slot_state[k] >> 1) & 1]++;
    out_rolerev[f] = uint8_t((votes[0][1] > votes[0][0] ? 1 : 0) |
                             (votes[1][1] > votes[1][0] ? 2 : 0));
  }
  return 0;
}

// Duplex-encode digest: the C twin of ops.encode.encode_duplex_families
// pass 1. Rows are keyed by exact flag value (the reference's 4-read group
// vocabulary, tools/2.extend_gap.py:117-131): 99->0, 163->1, 83->2, 147->3.
// Per record j: out_row[j] = 0..3 placed, -1 leftover (unknown flag,
// duplicate row, indel, or empty after trim), -2 hardclip-dropped (the
// reference silently drops these, never passes them through). Per family:
// out_start = max(lo-1, 0) (one margin column for the conversion prepend),
// out_window = hi-start (-1 when nothing places), out_rowmask (bit r =
// row r placed), out_gsize (non-hardclip record count; ==4 gates
// extend_eligible), out_refid, out_rx_rec (first placed record with a
// non-empty RX, -1 if none), out_nleft (leftover count — lets the Python
// side skip the per-family index scan for the common zero case).
int64_t bamio_duplex_scan(
    int64_t n_fam, const int64_t* fam_start, const int32_t* fam_nrec,
    const uint16_t* flag, const int32_t* pos, const int32_t* ref_id,
    const int32_t* l_seq,
    const int32_t* left_clip, const int32_t* right_clip,
    const uint8_t* cigar_flags,
    const uint8_t* rx, int32_t rx_w,
    int64_t* out_start, int64_t* out_window,
    uint8_t* out_rowmask, int32_t* out_gsize,
    int32_t* out_refid, int64_t* out_rx_rec, int32_t* out_nleft,
    int8_t* out_row) {
  for (int64_t f = 0; f < n_fam; f++) {
    const int64_t start = fam_start[f];
    const int64_t nrec = fam_nrec[f];
    int64_t lo = INT64_MAX, hi = INT64_MIN, rx_rec = -1;
    int32_t refid = -1, gsize = 0, nleft = 0;
    uint8_t mask = 0;
    bool any = false;
    for (int64_t j = start; j < start + nrec; j++) {
      const uint8_t cf = cigar_flags[j];
      if (cf & 2) {  // hardclip: dropped, not a leftover
        out_row[j] = -2;
        continue;
      }
      gsize++;
      int row;
      switch (flag[j]) {
        case 99: row = 0; break;
        case 163: row = 1; break;
        case 83: row = 2; break;
        case 147: row = 3; break;
        default: row = -1;
      }
      const int64_t L = int64_t(l_seq[j]) - left_clip[j] - right_clip[j];
      if (row < 0 || (mask & (1 << row)) || (cf & 1) || L <= 0) {
        out_row[j] = -1;  // leftover (first record wins a duplicate row)
        nleft++;
        continue;
      }
      mask |= uint8_t(1 << row);
      out_row[j] = int8_t(row);
      any = true;
      refid = ref_id[j];
      if (rx_rec < 0 && rx[j * int64_t(rx_w)] != 0) rx_rec = j;
      const int64_t p = pos[j];
      if (p < lo) lo = p;
      if (p + L > hi) hi = p + L;
    }
    const int64_t st = any ? (lo > 0 ? lo - 1 : 0) : -1;
    out_start[f] = st;
    out_window[f] = any ? hi - st : -1;
    out_rowmask[f] = mask;
    out_gsize[f] = gsize;
    out_refid[f] = refid;
    out_rx_rec[f] = rx_rec;
    out_nleft[f] = nleft;
  }
  return 0;
}

// Duplex pass 2: write placed reads (out_row >= 0) of families with
// rows[f] >= 0 into bases int8 / quals float32 / cover uint8(bool)
// [*, 4, w_pad]. Missing qualities (0xFF lead) stay zero. Returns records
// written, -1 on a window violation (scan/fill mismatch).
int64_t bamio_duplex_fill(
    int64_t n_fam, const int64_t* fam_start, const int32_t* fam_nrec,
    const int64_t* rows, const int64_t* starts,
    const int32_t* pos, const int32_t* l_seq, const int64_t* var_off,
    const int32_t* left_clip, const int32_t* right_clip,
    const uint8_t* seq, const uint8_t* qual,
    const int8_t* row_of, int64_t w_pad,
    int8_t* bases, float* quals, uint8_t* cover) {
  int64_t written = 0;
  for (int64_t f = 0; f < n_fam; f++) {
    const int64_t row = rows[f];
    if (row < 0) continue;
    const int64_t start = fam_start[f];
    for (int64_t j = start; j < start + fam_nrec[f]; j++) {
      if (row_of[j] < 0) continue;
      const int64_t L = int64_t(l_seq[j]) - left_clip[j] - right_clip[j];
      const int64_t off = int64_t(pos[j]) - starts[f];
      if (off < 0 || off + L > w_pad) return -1;
      const int64_t dst = (row * 4 + row_of[j]) * w_pad + off;
      const int64_t src = var_off[j] + left_clip[j];
      memcpy(bases + dst, seq + src, size_t(L));
      memset(cover + dst, 1, size_t(L));
      if (qual[var_off[j]] != 0xFF)
        for (int64_t i = 0; i < L; i++)
          quals[dst + i] = float(qual[src + i]);
      written++;
    }
  }
  return written;
}

// Pass 2: write direct-placed reads (keep==1) of families with rows[f] >= 0
// into bases/quals [*, t_pad, 2, w_pad] (bases pre-filled NBASE, quals
// zero). Missing qualities (0xFF lead byte, the BAM '*' fill) stay zero,
// matching ColumnarRecordView.codes_quals. Returns records written, or -1
// if any read falls outside its family window (scan/fill mismatch — a bug,
// not an input condition).
int64_t bamio_encode_fill(
    int64_t n_fam, const int64_t* fam_start, const int32_t* fam_nrec,
    const int64_t* rows, const int64_t* lo,
    const int32_t* pos, const int32_t* l_seq, const int64_t* var_off,
    const int32_t* left_clip, const int32_t* right_clip,
    const uint8_t* seq, const uint8_t* qual,
    const int32_t* ti, const uint8_t* role, const uint8_t* keep,
    int64_t t_pad, int64_t w_pad,
    int8_t* bases, uint8_t* quals) {
  int64_t written = 0;
  for (int64_t f = 0; f < n_fam; f++) {
    const int64_t row = rows[f];
    if (row < 0) continue;
    const int64_t start = fam_start[f];
    for (int64_t j = start; j < start + fam_nrec[f]; j++) {
      if (keep[j] != 1) continue;
      const int64_t L = int64_t(l_seq[j]) - left_clip[j] - right_clip[j];
      const int64_t off = int64_t(pos[j]) - lo[f];
      if (ti[j] < 0 || ti[j] >= t_pad || off < 0 || off + L > w_pad)
        return -1;
      const int64_t dst =
          ((row * t_pad + ti[j]) * 2 + role[j]) * w_pad + off;
      const int64_t src = var_off[j] + left_clip[j];
      memcpy(bases + dst, seq + src, size_t(L));
      if (qual[var_off[j]] != 0xFF) memcpy(quals + dst, qual + src, size_t(L));
      written++;
    }
  }
  return written;
}

}  // extern "C"
